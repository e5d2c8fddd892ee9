"""KITTI streaming inference with the port: predict, then densify on the card, frame by frame.

    python -m pointnet2_tpu_torch.cli.kitti_predict --ckpt log/semantic/model.pt --kitti_root DIR [--save] [--render]

Counterpart of the root ``kitti_predict.py``, with its flags by the same
names and ``--device``: it loads a drive (``data.kitti.KittiDataset``),
crops each Velodyne frame near the origin, labels one fixed-size sample of
it with the no-color model of a checkpoint the port's train CLI wrote
(``Predictor``; an orbax directory is refused), and densifies the labels to
the whole cropped frame with ``ops.densify.densify_labels_device``: row 3's
kNN kernel and the vote on the card. The sample's labels stay on the device
between the two; only the dense labels and colors come back to the host.
``--save`` writes ``result/dense/<frame>.pcd`` and ``.labels``; ``--render``
a PNG a frame to ``result/frames/`` (it needs matplotlib, and raises
``ImportError`` at the start where it is missing). With
``--bq_window``/``--fp_window`` (ints or ``auto``) every frame's window
certificate is checked and a failure aborts the run. ``--arch msg`` runs
the multi-scale-grouping model, which must be the checkpoint's.

Each frame prints the JAX script's timer line, then ``predict_interpolate``
split in two on a line of its own: ``predict`` (the model, the device
synchronised after it) and ``densify``. Where the JAX script draws each
frame's sample from an unseeded RandomState, the port seeds each frame's
(``data.kitti.SAMPLE_SEED``), so a run draws the same samples every time.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from pointnet2_tpu_torch.cli import add_device_flag, cli_device
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.data.io import write_labels, write_pcd
from pointnet2_tpu_torch.data.kitti import KittiDataset
from pointnet2_tpu_torch.infer import Predictor
from pointnet2_tpu_torch.ops.calibrate import calibrate_model_windows, parse_window_arg
from pointnet2_tpu_torch.ops.densify import densify_labels_device
from pointnet2_tpu_torch.train.trainer import load_model_state
from pointnet2_tpu_torch.utils.render import render_cloud_png, require_matplotlib


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ckpt", required=True, help="checkpoint file of the port's train CLI")
    parser.add_argument("--save", action="store_true", default=False)
    parser.add_argument(
        "--render", action="store_true", default=False,
        help="write a colorized PNG per frame to result/frames/ (needs matplotlib)",
    )
    parser.add_argument(
        "--arch", default="ssg", choices=["ssg", "msg"],
        help="model architecture: must match the checkpoint's (cli.train --arch)",
    )
    parser.add_argument("--kitti_root", required=True)
    parser.add_argument("--config_file", default="semantic_no_color.json")
    parser.add_argument("--dates", nargs="+", default=["2011_09_26"])
    parser.add_argument("--drives", nargs="+", default=["0095"])
    parser.add_argument(
        "--bq_window", type=parse_window_arg, default=None,
        help="calibrated ball-query x-window: an int, or 'auto' to calibrate from frame samples at "
        "startup; the certificate is checked on every frame and the run aborts if it fails",
    )
    parser.add_argument(
        "--fp_window", type=parse_window_arg, default=None,
        help="calibrated 3-NN x-window for the FP levels (int or 'auto'); checked like --bq_window",
    )
    add_device_flag(parser)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run every frame; returns each frame's name, dense point count, timers
    and sample (``centered``, the model's input, and ``raw``), and the windows."""
    flags = build_parser().parse_args(argv)
    if flags.render:
        require_matplotlib()
    device = cli_device(flags.device)
    cfg = Config.from_json(flags.config_file)

    dense_dir = os.path.join("result", "dense")
    frames_dir = os.path.join("result", "frames")
    os.makedirs(dense_dir, exist_ok=True)
    if flags.render:
        os.makedirs(frames_dir, exist_ok=True)

    dataset = KittiDataset(
        num_points_per_sample=cfg.num_point, base_dir=flags.kitti_root, dates=flags.dates, drives=flags.drives,
        box_size_x=cfg.box_size_x, box_size_y=cfg.box_size_y,
    )

    if flags.bq_window == "auto" or flags.fp_window == "auto":
        crng = np.random.RandomState(0)
        frames = dataset.list_file_data

        def sample_xyz() -> np.ndarray:
            fd = frames[crng.randint(len(frames))]
            centered, _ = fd.get_batch_of_one_z_box_from_origin(num_points_per_sample=cfg.num_point)
            return centered.astype(np.float32)

        auto_bq, auto_fp = calibrate_model_windows(
            sa_specs=[(s.npoint, s.radius) for s in cfg.sa_layers], num_point=cfg.num_point,
            sample_xyz=sample_xyz, num_batches=min(8, len(frames)), device=device,
        )
        if flags.bq_window == "auto":
            flags.bq_window = auto_bq
        if flags.fp_window == "auto":
            flags.fp_window = auto_fp
        print(
            f"auto window calibration: bq_window={flags.bq_window}, fp_window={flags.fp_window} "
            "(None = windowing would not engage; full exact kernels run)"
        )
    checked = flags.bq_window is not None or flags.fp_window is not None

    predictor = Predictor(
        cfg, load_model_state(os.path.abspath(flags.ckpt)), num_classes=dataset.num_classes,
        device=device, bq_window=flags.bq_window, fp_window=flags.fp_window, arch=flags.arch,
    )
    print("Model restored")

    summary: dict = {"frames": [], "bq_window": flags.bq_window, "fp_window": flags.fp_window}
    for kitti_file_data in dataset.list_file_data:
        timer = {"load_data": 0.0, "predict_interpolate": 0.0, "visualize": 0.0, "write_data": 0.0, "total": 0.0}
        global_start = time.time()

        start = time.time()
        centered, raw = kitti_file_data.get_batch_of_one_z_box_from_origin(num_points_per_sample=cfg.num_point)
        timer["load_data"] += time.time() - start

        start = time.time()
        dense_points = kitti_file_data.points
        if checked:
            sparse_labels, ok = predictor.predict_step_checked(centered.astype(np.float32))
            if not ok:
                raise ValueError(
                    f"--bq_window={flags.bq_window} / --fp_window={flags.fp_window} is too small for this "
                    f"drive (exactness certificate failed on frame {kitti_file_data.file_path_without_ext}); "
                    "use 'auto' or recalibrate"
                )
        else:
            sparse_labels = predictor.predict_step(centered.astype(np.float32))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        predict_seconds = time.time() - start
        # The sample's labels stay on the device: only the dense labels and colors come back.
        dense_labels_dev, dense_colors_dev = densify_labels_device(
            raw.reshape(-1, 3).astype(np.float32), sparse_labels.reshape(-1), dense_points.astype(np.float32),
            knn=3, device=device,
        )
        dense_labels = dense_labels_dev.cpu().numpy()
        dense_colors = dense_colors_dev.cpu().numpy()
        timer["predict_interpolate"] += time.time() - start
        split = {"predict": predict_seconds, "densify": timer["predict_interpolate"] - predict_seconds}

        prefix = os.path.basename(kitti_file_data.file_path_without_ext)
        frame_name = kitti_file_data.file_path_without_ext.replace(os.sep, "_")
        if flags.render:
            start = time.time()
            png = os.path.join(frames_dir, frame_name + ".png")
            render_cloud_png(dense_points, dense_colors / 255.0, png, title=frame_name)
            timer["visualize"] += time.time() - start

        if flags.save:
            start = time.time()
            pcd_path = os.path.join(dense_dir, prefix + ".pcd")
            write_pcd(pcd_path, dense_points, dense_colors / 255.0)
            print(f"Exported dense_pcd to {pcd_path}")
            labels_path = os.path.join(dense_dir, prefix + ".labels")
            write_labels(labels_path, dense_labels)
            print(f"Exported dense_labels to {labels_path}")
            timer["write_data"] += time.time() - start

        timer["total"] += time.time() - global_start
        fmt = "[{:5.2f} FPS] " + ": {:.04f}, ".join(timer.keys()) + ": {:.04f}"
        print(fmt.format(1.0 / max(timer["total"], 1e-9), *timer.values()))
        print("predict: {predict:.04f}, densify: {densify:.04f}".format(**split), flush=True)
        summary["frames"].append({
            "name": kitti_file_data.file_path_without_ext, "dense_points": len(dense_points),
            "timer": {**timer, **split}, "centered": centered[0], "raw": raw[0],
        })
    return summary


if __name__ == "__main__":
    main()
