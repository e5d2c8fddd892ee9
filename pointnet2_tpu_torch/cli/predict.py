"""Sparse multi-sample inference on Semantic3D scenes with the port, on the card.

    python -m pointnet2_tpu_torch.cli.predict --ckpt log/semantic/model.pt [--set validation]

Counterpart of the root ``predict.py``, with its flags by the same names:
it loads the model of a checkpoint the port's train CLI wrote, samples each
scene of the split ``--num_samples`` times in batches of ``--batch_size``
(``SemanticDataset(seed=0)`` after ``np.random.seed(0)``, so the same boxes
as the JAX script's), labels them, writes ``<output_dir>/<scene>.pcd`` (the
sampled points) and ``.labels`` (one label a point), and prints the
confusion matrix over the sampled points' ground truth when the split has
labels. With ``--bq_window``/``--fp_window`` (ints or ``auto``) every
batch's window certificate is checked and a failure aborts the run.
``--dtype bfloat16`` (with ``--bf16_min_width``, selectively) labels in the
bf16 inference mode, from the same float32 checkpoint. ``--arch msg``
labels with the multi-scale-grouping model: it must be the checkpoint's.

``--sharded`` splits each batch over every visible card (``--device cpu``:
the CPU alone), a copy of the model on each; ``--batch_size`` must divide by
their count, and a short last batch is padded with copies of its clouds.
With ``--dist_coordinator``, ``--dist_num_processes`` and
``--dist_process_id`` process I of P labels the scenes ``I::P`` on its own
device (``parallel.multihost``), drawing only their samples from its own
``SemanticDataset(seed=0)``, as each process of the JAX script does: process
I starts its first scene on a fresh stream. The confusion matrices are
gathered, and process 0 prints the global metrics.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from pointnet2_tpu_torch.cli import add_device_flag, add_dist_flags, cli_device, cli_mesh
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.data.io import write_labels, write_pcd
from pointnet2_tpu_torch.data.semantic3d import SemanticDataset
from pointnet2_tpu_torch.infer import Predictor, check_min_width, compute_dtype
from pointnet2_tpu_torch.ops.calibrate import calibrate_model_windows, parse_window_arg
from pointnet2_tpu_torch.parallel import multihost
from pointnet2_tpu_torch.parallel.mesh import pad_batch_to_devices, shard_batch
from pointnet2_tpu_torch.train.trainer import load_model_state
from pointnet2_tpu_torch.utils.metrics import ConfusionMatrix


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--num_samples", type=int, default=8, help="# samples, each contains num_point points_centered")
    parser.add_argument("--ckpt", required=True, help="checkpoint file of the port's train CLI")
    parser.add_argument("--set", default="validation", help="train, validation, test")
    parser.add_argument("--config_file", default="semantic.json")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--output_dir", default=os.path.join("result", "sparse"))
    parser.add_argument(
        "--dtype", default="float32", choices=["float32", "bfloat16"],
        help="inference compute dtype (bfloat16: the production mode, on BatchNorm-folded weights)",
    )
    parser.add_argument(
        "--bf16_min_width", type=int, default=None,
        help="selective mixed precision: with --dtype bfloat16, stages whose narrowest MLP width is "
        "below this stay float32 (128 keeps SA1 and SA2 in float32). Default: uniform bfloat16",
    )
    parser.add_argument(
        "--arch", default="ssg", choices=["ssg", "msg"],
        help="model architecture: must match the checkpoint's (cli.train --arch)",
    )
    parser.add_argument(
        "--bq_window", type=parse_window_arg, default=None,
        help="calibrated ball-query x-window: an int, or 'auto' to calibrate from scene samples at "
        "startup; the certificate is checked on every batch and the run aborts if it fails",
    )
    parser.add_argument(
        "--fp_window", type=parse_window_arg, default=None,
        help="calibrated 3-NN x-window for the FP levels (int or 'auto'); checked like --bq_window",
    )
    parser.add_argument(
        "--sharded", action="store_true",
        help="split each batch over every visible card, the model copied to each; --batch_size must divide by "
        "their count",
    )
    add_dist_flags(parser)
    add_device_flag(parser)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the prediction; returns the samples labelled, each batch's seconds
    (sampling excluded, the labels' read back included), the seconds spent
    drawing this process's samples and over its scenes in all, the files
    written and the confusion matrix over every process's points (None for
    the test set)."""
    np.random.seed(0)
    parser = build_parser()
    flags = parser.parse_args(argv)
    # As the JAX script's Trainer does, before anything is read.
    check_min_width(flags.bf16_min_width, "--dtype is not bfloat16", compute_dtype(flags.dtype, "dtype"))
    mesh = cli_mesh(flags.device) if flags.sharded else None
    if mesh is not None and flags.batch_size % len(mesh):
        parser.error(f"--sharded: batch_size {flags.batch_size} must divide by the device count {len(mesh)}")
    nproc = flags.dist_num_processes or 1
    device = multihost.maybe_initialize_distributed(
        flags.dist_coordinator, flags.dist_num_processes, flags.dist_process_id, cli_device(flags.device)
    )
    try:
        return _predict(flags, device, mesh)
    finally:
        if nproc > 1:
            multihost.shutdown()


def _predict(flags: argparse.Namespace, device: torch.device, mesh) -> dict:
    nproc, pid = multihost.process_count(), multihost.process_index()
    cfg = Config.from_json(flags.config_file)
    os.makedirs(flags.output_dir, exist_ok=True)
    dataset = SemanticDataset(
        num_points_per_sample=cfg.num_point, split=flags.set, box_size_x=cfg.box_size_x,
        box_size_y=cfg.box_size_y, use_color=bool(cfg.use_color), path=cfg.data_path, seed=0,
    )
    if flags.bq_window == "auto" or flags.fp_window == "auto":
        # Every process calibrates on the same samples, and so picks the same windows.
        crng = np.random.RandomState(0)

        def sample_xyz() -> np.ndarray:
            fd = dataset.list_file_data[crng.randint(len(dataset.list_file_data))]
            return fd.sample_batch(batch_size=8, num_points_per_sample=cfg.num_point)[0]

        auto_bq, auto_fp = calibrate_model_windows(
            sa_specs=[(s.npoint, s.radius) for s in cfg.sa_layers], num_point=cfg.num_point,
            sample_xyz=sample_xyz, num_batches=8, device=device,
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

    state = load_model_state(os.path.abspath(flags.ckpt))
    predictors = {
        d: Predictor(
            cfg, state, num_classes=dataset.num_classes, infer_chunk=8, device=d, bq_window=flags.bq_window,
            fp_window=flags.fp_window, dtype=flags.dtype, bf16_min_width=flags.bf16_min_width, arch=flags.arch,
        )
        for d in dict.fromkeys(mesh or (device,))
    }
    print("Model restored" + (f" (sharded over {len(mesh)} devices)" if mesh else ""))

    def label(inputs: np.ndarray) -> tuple[np.ndarray, bool]:
        """Labels of ``inputs`` and whether every window certificate held."""
        if mesh is None:
            shards, devices = [inputs], [device]
        else:
            # A short batch is padded with copies of its clouds; each cloud is labelled on its own.
            rows = np.arange(pad_batch_to_devices(len(inputs), len(mesh))) % len(inputs)
            shards, devices = shard_batch(inputs[rows], mesh), mesh
        if checked:
            outs = [predictors[d].predict_step_checked(x) for d, x in zip(devices, shards)]
        else:
            outs = [(predictors[d].predict_step(x), True) for d, x in zip(devices, shards)]  # all launched, then read
        labels = np.concatenate([out.cpu().numpy() for out, _ in outs])[: len(inputs)]
        return labels, all(ok for _, ok in outs)

    batch_size = flags.batch_size
    cm = ConfusionMatrix(dataset.num_classes)
    summary: dict = {"samples": 0, "batch_seconds": [], "sample_seconds": 0.0, "outputs": [], "processes": nproc,
                     "confusion": None}
    start = time.perf_counter()
    for file_data in dataset.list_file_data[pid::nproc]:
        print(f"Processing {file_data.file_path_without_ext}" + (f" (process {pid})" if nproc > 1 else ""))
        points_collector: list[np.ndarray] = []
        pd_labels_collector: list[np.ndarray] = []

        for batch_index in range(int(np.ceil(flags.num_samples / batch_size))):
            current = min(batch_size, flags.num_samples - batch_index * batch_size)
            s = time.perf_counter()
            centered, raw, gt_labels, colors = file_data.sample_batch(
                batch_size=current, num_points_per_sample=cfg.num_point
            )
            summary["sample_seconds"] += time.perf_counter() - s
            inputs = np.concatenate((centered, colors), axis=-1) if cfg.use_color else centered
            # The JAX script pads a short last batch to batch_size for its one
            # compiled shape. Not here: in eval mode each cloud is labelled on
            # its own (FPS, grouping and BatchNorm's moving statistics are per
            # cloud), so the short batch gives the labels the padded one would.
            s = time.perf_counter()
            pred, ok = label(inputs.astype(np.float32))
            if not ok:
                raise ValueError(
                    f"--bq_window={flags.bq_window} / --fp_window={flags.fp_window} is too small for "
                    f"this dataset (exactness certificate failed on batch {batch_index} of "
                    f"{file_data.file_path_without_ext}); recalibrate with --bq_window auto"
                )
            seconds = time.perf_counter() - s
            summary["batch_seconds"].append(seconds)
            summary["samples"] += current
            print(f"Batch size: {current}, time: {seconds}")

            points_collector.extend(raw)
            pd_labels_collector.extend(pred)
            if flags.set != "test":
                cm.increment_from_list(gt_labels.flatten(), pred.flatten())

        prefix = os.path.basename(file_data.file_path_without_ext)
        pcd_path = os.path.join(flags.output_dir, prefix + ".pcd")
        write_pcd(pcd_path, np.array(points_collector).reshape((-1, 3)))
        print(f"Exported sparse pcd to {pcd_path}")
        labels_path = os.path.join(flags.output_dir, prefix + ".labels")
        write_labels(labels_path, np.array(pd_labels_collector).flatten())
        print(f"Exported sparse labels to {labels_path}")
        summary["outputs"].append((pcd_path, labels_path))

    summary["seconds"] = time.perf_counter() - start
    if flags.set != "test":
        # One collective at the end: the matrix is a sum over points, so the
        # sum of the processes' matrices counts every scene's.
        total = ConfusionMatrix(dataset.num_classes)
        total.increment_from_matrix(multihost.allgather_host(np.asarray(cm.confusion_matrix, np.int64)).sum(axis=0))
        summary["confusion"] = np.asarray(total.confusion_matrix)
        if pid == 0:
            total.print_metrics()
    return summary


if __name__ == "__main__":
    main()
