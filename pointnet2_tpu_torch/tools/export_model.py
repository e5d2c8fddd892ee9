"""Export a checkpoint of the port as a self-contained serving artifact.

    python -m pointnet2_tpu_torch.tools.export_model --ckpt log/semantic/model.pt --out result/export \\
        [--config_file semantic.json] [--batch 0] [--dtype bfloat16 [--bf16_min_width 128]] \\
        [--output labels|logits] [--bq_window N|auto] [--fp_window N|auto] [--arch ssg|msg] [--device cuda]

Counterpart of the JAX repo's ``tools/export_model.py``, with its flags and
``--device`` (CUDA by default, which must be present): a ``torch.export``
program with the weights in it (``pointnet2_tpu_torch.export``), loadable
with ``torch`` and the ``pn2`` operators alone. ``--ckpt`` is a checkpoint
of the port's train CLI (``torch.save``). ``--batch 0`` (the default)
exports a symbolic batch (one artifact, any batch, the forward unchunked);
``--batch N`` the chunked forward at N. Export on the device you serve on.
``--bq_window``/``--fp_window auto`` calibrate from batches of the
``--calibration_set`` split under the config's ``data_path``, as
``cli.predict`` does; the artifact then returns each batch's certificate.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from pointnet2_tpu_torch.cli import add_device_flag, cli_device
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.data.semantic3d import SemanticDataset
from pointnet2_tpu_torch.export import export_model
from pointnet2_tpu_torch.ops.calibrate import calibrate_model_windows, parse_window_arg
from pointnet2_tpu_torch.train import Trainer
from pointnet2_tpu_torch.train.trainer import load_model_state


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="checkpoint file of the port's train CLI")
    ap.add_argument("--config_file", default="semantic.json")
    ap.add_argument("--out", default=os.path.join("result", "export"))
    ap.add_argument("--batch", type=int, default=0, help="0 = symbolic batch")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--output", default="labels", choices=["labels", "logits"])
    ap.add_argument(
        "--bq_window", type=parse_window_arg, default=None,
        help="calibrated ball-query x-window: an int, a per-level list like '3072,768,-,-', or 'auto'; "
        "the artifact then returns (output, ok) with the batch's certificate",
    )
    ap.add_argument("--fp_window", type=parse_window_arg, default=None,
                    help="calibrated 3-NN x-window for the FP levels (see --bq_window)")
    ap.add_argument("--bf16_min_width", type=int, default=None,
                    help="selective mixed precision threshold for --dtype bfloat16 (128 keeps SA1 and SA2 float32)")
    ap.add_argument("--calibration_set", default="train",
                    help="the split sampled for --bq_window/--fp_window auto (scenes under the config's data_path)")
    ap.add_argument("--arch", default="ssg", choices=["ssg", "msg"],
                    help="model architecture: must match the checkpoint's")
    add_device_flag(ap)
    return ap


def calibrate(ap: argparse.ArgumentParser, flags: argparse.Namespace, cfg: Config, device) -> None:
    """Resolve ``auto`` windows in ``flags`` from 8 batches of 8 sampled clouds."""
    if flags.bq_window != "auto" and flags.fp_window != "auto":
        return
    try:
        dataset = SemanticDataset(
            num_points_per_sample=cfg.num_point, split=flags.calibration_set, box_size_x=cfg.box_size_x,
            box_size_y=cfg.box_size_y, use_color=bool(cfg.use_color), path=cfg.data_path, seed=0,
        )
    except (OSError, ValueError) as e:
        ap.error(
            f"--bq_window/--fp_window auto needs calibration data (data_path={cfg.data_path!r}, split="
            f"{flags.calibration_set!r}: {e}); pass integer widths instead"
        )
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


def trainer_from_checkpoint(cfg: Config, ckpt: str, device, *, arch: str = "ssg", dtype: str = "float32",
                            bf16_min_width: Optional[int] = None, bq_window=None, fp_window=None) -> Trainer:
    """A ``Trainer`` in the export's mode holding the weights of the port's checkpoint ``ckpt``."""
    trainer = Trainer(cfg, arch=arch, infer_dtype=dtype, bf16_min_width=bf16_min_width, bq_window=bq_window,
                      fp_window=fp_window, device=device)
    trainer.model.load_state_dict(load_model_state(os.path.abspath(ckpt)))
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Export; returns the manifest."""
    ap = build_parser()
    flags = ap.parse_args(argv)
    device = cli_device(flags.device)
    cfg = Config.from_json(flags.config_file)
    calibrate(ap, flags, cfg, device)
    trainer = trainer_from_checkpoint(
        cfg, flags.ckpt, device, arch=flags.arch, dtype=flags.dtype, bf16_min_width=flags.bf16_min_width,
        bq_window=flags.bq_window, fp_window=flags.fp_window,
    )
    manifest = export_model(trainer, flags.out, batch=flags.batch or None, output=flags.output)
    print(f"exported {manifest['artifact_bytes']} bytes ({manifest['output']}, device {manifest['device']}) "
          f"-> {flags.out}")
    return manifest


if __name__ == "__main__":
    main()
