"""Multi-epoch training soak through the port's train CLI on fabricated Semantic3D scenes.

    python -m pointnet2_tpu_torch.tools.train_soak [--epochs 20] [--out log/soak] [--accum_steps 4]
        [--bq_window auto] [--fp_window auto] [--train_dtype bfloat16] [--bf16_min_width 128]
        [--hoist_geometry 1] [--arch ssg|msg] [--device cuda]

Counterpart of the JAX repo's ``tools/train_soak.py``, flag for flag:

- ``make_scene`` fabricates a geometry-separable scene holding all 8
  foreground classes (the same files as the JAX function's, byte for byte,
  from the same ``RandomState``); one for every prefix of the train and
  validation splits (9 + 6 scenes of ``--points_per_scene`` points), in a
  temporary directory removed at the end;
- the soak's ``Config`` (``soak_config``): 2048 points, batch 16, SA
  512/128/32/8, ``decay_step`` 20000, ``--epochs`` epochs, logging to
  ``--out``;
- ``cli.train.main`` runs in this process with ``--seed 0`` and the
  forwarded flags (``--accum_steps``, the windows, the precision mode,
  ``--hoist_geometry``, ``--arch``) and ``--device``: sampler thread,
  prefetch, eval every 5 epochs, best and rolling checkpoints,
  ``scalars.jsonl``;
- then the JAX tool's summary lines from ``scalars.jsonl``. TensorBoard
  event files are written where ``tensorboardX`` imports
  (``utils.logging.export_tensorboard``); where it does not, a line says the
  export was skipped.

``main`` returns the train CLI's summary, the train and validation records
and the checkpoints' names.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Optional, Sequence

import numpy as np

from pointnet2_tpu_torch.cli import add_device_flag, cli_device
from pointnet2_tpu_torch.cli import train as cli_train
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.data.io import write_labels, write_pcd
from pointnet2_tpu_torch.data.semantic3d import train_file_prefixes, validation_file_prefixes
from pointnet2_tpu_torch.utils.logging import export_tensorboard

FORWARDED = ("accum_steps", "bq_window", "fp_window", "train_dtype", "bf16_min_width", "hoist_geometry", "arch")


def make_scene(prefix: str, out_dir: str, rng: np.random.RandomState, n: int = 120_000) -> None:
    """Geometry-separable scene containing all 8 foreground classes."""
    pts = rng.rand(n, 3) * [30.0, 30.0, 4.0]
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    # strata give classes 1/4/6; radial features carve out the rest
    labels = np.where(z < 1.3, 1, np.where(z < 2.6, 4, 6)).astype(np.int32)
    r = np.hypot(x - 15, y - 15)
    labels[r < 5] = 2
    labels[(r >= 5) & (r < 8) & (z > 2)] = 8
    labels[(x < 6) & (z < 1.0)] = 3
    labels[(y < 6) & (z >= 3.2)] = 5
    labels[(x > 24) & (y > 24)] = 7
    # colors correlated with labels + noise so the color path carries signal
    base = np.stack([labels / 8.0, 1.0 - labels / 8.0, 0.5 * np.ones_like(x)], 1)
    colors = np.clip(base + rng.randn(n, 3) * 0.1, 0, 1)
    write_pcd(os.path.join(out_dir, prefix + ".pcd"), pts, colors)
    write_labels(os.path.join(out_dir, prefix + ".labels"), labels)


def fabricate(data_dir: str, points_per_scene: int, seed: int = 0) -> None:
    """A scene for every prefix of the train and validation splits (the
    dataset loads every prefix of a split), all from one ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    for prefix in train_file_prefixes + validation_file_prefixes:
        make_scene(prefix, data_dir, rng, n=points_per_scene)


def soak_config(data_path: str, epochs: int = 20, logdir: str = "log/soak") -> Config:
    return Config(
        num_point=2048, batch_size=16, max_epoch=epochs, logdir=logdir, data_path=data_path,
        l1_npoint=512, l2_npoint=128, l3_npoint=32, l4_npoint=8, decay_step=20000,
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--out", default="log/soak")
    ap.add_argument("--points_per_scene", type=int, default=80_000)
    ap.add_argument("--accum_steps", type=int, default=1)
    ap.add_argument("--bq_window", default=None, help="int or 'auto' — forwarded to cli.train")
    ap.add_argument("--fp_window", default=None, help="int or 'auto' — forwarded to cli.train")
    ap.add_argument("--train_dtype", default=None, help="float32/bfloat16 — forwarded to cli.train")
    ap.add_argument("--bf16_min_width", default=None, help="selective bf16 threshold — forwarded to cli.train")
    ap.add_argument("--hoist_geometry", default=None, help="0/1 — forwarded to cli.train")
    ap.add_argument("--arch", default=None, help="ssg/msg — forwarded to cli.train")
    add_device_flag(ap)
    return ap


def summarize(out: str) -> dict:
    """Print the JAX tool's summary lines of the run logged in ``out``; returns its records and checkpoints."""
    with open(os.path.join(out, "scalars.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    train_recs = [r for r in records if r["tag"] == "train"]
    val_recs = [r for r in records if r["tag"] == "validation"]
    print(f"epochs logged: {len(train_recs)}  evals: {len(val_recs)}")
    print(f"first epoch: loss={train_recs[0]['loss']:.3f} acc={train_recs[0]['accuracy']:.3f}")
    print(f"last epoch:  loss={train_recs[-1]['loss']:.3f} acc={train_recs[-1]['accuracy']:.3f}")
    if val_recs:
        best = max(v["accuracy"] for v in val_recs)
        print(f"best val acc: {best:.3f}  last val mIoU: {val_recs[-1]['miou']:.3f}")
    ckpts = sorted(d for d in os.listdir(out) if d.startswith(("best_model", "model")))
    print("checkpoints:", ckpts)
    return {"train": train_recs, "validation": val_recs, "checkpoints": ckpts}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    cli_device(args.device)  # no CUDA device: raise before fabricating anything
    with tempfile.TemporaryDirectory(prefix="soak_data_") as data_dir:
        fabricate(data_dir, args.points_per_scene)
        print(f"fabricated {len(train_file_prefixes)}+{len(validation_file_prefixes)} scenes in {data_dir}")
        cfg_path = os.path.join(data_dir, "soak.json")
        soak_config(data_dir, args.epochs, args.out).to_json(cfg_path)
        train_argv = ["--config_file", cfg_path, "--seed", "0", "--device", args.device]
        for name in FORWARDED:
            value = getattr(args, name)
            if value is not None:
                train_argv += [f"--{name}", str(value)]
        train_summary = cli_train.main(train_argv)

    try:
        runs = export_tensorboard(args.out)
        print("tensorboard runs:", [str(r) for r in runs])
    except ImportError:
        print("tensorboard export skipped: tensorboardX is not installed (scalars.jsonl holds every record)")
    return {"train_summary": train_summary, **summarize(args.out)}


if __name__ == "__main__":
    main()
