"""float32 against bfloat16 mixed-precision training: the convergence soak.

    python -m pointnet2_tpu_torch.tools.bf16_train_soak [--steps 300] [--eval_batches 12] [--min_width 128]
        [--device cuda]

Counterpart of the JAX repo's ``tools/bf16_train_soak.py``. The soak's
configuration (``tools.train_soak.soak_config``: 2048 points, batch 16, SA
512/128/32/8) is trained from one seed-0 init, dropout seed 1, on one stream
of batches, once a precision mode: ``Trainer(train_dtype="float32")``,
``"bfloat16"``, and with ``--min_width W`` also selective bfloat16
(``bf16_min_width=W``: stages narrower than W stay float32). The batches are
drawn once, before any run, from ``SemanticDataset``s of the soak's scenes
(``make_scene``, 80 000 points each): ``--steps`` train batches (seed 0) and
``--eval_batches`` validation batches (seed 1), so every run sees the same
data and any divergence is the compute dtype's.

Prints the loss curves side by side (means over 20-step windows, each mode's
difference to float32), the final train loss, the validation accuracy and
mIoU of each mode, and for each bfloat16 mode a ``CONVERGENCE[...] OK`` or
``DIVERGED`` line: OK where |d acc| < 0.02 and |d mIoU| < 0.04 against
float32. ``main`` returns each mode's losses, accuracy and mIoU.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from pointnet2_tpu_torch.cli import add_device_flag, cli_device
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.data.semantic3d import (
    NUM_CLASSES,
    SemanticDataset,
    train_file_prefixes,
    validation_file_prefixes,
)
from pointnet2_tpu_torch.tools.train_soak import make_scene, soak_config
from pointnet2_tpu_torch.train import Trainer
from pointnet2_tpu_torch.utils.metrics import ConfusionMatrix

SCENE_POINTS = 80_000
WINDOW = 20  # steps a row of the loss overlay
ACC_TOL, MIOU_TOL = 0.02, 0.04


def presample(cfg: Config, steps: int, eval_batches: int) -> tuple[list, list]:
    """``steps`` train batches (seed 0) and ``eval_batches`` validation batches
    (seed 1) from the scenes under ``cfg.data_path``, each a dict of numpy
    ``points``, ``labels`` and ``weights``, drawn in the JAX tool's order."""

    def dataset(split: str, seed: int) -> SemanticDataset:
        return SemanticDataset(
            num_points_per_sample=cfg.num_point, split=split, use_color=bool(cfg.use_color),
            box_size_x=cfg.box_size_x, box_size_y=cfg.box_size_y, path=cfg.data_path, seed=seed,
        )

    def named(batch) -> dict:
        data, labels, weights = batch
        return {"points": data, "labels": labels, "weights": weights}

    train_ds, val_ds = dataset("train", 0), dataset("validation", 1)
    batches = [named(train_ds.sample_batch_in_all_files(cfg.batch_size, True)) for _ in range(steps)]
    val_batches = [named(val_ds.sample_batch_in_all_files(cfg.batch_size, False)) for _ in range(eval_batches)]
    return batches, val_batches


def run(dtype: str, cfg: Config, batches: list, val_batches: list, device: torch.device,
        min_width: Optional[int] = None) -> tuple[list[float], float, float]:
    """One mode's training from the seed-0 init: every step's loss, then the
    validation accuracy and mIoU from the eval-mode confusion matrix."""
    trainer = Trainer(cfg, NUM_CLASSES, device=device, dropout_seed=1, train_dtype=dtype, bf16_min_width=min_width)
    trainer.init_state(0)
    losses = [trainer.train_step(batch)["loss"] for batch in batches]
    cm = ConfusionMatrix(NUM_CLASSES)
    for batch in val_batches:
        cm.increment_from_matrix(trainer.eval_step(batch)["confusion"])
    return torch.stack(losses).tolist(), cm.get_accuracy(), cm.get_mean_iou()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--eval_batches", type=int, default=12)
    ap.add_argument("--min_width", type=int, default=None,
                    help="also run selective bf16 (Trainer.bf16_min_width)")
    add_device_flag(ap)
    return ap


def report(results: dict, steps: int) -> dict:
    """Print the overlay, the final lines and the CONVERGENCE verdicts;
    returns each bfloat16 mode's verdict (True: OK)."""
    names = list(results)
    print("\nloss-curve overlay (mean over 20-step windows):")
    hdr = " ".join(f"{n:>12}" for n in names)
    dhdr = " ".join(f"{n + '-f32':>12}" for n in names[1:])
    print(f"{'steps':>10} {hdr} {dhdr}")
    for s in range(0, steps, WINDOW):
        means = [float(np.mean(results[n][0][s:s + WINDOW])) for n in names]
        vals = " ".join(f"{m:>12.4f}" for m in means)
        deltas = " ".join(f"{m - means[0]:>+12.4f}" for m in means[1:])
        print(f"{s:>5}-{min(s + WINDOW, steps):<4} {vals} {deltas}")

    _, acc32, miou32 = results["f32"]
    print("\nfinal train loss: " + "  ".join(f"{n} {results[n][0][-1]:.4f}" for n in names))
    print("val accuracy:     " + "  ".join(f"{n} {results[n][1]:.4f} ({results[n][1] - acc32:+.4f})" for n in names))
    print("val mIoU:         " + "  ".join(f"{n} {results[n][2]:.4f} ({results[n][2] - miou32:+.4f})" for n in names))
    verdicts = {}
    for n in names[1:]:
        _, acc, miou = results[n]
        verdicts[n] = bool(abs(acc - acc32) < ACC_TOL and abs(miou - miou32) < MIOU_TOL)
        print(f"CONVERGENCE[{n}]", "OK" if verdicts[n] else "DIVERGED",
              "(tolerance: |d acc| < 0.02, |d mIoU| < 0.04)")
    return verdicts


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    device = cli_device(args.device)
    print("backend:", device.type)
    with tempfile.TemporaryDirectory(prefix="bf16_soak_") as data_dir:
        rng = np.random.RandomState(0)
        for prefix in train_file_prefixes + validation_file_prefixes:
            make_scene(prefix, data_dir, rng, n=SCENE_POINTS)
        cfg = soak_config(data_dir)
        print(f"pre-sampling {args.steps} train + {args.eval_batches} val batches")
        batches, val_batches = presample(cfg, args.steps, args.eval_batches)
    # On the device once: every mode's steps read the same tensors.
    batches, val_batches = ([{k: torch.as_tensor(v).to(device) for k, v in b.items()} for b in bs]
                            for bs in (batches, val_batches))

    variants = [("f32", "float32", None), ("bf16", "bfloat16", None)]
    if args.min_width is not None:
        variants.append((f"bf16_sel{args.min_width}", "bfloat16", args.min_width))
    results = {}
    for name, dtype, mw in variants:
        print(f"training {args.steps} steps in {name} ...", flush=True)
        results[name] = run(dtype, cfg, batches, val_batches, device, min_width=mw)
    verdicts = report(results, args.steps)
    summary = {name: {"losses": losses, "accuracy": acc, "miou": miou} for name, (losses, acc, miou) in results.items()}
    summary["convergence"] = verdicts
    return summary


if __name__ == "__main__":
    main()
