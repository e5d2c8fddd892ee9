"""Where the train step's time goes on the GPU: a torch.profiler breakdown.

    python -m pointnet2_tpu_torch.train_profile [--arch ssg|msg] [--accum G] [--dtype bfloat16 [--bf16_min_width 128]]
        [--bq_window W] [--fp_window W] [--out FILE]

Builds the same ``Trainer`` as ``chip_smoke.py``'s train phase (full
``semantic.json`` width, Adam, the ``--arch`` model, SSG or MSG, with
weights from ``convert.init_variables(seed=0, bn_stats="random")``,
batches of 16 clouds with seeded labels and weights), takes two warm-up
steps, then profiles 3 steps with CPU and CUDA activities. Prints one JSON
object: the wall time of the window and per step, the device time summed
over kernels (busy share = device time / wall time), the device time of each
of the port's kernels, of matrix products, of the optimizer and of
everything else, the 20 largest device-time entries and the 15 host-side
operators with the most host time of their own. The calibrated windows, when
given, go to the Trainer, and so do ``--dtype`` (its ``train_dtype``) and
``--bf16_min_width``. Runs on CUDA only.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.models.pointnet2_seg import ARCHES
from pointnet2_tpu_torch.predict_profile import ROOT, summarise
from pointnet2_tpu_torch.train import Trainer

STEPS = 3
WARMUP = 2
BATCH = 16


def train_batch(cfg: Config, batch: int, seed: int) -> dict:
    """Clouds in 8 x 8 x 4.9 m with colours, labels in 0..8, weights in [0, 1) with a fifth zeros."""
    rng = np.random.RandomState(seed)
    points = np.zeros((batch, cfg.num_point, cfg.point_dim), np.float32)
    points[..., :3] = rng.rand(batch, cfg.num_point, 3) * [8.0, 8.0, 4.9]
    points[..., 3:] = rng.rand(batch, cfg.num_point, cfg.point_dim - 3)
    weights = rng.rand(batch, cfg.num_point).astype(np.float32)
    weights[rng.rand(batch, cfg.num_point) < 0.2] = 0.0
    labels = rng.randint(0, 9, (batch, cfg.num_point)).astype(np.int64)
    return {"points": points, "labels": labels, "weights": weights}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--accum", type=int, default=1, help="accum_steps of the Trainer")
    ap.add_argument("--bq_window", type=int, default=None, help="calibrated ball-query window")
    ap.add_argument("--fp_window", type=int, default=None, help="calibrated 3-NN window")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"], help="Trainer train_dtype")
    ap.add_argument("--bf16_min_width", type=int, default=None, help="Trainer bf16_min_width")
    ap.add_argument("--arch", default="ssg", choices=sorted(ARCHES), help="the Trainer's arch (models.model_class)")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile: needs a CUDA device", file=sys.stderr)
        return 1

    cfg = Config.from_json(ROOT / "semantic.json")
    trainer = Trainer(cfg, accum_steps=args.accum, bq_window=args.bq_window, fp_window=args.fp_window,
                      train_dtype=args.dtype, bf16_min_width=args.bf16_min_width, arch=args.arch)
    trainer.init_state(seed=0, bn_stats="random")
    batches = [train_batch(cfg, BATCH, 1 + i) for i in range(WARMUP + STEPS)]
    for batch in batches[:WARMUP]:
        trainer.train_step(batch)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[WARMUP:]:
            metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    result = {
        "arch": args.arch,
        "steps": STEPS,
        "batch": BATCH,
        "accum_steps": args.accum,
        "bq_window": args.bq_window,
        "fp_window": args.fp_window,
        "dtype": args.dtype,
        "bf16_min_width": args.bf16_min_width,
        "wall_ms_per_step": wall_ms / STEPS,
        "last_loss": float(metrics["loss"]),
        "peak_memory_mb": torch.cuda.max_memory_allocated() / 2**20,
        **summarise(prof, wall_ms),
    }
    result["device_ms_per_step"] = result["device_ms"] / STEPS
    text = json.dumps(result, indent=1)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
