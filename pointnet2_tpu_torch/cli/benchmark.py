"""Inference benchmark and profiler harness of the port.

    python -m pointnet2_tpu_torch.cli.benchmark [--ckpt model.pt] [--config_file semantic.json]
        [--trace_dir result/torch-trace] [--bq_window 3072 --fp_window 512] [--device cuda]

Counterpart of the root ``benchmark.py``, step for step:

1. a ``Predictor`` of the ``--config_file`` model, on random weights
   (``convert.init_variables`` of seed 0, the Predictor tests' draw) or on
   the port's checkpoint ``--ckpt``, with the calibrated windows if given;
2. clouds drawn from ``np.random.RandomState(0)`` in the JAX script's order
   (``data_stream``): first B = 64, then B = 1, 2, 4, ..., 128; standard
   normal values, or with a window box-regime clouds (8 x 8 x 4.9 m, colours
   in [0, 1)), whose geometry the windows' certificates need. With a window
   the certificates of ``Predictor.predict_step_checked`` must hold on the
   B = 64 batch, else the script raises before it profiles;
3. one warm predict of that batch, then one under ``torch.profiler`` (CPU
   and, on the card, CUDA activity), written as a Chrome trace
   (``predict_trace.json``) under ``--trace_dir``, with the per-op table
   ``gpu-profile.txt`` beside it (``utils.op_report``) and its top 15 rows
   printed;
4. the time of ``Predictor.infer_logits`` at B = 64 by ``utils.bench.
   slope_time`` (chains of 2 and 8 calls), then the same at each batch of
   the sweep, printed in the JAX script's lines.

The Predictor runs a batch in chunks of ``infer_chunk`` = 8 clouds, so the
sweep's B = 1, 2 and 4 run whole. ``--device`` is CUDA by default, which
must be present; ``--device cpu`` runs the plain versions on the host's
clock (for tests).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from pointnet2_tpu_torch import convert
from pointnet2_tpu_torch.cli import add_device_flag, cli_device
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.infer import Predictor
from pointnet2_tpu_torch.train import load_model_state
from pointnet2_tpu_torch.utils import op_report
from pointnet2_tpu_torch.utils.bench import slope_time

PROFILE_BATCH = 64
SWEEP = tuple(2**n for n in range(8))  # 1 .. 128
PROFILE_TRIES = 3  # the card's tracer now and then records no kernel in a session


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ckpt", default="", help="optional checkpoint (the port's .pt)")
    parser.add_argument("--config_file", default="semantic.json")
    parser.add_argument("--trace_dir", default="result/torch-trace")
    parser.add_argument("--repeats", type=int, default=10, help="accepted as the root script accepts it; unused")
    parser.add_argument(
        "--bq_window", type=int, default=None,
        help="profile the production config: the calibrated ball-query window (the fused SA1 grouping "
        "on the eval path). Ints only: the data here is synthetic box-regime, certified before profiling",
    )
    parser.add_argument("--fp_window", type=int, default=None,
                        help="calibrated 3-NN window for the FP decoder (see --bq_window)")
    add_device_flag(parser)
    return parser


def data_stream(cfg: Config, windowed: bool, seed: int = 0) -> Callable[[int], np.ndarray]:
    """The JAX script's ``data``: each call draws the next batch of
    ``(batch, num_point, point_dim)`` float32 clouds from one
    ``RandomState(seed)``, box-regime with a window, standard normal without."""
    rng = np.random.RandomState(seed)

    def data(batch: int) -> np.ndarray:
        if windowed:
            x = np.zeros((batch, cfg.num_point, cfg.point_dim), np.float32)
            x[..., :3] = rng.rand(batch, cfg.num_point, 3) * [8.0, 8.0, 4.9]
            x[..., 3:] = rng.rand(batch, cfg.num_point, cfg.point_dim - 3)
            return x
        return rng.randn(batch, cfg.num_point, cfg.point_dim).astype(np.float32)

    return data


def _profile_predict(predictor: Predictor, x: torch.Tensor, device: torch.device):
    """One predict of ``x`` under the profiler; on the card, again (up to
    ``PROFILE_TRIES`` sessions) while a session records no kernel."""
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    for attempt in range(PROFILE_TRIES):
        with profile(activities=activities) as prof:
            labels = predictor.predict_step(x).cpu().numpy()
        if device.type != "cuda" or any(r.line == "device" for r in op_report.aggregate_ops(prof.key_averages())):
            return prof, labels
        print(f"the profiler recorded no kernel in session {attempt + 1}; profiling again", flush=True)
    return prof, labels


def main(argv: Optional[Sequence[str]] = None, sweep: Sequence[int] = SWEEP) -> dict:
    """Run the benchmark; returns the profiled batch's labels, the trace and
    report paths, the report's rows, and each timed batch's seconds (the
    sweep's records also hold one predict's labels of their batch)."""
    flags = build_parser().parse_args(argv)
    device = cli_device(flags.device)
    cfg = Config.from_json(flags.config_file)
    if flags.ckpt:
        state_dict = load_model_state(os.path.abspath(flags.ckpt))
    else:
        state_dict = convert.from_flax_variables(convert.init_variables(cfg, 9, seed=0))
    predictor = Predictor(cfg, state_dict, device=device, bq_window=flags.bq_window, fp_window=flags.fp_window)

    windowed = flags.bq_window is not None or flags.fp_window is not None
    data = data_stream(cfg, windowed)

    def timed_forward(x: torch.Tensor, K0: int = 2, K1: int = 8) -> float:
        """K-slope seconds of the production (chunked) inference forward."""
        return slope_time(predictor.infer_logits, x, K0=K0, K1=K1)

    def synchronize() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    batch_size = PROFILE_BATCH
    x = torch.from_numpy(data(batch_size)).to(device)
    summary: dict = {"device": str(device), "windowed": windowed, "bq_window": flags.bq_window,
                     "fp_window": flags.fp_window, "certified": None}
    if windowed:
        _, ok = predictor.predict_step_checked(x)
        if not ok:
            raise RuntimeError(
                "window certificate failed on the benchmark data — refusing to profile an unverified fast path"
            )
        summary["certified"] = True
        print(f"window certificate OK (bq={flags.bq_window}, fp={flags.fp_window})")
    predictor.predict_step(x)  # warm
    synchronize()
    os.makedirs(flags.trace_dir, exist_ok=True)
    prof, labels = _profile_predict(predictor, x, device)
    trace_path = os.path.join(flags.trace_dir, "predict_trace.json")
    prof.export_chrome_trace(trace_path)
    print(f"Profiler trace written to {flags.trace_dir}")

    # Per-op report, the tf-profile.txt equivalent.
    report_path = os.path.join(flags.trace_dir, "gpu-profile.txt")
    rows = op_report.write_op_report(prof, report_path)
    print(f"Per-op profile ({len(rows)} ops) written to {report_path}")
    sys.stdout.write(op_report.format_report(rows, top=15, title="top ops"))
    summary.update(labels=labels, trace=trace_path, report=report_path, rows=rows)

    batch_time = timed_forward(x)
    print(f"Batch size: {batch_size}, batch_time: {batch_time}, sample_time: {batch_time / batch_size}")
    summary["profiled"] = {"batch": batch_size, "batch_time": batch_time}

    # Batch sweep.
    summary["sweep"] = []
    for batch_size in sweep:
        x = torch.from_numpy(data(batch_size)).to(device)
        batch_time = timed_forward(x)
        points_per_sec = batch_size * cfg.num_point / batch_time
        print(
            f"Batch size: {batch_size}, batch_time: {batch_time}, "
            f"sample_time: {batch_time / batch_size}, "
            f"points_per_sec: {points_per_sec:.0f}"
        )
        summary["sweep"].append({
            "batch": batch_size, "batch_time": batch_time, "sample_time": batch_time / batch_size,
            "points_per_sec": points_per_sec, "labels": predictor.predict_step(x).cpu().numpy(),
        })
    return summary


if __name__ == "__main__":
    main()
