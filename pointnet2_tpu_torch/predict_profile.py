"""Where the predict path's time goes on the GPU: a torch.profiler breakdown.

    python -m pointnet2_tpu_torch.predict_profile [--arch ssg|msg] [--dtype bfloat16 [--bf16_min_width 128]]
        [--bq_window W] [--fp_window W] [--out FILE]

Builds the same ``Predictor`` as ``chip_smoke.py`` (full ``semantic.json``
width, weights from ``convert.init_variables(seed=0, bn_stats="random")``
of the ``--arch`` model, SSG or MSG, through ``models.model_class``; with the calibrated
windows given, through ``predict_step_checked``; with ``--dtype bfloat16``
in the bf16 inference mode), answers one warm-up
request, then profiles 3 requests of 16 clouds with CPU and CUDA
activities. Prints one JSON object: the wall time of the window, the device
time summed over kernels (busy share = device time / wall time), the device
time of each of the port's kernels, of matrix products, and of everything
else, the 20 largest device-time entries, the 15 host-side operators
with the most host time of their own, and the calls of the CUDA runtime that
make the host wait for the device (``host_waits``). Runs on CUDA only.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pointnet2_tpu_torch import convert
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.infer import Predictor
from pointnet2_tpu_torch.models.pointnet2_seg import ARCHES
from pointnet2_tpu_torch.utils.bench import KERNEL_SYMBOLS, event_device_us

ROOT = pathlib.Path(__file__).resolve().parents[1]
# CUDA runtime calls after which the host has waited for the device.
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
REQUESTS = 3
BATCH = 16


def _category(name: str) -> str:
    for kernel, symbol in KERNEL_SYMBOLS.items():
        if symbol in name:
            return kernel
    lowered = name.lower()
    if "multi_tensor" in lowered or "adam" in lowered:
        return "optimizer"
    # cuBLAS names its Hopper GEMMs sm90_xmma_gemm_*, cutlass* or nvjet_* (bfloat16 among them).
    if any(part in lowered for part in ("gemm", "cutlass", "matmul", "nvjet", "xmma")):
        return "matmul"
    if "index" in lowered or "gather" in lowered or "scatter" in lowered:
        return "gather_scatter"
    if "reduce" in lowered or "max" in lowered:
        return "reduce"
    if "cat" in lowered:
        return "concat"
    return "elementwise_and_other"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def summarise(prof, wall_ms: float) -> dict:
    """Device time of a profiled window by category, its busy share, and the 20 largest entries."""
    by_category: dict[str, float] = {}
    top = []
    host = []
    waits = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CPU and ev.key.startswith("aten::"):
            host.append((ev.self_cpu_time_total / 1e3, ev.count, ev.key))
        if ev.device_type == DeviceType.CPU and ev.key in HOST_WAITS:
            waits[ev.key] = ev.count
        us = event_device_us(ev)
        if us <= 0 or ev.device_type != DeviceType.CUDA or ev.key.startswith("Optimizer."):
            continue  # host-side ops and the optimizer's own span carry their kernels' time too: count kernels only
        cat = _category(ev.key)
        by_category[cat] = by_category.get(cat, 0.0) + us / 1e3
        top.append((us / 1e3, ev.count, ev.key[:120]))
    top.sort(reverse=True)
    host.sort(reverse=True)
    device_ms = sum(by_category.values())
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "device_ms_by_category": dict(sorted(by_category.items(), key=lambda kv: -kv[1])),
        "top": [{"ms": ms, "calls": n, "name": name} for ms, n, name in top[:20]],
        "top_host": [{"self_cpu_ms": ms, "calls": n, "name": name} for ms, n, name in host[:15]],
        "host_waits": waits,
        "card": card_line(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=None)
    ap.add_argument("--bq_window", type=int, default=None, help="calibrated ball-query window")
    ap.add_argument("--fp_window", type=int, default=None, help="calibrated 3-NN window")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"], help="Predictor dtype")
    ap.add_argument("--bf16_min_width", type=int, default=None, help="Predictor bf16_min_width")
    ap.add_argument("--arch", default="ssg", choices=sorted(ARCHES), help="the model (models.model_class)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("predict_profile: needs a CUDA device", file=sys.stderr)
        return 1

    cfg = Config.from_json(ROOT / "semantic.json")
    sd = convert.from_flax_variables(
        convert.init_variables(cfg, num_classes=9, seed=0, bn_stats="random", arch=args.arch)
    )
    predictor = Predictor(cfg, sd, infer_chunk=8, bq_window=args.bq_window, fp_window=args.fp_window,
                          dtype=args.dtype, bf16_min_width=args.bf16_min_width, arch=args.arch)
    step = predictor.predict_step_checked if args.bq_window or args.fp_window else predictor.predict_step
    rng = np.random.RandomState(1)
    inputs = []
    for _ in range(REQUESTS + 1):
        x = np.zeros((BATCH, cfg.num_point, cfg.point_dim), np.float32)
        x[..., :3] = rng.rand(BATCH, cfg.num_point, 3) * [8.0, 8.0, 4.9]
        x[..., 3:] = rng.rand(BATCH, cfg.num_point, cfg.point_dim - 3)
        inputs.append(x)
    step(inputs[0])
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x in inputs[1:]:
            step(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    result = {
        "arch": args.arch,
        "requests": REQUESTS,
        "batch": BATCH,
        "bq_window": args.bq_window,
        "fp_window": args.fp_window,
        "dtype": args.dtype,
        "bf16_min_width": args.bf16_min_width,
        "wall_ms_per_request": wall_ms / REQUESTS,
        **summarise(prof, wall_ms),
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
