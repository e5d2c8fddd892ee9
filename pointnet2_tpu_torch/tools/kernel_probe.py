"""Device time of three_interpolate's backward, the windowed kernels and the window gather, by kernel name.

    python /path/to/pointnet2_tpu_torch/tools/kernel_probe.py TAG   (from a tree's root, that tree on PYTHONPATH)

Reads rows 5 and 7-11 of PERF.md's kernel table at the model's shapes
(``tools.op_bench``'s levels: bench.py's clouds and their FPS centroids),
B=8 and B=16: three_interpolate's backward at the four FP levels on a
cotangent strided as the train step hands it over, the calibrated windowed
ball query with and without window columns at SA1 with the production
window (3072), the window gather of the fused grouping on those window
columns (a seeded source of SA1's first MLP width standing for the
projected sorted cloud; then again with 256 MB read before each call,
so that its source and picks come from memory, not from the L2), the
windowed 3-NN at FP4 with the production ``fp_window`` (512), and the
round-1 windowed ball query at SA1-SA3. Each line is one JSON object: the
profiler's device time of one call, summed over every kernel whose name
holds the row's name, median of 3 sessions of 20 calls,
and each kernel's own share (``kernels``). It calls only the op API, which
every tree of the port has, and matches kernels by a part of their name, so
one copy of this script reads an older tree too: run it from that tree's
root with that tree on ``PYTHONPATH``, in turns with the newer one on the
same card. Needs a card.
"""

from __future__ import annotations

import json
import re
import statistics
import sys
from collections import Counter

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.models.pointnet2_seg import SA_MLPS
from pointnet2_tpu_torch.ops import core, cuda
from pointnet2_tpu_torch.tools.op_bench import FP, SA, levels
from pointnet2_tpu_torch.utils.bench import card_line

BQ_WINDOW = 3072
FP_WINDOW = 512


def kernel_name(key: str) -> str:
    """A kernel's bare name from the profiler's key:
    ``void (anonymous namespace)::name<true>(float const*, ...)`` -> ``name``."""
    key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", key)[0].split("::")[-1]


def device_us(fn, part: str, calls: int = 20, sessions: int = 3) -> tuple[float, dict]:
    """Device µs of one call of ``fn`` in the kernels whose name holds
    ``part``: the median of ``sessions`` profiles of ``calls`` calls, and the
    last session's µs a call by kernel name."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    totals = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        per = Counter()
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and part in ev.key:
                per[kernel_name(ev.key)] += ev.self_device_time_total / calls
        totals.append(sum(per.values()))
    return statistics.median(totals), dict(per)


def run(tag: str) -> None:
    card = card_line()
    flush = torch.zeros(64 << 20, device="cuda")  # 256 MB read before a cold call: five L2s of clean lines

    def emit(row, b, shape, measured):
        us, kernels = measured
        print(json.dumps({"tree": tag, "row": row, "b": b, "shape": shape, "device_us": us,
                          "kernels": kernels, "card": card}), flush=True)

    for b in (8, 16):
        lv = levels(b, 8192, SA, torch.device("cuda"))
        gen = torch.Generator(device="cuda").manual_seed(2)
        for lvl, (c, c1) in zip(range(len(SA) - 1, -1, -1), FP):
            dense, coarse = lv[lvl], lv[lvl + 1]
            n, m = dense.shape[1], coarse.shape[1]
            d2, idx = ops.three_nn(dense, coarse)
            w = ops.interpolation_weights(d2)
            g = torch.randn((b, n, c + c1), generator=gen, device="cuda")[..., :c]
            emit(5, b, f"N={n} M={m} C={c}", device_us(
                lambda: ops.three_interpolate_grad(g, idx, w, m), "three_interpolate_grad"))
        npoint, radius, nsample = SA[0]
        perm, xs, _, qs, lo, _ = core.ball_query_window_plan(lv[0], lv[1], radius, BQ_WINDOW)
        emit(7, b, f"SA1 w={BQ_WINDOW}", device_us(
            lambda: cuda.ball_query_tiles(xs, perm, qs, lo, radius, nsample, BQ_WINDOW), "ball_query_tiles_kernel"))
        emit(8, b, f"SA1 w={BQ_WINDOW}", device_us(
            lambda: cuda.ball_query_tiles_pos(xs, perm, qs, lo, radius, nsample, BQ_WINDOW),
            "ball_query_tiles_kernel"))
        pos = cuda.ball_query_tiles_pos(xs, perm, qs, lo, radius, nsample, BQ_WINDOW)[1]
        c = SA_MLPS[0][0]
        zp_s = torch.randn((b, lv[0].shape[1], c), generator=gen, device="cuda")
        emit(9, b, f"SA1 w={BQ_WINDOW} K={nsample} C={c}", device_us(
            lambda: cuda.window_gather(zp_s, lo, pos), "window_gather_kernel"))
        emit(9, b, f"SA1 w={BQ_WINDOW} K={nsample} C={c} cold L2", device_us(
            lambda: (flush.sum(), cuda.window_gather(zp_s, lo, pos)), "window_gather_kernel"))
        emit(10, b, f"FP4 w={FP_WINDOW}", device_us(
            lambda: ops.three_nn_calibrated(lv[0], lv[1], FP_WINDOW), "knn_tiles_kernel"))
        for i, (npoint, radius, nsample) in enumerate(SA[:3]):
            src, cent = lv[i], lv[i + 1]
            emit(11, b, f"SA{i + 1}", device_us(
                lambda: ops.ball_query(src, cent, radius, nsample, impl="windowed"), "ball_query_windowed_kernel"))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_probe reads device times on a card, and there is none")
    run(argv[0] if argv else "tree")
    return 0


if __name__ == "__main__":
    sys.exit(main())
