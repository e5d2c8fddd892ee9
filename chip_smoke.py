#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: kernels, parity, and the predict path.

    python3 chip_smoke.py [--out FILE]

Phases, each of which raises on a failed check (the script then exits
non-zero and prints no result):

1. Device: the card's name and power limit (``nvidia-smi``), then the
   kernels are built from ``pointnet2_tpu_torch/csrc`` with ``nvcc`` for
   ``sm_90a``, one ``nvcc`` per source, all at once.
2. Kernels: at every shape the SSG eval forward gives them at
   ``semantic.json`` width (B=8, one ``infer_chunk``), each kernel runs beside
   its plain PyTorch version on the same seeded input. FPS, ball query and
   kNN must be equal; three_interpolate within rtol=1e-6, atol=1e-6. Both are
   timed with CUDA events (2 warm-ups, then the median of 10 runs of 5 calls
   in a row), with the bound of the work beside them: the larger of the
   bytes it must move over 3.35 TB/s and its operations over 67 TFLOP/s
   (float32 without tensor cores), the H100 SXM's published peaks at 700 W.
   ``library_ms`` is one PyTorch call computing the same function, where
   there is one (``embedding_bag`` for three_interpolate); the port never
   calls it.
3. Predict: a ``Predictor`` at full ``semantic.json`` width with seeded
   weights (``convert.init_variables``) answers 3 requests of 16 clouds of
   8192 points (after one warm-up request). The launch counts, reset just before,
   must show each kernel 4 times a chunk. The labels must match the same
   Predictor run with the plain versions (``impl="torch"``) on the card.

Output: one JSON line a kernel and shape, one for the predict run, the
``nvidia-smi`` line, one ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from pointnet2_tpu_torch import convert, ops
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.infer import Predictor, full_float32
from pointnet2_tpu_torch.ops import cuda
from pointnet2_tpu_torch.ops.cuda import build

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, published
CHUNK = 8  # Trainer.infer_chunk / Predictor default: the batch a kernel sees
REQUESTS = 3
BATCH = 16  # semantic.json's batch_size
SEED = 0
FP_CHANNELS = (512, 256, 256, 128)  # features interpolated by FP1..FP4

KERNELS = {
    "fps_centroids": ("pointnet2_tpu_torch/csrc/fps.cu", "pointnet2_tpu/ops/pallas/fps.py:89"),
    "ball_query": ("pointnet2_tpu_torch/csrc/ballquery.cu", "pointnet2_tpu/ops/pallas/ballquery.py:42"),
    "knn": ("pointnet2_tpu_torch/csrc/knn.cu", "pointnet2_tpu/ops/pallas/knn.py:39"),
    "three_interpolate": (
        "pointnet2_tpu_torch/csrc/interpolate.cu", "pointnet2_tpu/ops/pallas/interpolate.py:48",
    ),
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def clouds(batch: int, cfg: Config, seed: int) -> np.ndarray:
    """bench.py's clouds: xyz uniform in 8 x 8 x 4.9 m, colours in [0, 1)."""
    rng = np.random.RandomState(seed)
    x = np.zeros((batch, cfg.num_point, cfg.point_dim), np.float32)
    x[..., :3] = rng.rand(batch, cfg.num_point, 3) * [8.0, 8.0, 4.9]
    x[..., 3:] = rng.rand(batch, cfg.num_point, cfg.point_dim - 3)
    return x


def cuda_ms(fn, reps: int = 10, inner: int = 5, warmup: int = 2) -> float:
    """Time of one call: CUDA events around ``inner`` calls in a row, divided by
    ``inner``; the median of ``reps`` such runs. A call whose kernel is shorter
    than its host-side launch measures the launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


class Report:
    """Per (kernel, shape) records, and their sums over the four levels."""

    def __init__(self, card: str):
        self.card = card
        self.rows: list[dict] = []

    def add(self, kernel, shape, run, plain, nbytes, nops, err, match, library=None):
        if not match:
            raise AssertionError(f"{kernel} at {shape} disagrees with its plain version (max abs err {err})")
        bound_ms, bound_by = bound(nbytes, nops)
        before = cuda.LAUNCHES[kernel]
        kernel_ms = cuda_ms(run)
        row = {
            "kernel": kernel,
            "shape": shape,
            "kernel_ms": kernel_ms,
            "launches": cuda.LAUNCHES[kernel] - before,  # the timed calls really ran the kernel
            "plain_ms": cuda_ms(plain),
            "library_ms": None if library is None else cuda_ms(library),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bytes": nbytes,
            "ops": nops,
            "max_abs_err": err,
            "match": match,
            "card": self.card,
        }
        self.rows.append(row)
        emit(row)

    def kernels_line(self, launches: dict) -> dict:
        out = []
        for name, (source, replaces) in KERNELS.items():
            rows = [r for r in self.rows if r["kernel"] == name]
            libs = [r["library_ms"] for r in rows]
            worst = max(rows, key=lambda r: r["bound_ms"])
            out.append({
                "name": name,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": launches.get(name, 0),
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": sum(r["kernel_ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": sum(r["bound_ms"] for r in rows),
                "bound_by": worst["bound_by"],
                "library_ms": None if None in libs else sum(libs),
            })
        return {"kernels": out}


def kernel_phase(cfg: Config, seed: int, report: Report) -> None:
    """Every kernel at every shape of one B=8 chunk, against its plain version."""
    dev = torch.device("cuda")
    x = torch.from_numpy(clouds(CHUNK, cfg, seed)).to(dev)
    levels = [x[..., :3].contiguous()]
    b = CHUNK
    for spec in cfg.sa_layers:
        src = levels[-1]
        n = src.shape[1]
        idx, cent = ops.fps_centroids(src, spec.npoint, impl="cuda")
        p_idx, p_cent = ops.fps_centroids(src, spec.npoint, impl="torch")
        report.add(
            "fps_centroids", f"B={b} N={n} npoint={spec.npoint}",
            lambda: ops.fps_centroids(src, spec.npoint, impl="cuda"),
            lambda: ops.fps_centroids(src, spec.npoint, impl="torch"),
            nbytes=b * n * 12 + b * spec.npoint * 16,
            nops=10 * b * (spec.npoint - 1) * n,
            err=max_abs(cent, p_cent),
            match=torch.equal(idx, p_idx) and torch.equal(cent, p_cent),
        )
        m, ns, r = spec.npoint, spec.nsample, spec.radius
        bq, cnt = ops.ball_query(src, cent, r, ns, impl="cuda")
        p_bq, p_cnt = ops.ball_query(src, cent, r, ns, impl="torch")
        # Pairs this data needs: up to the nsample-th hit, or all N.
        scanned = torch.where(cnt == ns, bq[..., -1].long() + 1, n).sum().item()
        report.add(
            "ball_query", f"B={b} N={n} M={m} r={r} nsample={ns}",
            lambda: ops.ball_query(src, cent, r, ns, impl="cuda"),
            lambda: ops.ball_query(src, cent, r, ns, impl="torch"),
            nbytes=b * n * 12 + b * m * 12 + b * m * (ns + 1) * 4,
            nops=9 * scanned,
            err=0.0,
            match=torch.equal(bq, p_bq) and torch.equal(cnt, p_cnt),
        )
        levels.append(cent)

    gen = torch.Generator(device=dev).manual_seed(seed)
    for i, c in enumerate(FP_CHANNELS):
        lvl = 3 - i
        dense, coarse = levels[lvl], levels[lvl + 1]
        nq, m = dense.shape[1], coarse.shape[1]
        d2, nn_idx = ops.three_nn(dense, coarse, impl="cuda")
        p_d2, p_idx = ops.three_nn(dense, coarse, impl="torch")
        report.add(
            "knn", f"B={b} Nq={nq} M={m} k=3",
            lambda: ops.three_nn(dense, coarse, impl="cuda"),
            lambda: ops.three_nn(dense, coarse, impl="torch"),
            nbytes=b * m * 12 + b * nq * 12 + b * nq * 3 * 8,
            nops=9 * b * nq * m,
            err=max_abs(d2, p_d2),
            match=torch.equal(nn_idx, p_idx) and torch.equal(d2, p_d2),
        )
        weight = ops.interpolation_weights(d2)
        points = torch.randn((b, m, c), generator=gen, device=dev)
        out = ops.three_interpolate(points, nn_idx, weight, impl="cuda")
        ref = ops.three_interpolate(points, nn_idx, weight, impl="torch")
        flat_idx = (nn_idx.long() + torch.arange(b, device=dev)[:, None, None] * m).reshape(-1, 3)
        flat_points, flat_w = points.reshape(b * m, c), weight.reshape(-1, 3)
        report.add(
            "three_interpolate", f"B={b} M={m} C={c} N={nq}",
            lambda: ops.three_interpolate(points, nn_idx, weight, impl="cuda"),
            lambda: ops.three_interpolate(points, nn_idx, weight, impl="torch"),
            nbytes=b * m * c * 4 + b * nq * 3 * 8 + b * nq * c * 4,
            nops=5 * b * nq * c,
            err=max_abs(out, ref),
            match=torch.allclose(out, ref, rtol=1e-6, atol=1e-6),
            library=lambda: F.embedding_bag(
                flat_idx, flat_points, mode="sum", per_sample_weights=flat_w
            ),
        )


def predict_phase(cfg: Config, requests: int, batch: int, seed: int, card: str) -> dict:
    """The port's main path: Predictor.predict_step on full-width requests."""
    sd = convert.from_flax_variables(convert.init_variables(cfg, num_classes=9, seed=seed))
    predictor = Predictor(cfg, sd, num_classes=9, infer_chunk=CHUNK)
    inputs = [clouds(batch, cfg, seed + 1 + i) for i in range(requests)]
    predictor.predict_step(inputs[0])  # warm-up: first launches, allocator
    torch.cuda.synchronize()

    cuda.reset_launches()
    labels, times = [], []
    for x in inputs:
        t0 = time.perf_counter()
        labels.append(predictor.predict_step(x))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(cuda.LAUNCHES)

    chunks = requests * (batch // CHUNK)
    for name in KERNELS:
        if launches.get(name, 0) != 4 * chunks:
            raise AssertionError(f"{name} launched {launches.get(name, 0)} times in {chunks} chunks, want {4 * chunks}")

    plain = Predictor(cfg, sd, num_classes=9, infer_chunk=CHUNK, impl="torch")
    logits = predictor.infer_logits(inputs[0])
    ref_logits = plain.infer_logits(inputs[0])
    if logits.shape != (batch, cfg.num_point, 9) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits: shape {tuple(logits.shape)}, finite {bool(torch.isfinite(logits).all())}")
    logit_err = max_abs(logits, ref_logits)
    agree = []
    for x, got in zip(inputs, labels):
        want = plain.predict_step(x)
        agree.append(float((got == want).float().mean()))
    if min(agree) < 0.9999 or logit_err > 1e-3:
        raise AssertionError(f"kernel path vs plain path: label agreement {agree}, max abs logit diff {logit_err}")

    median = statistics.median(times)
    row = {
        "phase": "predict",
        "requests": requests,
        "batch": batch,
        "points": cfg.num_point,
        "infer_chunk": CHUNK,
        "ms_per_request": times,
        "median_ms": median,
        "points_per_s": batch * cfg.num_point / (median / 1e3),
        "launches": launches,
        "label_agreement": agree,
        "max_abs_logit_diff": logit_err,
        "card": card,
    }
    emit(row)
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=None, help="also write every record here as JSON")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    full_float32()
    card = card_line()
    cfg = Config.from_json(ROOT / "semantic.json")

    t0 = time.perf_counter()
    paths = build.build()
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines() if "Used" in ln or "spill" in ln]
        for name, path in paths.items()
    }
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas, "torch": torch.__version__, "cuda": torch.version.cuda})

    report = Report(card)
    kernel_phase(cfg, SEED, report)
    launches = predict_phase(cfg, REQUESTS, BATCH, SEED, card)
    kernels = report.kernels_line(launches)

    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "rows": report.rows, **kernels}, indent=1))
    print(card, flush=True)
    emit(kernels)
    emit({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
