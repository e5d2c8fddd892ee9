#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: kernels, parity, the predict and the train path.

    python3 chip_smoke.py [--out FILE]

Phases, each of which raises on a failed check (the script then exits
non-zero and prints no result):

1. Device: the card's name and power limit (``nvidia-smi``), then the
   kernels are built from ``pointnet2_tpu_torch/csrc`` with ``nvcc`` for
   ``sm_90a``, one ``nvcc`` per source, all at once.
2. Kernels: at every shape the two driven paths give them at
   ``semantic.json`` width (B=8, one ``infer_chunk`` of the eval forward, and
   B=16, the train step's batch), each kernel runs beside its plain PyTorch
   version on the same seeded input. FPS, ball query and
   kNN must be equal; three_interpolate within rtol=1e-6, atol=1e-6. Both are
   timed with CUDA events (2 warm-ups, then the median of 10 runs of 5 calls
   in a row), with the bound of the work beside them: the larger of the
   bytes it must move over 3.35 TB/s and its operations over 67 TFLOP/s
   (float32 without tensor cores), the H100 SXM's published peaks at 700 W.
   ``library_ms`` is one PyTorch call computing the same function, where
   there is one (``embedding_bag`` for three_interpolate); the port never
   calls it. ``three_interpolate_grad``, the backward kernel of the train
   step, runs at the four shapes a batch of 16 gives it, on real 3-NN indices
   and weights and on seeded cotangents laid out as the train step hands them
   over: the first C channels of the skip concat's wider cotangent, read in
   place through its strides (``contiguous_g_ms`` is the same call on a
   contiguous copy). It sums with float atomics in an order
   that changes from run to run (and so does ``index_add_``, its plain
   version's sum on the card), so it is held to rtol=1e-5, atol=1e-5: a row
   sums 12 to 24 addends of magnitude below 1 on average, a few times that at
   most, and reordering those moves a float32 sum by a few 1e-7 a term.
   Its library call is the backward of ``embedding_bag`` with respect to the
   rows. The differentiable ``ops.three_interpolate`` as a whole (both
   kernels) is held against autograd through the plain forward.
3. Predict: a ``Predictor`` at full ``semantic.json`` width with seeded
   weights (``convert.init_variables``) answers 3 requests of 16 clouds of
   8192 points (after one warm-up request). The launch counts, reset just before,
   must show each kernel 4 times a chunk. The labels must match the same
   Predictor run with the plain versions (``impl="torch"``) on the card.
4. Train: a ``Trainer`` at full ``semantic.json`` width (Adam, seeded
   weights, dropout on) takes one warm-up step and then 5 steps on seeded
   batches of 16 clouds with labels in 0..8 and weights of which a fifth are
   zero. Every loss must be finite, the moving statistics must have moved,
   and the launch counts, reset after the warm-up, must show each of the five
   kernels exactly 4 times a step. From the same weights and the same batch,
   with dropout off, one step of the kernel path is held against one step of
   the plain path (``ops_impl="torch"``) on the card: the loss within 1e-5
   relative, every parameter gradient within 1e-3 of that gradient's max abs
   (the forward is the same bit for bit; the backward's scatter sums, in the
   kernel and in PyTorch's own ``index_put_``, take another order on every
   run). Then an ``accum_steps=4`` Trainer with hoisted geometry takes 2
   steps: FPS, ball query and 3-NN 4 times a step, the two interpolate
   kernels 16 times.

Output: one JSON line a kernel and shape, one for the predict run, one for
the train run, the ``nvidia-smi`` line, one ``{"kernels": [...]}`` line, and last
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
from pointnet2_tpu_torch.ops import core, cuda
from pointnet2_tpu_torch.ops.cuda import build
from pointnet2_tpu_torch.train import Trainer
from pointnet2_tpu_torch.train_profile import train_batch

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, published
CHUNK = 8  # Trainer.infer_chunk / Predictor default: the batch a kernel sees
REQUESTS = 3
BATCH = 16  # semantic.json's batch_size
SEED = 0
DEVICE = "cuda"  # every phase runs here; there is no other choice from the command line
FP_CHANNELS = (512, 256, 256, 128)  # features interpolated by FP1..FP4
FP_SKIP_CHANNELS = (256, 128, 64, 3)  # the skip features each is concatenated with (SA3, SA2, SA1, colour)
TRAIN_STEPS = 5
ACCUM = 4
ACCUM_STEPS = 2
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)  # three_interpolate_grad against its plain version
STEP_GRAD_TOL = 1e-3  # kernel-path against plain-path parameter gradients, of each one's max abs

KERNELS = {
    "fps_centroids": ("pointnet2_tpu_torch/csrc/fps.cu", "pointnet2_tpu/ops/pallas/fps.py:89"),
    "ball_query": ("pointnet2_tpu_torch/csrc/ballquery.cu", "pointnet2_tpu/ops/pallas/ballquery.py:42"),
    "knn": ("pointnet2_tpu_torch/csrc/knn.cu", "pointnet2_tpu/ops/pallas/knn.py:39"),
    "three_interpolate": (
        "pointnet2_tpu_torch/csrc/interpolate.cu", "pointnet2_tpu/ops/pallas/interpolate.py:48",
    ),
    "three_interpolate_grad": (
        "pointnet2_tpu_torch/csrc/interpolate.cu", "pointnet2_tpu/ops/pallas/interpolate.py:112",
    ),
}
GEOMETRY_KERNELS = ("fps_centroids", "ball_query", "knn")
INTERPOLATE_KERNELS = ("three_interpolate", "three_interpolate_grad")


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

    def add(self, kernel, batch, shape, run, plain, nbytes, nops, err, match, library=None, extra=None):
        """``extra``: further calls to time beside the kernel, by the key each gets in the row."""
        if not match:
            raise AssertionError(f"{kernel} at {shape} disagrees with its plain version (max abs err {err})")
        bound_ms, bound_by = bound(nbytes, nops)
        before = cuda.LAUNCHES[kernel]
        kernel_ms = cuda_ms(run)
        row = {
            "kernel": kernel,
            "batch": batch,
            "shape": f"B={batch} {shape}",
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
            **{key: cuda_ms(fn) for key, fn in (extra or {}).items()},
        }
        self.rows.append(row)
        emit(row)

    def kernels_line(self, predict: dict, train: dict) -> dict:
        """``launches`` is the sum over the two driven paths (the predict
        requests and the 5 full-batch train steps), each also given apart.
        The times are sums over every shape the kernel was held at, those of
        the B=8 chunk and those of the B=16 train batch; ``ms_by_batch`` and
        ``plain_ms_by_batch`` give the two apart."""
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
                "launches": predict.get(name, 0) + train.get(name, 0),
                "launches_predict": predict.get(name, 0),
                "launches_train": train.get(name, 0),
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": sum(r["kernel_ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": sum(r["bound_ms"] for r in rows),
                "bound_by": worst["bound_by"],
                "library_ms": None if None in libs else sum(libs),
                **{
                    f"{key}_by_batch": {
                        str(b): sum(r[column] for r in rows if r["batch"] == b)
                        for b in sorted({r["batch"] for r in rows})
                    }
                    for key, column in (("ms", "kernel_ms"), ("plain_ms", "plain_ms"), ("bound_ms", "bound_ms"))
                },
            })
        return {"kernels": out}


def kernel_phase(cfg: Config, seed: int, report: Report, b: int) -> list:
    """Every forward kernel at every shape a batch of ``b`` clouds gives it,
    against its plain version. Returns the five levels' coordinates."""
    dev = torch.device(DEVICE)
    x = torch.from_numpy(clouds(b, cfg, seed)).to(dev)
    levels = [x[..., :3].contiguous()]
    for spec in cfg.sa_layers:
        src = levels[-1]
        n = src.shape[1]
        idx, cent = ops.fps_centroids(src, spec.npoint, impl="cuda")
        p_idx, p_cent = ops.fps_centroids(src, spec.npoint, impl="torch")
        report.add(
            "fps_centroids", b, f"N={n} npoint={spec.npoint}",
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
            "ball_query", b, f"N={n} M={m} r={r} nsample={ns}",
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
            "knn", b, f"Nq={nq} M={m} k=3",
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
            "three_interpolate", b, f"M={m} C={c} N={nq}",
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
    return levels


def grad_kernel_phase(levels: list, seed: int, report: Report) -> None:
    """three_interpolate_grad at the four shapes of a batch-16 train step, on
    the levels ``kernel_phase`` made (whose 3-NN it held against the plain
    version), and the whole Function."""
    dev = torch.device(DEVICE)
    b = levels[0].shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed + 100)
    for i, (c, skip) in enumerate(zip(FP_CHANNELS, FP_SKIP_CHANNELS)):
        lvl = 3 - i
        dense, coarse = levels[lvl], levels[lvl + 1]
        n, m = dense.shape[1], coarse.shape[1]
        d2, idx = ops.three_nn(dense, coarse, impl="cuda")
        weight = ops.interpolation_weights(d2)
        # The cotangent as the train step's backward hands it over: the first c
        # channels of the cotangent of cat([interpolated, skip features]).
        g = torch.randn((b, n, c + skip), generator=gen, device=dev)[..., :c]
        if g.is_contiguous():
            raise AssertionError("the cotangent slice should not be contiguous")
        g_copy = g.contiguous()
        out = ops.three_interpolate_grad(g, idx, weight, m, impl="cuda")
        if not torch.allclose(out, ops.three_interpolate_grad(g_copy, idx, weight, m, impl="cuda"), **GRAD_TOL):
            raise AssertionError(f"three_interpolate_grad at N={n}: the strided and the contiguous cotangent disagree")
        ref = ops.three_interpolate_grad(g, idx, weight, m, impl="torch")
        torch.cuda.synchronize()
        if out.shape != (b, m, c) or not torch.isfinite(out).all():
            raise AssertionError(f"three_interpolate_grad: bad output {tuple(out.shape)}")

        # The library call: embedding_bag's own backward with respect to the rows.
        flat_idx = (idx.long() + torch.arange(b, device=dev)[:, None, None] * m).reshape(-1, 3)
        flat_points = torch.zeros((b * m, c), device=dev, requires_grad=True)
        bag = F.embedding_bag(flat_idx, flat_points, mode="sum", per_sample_weights=weight.reshape(-1, 3))
        flat_g = g.reshape(-1, c)
        lib = torch.autograd.grad(bag, flat_points, flat_g, retain_graph=True)[0].view(b, m, c)
        if not torch.allclose(lib, ref, **GRAD_TOL):
            raise AssertionError("embedding_bag's backward disagrees with the plain three_interpolate_grad")
        report.add(
            "three_interpolate_grad", b, f"N={n} C={c} M={m} g_row_stride={c + skip}",
            lambda: ops.three_interpolate_grad(g, idx, weight, m, impl="cuda"),
            lambda: ops.three_interpolate_grad(g, idx, weight, m, impl="torch"),
            # g and idx/weight read once; dpoints written twice (the zero fill, then the sums).
            nbytes=b * n * c * 4 + b * n * 3 * 8 + 2 * b * m * c * 4,
            nops=6 * b * n * c,
            err=max_abs(out, ref),
            match=torch.allclose(out, ref, **GRAD_TOL),
            library=lambda: torch.autograd.grad(bag, flat_points, flat_g, retain_graph=True),
            extra={"contiguous_g_ms": lambda: ops.three_interpolate_grad(g_copy, idx, weight, m, impl="cuda")},
        )

        # Both kernels behind autograd, on a cotangent that is a slice of a wider
        # tensor, against autograd through the plain forward.
        points = torch.randn((b, m, c), generator=gen, device=dev, requires_grad=True)
        w = weight.clone().requires_grad_()
        got = torch.autograd.grad(ops.three_interpolate(points, idx, w, impl="cuda"), (points, w), g)
        want = torch.autograd.grad(core.three_interpolate(points, idx, w), (points, w), g)
        if not torch.allclose(got[0], want[0], **GRAD_TOL) or not torch.allclose(got[1], want[1], rtol=1e-5, atol=1e-4):
            raise AssertionError(
                f"three_interpolate Function at N={n}: d points off by {max_abs(got[0], want[0])}, "
                f"d weight by {max_abs(got[1], want[1])}"
            )


def _expect_launches(launches: dict, want: dict, what: str) -> None:
    got = {name: launches.get(name, 0) for name in KERNELS}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")


def _one_step(cfg: Config, impl, batch: dict, seed: int):
    """Loss and parameter gradients of one dropout-free step from seeded weights."""
    trainer = Trainer(cfg, ops_impl=impl, dropout_rate=0.0, device=DEVICE)
    trainer.init_state(seed)
    loss = trainer.train_step(batch)["loss"]
    grads = {name: p.grad.clone() for name, p in trainer.model.named_parameters()}
    torch.cuda.synchronize()
    return float(loss), grads


def train_phase(cfg: Config, seed: int, card: str) -> dict:
    """The port's second main path: Trainer.train_step on full-width batches."""
    batches = [train_batch(cfg, BATCH, seed + 200 + i) for i in range(1 + TRAIN_STEPS)]
    trainer = Trainer(cfg, device=DEVICE)
    trainer.init_state(seed)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    stats_before = {k: v.clone() for k, v in trainer.model.named_buffers()}
    trainer.train_step(batches[0], generator=gen)  # warm-up: first launches, allocator, cuBLAS
    torch.cuda.synchronize()

    cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    launches = dict(cuda.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    _expect_launches(launches, {name: 4 * TRAIN_STEPS for name in KERNELS}, f"{TRAIN_STEPS} train steps")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train losses not finite: {losses}")
    if metrics["confusion"].shape != (9, 9) or int(metrics["confusion"].sum()) != BATCH * cfg.num_point:
        raise AssertionError("bad confusion matrix")
    unmoved = [k for k, v in trainer.model.named_buffers() if torch.equal(v, stats_before[k])]
    if unmoved or trainer.step != 1 + TRAIN_STEPS:
        raise AssertionError(f"moving statistics that did not move: {unmoved}; step {trainer.step}")
    del trainer

    loss, grads = _one_step(cfg, None, batches[0], seed)
    plain_loss, plain_grads = _one_step(cfg, "torch", batches[0], seed)
    worst = max(
        max_abs(grads[name], ref) / max(float(ref.abs().max()), 1e-30)
        for name, ref in plain_grads.items() if float(ref.abs().max()) > 1e-6
    )
    if abs(loss - plain_loss) > 1e-5 * abs(plain_loss) or worst > STEP_GRAD_TOL:
        raise AssertionError(
            f"kernel path vs plain path: loss {loss} vs {plain_loss}, worst gradient error {worst} of max abs"
        )
    del grads, plain_grads

    accum = Trainer(cfg, accum_steps=ACCUM, device=DEVICE)
    accum.init_state(seed)
    accum.train_step(batches[0], generator=gen)
    torch.cuda.synchronize()
    cuda.reset_launches()
    accum_losses, accum_times = [], []
    for batch in batches[1 : 1 + ACCUM_STEPS]:
        t0 = time.perf_counter()
        metrics = accum.train_step(batch, generator=gen)
        torch.cuda.synchronize()
        accum_times.append((time.perf_counter() - t0) * 1e3)
        accum_losses.append(float(metrics["loss"]))
    accum_launches = dict(cuda.LAUNCHES)
    _expect_launches(
        accum_launches,
        {**{name: 4 * ACCUM_STEPS for name in GEOMETRY_KERNELS},
         **{name: 4 * ACCUM * ACCUM_STEPS for name in INTERPOLATE_KERNELS}},
        f"{ACCUM_STEPS} accum-{ACCUM} steps",
    )
    if not all(np.isfinite(accum_losses)):
        raise AssertionError(f"accum losses not finite: {accum_losses}")

    median = statistics.median(times)
    emit({
        "phase": "train",
        "steps": TRAIN_STEPS,
        "batch": BATCH,
        "points": cfg.num_point,
        "optimizer": cfg.optimizer,
        "ms_per_step": times,
        "median_ms": median,
        "points_per_s": BATCH * cfg.num_point / (median / 1e3),
        "losses": losses,
        "launches": launches,
        "peak_memory_mb": peak_mb,
        "kernel_vs_plain": {"loss": loss, "plain_loss": plain_loss, "worst_grad_err_of_max_abs": worst},
        "accum": {"accum_steps": ACCUM, "steps": ACCUM_STEPS, "ms_per_step": accum_times,
                  "losses": accum_losses, "launches": accum_launches},
        "card": card,
    })
    return launches


def predict_phase(cfg: Config, requests: int, batch: int, seed: int, card: str) -> dict:
    """The port's main path: Predictor.predict_step on full-width requests."""
    sd = convert.from_flax_variables(convert.init_variables(cfg, num_classes=9, seed=seed))
    predictor = Predictor(cfg, sd, num_classes=9, infer_chunk=CHUNK, device=DEVICE)
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
    _expect_launches(
        launches,
        {name: 0 if name == "three_interpolate_grad" else 4 * chunks for name in KERNELS},
        f"{chunks} predict chunks",
    )

    plain = Predictor(cfg, sd, num_classes=9, infer_chunk=CHUNK, device=DEVICE, impl="torch")
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
    kernel_phase(cfg, SEED, report, CHUNK)
    train_levels = kernel_phase(cfg, SEED + 100, report, BATCH)
    grad_kernel_phase(train_levels, SEED, report)
    predict_launches = predict_phase(cfg, REQUESTS, BATCH, SEED, card)
    torch.cuda.empty_cache()
    train_launches = train_phase(cfg, SEED, card)
    kernels = report.kernels_line(predict_launches, train_launches)

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
