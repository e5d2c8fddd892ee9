#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: kernels, parity, the predict, train and op paths.

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
   step, runs at the four shapes a batch gives it (B=16, the train step's,
   and B=8), on real 3-NN indices and weights and on seeded cotangents laid
   out as the train step hands them over: the first C channels of the skip
   concat's wider cotangent, read in place through its strides
   (``contiguous_g_ms`` is the same call on a contiguous copy). It sums each
   element in its plain version's order (slot j, then the queries
   ascending), so it must equal the plain version bit for bit: run on the
   CPU, where ``index_add_`` sums serially, and on the card under PyTorch's
   deterministic algorithms, which keep that order for rows of more than 32
   floats (all four shapes); and it must give the same bits on a second run
   and on the contiguous copy. Its library call is the
   backward of ``embedding_bag`` with respect to the rows, which sums in its
   own order: held to the plain version within rtol=1e-5, atol=1e-5 (a row
   sums 12 to 24 addends of magnitude below 1 on average). The
   differentiable ``ops.three_interpolate`` as a whole (both kernels) equals
   the plain Function bit for bit, and autograd through the plain forward
   (which sums query by query) within the same tolerance.
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
   the plain path (``ops_impl="torch"``) on the card, both under PyTorch's
   deterministic algorithms: a second kernel-path step must give the same
   gradients bit for bit, and against the plain path the loss within 1e-5
   relative, every parameter gradient within 1e-3 of that gradient's max abs
   (the forward and the backward's scatters sum in the same order on both
   paths; cuBLAS's products need not, at the paths' own shapes; the worst
   error is recorded, and whether the paths were equal bit for bit in this
   run). Then an ``accum_steps=4`` Trainer with hoisted geometry takes 2
   steps: FPS, ball query and 3-NN 4 times a step, the two interpolate
   kernels 16 times.
5. Calibrated windows (``bq_window=3072``, ``fp_window=512``, the production
   widths; they engage at SA1 and FP4): the four windowed kernels (the
   windowed ball query, the same with window columns, the window gather, the
   windowed kNN) equal their plain versions on the sorted inputs the
   calibrated ops make, at the B=8 chunk and the B=16 batch, on the route
   their plan picks (the windowed ball query's ``(split, warps)`` is in its
   record), timed beside their bounds (9 operations a pair the data needs:
   for the ball query the columns of each query's x-span,
   ``ops.core.ball_query_tile_spans``; the gather's bytes, with
   ``index_select`` of the same rows as its library call) and beside the whole
   calibrated op and the exact op it stands in for (``op_ms``,
   ``exact_op_ms``). The whole ops equal on the kernel and the plain path,
   ``ok`` included, with a window that fits and one too small (256 at SA1
   must give ``ok`` False). Then a windowed ``Predictor`` answers the 3
   requests through ``predict_step_checked`` (every ``ok`` True; per chunk
   the fused grouping's two kernels and the windowed kNN once, ball query and
   3-NN 3 times, FPS and three_interpolate 4 times; labels equal to the
   no-window path's on >= 99.99 % of points, logits within 1e-4; a
   ``bq_window=256`` request gives ``ok`` False), and a windowed ``Trainer``
   takes 1 + 3 Adam steps (``window_ok`` every step; per step the windowed
   ball query and kNN once, the exact ones 3 times), with the no-window
   Trainer timed in turns on the same batches; one dropout-free windowed step
   against the no-window step under deterministic algorithms (loss within
   1e-5 relative, gradients within 1e-3 of their max abs; the worst error and
   bit equality recorded); and the windows ``auto`` would pick
   (``calibrate_model_windows``) on the smoke clouds.
6. Op surface: the index-only FPS (``farthest_point_sample``) at the four SA
   shapes of both batches, equal to its plain version and to the fused
   kernel's indices; the round-1 windowed ball query (``ops.ball_query(
   impl="windowed")``, default window ``max(2 * nsample, N // 4)``) at
   SA1-SA3 of both batches, on a clustered cloud whose band's tiles fall back,
   on 2 clouds of 65536 points (a 16384-column window, past shared memory)
   and with nsample = 64: the kernel equal to its plain version on the op's
   sorted inputs, the whole op equal to the plain windowed op and to the
   exact kernel, run under ``torch.cuda.set_sync_debug_mode("error")`` (no
   host read decides the fallback), the tiles that fit counted on the host
   from the plan; both kernels timed beside their bounds, their plain
   versions timed with 3 single calls (the plain FPS takes some 200 ms a
   call). Then ``tools.parity`` on the card (48 checks of every kernel
   against the NumPy oracles; zero failures), and the op-level path: one run
   of ``tools.stage_bench``'s composites (the SA sample-and-group through
   ``ops.farthest_point_sample`` with either ball query, the gather, the FP
   interpolation), which must launch its five kernels.

Output: one JSON line a kernel and shape, one for each driven path (predict,
train, predict_windows, train_windows, op_surface; the parity sweep's lines
and the stage bench's lines inside the last), the ``nvidia-smi`` line, one
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``.
Each path's launch counts are reset just before it and read just after;
the ``kernels`` line sums them.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import statistics
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from pointnet2_tpu_torch import convert, ops
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.infer import Predictor, full_float32
from pointnet2_tpu_torch.models.pointnet2_seg import SA_MLPS
from pointnet2_tpu_torch.ops.calibrate import calibrate_model_windows
from pointnet2_tpu_torch.ops import core, cuda
from pointnet2_tpu_torch.ops.cuda import ballquery as cuda_ballquery
from pointnet2_tpu_torch.ops.cuda import build
from pointnet2_tpu_torch.ops.cuda import fps as cuda_fps
from pointnet2_tpu_torch.ops.cuda import interpolate as cuda_interp
from pointnet2_tpu_torch.tools import op_bench, parity, stage_bench
from pointnet2_tpu_torch.train import Trainer
from pointnet2_tpu_torch.train_profile import train_batch
from pointnet2_tpu_torch.utils.bench import bound, card_line, cuda_ms, deterministic_algorithms, device_ms

# The package's ``knn`` is the wrapper function; the module is reached by name.
cuda_knn = importlib.import_module("pointnet2_tpu_torch.ops.cuda.knn")

ROOT = pathlib.Path(__file__).resolve().parent
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
# three_interpolate_grad's plain version against sums in another order: the
# library call's, and autograd's through the plain forward (query by query).
ORDER_TOL = dict(rtol=1e-5, atol=1e-5)
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
    "ball_query_sliced": ("pointnet2_tpu_torch/csrc/ballquery.cu", "pointnet2_tpu/ops/pallas/ballquery.py:247"),
    "ball_query_sliced_pos": ("pointnet2_tpu_torch/csrc/wingather.cu", "pointnet2_tpu/ops/pallas/wingather.py:54"),
    "window_gather": ("pointnet2_tpu_torch/csrc/wingather.cu", "pointnet2_tpu/ops/pallas/wingather.py:98"),
    "knn_sliced": ("pointnet2_tpu_torch/csrc/knn.cu", "pointnet2_tpu/ops/pallas/knn.py:133"),
    "farthest_point_sample": ("pointnet2_tpu_torch/csrc/fps.cu", "pointnet2_tpu/ops/pallas/fps.py:40"),
    "ball_query_windowed": (
        "pointnet2_tpu_torch/csrc/window_bq.cuh", "pointnet2_tpu/ops/pallas/ballquery.py:80",
    ),
}
GEOMETRY_KERNELS = ("fps_centroids", "ball_query", "knn")
INTERPOLATE_KERNELS = ("three_interpolate", "three_interpolate_grad")
# The production windows (bench.py's Trainer(bq_window=3072) and its fp_window=512
# opt-in): at semantic.json's widths they engage at SA1 (8192 points) and FP4
# (1024 coarse points) and fall back to the exact kernels at the other levels.
BQ_WINDOW = 3072
FP_WINDOW = 512
SMALL_BQ_WINDOW = 256  # too small for SA1: ok must be False
SMALL_FP_WINDOW = 128
WINDOW_TRAIN_STEPS = 3
WINDOW_LOGIT_TOL = 1e-4
# The plain versions of the op-surface rows run a few times only: the plain FPS
# takes some 200 ms a call at SA1.
FEW = dict(reps=3, inner=1, warmup=1)
# Past a block's shared memory: N // 4 = 16384 columns > the 14528 that fit.
WIDE_N, WIDE_M, WIDE_B = 65536, 1024, 2


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def clouds(batch: int, cfg: Config, seed: int) -> np.ndarray:
    """bench.py's clouds: xyz uniform in 8 x 8 x 4.9 m, colours in [0, 1)."""
    rng = np.random.RandomState(seed)
    x = np.zeros((batch, cfg.num_point, cfg.point_dim), np.float32)
    x[..., :3] = rng.rand(batch, cfg.num_point, 3) * [8.0, 8.0, 4.9]
    x[..., 3:] = rng.rand(batch, cfg.num_point, cfg.point_dim - 3)
    return x


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


class Report:
    """Per (kernel, shape) records, and their sums over the four levels."""

    def __init__(self, card: str):
        self.card = card
        self.rows: list[dict] = []

    def add(self, kernel, batch, shape, run, plain, nbytes, nops, err, match, library=None, extra=None,
            info=None, plain_timing=None):
        """``extra``: further calls to time beside the kernel, by the key each gets in the row;
        ``info``: further fields of the row; ``plain_timing``: ``cuda_ms`` arguments for the plain version."""
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
            "plain_ms": cuda_ms(plain, **(plain_timing or {})),
            "library_ms": None if library is None else cuda_ms(library),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bytes": nbytes,
            "ops": nops,
            "max_abs_err": err,
            "match": match,
            "card": self.card,
            **{key: cuda_ms(fn) for key, fn in (extra or {}).items()},
            **(info or {}),
        }
        self.rows.append(row)
        emit(row)

    def kernels_line(self, paths: dict) -> dict:
        """``launches`` is the sum over the driven paths (``paths``: path name ->
        launch counts, each path's counts reset just before it and read just
        after), each also given apart. The times are sums over every shape the
        kernel was held at; ``ms_by_batch`` and the others give the batches apart."""
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
                "launches": sum(launches.get(name, 0) for launches in paths.values()),
                "launches_by_path": {path: launches.get(name, 0) for path, launches in paths.items()},
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
            info={"plan": cuda_fps.planned_route(src, spec.npoint)},
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
            info={"plan": cuda_ballquery.plan(b, n, m, cuda_ballquery.num_sms(src.device.index))},
        )
        levels.append(cent)

    gen = torch.Generator(device=dev).manual_seed(seed)
    for i, (c, c1) in enumerate(zip(FP_CHANNELS, FP_SKIP_CHANNELS)):
        lvl = 3 - i
        dense, coarse = levels[lvl], levels[lvl + 1]
        nq, m = dense.shape[1], coarse.shape[1]
        d2, nn_idx = ops.three_nn(dense, coarse, impl="cuda")
        p_d2, p_idx = ops.three_nn(dense, coarse, impl="torch")
        route = cuda_knn.plan(b, nq, m, 3, cuda_ballquery.num_sms(dense.device.index))
        report.add(
            "knn", b, f"Nq={nq} M={m} k=3",
            lambda: ops.three_nn(dense, coarse, impl="cuda"),
            lambda: ops.three_nn(dense, coarse, impl="torch"),
            *op_bench.work_knn(b, nq, m, 3),
            err=max_abs(d2, p_d2),
            match=torch.equal(nn_idx, p_idx) and torch.equal(d2, p_d2),
            info={"plan": route, "device_ms": device_ms(lambda: ops.three_nn(dense, coarse, impl="cuda"), "knn")},
        )
        # The FP concat as the model writes it: FP4's skip is the input cloud's
        # colours (a view of row stride 6), the others the SA level's features.
        skip = x[..., 3:6] if c1 == 3 else torch.randn((b, nq, c1), generator=gen, device=dev)
        weight = ops.interpolation_weights(d2)
        points = torch.randn((b, m, c), generator=gen, device=dev)
        out = ops.three_interpolate(points, nn_idx, weight, impl="cuda", skip=skip)
        ref = ops.three_interpolate(points, nn_idx, weight, impl="torch", skip=skip)
        bare = ops.three_interpolate(points, nn_idx, weight, impl="cuda")
        flat_idx = (nn_idx.long() + torch.arange(b, device=dev)[:, None, None] * m).reshape(-1, 3)
        flat_points, flat_w = points.reshape(b * m, c), weight.reshape(-1, 3)
        vec, skip_vec = cuda_interp.planned_route(points, skip)
        report.add(
            "three_interpolate", b, f"M={m} C={c} N={nq} skip={c1}",
            lambda: ops.three_interpolate(points, nn_idx, weight, impl="cuda", skip=skip),
            lambda: ops.three_interpolate(points, nn_idx, weight, impl="torch", skip=skip),
            # points, idx/weight and the skip read once, the concatenated rows written once
            nbytes=b * m * c * 4 + b * nq * 3 * 8 + b * nq * c1 * 4 + b * nq * (c + c1) * 4,
            nops=5 * b * nq * c,
            err=max(max_abs(out, ref), max_abs(bare, ref[..., :c])),
            match=torch.allclose(out, ref, rtol=1e-6, atol=1e-6) and torch.equal(out[..., c:], ref[..., c:])
            and torch.allclose(bare, ref[..., :c], rtol=1e-6, atol=1e-6),
            library=lambda: torch.cat([F.embedding_bag(
                flat_idx, flat_points, mode="sum", per_sample_weights=flat_w
            ).view(b, nq, c), skip], -1),
            extra={
                # The path before the fused kernel: the kernel without the skip, then torch.cat.
                "no_skip_ms": lambda: ops.three_interpolate(points, nn_idx, weight, impl="cuda"),
                "concat_ms": lambda: torch.cat([bare, skip], -1),
            },
            info={"plan": {"vec": vec, "skip_vec": skip_vec},
                  "device_ms": device_ms(
                      lambda: ops.three_interpolate(points, nn_idx, weight, impl="cuda", skip=skip), "three_interpolate")},
        )
    return levels


def grad_kernel_phase(levels: list, seed: int, report: Report) -> None:
    """three_interpolate_grad at the four shapes a train step of the levels'
    batch gives it, on the levels ``kernel_phase`` made (whose 3-NN it held
    against the plain version), and the whole Function."""
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
        for again in (ops.three_interpolate_grad(g, idx, weight, m, impl="cuda"),
                      ops.three_interpolate_grad(g_copy, idx, weight, m, impl="cuda")):
            if not torch.equal(out, again):
                raise AssertionError(f"three_interpolate_grad at N={n}: a second run or the contiguous cotangent "
                                     f"gave other bits (max abs {max_abs(out, again)})")
        # The plain version in its fixed order: on the CPU (serial sums), and on
        # the card under deterministic algorithms (the same order for these
        # rows of more than 32 floats), which the train-step comparison uses.
        ref = ops.three_interpolate_grad(g.cpu(), idx.cpu(), weight.cpu(), m, impl="torch").to(dev)
        with deterministic_algorithms():
            if not torch.equal(ops.three_interpolate_grad(g, idx, weight, m, impl="torch"), ref):
                raise AssertionError(f"three_interpolate_grad's plain version at N={n}: the card's "
                                     "deterministic sums and the CPU's differ")
        torch.cuda.synchronize()
        if out.shape != (b, m, c) or not torch.isfinite(out).all():
            raise AssertionError(f"three_interpolate_grad: bad output {tuple(out.shape)}")

        # The library call: embedding_bag's own backward with respect to the rows.
        flat_idx = (idx.long() + torch.arange(b, device=dev)[:, None, None] * m).reshape(-1, 3)
        flat_points = torch.zeros((b * m, c), device=dev, requires_grad=True)
        bag = F.embedding_bag(flat_idx, flat_points, mode="sum", per_sample_weights=weight.reshape(-1, 3))
        flat_g = g.reshape(-1, c)
        lib = torch.autograd.grad(bag, flat_points, flat_g, retain_graph=True)[0].view(b, m, c)
        if not torch.allclose(lib, ref, **ORDER_TOL):
            raise AssertionError("embedding_bag's backward disagrees with the plain three_interpolate_grad")
        report.add(
            "three_interpolate_grad", b, f"N={n} C={c} M={m} g_row_stride={c + skip}",
            lambda: ops.three_interpolate_grad(g, idx, weight, m, impl="cuda"),
            lambda: ops.three_interpolate_grad(g, idx, weight, m, impl="torch"),
            # g and idx/weight read once, dpoints written once: the op's least traffic.
            nbytes=b * n * c * 4 + b * n * 3 * 8 + b * m * c * 4,
            nops=6 * b * n * c,
            err=max_abs(out, ref),
            match=torch.equal(out, ref),
            library=lambda: torch.autograd.grad(bag, flat_points, flat_g, retain_graph=True),
            extra={"contiguous_g_ms": lambda: ops.three_interpolate_grad(g_copy, idx, weight, m, impl="cuda")},
        )

        # Both kernels behind autograd, on a cotangent that is a slice of a wider
        # tensor, against the plain Function and autograd through the plain forward.
        points = torch.randn((b, m, c), generator=gen, device=dev, requires_grad=True)
        w = weight.clone().requires_grad_()
        got = torch.autograd.grad(ops.three_interpolate(points, idx, w, impl="cuda"), (points, w), g)
        with deterministic_algorithms():
            plain = torch.autograd.grad(ops.three_interpolate(points, idx, w, impl="torch"), (points, w), g)
        want = torch.autograd.grad(core.three_interpolate(points, idx, w), (points, w), g)
        if not (torch.equal(got[0], plain[0]) and torch.allclose(got[0], want[0], **ORDER_TOL)
                and torch.allclose(got[1], want[1], rtol=1e-5, atol=1e-4)):
            raise AssertionError(
                f"three_interpolate Function at N={n}: d points off the plain Function by "
                f"{max_abs(got[0], plain[0])}, off autograd by {max_abs(got[0], want[0])}, "
                f"d weight by {max_abs(got[1], want[1])}"
            )


def window_kernel_phase(cfg: Config, seed: int, report: Report, b: int) -> None:
    """The four calibrated-window kernels at the shapes a batch of ``b`` gives
    them, each against its plain version on the same sorted inputs, and the
    whole calibrated ops (sorts, window starts, certificate) on the kernel
    path against the plain path, with a window that fits and one too small.

    Every row runs at both batches: row 7 (the windowed ball query of the
    train forward), rows 8 and 9 (the fused eval grouping), row 10 (FP4's
    windowed 3-NN).
    """
    dev = torch.device(DEVICE)
    x = torch.from_numpy(clouds(b, cfg, seed)).to(dev)
    xyz = x[..., :3].contiguous()
    sa1, n = cfg.sa_layers[0], cfg.num_point
    m, ns, r = sa1.npoint, sa1.nsample, sa1.radius
    _, cent = ops.fps_centroids(xyz, m, impl="cuda")
    w = core.round_up(BQ_WINDOW, core.LANES)
    perm, xs, _, qs, lo, ok = core.ball_query_window_plan(xyz, cent, r, w)
    if not bool(ok):
        raise AssertionError(f"bq_window={BQ_WINDOW} does not certify SA1 on the smoke clouds")
    tiles = lo.shape[1]
    first, last = core.ball_query_tile_spans(xs, qs, lo, r, w)
    pairs = int((last - first).sum())  # the columns of each query's x-span: all that can hit
    bq_bytes = b * n * 16 + b * m * 12 + b * tiles * 4  # sorted cloud and indices, sorted queries, starts
    route = list(cuda_ballquery.tiles_route(xs, m, m // tiles, w))
    bq_info = {"route": route, "pairs": pairs, "window_pairs": b * m * w}

    def check_op(name, run, plain, windows, want_ok):
        """The whole calibrated op on both paths: equal outputs and ok."""
        for window in windows:
            got, want = run(window), plain(window)
            if not all((g is None and h is None) or torch.equal(g, h) for g, h in zip(got, want)):
                raise AssertionError(f"{name} at window {window}: the kernel path and the plain path disagree")
            if want_ok.get(window) is not None and bool(got[-1]) != want_ok[window]:
                raise AssertionError(f"{name} at window {window}: ok {bool(got[-1])}, want {want_ok[window]}")

    got = cuda.ball_query_tiles(xs, perm, qs, lo, r, ns, w)
    want = core.ball_query_tiles(xs, perm, qs, lo, r, ns, w)
    report.add(
        "ball_query_sliced", b, f"N={n} M={m} r={r} nsample={ns} w={w}",
        lambda: cuda.ball_query_tiles(xs, perm, qs, lo, r, ns, w),
        lambda: core.ball_query_tiles(xs, perm, qs, lo, r, ns, w),
        nbytes=bq_bytes + b * m * (ns + 1) * 4,
        nops=9 * pairs,
        err=0.0,
        match=all(torch.equal(g, h) for g, h in zip(got, want)),
        extra={
            "op_ms": lambda: ops.ball_query_calibrated(xyz, cent, r, ns, BQ_WINDOW, impl="cuda"),
            "exact_op_ms": lambda: ops.ball_query(xyz, cent, r, ns, impl="cuda"),
        },
        info=bq_info,
    )
    check_op(
        "ball_query_calibrated",
        lambda win: ops.ball_query_calibrated(xyz, cent, r, ns, win, impl="cuda"),
        lambda win: ops.ball_query_calibrated(xyz, cent, r, ns, win, impl="torch"),
        (BQ_WINDOW, SMALL_BQ_WINDOW), {BQ_WINDOW: True, SMALL_BQ_WINDOW: False},
    )

    got = cuda.ball_query_tiles_pos(xs, perm, qs, lo, r, ns, w)
    want = core.ball_query_tiles_pos(xs, perm, qs, lo, r, ns, w)
    gen = torch.Generator(device=dev).manual_seed(seed)
    w0 = torch.randn((cfg.point_dim, SA_MLPS[0][0]), generator=gen, device=dev) * 0.5
    b0 = torch.randn((SA_MLPS[0][0],), generator=gen, device=dev) * 0.1
    report.add(
        "ball_query_sliced_pos", b, f"N={n} M={m} r={r} nsample={ns} w={w}",
        lambda: cuda.ball_query_tiles_pos(xs, perm, qs, lo, r, ns, w),
        lambda: core.ball_query_tiles_pos(xs, perm, qs, lo, r, ns, w),
        nbytes=bq_bytes + b * m * (2 * ns + 1) * 4,
        nops=9 * pairs,
        err=0.0,
        match=all(torch.equal(g, h) for g, h in zip(got, want)),
        extra={
            "op_ms": lambda: ops.project_group_calibrated(x, w0, b0, xyz, cent, r, ns, BQ_WINDOW, impl="cuda"),
            "exact_op_ms": lambda: ops.project_group_leaf(
                x, w0, b0, ops.ball_query(xyz, cent, r, ns, impl="cuda")[0]
            ),
        },
        info=bq_info,
    )
    check_op(
        "project_group_calibrated",
        lambda win: ops.project_group_calibrated(x, w0, b0, xyz, cent, r, ns, win, impl="cuda"),
        lambda win: ops.project_group_calibrated(x, w0, b0, xyz, cent, r, ns, win, impl="torch"),
        (BQ_WINDOW, SMALL_BQ_WINDOW), {BQ_WINDOW: True, SMALL_BQ_WINDOW: False},
    )

    pos = got[1]
    zp_s = ops.gather_points(x, perm) @ w0 + b0  # the projected sorted cloud, as the fused op makes it
    c = zp_s.shape[-1]
    rows = (lo.long().repeat_interleave(m // tiles, dim=1)[:, :, None] + pos.long()
            + torch.arange(b, device=dev)[:, None, None] * n).reshape(-1)
    flat = zp_s.reshape(b * n, c)
    out = cuda.window_gather(zp_s, lo, pos)
    report.add(
        "window_gather", b, f"N={n} M={m} K={ns} C={c}",
        lambda: cuda.window_gather(zp_s, lo, pos),
        lambda: core.window_gather(zp_s, lo, pos),
        nbytes=b * n * c * 4 + b * tiles * 4 + b * m * ns * 4 + b * m * ns * c * 4,
        nops=0,
        err=max_abs(out, core.window_gather(zp_s, lo, pos)),
        match=torch.equal(out, core.window_gather(zp_s, lo, pos))
        and torch.equal(out.reshape(-1, c), torch.index_select(flat, 0, rows)),
        library=lambda: torch.index_select(flat, 0, rows),
    )

    # FP4: the dense cloud's 3-NN among SA1's centroids.
    wf = core.round_up(FP_WINDOW, core.LANES)
    fperm, fxs, _, fqs, flo = core.knn_window_plan(cent, xyz, wf)
    got = cuda.knn_tiles(fxs, fperm, fqs, flo, 3, wf)
    want = core.knn_tiles(fxs, fperm, fqs, flo, 3, wf)
    report.add(
        "knn_sliced", b, f"Nq={n} M={m} k=3 w={wf}",
        lambda: cuda.knn_tiles(fxs, fperm, fqs, flo, 3, wf),
        lambda: core.knn_tiles(fxs, fperm, fqs, flo, 3, wf),
        nbytes=b * m * 16 + b * fqs.shape[1] * 12 + b * flo.shape[1] * 4 + b * fqs.shape[1] * 3 * 8,
        nops=9 * b * fqs.shape[1] * wf,
        err=max_abs(got[0], want[0]),
        match=torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
        extra={
            "op_ms": lambda: ops.three_nn_calibrated(xyz, cent, FP_WINDOW, impl="cuda"),
            "exact_op_ms": lambda: ops.three_nn(xyz, cent, impl="cuda"),
        },
    )
    check_op(
        "three_nn_calibrated",
        lambda win: ops.three_nn_calibrated(xyz, cent, win, impl="cuda"),
        lambda win: ops.three_nn_calibrated(xyz, cent, win, impl="torch"),
        (FP_WINDOW, SMALL_FP_WINDOW), {FP_WINDOW: True},
    )


def repaired_phase(cfg: Config, seed: int, report: Report) -> None:
    """The limits this port once refused, each kernel against its plain version
    on the card, bit for bit: kNN past k = 16 (the list route) on the
    roadmap's input (64 references, 8 queries) and at FP4's shape; the two
    calibrated windowed ball-query kernels with nsample = 64 (the sorted list
    in the output row) on the roadmap's input (1024 / 128 points, radius 0.2,
    window 512) and at SA1's shape, and with a window past a block's shared
    memory (16384 columns at N = 32768, read from device memory); the
    windowed kNN with k = 32 at FP4's shape and with the wide window. The
    whole calibrated ops are held on both paths too. These rows carry the
    batches 1 and 2, apart from the model's 8 and 16."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed + 600)
    sms = cuda_ballquery.num_sms(dev.index or 0)

    def knn_row(label, refs, queries, k):
        b, m, nq = refs.shape[0], refs.shape[1], queries.shape[1]
        got, want = cuda.knn(refs, queries, k), core.knn(refs, queries, k)
        report.add(
            "knn", b, f"{label} Nq={nq} M={m} k={k}",
            lambda: cuda.knn(refs, queries, k), lambda: core.knn(refs, queries, k),
            *op_bench.work_knn(b, nq, m, k), err=max_abs(got[0], want[0]),
            match=torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            info={"plan": cuda_knn.plan(b, nq, m, k, sms), "case": "repaired"},
        )

    def bq_rows(label, xyz, cent, r, ns, w):
        b, n, m = xyz.shape[0], xyz.shape[1], cent.shape[1]
        perm, xs, _, qs, lo, _ = core.ball_query_window_plan(xyz, cent, r, w)
        first, last = core.ball_query_tile_spans(xs, qs, lo, r, w)
        pairs, base = int((last - first).sum()), b * n * 16 + b * m * 12 + b * lo.shape[1] * 4
        route = list(cuda_ballquery.tiles_route(xs, m, m // lo.shape[1], w))
        for name, fn, plain, out_ints in (
            ("ball_query_sliced", cuda.ball_query_tiles, core.ball_query_tiles, ns + 1),
            ("ball_query_sliced_pos", cuda.ball_query_tiles_pos, core.ball_query_tiles_pos, 2 * ns + 1),
        ):
            got, want = fn(xs, perm, qs, lo, r, ns, w), plain(xs, perm, qs, lo, r, ns, w)
            report.add(
                name, b, f"{label} N={n} M={m} r={r} nsample={ns} w={w}",
                lambda fn=fn: fn(xs, perm, qs, lo, r, ns, w), lambda plain=plain: plain(xs, perm, qs, lo, r, ns, w),
                nbytes=base + b * m * out_ints * 4, nops=9 * pairs, err=0.0,
                match=all(torch.equal(g, h) for g, h in zip(got, want)),
                info={"case": "repaired", "max_count": int(got[-1].max()), "staged": w <= 232448 // 16,
                      "route": route},
            )
        got = ops.ball_query_calibrated(xyz, cent, r, ns, w, impl="cuda")
        want = ops.ball_query_calibrated(xyz, cent, r, ns, w, impl="torch")
        if not all(torch.equal(g, h) for g, h in zip(got, want)):
            raise AssertionError(f"ball_query_calibrated {label}: the kernel path and the plain path disagree")

    def knn_tiles_row(label, refs, queries, k, w):
        b, m = refs.shape[:2]
        fperm, fxs, _, fqs, flo = core.knn_window_plan(refs, queries, w)
        got, want = cuda.knn_tiles(fxs, fperm, fqs, flo, k, w), core.knn_tiles(fxs, fperm, fqs, flo, k, w)
        nq = fqs.shape[1]
        report.add(
            "knn_sliced", b, f"{label} Nq={nq} M={m} k={k} w={w}",
            lambda: cuda.knn_tiles(fxs, fperm, fqs, flo, k, w), lambda: core.knn_tiles(fxs, fperm, fqs, flo, k, w),
            nbytes=b * m * 16 + b * nq * 12 + b * flo.shape[1] * 4 + b * nq * k * 8, nops=9 * b * nq * w,
            err=max_abs(got[0], want[0]), match=torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            info={"case": "repaired"},
        )
        got = ops.knn_calibrated(refs, queries, k, w, impl="cuda")
        want = ops.knn_calibrated(refs, queries, k, w, impl="torch")
        if not all(torch.equal(g, h) for g, h in zip(got, want)):
            raise AssertionError(f"knn_calibrated {label}: the kernel path and the plain path disagree")

    small1 = torch.rand((1, 64, 3), generator=gen, device=dev)
    small2 = torch.rand((1, 8, 3), generator=gen, device=dev)
    knn_row("roadmap input", small1, small2, 32)
    x = torch.from_numpy(clouds(2, cfg, seed + 600)).to(dev)
    xyz = x[..., :3].contiguous()
    sa1 = cfg.sa_layers[0]
    cent = ops.fps_centroids(xyz, sa1.npoint, impl="cuda")[1].contiguous()
    knn_row("FP4 shape", cent, xyz, 32)
    bq1 = torch.rand((1, 1024, 3), generator=gen, device=dev)
    bq2 = torch.rand((1, 128, 3), generator=gen, device=dev)
    bq_rows("roadmap input", bq1, bq2, 0.2, 64, 512)
    bq_rows("SA1 shape", xyz, cent, sa1.radius, 64, core.round_up(BQ_WINDOW, core.LANES))
    wide = torch.rand((1, 32768, 3), generator=gen, device=dev) * torch.tensor([8.0, 1.0, 1.0], device=dev)
    wide_q = wide[:, ::32].contiguous()
    for ns in (32, 64):
        bq_rows("window past shared memory", wide, wide_q, 0.2, ns, 16384)
    knn_tiles_row("FP4 shape", cent, xyz, 32, core.round_up(FP_WINDOW, core.LANES))
    knn_tiles_row("window past shared memory", wide, wide_q, 3, 16384)


def no_host_read(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: any
    synchronising PyTorch call in it (``.item()``, ``.cpu()``, ``bool()`` of a
    device tensor, ...) raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def clustered(b: int, cfg: Config, seed: int) -> torch.Tensor:
    """Smoke clouds with half their points in a 2 cm band of x: the query tiles
    over the band hold far more candidates than the window."""
    xyz = torch.from_numpy(np.ascontiguousarray(clouds(b, cfg, seed)[..., :3])).to(DEVICE)
    half = cfg.num_point // 2
    xyz[:, :half, 0] = 4.0 + 0.02 * xyz[:, :half, 0] / 8.0
    return xyz.contiguous()


def windowed_rows(report: Report, label: str, xyz, cent, radius: float, nsample: int) -> None:
    """The round-1 windowed ball query with its default window on one input:
    the kernel against its plain version on the op's sorted inputs, the whole
    op (run without a host read) against the plain windowed op and the exact
    kernel, all bit for bit; the tiles that fit, counted on the host from the
    plan's ``lo``/``hi``."""
    b, n = xyz.shape[:2]
    m = cent.shape[1]
    plan, w, fits, pairs = op_bench.windowed_plan(xyz, cent, radius, nsample)
    got = cuda.ball_query_window_tiles(xyz, *plan, radius, nsample, w)
    want = core.ball_query_window_tiles(xyz, *plan, radius, nsample, w)
    op = no_host_read(lambda: ops.ball_query(xyz, cent, radius, nsample, impl="windowed"))
    plain_op = core.ball_query_windowed(xyz, cent, radius, nsample)
    exact = ops.ball_query(xyz, cent, radius, nsample, impl="cuda")
    match = all(torch.equal(g, h) for g, h in zip(got, want)) and all(
        torch.equal(g, h) and torch.equal(g, e) for g, h, e in zip(op, plain_op, exact)
    )
    report.add(
        "ball_query_windowed", b, f"{label} N={n} M={m} r={radius} nsample={nsample} w={w}",
        lambda: cuda.ball_query_window_tiles(xyz, *plan, radius, nsample, w),
        lambda: core.ball_query_window_tiles(xyz, *plan, radius, nsample, w),
        *op_bench.work_ball_query_windowed(b, n, m, fits.shape[1], nsample, pairs),
        err=0.0, match=match, plain_timing=FEW,
        extra={
            "op_ms": lambda: ops.ball_query(xyz, cent, radius, nsample, impl="windowed"),
            "exact_op_ms": lambda: ops.ball_query(xyz, cent, radius, nsample, impl="cuda"),
        },
        info={"cloud": label, "tiles_fit": int(fits.sum()), "tiles": fits.numel(), "no_host_read": True},
    )


def op_surface_kernel_phase(cfg: Config, levels: list, report: Report) -> None:
    """The two kernels of the op surface on the levels ``kernel_phase`` made
    for a batch: the index-only FPS at the four SA shapes, equal to its plain
    version and to the fused kernel's indices; the round-1 windowed ball query
    at SA1-SA3 (SA4's 64 points take the exact kernel statically)."""
    b = levels[0].shape[0]
    for spec, src in zip(cfg.sa_layers, levels):
        n, npoint = src.shape[1], spec.npoint
        idx = ops.farthest_point_sample(src, npoint, impl="cuda")
        match = torch.equal(idx, ops.farthest_point_sample(src, npoint, impl="torch")) and torch.equal(
            idx, ops.fps_centroids(src, npoint, impl="cuda")[0]
        )
        report.add(
            "farthest_point_sample", b, f"N={n} npoint={npoint}",
            lambda: ops.farthest_point_sample(src, npoint, impl="cuda"),
            lambda: ops.farthest_point_sample(src, npoint, impl="torch"),
            *op_bench.work_fps(b, n, npoint, rows=False), err=0.0, match=match, plain_timing=FEW,
            info={"plan": cuda_fps.planned_route(src, npoint, rows=False)},
        )
    for spec, src, cent in zip(cfg.sa_layers[:3], levels, levels[1:]):
        windowed_rows(report, "smoke clouds", src, cent, spec.radius, spec.nsample)


def windowed_stress_phase(cfg: Config, seed: int, report: Report) -> None:
    """The round-1 windowed ball query where the smoke clouds do not take it:
    a clustered cloud (tiles over the band fall back), a cloud of 65536
    points (its default window, 16384 columns, is read from device memory),
    and nsample = 64 (the sorted list in the output row)."""
    sa1 = cfg.sa_layers[0]
    xyz = clustered(BATCH, cfg, seed + 500)
    cent = ops.fps_centroids(xyz, sa1.npoint, impl="cuda")[1].contiguous()
    windowed_rows(report, "clustered", xyz, cent, sa1.radius, sa1.nsample)
    rng = np.random.RandomState(seed + 501)
    wide = torch.from_numpy((rng.rand(WIDE_B, WIDE_N, 3) * [8.0, 8.0, 4.9]).astype(np.float32)).to(DEVICE)
    queries = wide[:, rng.choice(WIDE_N, WIDE_M, replace=False)].contiguous()
    windowed_rows(report, "past shared memory", wide, queries, sa1.radius, sa1.nsample)
    xyz = torch.from_numpy(np.ascontiguousarray(clouds(CHUNK, cfg, seed)[..., :3])).to(DEVICE)
    cent = ops.fps_centroids(xyz, sa1.npoint, impl="cuda")[1].contiguous()
    windowed_rows(report, "nsample=64", xyz, cent, sa1.radius, 64)


def op_surface_phase(card: str) -> dict:
    """The port's op-level path. First ``tools.parity`` on the card: every
    kernel, the two FPS entries and the round-1 windowed ball query among
    them, against the NumPy oracles, with zero failures (its launches are
    comparisons and count nowhere). Then, launch counts reset just before
    and read just after, one run of ``tools.stage_bench``: the SA composite
    through ``ops.farthest_point_sample`` with the exact and the windowed
    ball query, the gather, the FP composite; the five kernels it drives
    must have run, and no other."""
    t0 = time.perf_counter()
    if parity.main([]) != 0:
        raise AssertionError("the parity sweep reported failures")
    parity_s = time.perf_counter() - t0
    cuda.reset_launches()
    stages = stage_bench.run(torch.device(DEVICE), small=False)
    launches = dict(cuda.LAUNCHES)
    driven = ("farthest_point_sample", "ball_query", "ball_query_windowed", "knn", "three_interpolate")
    if not all(launches.get(name) for name in driven) or set(launches) - set(driven):
        raise AssertionError(f"the op surface launched {launches}, want each of {driven} and no other")
    emit({
        "phase": "op_surface",
        "parity_seconds": parity_s,
        "stage_ms": {row["shape"]: row["ms"] for row in stages},
        "launches": launches,
        "card": card,
    })
    return launches


def _expect_launches(launches: dict, want: dict, what: str) -> None:
    """Every kernel launched exactly as often as ``want`` says (0 where it has no entry)."""
    got = {name: launches.get(name, 0) for name in KERNELS}
    want = {name: want.get(name, 0) for name in KERNELS}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")


def _one_step(cfg: Config, impl, batch: dict, seed: int, **windows):
    """Loss and parameter gradients of one dropout-free step from seeded
    weights, under PyTorch's deterministic algorithms (for the comparisons
    of two paths; the timed steps run without them)."""
    with deterministic_algorithms():
        trainer = Trainer(cfg, ops_impl=impl, dropout_rate=0.0, device=DEVICE, **windows)
        trainer.init_state(seed)
        loss = trainer.train_step(batch)["loss"]
        grads = {name: p.grad.clone() for name, p in trainer.model.named_parameters()}
        torch.cuda.synchronize()
    return float(loss), grads


def _compare_steps(what: str, step: tuple, ref_step: tuple) -> dict:
    """One step's loss and gradients against another's: within 1e-5 of the
    loss and ``STEP_GRAD_TOL`` of each gradient's max abs, or raise. Returns
    the worst error and whether every gradient was equal bit for bit."""
    (loss, grads), (ref_loss, ref_grads) = step, ref_step
    worst = max(
        max_abs(grads[name], ref) / max(float(ref.abs().max()), 1e-30)
        for name, ref in ref_grads.items() if float(ref.abs().max()) > 1e-6
    )
    if abs(loss - ref_loss) > 1e-5 * abs(ref_loss) or worst > STEP_GRAD_TOL:
        raise AssertionError(f"{what}: loss {loss} vs {ref_loss}, worst gradient error {worst} of max abs")
    equal = all(torch.equal(grads[name], ref) for name, ref in ref_grads.items())
    return {"loss": loss, "ref_loss": ref_loss, "worst_grad_err_of_max_abs": worst, "bit_equal": equal}


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
    _expect_launches(
        launches, {name: 4 * TRAIN_STEPS for name in (*GEOMETRY_KERNELS, *INTERPOLATE_KERNELS)},
        f"{TRAIN_STEPS} train steps",
    )
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train losses not finite: {losses}")
    if metrics["confusion"].shape != (9, 9) or int(metrics["confusion"].sum()) != BATCH * cfg.num_point:
        raise AssertionError("bad confusion matrix")
    unmoved = [k for k, v in trainer.model.named_buffers() if torch.equal(v, stats_before[k])]
    if unmoved or trainer.step != 1 + TRAIN_STEPS:
        raise AssertionError(f"moving statistics that did not move: {unmoved}; step {trainer.step}")
    del trainer

    step = _one_step(cfg, None, batches[0], seed)
    again = _one_step(cfg, None, batches[0], seed)
    if again[0] != step[0] or not all(torch.equal(g, step[1][k]) for k, g in again[1].items()):
        raise AssertionError("two kernel-path steps from the same weights and batch gave other gradients")
    kernel_vs_plain = _compare_steps("kernel path vs plain path", step, _one_step(cfg, "torch", batches[0], seed))
    del step, again

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
        "kernel_vs_plain": kernel_vs_plain,
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
        launches, {name: 4 * chunks for name in (*GEOMETRY_KERNELS, "three_interpolate")},
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


def predict_windows_phase(cfg: Config, requests: int, batch: int, seed: int, card: str) -> dict:
    """The calibrated-window predict path: ``Predictor(bq_window, fp_window)``
    through ``predict_step_checked``, against the no-window kernel path on the
    same requests, timed in turns; and a too-small window that must say so."""
    sd = convert.from_flax_variables(convert.init_variables(cfg, num_classes=9, seed=seed))
    windowed = Predictor(cfg, sd, infer_chunk=CHUNK, device=DEVICE, bq_window=BQ_WINDOW, fp_window=FP_WINDOW)
    exact = Predictor(cfg, sd, infer_chunk=CHUNK, device=DEVICE)
    inputs = [clouds(batch, cfg, seed + 1 + i) for i in range(requests)]
    windowed.predict_step_checked(inputs[0])  # warm-up
    exact.predict_step(inputs[0])
    torch.cuda.synchronize()

    cuda.reset_launches()
    labels, oks, times = [], [], []
    for x in inputs:
        t0 = time.perf_counter()
        got, ok = windowed.predict_step_checked(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        labels.append(got)
        oks.append(ok)
    launches = dict(cuda.LAUNCHES)
    chunks = requests * (batch // CHUNK)
    _expect_launches(
        launches,
        {"fps_centroids": 4 * chunks, "three_interpolate": 4 * chunks, "ball_query": 3 * chunks, "knn": 3 * chunks,
         "ball_query_sliced_pos": chunks, "window_gather": chunks, "knn_sliced": chunks},
        f"{chunks} windowed predict chunks",
    )
    if not all(oks):
        raise AssertionError(f"window certificates of the smoke requests: {oks}")

    exact_times = []
    agree = []
    for x, got in zip(inputs, labels):
        t0 = time.perf_counter()
        want = exact.predict_step(x)
        torch.cuda.synchronize()
        exact_times.append((time.perf_counter() - t0) * 1e3)
        agree.append(float((got == want).float().mean()))
    logits = windowed.infer_logits(inputs[0])
    logit_err = max_abs(logits, exact.infer_logits(inputs[0]))
    if not torch.isfinite(logits).all() or min(agree) < 0.9999 or logit_err > WINDOW_LOGIT_TOL:
        raise AssertionError(f"windowed vs exact path: label agreement {agree}, max abs logit diff {logit_err}")
    small = Predictor(cfg, sd, infer_chunk=CHUNK, device=DEVICE, bq_window=SMALL_BQ_WINDOW)
    if small.predict_step_checked(inputs[0])[1]:
        raise AssertionError(f"bq_window={SMALL_BQ_WINDOW} certified SA1 on the smoke clouds")

    median, exact_median = statistics.median(times), statistics.median(exact_times)
    emit({
        "phase": "predict_windows",
        "bq_window": BQ_WINDOW,
        "fp_window": FP_WINDOW,
        "requests": requests,
        "batch": batch,
        "ms_per_request": times,
        "median_ms": median,
        "points_per_s": batch * cfg.num_point / (median / 1e3),
        "exact_ms_per_request": exact_times,
        "exact_median_ms": exact_median,
        "window_ok": oks,
        "launches": launches,
        "label_agreement": agree,
        "max_abs_logit_diff": logit_err,
        "card": card,
    })
    return launches


def train_windows_phase(cfg: Config, seed: int, card: str) -> dict:
    """The calibrated-window train path: ``Trainer(bq_window, fp_window)``, one
    warm-up and 3 Adam steps beside the no-window Trainer on the same batches,
    then one dropout-free step against the no-window step, and the windows
    that ``auto`` would pick on these clouds."""
    batches = [train_batch(cfg, BATCH, seed + 300 + i) for i in range(1 + WINDOW_TRAIN_STEPS)]
    windowed = Trainer(cfg, device=DEVICE, bq_window=BQ_WINDOW, fp_window=FP_WINDOW)
    exact = Trainer(cfg, device=DEVICE)
    for trainer in (windowed, exact):
        trainer.init_state(seed)
        trainer.train_step(batches[0], generator=torch.Generator(device=DEVICE).manual_seed(seed))
    torch.cuda.synchronize()

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    times, exact_times, oks, step_launches = [], [], [], []
    for batch in batches[1:]:
        cuda.reset_launches()
        t0 = time.perf_counter()
        metrics = windowed.train_step(batch, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        step_launches.append(dict(cuda.LAUNCHES))
        oks.append(bool(metrics["window_ok"]))
        if not np.isfinite(float(metrics["loss"])):
            raise AssertionError("windowed train loss not finite")
        t0 = time.perf_counter()
        exact.train_step(batch, generator=gen)
        torch.cuda.synchronize()
        exact_times.append((time.perf_counter() - t0) * 1e3)
    # Train mode groups through the windowed ball query (row 7) and the raw
    # gather: SA1 engages the window, SA2-4 (clouds of 1024 and fewer) take the
    # exact kernel; FP4 engages the 3-NN window, FP1-3 take the exact kernel.
    for launches in step_launches:
        _expect_launches(
            launches,
            {"fps_centroids": 4, "ball_query_sliced": 1, "ball_query": 3, "knn_sliced": 1, "knn": 3,
             "three_interpolate": 4, "three_interpolate_grad": 4},
            "one windowed train step",
        )
    if not all(oks):
        raise AssertionError(f"window_ok of the windowed train steps: {oks}")
    launches = {name: sum(step.get(name, 0) for step in step_launches) for name in KERNELS}
    del windowed, exact

    windowed_vs_exact = _compare_steps(
        "windowed vs exact step",
        _one_step(cfg, None, batches[0], seed, bq_window=BQ_WINDOW, fp_window=FP_WINDOW),
        _one_step(cfg, None, batches[0], seed),
    )

    sample = iter(clouds(BATCH, cfg, seed + 400 + i) for i in range(2))
    auto = calibrate_model_windows(
        [(spec.npoint, spec.radius) for spec in cfg.sa_layers], cfg.num_point, lambda: next(sample),
        num_batches=2, device=DEVICE,
    )
    median, exact_median = statistics.median(times), statistics.median(exact_times)
    emit({
        "phase": "train_windows",
        "bq_window": BQ_WINDOW,
        "fp_window": FP_WINDOW,
        "steps": WINDOW_TRAIN_STEPS,
        "batch": BATCH,
        "ms_per_step": times,
        "median_ms": median,
        "points_per_s": BATCH * cfg.num_point / (median / 1e3),
        "exact_ms_per_step": exact_times,
        "exact_median_ms": exact_median,
        "window_ok": oks,
        "launches": launches,
        "windowed_vs_exact": windowed_vs_exact,
        "auto_windows": {"bq_window": auto[0], "fp_window": auto[1]},
        "card": card,
    })
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
    chunk_levels = kernel_phase(cfg, SEED, report, CHUNK)
    train_levels = kernel_phase(cfg, SEED + 100, report, BATCH)
    grad_kernel_phase(chunk_levels, SEED, report)
    grad_kernel_phase(train_levels, SEED, report)
    window_kernel_phase(cfg, SEED, report, CHUNK)
    window_kernel_phase(cfg, SEED + 100, report, BATCH)
    op_surface_kernel_phase(cfg, chunk_levels, report)
    op_surface_kernel_phase(cfg, train_levels, report)
    windowed_stress_phase(cfg, SEED, report)
    repaired_phase(cfg, SEED, report)
    del chunk_levels, train_levels
    torch.cuda.empty_cache()
    paths = {"predict": predict_phase(cfg, REQUESTS, BATCH, SEED, card)}
    torch.cuda.empty_cache()
    paths["train"] = train_phase(cfg, SEED, card)
    torch.cuda.empty_cache()
    paths["predict_windows"] = predict_windows_phase(cfg, REQUESTS, BATCH, SEED, card)
    torch.cuda.empty_cache()
    paths["train_windows"] = train_windows_phase(cfg, SEED, card)
    torch.cuda.empty_cache()
    paths["op_surface"] = op_surface_phase(card)
    kernels = report.kernels_line(paths)

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
