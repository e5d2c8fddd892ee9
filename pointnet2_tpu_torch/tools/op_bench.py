"""Op-level timing of the port's kernels at the model's shapes, on the card.

    python -m pointnet2_tpu_torch.tools.op_bench [--device cpu] [--small] [--batch 8] [--dtype bfloat16]

The counterpart of the JAX repo's ``tools/op_bench.py``. At the four SA
levels of ``semantic.json`` (clouds as ``bench.py`` makes them: xyz uniform
in 8 x 8 x 4.9 m, each level the FPS centroids of the one before, as the
model makes them) it times FPS (the index-only and the fused entry), the
ball query (exact, the calibrated windowed one's two kernels with the
production window where it engages, then the window gather of the fused
grouping on its window columns and a seeded projection of SA1's first MLP
width, and the round-1 windowed one with its default window), and at the four FP levels the 3-NN (and the windowed 3-NN
with the production ``fp_window`` where it engages), three_interpolate
writing the FP concat (the skip as the model hands it over: FP4's is the
input cloud's colours), its backward on a cotangent strided as the train
step's, and a kNN with k=8, all at B=16 (``semantic.json``'s batch; ``--batch 8``
for the predict path's chunk). ``--dtype bfloat16`` runs three_interpolate
and its backward as the bf16 modes do (bfloat16 features, skip and
cotangent, ``precision="default"``, bfloat16 ``dpoints``; their bounds count
2-byte features). One JSON line per op and shape:

- ``kernel_ms``: the kernel alone (``utils.bench.cuda_ms``: CUDA events,
  median of 10 runs of 5 calls); for the windowed ball query the kernel on
  the op's sorted inputs, with ``op_ms`` the whole op (sorts, window bounds,
  un-permutation) and ``exact_op_ms`` the exact kernel beside it;
- ``device_ms``: the same call's kernel time on the device alone
  (``utils.bench.device_ms``: the profiler's kernel durations over 20
  calls). Where a launch's host side outlasts its kernel (the small
  levels), ``kernel_ms`` is the host's enqueue rate and this the kernel;
- ``plan``: the launch shape the wrapper's plan picked (FPS: cluster,
  threads, points a thread; exact ball query: warps a block, tile points;
  3-NN: lanes a query, threads; three_interpolate: 16-byte accesses or not,
  the skip's 16-byte copy; the windowed ball queries over tiles: blocks a
  tile, warps a block; the window gather: 16-byte vectors or not, lanes a
  row; the backward: 16-byte accesses or not; the windowed 3-NN has one
  launch shape, a block a tile), and for the 3-NN,
  three_interpolate, the windowed ball queries and the window gather
  ``routes_device_ms``, the device time of every route of that shape (3-NN:
  1 to 32 lanes a query; three_interpolate: 4-byte accesses, and 16-byte ones
  where the rows allow; the windowed ball queries: ``tiles_routes``; the
  gather: ``gather_routes``), the yardstick of the plan's choice; three_interpolate's
  ``unfused_ms`` is the kernel without the skip followed by ``torch.cat``;
  and for FPS ``chain_ms``, the device time of the same number of empty
  cluster-barrier steps in the same layout (``ops.cuda.fps.barrier_chain``):
  the chain's latency bound beside the operation bound;
- ``plain_ms``: the plain PyTorch version on the card (median of 3 single
  calls: the plain FPS takes some 200 ms a call);
- ``library_ms``: one PyTorch call computing the same function, or null
  where there is none (``index_select`` of the same rows for the window
  gather; none for the other ops);
- ``bound_ms`` and ``bound_by``: the least time for the work of these inputs
  (``work_*`` below; ``utils.bench.bound``);
- ``launches``: launches of the kernel in one call, counted before the timed ones.

This is the yardstick the redesign of a kernel is read against. With
``--device cpu`` each op runs once on its plain version (``--small``: two
clouds of 1024 points) and no time is measured: the records carry null times.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import numpy as np
import torch

from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.models.pointnet2_seg import SA_MLPS
from pointnet2_tpu_torch.ops import core, cuda
from pointnet2_tpu_torch.ops.cuda import ballquery as cuda_ballquery
from pointnet2_tpu_torch.ops.cuda import fps as cuda_fps
from pointnet2_tpu_torch.ops.cuda import interpolate as cuda_interp
from pointnet2_tpu_torch.ops.cuda import wingather as cuda_gather
from pointnet2_tpu_torch.utils.bench import bound, card_line, cuda_ms, device_ms, require_device

# The package's ``knn`` is the wrapper function; the module is reached by name.
cuda_knn = importlib.import_module("pointnet2_tpu_torch.ops.cuda.knn")

# semantic.json's SA levels: (npoint, radius, nsample); FP levels follow.
SA = [(1024, 0.5, 32), (256, 1.0, 32), (64, 2.0, 32), (16, 4.0, 32)]
SMALL_SA = [(256, 0.5, 16), (64, 1.0, 16), (16, 2.0, 16), (8, 4.0, 16)]
# The FP levels' interpolated and skip channels, FP1 to FP4 (the skip of FP4
# is the input cloud's colours, a view of row stride 6).
FP = [(512, 256), (256, 128), (256, 64), (128, 3)]
SMALL_FP = [(128, 64), (64, 32), (64, 16), (32, 3)]
KNN_K = 8
BATCH, SMALL_BATCH = 16, 2
# The calibrated ball query's production window (bench.py's bq_window): it
# engages at SA1, where the cloud is wider; --small uses a window that
# engages on its 1024 points.
BQ_WINDOW, SMALL_BQ_WINDOW = 3072, 384
# The windowed 3-NN's production window (the Trainer's fp_window opt-in): it
# engages at FP4, where the coarse cloud is wider; --small's at its FP4 too.
FP_WINDOW, SMALL_FP_WINDOW = 512, 128


def work_fps(b: int, n: int, npoint: int, rows: bool) -> tuple[float, float]:
    """(bytes, operations) of FPS: the cloud read once, the indices (and the
    rows) written once; 10 operations a point and step."""
    return b * n * 12 + b * npoint * (16 if rows else 4), 10 * b * (npoint - 1) * n


def scanned_pairs(idx: torch.Tensor, cnt: torch.Tensor, n: int, nsample: int) -> torch.Tensor:
    """Pairs the exact scan of each query needs on this data: up to its
    nsample-th hit, or all N. (B, M) int64."""
    return torch.where(cnt == nsample, idx[..., -1].long() + 1, n)


def work_ball_query(b, n, m, nsample, pairs: int) -> tuple[float, float]:
    """(bytes, operations) of the exact ball query: cloud and queries read,
    idx and cnt written; 9 operations a scanned pair."""
    return b * n * 12 + b * m * 12 + b * m * (nsample + 1) * 4, 9 * pairs


def windowed_plan(xyz, cent, radius, nsample):
    """The round-1 windowed ball query's inputs and what its data asks of the
    kernel: ``(plan, w, fits, pairs)``. ``plan`` is ``(xs, perm, qs, lo,
    hi)``; ``fits`` (B, T) bool says which tiles fit their window; ``pairs``
    counts the (query, column) pairs of each query's x-span over its tile's
    range, the window for a fitting tile and the whole sorted cloud for
    another (``ops.core.ball_query_tile_spans`` with ``hi``): the columns that
    can hit. Read on the host, outside any timed or checked call."""
    n = xyz.shape[1]
    w = core.round_up(core.default_bq_window(n, nsample), core.LANES)
    perm, xs, qperm, qs, lo, hi = core.ball_query_window_bounds(xyz, cent, radius, w)
    first, last = core.ball_query_tile_spans(xs, qs, lo, radius, w, hi=hi)
    return (xs, perm, qs, lo, hi), w, (hi - lo) <= w, int((last - first).sum())


def work_ball_query_windowed(b, n, m, tiles, nsample, pairs: int) -> tuple[float, float]:
    """(bytes, operations) of the round-1 kernel: the sorted cloud with its
    original indices, the sorted queries and two ints a tile read, idx and cnt
    written; 9 operations a pair of each query's x-span over its range."""
    return b * n * 16 + b * m * 12 + b * tiles * 8 + b * m * (nsample + 1) * 4, 9 * pairs


def work_ball_query_tiles(b, n, m, tiles, nsample, outs: int, pairs: int) -> tuple[float, float]:
    """(bytes, operations) of the windowed ball query over sorted tiles: the
    sorted cloud with its original indices, the sorted queries and a start a
    tile read, ``outs`` int rows of nsample (idx, and pos with positions) and
    cnt written; 9 operations a pair of each query's x-span, the columns
    that can hit (``ops.core.ball_query_tile_spans``)."""
    return b * n * 16 + b * m * 12 + b * tiles * 4 + b * m * (outs * nsample + 1) * 4, 9 * pairs


def work_ball_query_precut(b, t, tm, w, nsample, pairs: int, outs: int = 1) -> tuple[float, float]:
    """(bytes, operations) of the ball query on cut windows (the probes'
    pre-cut kernel): each tile's window, three coordinates and an original
    index a column, and its sorted queries read, ``outs`` int rows of
    nsample (idx, and pos with window columns) and cnt written; 9 operations
    a pair of each query's x-span over its window
    (``ops.core.ball_query_tile_spans``)."""
    return b * t * w * 16 + b * t * tm * 12 + b * t * tm * (outs * nsample + 1) * 4, 9 * pairs


def tiles_routes(tm: int) -> list[tuple[int, int]]:
    """The windowed ball query's routes at a tile of ``tm`` queries: split
    1 to 32 with a warp a query up to 16, and 8-warp blocks at split 4 and 8."""
    routes = [(s, min(cuda_ballquery.TILES_MAX_WARPS, tm // s)) for s in (1, 2, 4, 8, 16, 32) if tm % s == 0]
    return routes + [(s, 8) for s in (4, 8) if tm % s == 0 and (s, 8) not in routes]


def knn_tiles_pairs(xs, qs, lo, dist, w: int) -> int:
    """Pairs the windowed kNN's walk cannot rule out on this data: the columns
    of each query's span at its k-th distance (``ops.core.knn_tile_spans``)."""
    first, last = core.knn_tile_spans(xs, qs, lo, dist[..., -1], w)
    return int((last - first).sum())


def work_knn_tiles(b, m, nq, tiles, k, pairs: int) -> tuple[float, float]:
    """(bytes, operations) of the windowed kNN: the sorted dataset with its
    original indices, the sorted queries and a start a tile read, dist and idx
    written; 9 operations a pair of each query's span (``knn_tiles_pairs``)."""
    return b * m * 16 + b * nq * 12 + b * tiles * 4 + b * nq * k * 8, 9 * pairs


def gather_source_rows(lo: torch.Tensor, pos: torch.Tensor, n: int) -> torch.Tensor:
    """The window gather's picks as rows of the (B * N, C) source, in output
    order: ``b * n + lo[b, tile(q)] + pos[b, q, s]``, int64."""
    b, m = pos.shape[:2]
    tiles = lo.shape[1]
    return (lo.long().repeat_interleave(m // tiles, dim=1)[:, :, None] + pos.long()
            + torch.arange(b, device=pos.device)[:, None, None] * n).reshape(-1)


def work_window_gather(lo: torch.Tensor, rows: torch.Tensor, c: int) -> tuple[float, float]:
    """(bytes, operations) of the window gather on these picks: each distinct
    source row they name (``rows``, ``gather_source_rows``) read once, a start
    a tile and the picks read once, the output rows written once; no
    arithmetic."""
    picked = int(torch.unique(rows).numel())
    return picked * c * 4 + lo.numel() * 4 + rows.numel() * 4 + rows.numel() * c * 4, 0


def gather_routes(c: int, aligned: bool) -> list[tuple[bool, int]]:
    """Every route of the window gather for rows of C floats: 16-byte vectors
    where ``plan`` allows them and floats, each lane count."""
    vecs = (True, False) if cuda_gather.plan(c, aligned)[0] else (False,)
    return [(v, lanes) for v in vecs for lanes in cuda_gather.GATHER_LANES]


def work_three_interpolate_grad(b, n, m, c, elem: int = 4) -> tuple[float, float]:
    """(bytes, operations) of three_interpolate's backward: the cotangent,
    indices and weights read once, the (B, M, C) result written once, the
    features ``elem`` bytes an element (4 float32, 2 bfloat16); 6 operations
    an element of the cotangent (its three products and sums)."""
    return b * n * c * elem + b * n * 3 * 8 + b * m * c * elem, 6 * b * n * c


def work_knn(b, nq, m, k) -> tuple[float, float]:
    """(bytes, operations) of an exact kNN: 9 operations a (query, point) pair."""
    return b * m * 12 + b * nq * 12 + b * nq * k * 8, 9 * b * nq * m


def work_fp_interpolate(b, n, m, c, c1, elem: int = 4) -> tuple[float, float]:
    """(bytes, operations) of three_interpolate writing the FP concat: the
    features, indices, weights and skip read once, the concatenated rows
    written once, the features ``elem`` bytes an element (4 float32, 2
    bfloat16); 5 operations an interpolated element."""
    return b * m * c * elem + b * n * 3 * 8 + b * n * c1 * elem + b * n * (c + c1) * elem, 5 * b * n * c


def knn_routes(nq: int) -> list[tuple[int, int]]:
    """Every register route of the kNN kernel at a shape: 1 to 32 lanes a
    query, ``plan``'s block for each."""
    return [(lanes, cuda_knn.block_threads(nq, lanes)) for lanes in (1, 2, 4, 8, 16, 32)]


def route_key(route) -> str:
    return "x".join(str(v) for v in route)


def gather_route_key(route) -> str:
    vec, lanes = route
    return f"{'vec' if vec else 'float'}x{lanes}"


def levels(batch: int, num_point: int, sa, device, seed: int = 0) -> list[torch.Tensor]:
    """The five levels' coordinates of a batch: bench.py's clouds, then the
    FPS centroids of each level (the plain FPS on the CPU, the kernel on the card)."""
    rng = np.random.RandomState(seed)
    xyz = torch.from_numpy((rng.rand(batch, num_point, 3) * [8.0, 8.0, 4.9]).astype(np.float32)).to(device)
    out = [xyz]
    for npoint, _, _ in sa:
        out.append(ops.fps_centroids(out[-1], npoint)[1].contiguous())
    return out


def _record(op, shape, card, kernel, run, plain, nbytes, nops, timed, plan=None, chain=None,
            routes_device_ms=None, library=None, **extra):
    """One line: times where ``timed``, else nulls; launches of ``kernel`` in
    one call. ``chain``: the FPS call's empty barrier chain, timed on the
    device; ``routes_device_ms``: route name -> a function returning that
    route's device time, each measured beside the plan's; ``library``: one
    PyTorch call computing the same function."""
    bound_ms, bound_by = bound(nbytes, nops)
    row = {"op": op, "shape": shape, "kernel": kernel, "plan": plan, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": nbytes, "ops": nops, "library_ms": None, "card": card}
    if timed:
        before = cuda.LAUNCHES[kernel]
        run()
        row["launches"] = cuda.LAUNCHES[kernel] - before
        row["kernel_ms"] = cuda_ms(run)
        row["device_ms"] = device_ms(run, kernel.removesuffix("_bf16"))  # a bfloat16 instance's symbol is its row's
        if chain is not None:
            row["chain_ms"] = device_ms(chain, "fps_barrier_chain")
        row["plain_ms"] = cuda_ms(plain, reps=3, inner=1, warmup=1)
        if library is not None:
            row["library_ms"] = cuda_ms(library)
        row.update({key: cuda_ms(fn) for key, fn in extra.items()})
        if routes_device_ms:
            row["routes_device_ms"] = {name: fn() for name, fn in routes_device_ms.items()}
    else:
        run(), plain()
        row.update({"kernel_ms": None, "device_ms": None, "launches": None, "plain_ms": None,
                    **({"chain_ms": None} if chain is not None else {}), **{key: None for key in extra}})
    print(json.dumps(row), flush=True)
    return row


def _gather_record(card, timed, xs, perm, qs, lo, radius, nsample, w) -> dict:
    """The window gather at a calibrated level: the picks' window columns from
    the windowed ball query, a seeded (B, N, C) source of SA1's first MLP
    width standing for the projected sorted cloud."""
    b, n = xs.shape[:2]
    m, c = qs.shape[1], SA_MLPS[0][0]
    tiles_pos = cuda.ball_query_tiles_pos if timed else core.ball_query_tiles_pos
    pos = tiles_pos(xs, perm, qs, lo, radius, nsample, w)[1]
    zp_s = torch.randn((b, n, c), generator=torch.Generator(device=xs.device).manual_seed(3), device=xs.device)
    gather = cuda.window_gather if timed else core.window_gather
    rows = gather_source_rows(lo, pos, n)
    flat = zp_s.reshape(b * n, c)
    return _record(
        "window_gather", f"B={b} N={n} M={m} K={nsample} C={c} w={w}", card, "window_gather",
        lambda: gather(zp_s, lo, pos), lambda: core.window_gather(zp_s, lo, pos),
        *work_window_gather(lo, rows, c), timed,
        plan=cuda_gather.planned_route(zp_s) if timed else None,
        routes_device_ms={
            gather_route_key(r): (lambda r=r: device_ms(
                lambda: cuda.window_gather(zp_s, lo, pos, route=r), "window_gather"))
            for r in gather_routes(c, zp_s.data_ptr() % 16 == 0)
        } if timed else {},
        library=lambda: torch.index_select(flat, 0, rows),
    )


def run(device: torch.device, small: bool, batch: int = BATCH, dtype: str = "float32") -> list[dict]:
    timed = device.type == "cuda"
    features = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    precision = "default" if features == torch.bfloat16 else None
    elem = torch.finfo(features).bits // 8
    card = card_line() if timed else "cpu (not measured)"
    sa = SMALL_SA if small else SA
    lv = levels(SMALL_BATCH if small else batch, 1024 if small else 8192, sa, device)
    colours = torch.from_numpy(
        np.random.RandomState(1).rand(lv[0].shape[0], lv[0].shape[1], 3).astype(np.float32)
    ).to(device)
    cloud = torch.cat([lv[0], colours], -1)  # the model's input: FP4's skip is a view into it
    rows = []
    for i, (npoint, radius, nsample) in enumerate(sa):
        src, cent = lv[i], lv[i + 1]
        b, n = src.shape[:2]
        m = npoint
        for name, fn, rows_out in (("farthest_point_sample", ops.farthest_point_sample, False),
                                   ("fps_centroids", ops.fps_centroids, True)):
            route = cuda_fps.planned_route(src, m, rows_out) if timed else None
            rows.append(_record(
                name, f"B={b} N={n} npoint={m}", card, name,
                lambda fn=fn: fn(src, m), lambda fn=fn: fn(src, m, impl="torch"),
                *work_fps(b, n, m, rows_out), timed, plan=route,
                chain=lambda route=route: cuda_fps.barrier_chain(b, m, route, src.device.index),
            ))
        idx, cnt = ops.ball_query(src, cent, radius, nsample, impl="torch")
        pairs = int(scanned_pairs(idx, cnt, n, nsample).sum())
        rows.append(_record(
            "ball_query", f"B={b} N={n} M={m} r={radius} nsample={nsample}", card, "ball_query",
            lambda: ops.ball_query(src, cent, radius, nsample),
            lambda: ops.ball_query(src, cent, radius, nsample, impl="torch"),
            *work_ball_query(b, n, m, nsample, pairs), timed,
            plan=cuda_ballquery.plan(b, n, m, cuda_ballquery.num_sms(src.device.index)) if timed else None,
        ))
        w = core.round_up(SMALL_BQ_WINDOW if small else BQ_WINDOW, core.LANES)
        if not core.bq_falls_back(n, m, w):  # the calibrated windowed ball query engages here
            perm, xs, _, qs, lo, _ = core.ball_query_window_plan(src, cent, radius, w)
            first, last = core.ball_query_tile_spans(xs, qs, lo, radius, w)
            pairs = int((last - first).sum())
            tm = m // lo.shape[1]
            for kernel, fn, plain, outs in (
                ("ball_query_sliced", cuda.ball_query_tiles, core.ball_query_tiles, 1),
                ("ball_query_sliced_pos", cuda.ball_query_tiles_pos, core.ball_query_tiles_pos, 2),
            ):
                run_fn = fn if timed else plain
                rows.append(_record(
                    kernel, f"B={b} N={n} M={m} r={radius} nsample={nsample} w={w}", card, kernel,
                    lambda run_fn=run_fn: run_fn(xs, perm, qs, lo, radius, nsample, w),
                    lambda plain=plain: plain(xs, perm, qs, lo, radius, nsample, w),
                    *work_ball_query_tiles(b, n, m, lo.shape[1], nsample, outs, pairs), timed,
                    plan=cuda_ballquery.tiles_route(xs, m, tm, w) if timed else None,
                    routes_device_ms={
                        route_key(r): (lambda r=r, fn=fn, kernel=kernel: device_ms(
                            lambda: fn(xs, perm, qs, lo, radius, nsample, w, route=r), kernel))
                        for r in tiles_routes(tm)
                    } if timed else {},
                ))
            rows.append(_gather_record(card, timed, xs, perm, qs, lo, radius, nsample, w))
        w = core.round_up(core.default_bq_window(n, nsample), core.LANES)
        if core.bq_falls_back(n, m, w):
            continue  # the round-1 windowed op runs the exact kernel here
        plan, w, fits, pairs = windowed_plan(src, cent, radius, nsample)
        kernel = cuda.ball_query_window_tiles if timed else core.ball_query_window_tiles
        tm = m // fits.shape[1]
        rows.append(_record(
            "ball_query_windowed",
            f"B={b} N={n} M={m} r={radius} nsample={nsample} w={w} tiles_fit={int(fits.sum())}/{fits.numel()}",
            card, "ball_query_windowed",
            lambda: kernel(src, *plan, radius, nsample, w),
            lambda: core.ball_query_window_tiles(src, *plan, radius, nsample, w),
            *work_ball_query_windowed(b, n, m, fits.shape[1], nsample, pairs), timed,
            plan=cuda_ballquery.windowed_plan(b, n, m, tm, w, cuda_ballquery.num_sms(src.device.index))
            if timed else None,
            routes_device_ms={
                route_key(r): (lambda r=r: device_ms(
                    lambda: cuda.ball_query_window_tiles(src, *plan, radius, nsample, w, route=r),
                    "ball_query_windowed"))
                for r in tiles_routes(tm)
            } if timed else {},
            op_ms=lambda: ops.ball_query(src, cent, radius, nsample, impl="windowed"),
            exact_op_ms=lambda: ops.ball_query(src, cent, radius, nsample),
        ))
    gen = torch.Generator(device=device).manual_seed(2)
    for lvl, (c, c1) in zip(range(len(sa) - 1, -1, -1), SMALL_FP if small else FP):
        dense, coarse = lv[lvl], lv[lvl + 1]
        b, nq, m = dense.shape[0], dense.shape[1], coarse.shape[1]
        sms = cuda_ballquery.num_sms(dense.device.index) if timed else None
        rows.append(_record(
            "three_nn", f"B={b} Nq={nq} M={m} k=3", card, "knn",
            lambda: ops.three_nn(dense, coarse), lambda: ops.three_nn(dense, coarse, impl="torch"),
            *work_knn(b, nq, m, 3), timed, plan=cuda_knn.plan(b, nq, m, 3, sms) if timed else None,
            routes_device_ms={
                route_key(r): (lambda r=r: device_ms(lambda: cuda.knn(coarse, dense, 3, route=r), "knn"))
                for r in knn_routes(nq)
            } if timed else {},
        ))
        wf = core.round_up(SMALL_FP_WINDOW if small else FP_WINDOW, core.LANES)
        if wf < m and nq >= core.LANES:  # the windowed 3-NN engages here
            fperm, fxs, _, fqs, flo = core.knn_window_plan(coarse, dense, wf)
            want = core.knn_tiles(fxs, fperm, fqs, flo, 3, wf)
            tiles_fn = cuda.knn_tiles if timed else core.knn_tiles
            rows.append(_record(
                "knn_sliced", f"B={b} Nq={nq} M={m} k=3 w={wf}", card, "knn_sliced",
                lambda: tiles_fn(fxs, fperm, fqs, flo, 3, wf),
                lambda: core.knn_tiles(fxs, fperm, fqs, flo, 3, wf),
                *work_knn_tiles(b, m, fqs.shape[1], flo.shape[1], 3, knn_tiles_pairs(fxs, fqs, flo, want[0], wf)),
                timed,
                op_ms=lambda: ops.three_nn_calibrated(dense, coarse, wf),
                exact_op_ms=lambda: ops.three_nn(dense, coarse),
            ))
        # three_interpolate writing the FP concat, with the skip as the model hands it over.
        d2, idx = ops.three_nn(dense, coarse)
        weight = ops.interpolation_weights(d2)
        points = torch.randn((b, m, c), generator=gen, device=device).to(features)
        skip = cloud[..., 3:] if lvl == 0 else torch.randn((b, nq, c1), generator=gen, device=device)
        skip = skip.to(features)  # a bfloat16 stage casts its skip features
        bf16 = "_bf16" if features == torch.bfloat16 else ""
        widths = (False, True) if timed and cuda_interp.planned_route(points, skip)[0] else (False,)
        rows.append(_record(
            "three_interpolate_concat", f"B={b} M={m} C={c} N={nq} skip={c1} {dtype}", card,
            f"three_interpolate{bf16}",
            lambda: ops.three_interpolate(points, idx, weight, precision=precision, skip=skip),
            lambda: ops.three_interpolate(points, idx, weight, impl="torch", precision=precision, skip=skip),
            *work_fp_interpolate(b, nq, m, c, c1, elem), timed,
            plan=cuda_interp.planned_route(points, skip) if timed else None,
            unfused_ms=lambda: torch.cat([ops.three_interpolate(points, idx, weight, precision=precision), skip], -1),
            routes_device_ms={
                f"vec={vec}": (lambda vec=vec: device_ms(
                    lambda: cuda.three_interpolate(points, idx, weight, skip, route=vec, precision=precision),
                    "three_interpolate"))
                for vec in widths
            } if timed else {},
        ))
        # The backward, on a cotangent laid out as the train step hands it over:
        # the first C channels of the FP concat's.
        g = torch.randn((b, nq, c + c1), generator=gen, device=device).to(features)[..., :c]
        rows.append(_record(
            "three_interpolate_grad", f"B={b} M={m} C={c} N={nq} g_row_stride={c + c1} {dtype}", card,
            f"three_interpolate_grad{bf16}",
            lambda: ops.three_interpolate_grad(g, idx, weight, m, precision=precision),
            lambda: ops.three_interpolate_grad(g, idx, weight, m, impl="torch", precision=precision),
            *work_three_interpolate_grad(b, nq, m, c, elem), timed,
            plan=cuda_interp.grad_vec(g, c) if timed else None,
        ))
        k = min(KNN_K, m)
        rows.append(_record(
            "knn", f"B={b} Nq={nq} M={m} k={k}", card, "knn",
            lambda: ops.knn(coarse, dense, k), lambda: ops.knn(coarse, dense, k, impl="torch"),
            *work_knn(b, nq, m, k), timed,
        ))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--small", action="store_true", help="small shapes")
    ap.add_argument("--batch", type=int, default=BATCH,
                    help="clouds a call: 16, the train batch (the default), or 8, the predict chunk")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                    help="three_interpolate's features and its backward's, as the precision modes run them")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    run(device, args.small, args.batch, args.dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
