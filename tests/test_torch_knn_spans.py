"""The exact stop of the windowed kNN and the whole-cloud spans of the round-1
windowed ball query, on the CPU.

The CUDA windowed kNN (``csrc/knn.cu``, row 10 of PERF.md's kernel table)
walks each query outward from its place in the x-sorted window and stops a
side once the rounded ``dx * dx`` passes the query's k-th distance;
``ops.core.knn_tile_spans`` gives the columns that stop cannot rule out.
The round-1 windowed ball query (``csrc/window_bq.cuh``, row 11) scans a
falling-back tile over the whole sorted cloud, each query over its x-span
(``ops.core.ball_query_tile_spans`` with ``hi``). These tests hold that
neither loses an answer: every kNN pick lies in its span, ties at the k-th
distance included; a model of the kernel's walk (NumPy float32: a warp's
queries in step, 8 columns of one side a step, the same side choice and
strict stop) equals ``core.knn_tiles`` bit for bit and sees every column of
each span; and the whole-cloud spans
hold every in-ball column, so the span scan of a tile that does not fit its
window gives the exact ball query and the JAX package's Pallas wrapper's
answer in interpret mode.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pointnet2_tpu.ops.pallas.ballquery import ball_query_windowed as jax_ball_query_windowed
from pointnet2_tpu_torch.ops import core

T = torch.from_numpy
CHUNK = 8  # columns of one side the kernel's warp takes a step (kChunk)
INF_BITS = 0x7F800000


def _bits(x) -> int:
    return int(np.float32(x).view(np.uint32))


def _f32(v) -> np.float32:
    return np.float32(v)


def _warp_walk(cols, queries, k):
    """The kernel's register route for one warp, in float32: ``cols`` (W, 4)
    the window's real columns (x, y, z, original index), x-sorted;
    ``queries`` (32, 3) the warp's x-sorted queries, one a lane. All lanes
    walk in step from the first query's place outward, CHUNK columns of one
    side a step, the side whose chunk starts nearer in x to the middle query
    first; a side closes once no lane's outermost column of the chunk passes
    (strict, fl(dx^2) <= d_k; on the right a column left of a lane's own
    query passes). Returns each query's k smallest keys (distance bits << 32
    | original index) and the columns each query looked at."""
    x = cols[:, 0].astype(np.float32)
    n = len(cols)
    places = [int(np.searchsorted(x, _f32(q[0]), side="left")) for q in queries]
    centre = _f32(queries[16][0])
    keys = [[] for _ in queries]
    bound = [INF_BITS] * len(queries)
    seen = [set() for _ in queries]
    left, right = places[0] - 1, places[0]
    open_left, open_right = left >= 0, right < n
    while open_left or open_right:
        take_left = open_left and (not open_right or _f32(centre - x[left]) <= _f32(x[right] - centre))
        base, step = (left, -1) if take_left else (right, 1)
        more = False
        for qi, q in enumerate(queries):
            qx, qy, qz = (_f32(v) for v in q)
            go = False
            for i in range(CHUNK):
                j = base + step * i
                if not 0 <= j < n:
                    continue
                seen[qi].add(j)
                c = cols[j]
                dx, dy, dz = (_f32(v - _f32(cv)) for v, cv in zip((qx, qy, qz), c[:3]))
                dx2 = dx * dx
                d = (dx2 + dy * dy) + dz * dz  # (NumPy's float32 ** 2 is not the rounded product)
                key = (_bits(d) << 32) | int(c[3])
                lst = keys[qi]
                if len(lst) < k or key < lst[k - 1]:
                    keys[qi] = lst = sorted(lst + [key])[:k]
                    bound[qi] = min(lst[k - 1] >> 32, INF_BITS) if len(lst) >= k else INF_BITS
                go = _bits(dx2) <= bound[qi] or (not take_left and j < places[qi])
            more |= go
        if take_left:
            left -= CHUNK
            open_left = more and left >= 0
        else:
            right += CHUNK
            open_right = more and right < n
    return keys, seen


def _model_knn_tiles(xs, perm, qs, lo, k, w):
    """``core.knn_tiles`` as the kernel computes it, warp by warp (32
    consecutive sorted queries); also returns each query's seen window columns."""
    b, m, _ = xs.shape
    nq = qs.shape[1]
    tm = nq // lo.shape[1]
    dist = np.zeros((b, nq, k), np.float32)
    idx = np.zeros((b, nq, k), np.int32)
    seen = {}
    for bi in range(b):
        for q0 in range(0, nq, 32):
            start = int(lo[bi, q0 // tm])
            end = min(start + w, m)
            cols = np.zeros((max(end - start, 0), 4), np.float64)  # x, y, z exact; the index whole
            cols[:, :3] = xs[bi, start:end]
            cols[:, 3] = perm[bi, start:end]
            lowest = min([m, *perm[bi, start:end].tolist()])
            all_keys, all_seen = _warp_walk(cols, qs[bi, q0:q0 + 32], k)
            for qi, (keys, cols_seen) in enumerate(zip(all_keys, all_seen)):
                q = q0 + qi
                seen[bi, q] = cols_seen
                for s in range(k):
                    key = keys[s] if s < len(keys) else None
                    if key is None or (key >> 32) >= INF_BITS:
                        dist[bi, q, s], idx[bi, q, s] = np.inf, lowest
                    else:
                        dist[bi, q, s] = np.uint32(key >> 32).view(np.float32)
                        idx[bi, q, s] = key & 0xFFFFFFFF
    return dist, idx, seen


def _sorted_tiles(refs, queries):
    """The x-sorted dataset (xs, perm int32) and queries of the calibrated op."""
    perm = np.argsort(refs[..., 0], axis=1, kind="stable")
    xs = np.take_along_axis(refs, perm[..., None], 1)
    qperm = np.argsort(queries[..., 0], axis=1, kind="stable")
    qs = np.take_along_axis(queries, qperm[..., None], 1)
    return xs, perm.astype(np.int32), np.ascontiguousarray(qs)


def _knn_case(seed, b, m, nq, w, ties):
    rng = np.random.RandomState(seed)
    refs = (rng.rand(b, m, 3) * [4.0, 1.0, 1.0]).astype(np.float32)
    if ties:
        refs[:, ::5, 0] = refs[:, 1:2, 0]  # repeated x
        refs[:, 7::9] = refs[:, 6::9][:, : refs[:, 7::9].shape[1]]  # repeated points: distance ties
    queries = (rng.rand(b, nq, 3) * [4.0, 1.0, 1.0]).astype(np.float32)
    xs, perm, qs = _sorted_tiles(refs, queries)
    mpad = core.round_up(m, core.LANES)
    lo = rng.randint(0, (mpad - w) // core.LANES + 1, (b, nq // core.LANES)).astype(np.int32) * core.LANES
    return xs, perm, qs, lo


def _inside(first, last, pos):
    return (pos >= first[..., None]) & (pos < last[..., None])


@pytest.mark.parametrize("seed,b,m,nq,w,k,ties", [
    (0, 2, 1024, 512, 512, 3, True),  # FP4-like: 3 picks among 512 columns
    (1, 1, 512, 256, 384, 16, True),
    (2, 2, 130, 256, 128, 5, False),  # windows past M: padding
    (3, 1, 300, 128, 256, 1, True),
    (4, 1, 2048, 256, 1024, 8, False),
])
def test_every_knn_pick_lies_in_its_span(seed, b, m, nq, w, k, ties):
    xs, perm, qs, lo = _knn_case(seed, b, m, nq, w, ties)
    dist, idx = core.knn_tiles(T(xs), T(perm), T(qs), T(lo), k, w)
    first, last = core.knn_tile_spans(T(xs), T(qs), T(lo), dist[..., -1], w)
    assert bool((last >= first).all()) and bool((last <= w).all())
    # Each pick's window column: where its original index sits in the window.
    cols = (T(lo).long()[:, :, None] + torch.arange(w)).clamp_max(m - 1)
    win_orig = torch.where(T(lo).long()[:, :, None] + torch.arange(w) < m,
                           T(perm).long().gather(1, cols.reshape(b, -1)).reshape(cols.shape), m)
    win_orig = win_orig.repeat_interleave(core.LANES, dim=1)  # (B, Nq, w)
    pos = (win_orig[:, :, None, :] == idx.long()[..., None]).int().argmax(-1)  # (B, Nq, k)
    finite = torch.isfinite(dist)
    assert bool(_inside(first, last, pos)[finite].all())
    # The span is exactly the columns with fl(dx^2) <= d_k, one run of the window.
    wx = torch.cat([T(xs)[..., 0], torch.full((b, core.round_up(m, core.LANES) - m), 1e30)], 1)
    wx = wx.gather(1, (T(lo).long()[:, :, None] + torch.arange(w)).reshape(b, -1)).reshape(b, -1, 1, w)
    dx = T(qs)[..., 0].reshape(b, -1, core.LANES, 1) - wx
    near = (dx * dx <= dist[..., -1].reshape(b, -1, core.LANES, 1)).reshape(b, nq, w)
    assert torch.equal(_inside(first, last, torch.arange(w)), near)


def test_a_tie_at_the_kth_distance_from_a_lower_index_is_in_the_span():
    """Two columns at the same distance d from the query: one straight along y
    (fl(dx^2) = 0), one straight along x with the lower original index
    (fl(dx^2) == d exactly). k = 1 picks the second, and the stop at
    fl(dx^2) > d (strict) keeps it in the span; a stop at >= would lose it."""
    refs = np.array([[[2.5, 0.0, 0.0], [2.0, 0.5, 0.0]] + [[3.9 - 0.001 * i, 0.9, 0.9] for i in range(126)]],
                    np.float32)
    queries = np.zeros((1, 128, 3), np.float32)
    queries[0, :, 0] = 2.0
    queries[0, 1:, 0] += np.linspace(0.6, 1.0, 127).astype(np.float32)
    xs, perm, qs = _sorted_tiles(refs, queries)
    lo = np.zeros((1, 1), np.int32)
    dist, idx = core.knn_tiles(T(xs), T(perm), T(qs), T(lo), 1, 128)
    at = int(np.nonzero(qs[0, :, 0] == np.float32(2.0))[0][0])
    assert int(idx[0, at, 0]) == 0 and float(dist[0, at, 0]) == np.float32(0.5) ** 2
    first, last = core.knn_tile_spans(T(xs), T(qs), T(lo), dist[..., -1], 128)
    col = int(np.nonzero(perm[0] == 0)[0][0])
    assert first[0, at] <= col < last[0, at]
    dx = np.float32(qs[0, at, 0] - xs[0, col, 0])
    assert dx * dx == dist[0, at, 0]  # exactly at the stop
    got = _model_knn_tiles(xs, perm, qs, lo, 1, 128)
    assert got[1][0, at, 0] == 0


def test_a_window_with_fewer_than_k_columns():
    """Two real columns and 126 of padding, k = 5: the last three picks are
    +inf at the window's lowest original index, the span is the whole window,
    and the walk (which then never stops) sees both columns."""
    rng = np.random.RandomState(5)
    refs = rng.rand(1, 130, 3).astype(np.float32)
    xs, perm, qs = _sorted_tiles(refs, rng.rand(1, 128, 3).astype(np.float32))
    lo = np.full((1, 1), 128, np.int32)
    dist, idx = core.knn_tiles(T(xs), T(perm), T(qs), T(lo), 5, 128)
    assert bool(torch.isinf(dist[..., 2:]).all()) and bool(torch.isfinite(dist[..., :2]).all())
    assert bool((idx[..., 2:] == int(perm[0, 128:].min())).all())
    first, last = core.knn_tile_spans(T(xs), T(qs), T(lo), dist[..., -1], 128)
    assert bool((first == 0).all()) and bool((last == 128).all())
    got_dist, got_idx, seen = _model_knn_tiles(xs, perm, qs, lo, 5, 128)
    np.testing.assert_array_equal(got_dist, dist.numpy())
    np.testing.assert_array_equal(got_idx, idx.numpy())
    assert all(s == {0, 1} for s in seen.values())


@pytest.mark.parametrize("seed,m,w,k,ties", [(11, 600, 256, 3, True), (12, 600, 256, 16, False),
                                           (13, 1000, 512, 3, False), (14, 300, 128, 8, True)])
def test_the_kernels_walk_equals_the_plain_knn_tiles(seed, m, w, k, ties):
    """The walk's model, a warp's queries in step, 8 columns of one side a
    step, against ``core.knn_tiles`` bit for bit; it looks at every column of
    each query's span."""
    xs, perm, qs, lo = _knn_case(seed, 1, m, 256, w, ties)
    dist, idx = core.knn_tiles(T(xs), T(perm), T(qs), T(lo), k, w)
    got_dist, got_idx, seen = _model_knn_tiles(xs, perm, qs, lo, k, w)
    np.testing.assert_array_equal(got_dist, dist.numpy())
    np.testing.assert_array_equal(got_idx, idx.numpy())
    first, last = core.knn_tile_spans(T(xs), T(qs), T(lo), dist[..., -1], w)
    for (bi, q), cols in seen.items():
        real = min(w, m - int(lo[bi, q // core.LANES]))
        assert set(range(int(first[bi, q]), min(int(last[bi, q]), real))) <= cols


# -- the round-1 windowed ball query's fallback over the whole sorted cloud --------


def _box(seed, b, n):
    return (np.random.RandomState(seed).rand(b, n, 3) * [8.0, 8.0, 4.9]).astype(np.float32)


def _whole_cloud_scan(xs, perm, qs, lo, hi, radius, nsample, w, spans):
    """The kernel's round-1 design on the plain helpers: each query's picks
    over its span of its tile's range (the window, or the whole sorted cloud)."""
    b, n, _ = xs.shape
    m = qs.shape[1]
    t = lo.shape[1]
    first, last = spans
    fits = ((hi - lo) <= w)[:, :, None].expand(b, t, m // t).reshape(b, m)
    starts = torch.where(fits, lo.long().repeat_interleave(m // t, dim=1), 0)
    keys, sentinel = core._bq_tile_keys(xs, perm, qs, torch.zeros_like(lo), radius, n, with_pos=False)
    col = torch.arange(n)
    inside = (col >= (starts + first)[..., None]) & (col < (starts + last)[..., None])
    sel, cnt = core._first_k(torch.where(inside, keys, sentinel), sentinel, nsample)
    return sel.to(torch.int32), cnt.to(torch.int32)


@pytest.mark.parametrize("b,n,m,radius,nsample", [
    (2, 1024, 256, 1.0, 32),  # SA2: no tile fits the default window
    (2, 256, 64, 2.0, 32),  # SA3: one tile of 64 queries
    (1, 1024, 256, 1.0, 64),
    (2, 2048, 512, 0.5, 8),
])
def test_every_in_ball_column_of_a_falling_back_tile_is_in_its_whole_cloud_span(b, n, m, radius, nsample):
    xyz = _box(b * n + m, b, n)
    cent = np.ascontiguousarray(xyz[:, :: n // m][:, :m])
    x1, x2 = T(xyz), T(cent)
    w = core.round_up(core.default_bq_window(n, nsample), core.LANES)
    perm, xs, _, qs, lo, hi = core.ball_query_window_bounds(x1, x2, radius, w)
    fits = (hi - lo) <= w
    if n <= 1024:
        assert not bool(fits.any())  # SA2 and SA3: every tile falls back
    spans = core.ball_query_tile_spans(xs, qs, lo, radius, w, hi=hi)
    first, last = spans
    t = lo.shape[1]
    whole = ~fits[:, :, None].expand(b, t, m // t).reshape(b, m)
    in_ball = core._dist2(qs[:, :, None, :], xs[:, None, :, :]) < core.squared_radius(radius)  # (B, M, N)
    col = torch.arange(n)
    inside = (col >= first[..., None]) & (col < last[..., None])
    assert not bool((in_ball & ~inside)[whole].any())
    assert bool((last[whole] <= n).all())
    # Without hi the spans are the window's, as before.
    assert all(torch.equal(g[~whole], h[~whole])
               for g, h in zip(spans, core.ball_query_tile_spans(xs, qs, lo, radius, w)))
    got = _whole_cloud_scan(xs, perm, qs, lo, hi, radius, nsample, w, spans)
    want = core.ball_query_window_tiles(x1, xs, perm, qs, lo, hi, radius, nsample, w)
    assert all(torch.equal(g, h) for g, h in zip(got, want))


@pytest.mark.parametrize("b,n,m,radius,nsample,cloud", [
    (2, 1024, 256, 1.0, 32, "box"),
    (2, 2048, 512, 0.2, 40, "band"),  # some tiles fit, the band's fall back
])
def test_the_whole_cloud_scan_matches_the_pallas_wrapper(b, n, m, radius, nsample, cloud):
    xyz = _box(7 + n, b, n)
    if cloud == "band":  # long in x, half the points in a 1 cm band
        xyz = (np.random.RandomState(1).rand(b, n, 3) * [8.0, 1.0, 1.0]).astype(np.float32)
        xyz[:, : n // 2, 0] = 4.0 + 0.01 * xyz[:, : n // 2, 0]
    cent = np.ascontiguousarray(xyz[:, np.random.RandomState(8).choice(n, m, replace=False)])
    x1, x2 = T(xyz), T(cent)
    w = core.round_up(core.default_bq_window(n, nsample), core.LANES)
    perm, xs, qperm, qs, lo, hi = core.ball_query_window_bounds(x1, x2, radius, w)
    if cloud == "band":
        fits = (hi - lo) <= w
        assert bool(fits.any()) and not bool(fits.all())
    idx_s, cnt_s = _whole_cloud_scan(xs, perm, qs, lo, hi, radius, nsample, w,
                                     core.ball_query_tile_spans(xs, qs, lo, radius, w, hi=hi))
    inv = torch.argsort(qperm, dim=1)
    with pltpu.force_tpu_interpret_mode():
        want_idx, want_cnt = jax_ball_query_windowed(xyz, cent, radius, nsample, None)
    np.testing.assert_array_equal(core._take_rows(idx_s, inv).numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(core._take_rows(cnt_s, inv).numpy(), np.asarray(want_cnt))
