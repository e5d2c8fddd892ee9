"""Plain PyTorch versions of the point-set operators.

These are the port's counterparts of ``pointnet2_tpu/ops/core.py``. They run
on any device, serve the CPU, and are what every CUDA kernel in
``ops.cuda`` is held against on the card.

Bit parity with the NumPy oracles rests on two rules:

- squared distances use the float32 difference form, written out as
  ``dx*dx + dy*dy + dz*dz`` in that order. Eager PyTorch rounds each
  elementwise op on its own, so the sum is ``((dx² + dy²) + dz²)`` exactly as
  the oracle computes it; a reduction over the last axis promises no order;
- a ball's squared radius is ``np.float32(radius) ** 2``, a float32 square.

Index outputs are int32, as in the JAX package; they are widened to int64
only where ``torch`` indexing needs it.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def squared_radius(radius: float) -> float:
    """The f32 square of ``float32(radius)``, as the oracle and the kernels use it."""
    return float(np.float32(radius) ** 2)


def _dist2(q: Tensor, d: Tensor) -> Tensor:
    """Squared distances between ``q (..., 3)`` and ``d (..., 3)`` (broadcast), f32 difference form."""
    dx = q[..., 0] - d[..., 0]
    dy = q[..., 1] - d[..., 1]
    dz = q[..., 2] - d[..., 2]
    return dx * dx + dy * dy + dz * dz


def _pairwise_dist2(xyz_q: Tensor, xyz_d: Tensor) -> Tensor:
    """(B, M, N) squared distances between queries (B, M, 3) and dataset (B, N, 3)."""
    return _dist2(xyz_q[:, :, None, :], xyz_d[:, None, :, :])


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def farthest_point_sample(xyz: Tensor, npoint: int) -> Tensor:
    """Farthest point sampling: (B, N, 3) float32 -> (B, npoint) int32.

    Slot 0 is index 0; each step takes the first index of the max of the
    running min squared distance, which starts at 1e38.
    """
    b, n, _ = xyz.shape
    xyz = xyz.float()
    rows = torch.arange(b, device=xyz.device)
    min_d = torch.full((b, n), 1e38, dtype=torch.float32, device=xyz.device)
    idx = torch.zeros((b, npoint), dtype=torch.int64, device=xyz.device)
    old = torch.zeros((b,), dtype=torch.int64, device=xyz.device)
    for j in range(1, npoint):
        sel = xyz[rows, old]  # (B, 3)
        min_d = torch.minimum(min_d, _dist2(xyz, sel[:, None, :]))
        old = torch.argmax(min_d, dim=-1)  # first index of the max
        idx[:, j] = old
    return idx.to(torch.int32)


def gather_points(points: Tensor, idx: Tensor) -> Tensor:
    """points (B, N, C), idx (B, M) -> (B, M, C)."""
    rows = torch.arange(points.shape[0], device=points.device)[:, None]
    return points[rows, idx.long()]


def fps_centroids(xyz: Tensor, npoint: int) -> tuple[Tensor, Tensor]:
    """FPS indices and the chosen rows: ((B, npoint) int32, (B, npoint, 3))."""
    idx = farthest_point_sample(xyz, npoint)
    return idx, gather_points(xyz, idx)


def prob_sample(cdf: Tensor, uniforms: Tensor) -> Tensor:
    """Inverse-CDF categorical sampling: cdf (B, N) an unnormalised inclusive
    cumsum, uniforms (B, M) in [0, 1) -> (B, M) int32, the left insertion point
    of ``uniforms * cdf[:, -1]`` clamped to N - 1."""
    q = uniforms * cdf[:, -1:]
    idx = torch.searchsorted(cdf.contiguous(), q.contiguous(), side="left")
    return idx.clamp_max(cdf.shape[-1] - 1).to(torch.int32)


# ---------------------------------------------------------------------------
# Grouping
# ---------------------------------------------------------------------------


def _first_k(keys: Tensor, sentinel: int, nsample: int) -> tuple[Tensor, Tensor]:
    """The ``nsample`` smallest keys of each row, ascending, keys equal to
    ``sentinel`` counting as absent; absent slots repeat the first key, or 0
    when there is none. Returns (selected keys, count of present ones)."""
    k = min(nsample, keys.shape[-1])
    sel = torch.topk(keys, k, dim=-1, largest=False, sorted=True).values
    if k < nsample:
        pad = torch.full((*sel.shape[:-1], nsample - k), sentinel, dtype=sel.dtype, device=sel.device)
        sel = torch.cat([sel, pad], dim=-1)
    valid = sel < sentinel
    first = sel[..., :1]
    first = torch.where(first < sentinel, first, 0)
    return torch.where(valid, sel, first), valid.sum(-1)


def ball_query(
    xyz1: Tensor, xyz2: Tensor, radius: float, nsample: int
) -> tuple[Tensor, Tensor]:
    """First ``nsample`` in-ball dataset points per query, in dataset order.

    xyz1 (B, N, 3) dataset, xyz2 (B, M, 3) queries. Membership is the strict
    ``d2 < float32(radius)**2``. Unused slots repeat the first hit, or 0 for
    an empty ball; the count is capped at ``nsample``. Returns idx
    (B, M, nsample) int32 and cnt (B, M) int32.
    """
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    d2 = _pairwise_dist2(xyz2.float(), xyz1.float())
    in_ball = d2 < squared_radius(radius)
    iota = torch.arange(n, device=xyz1.device).expand(b, m, n)
    idx, cnt = _first_k(torch.where(in_ball, iota, n), n, nsample)
    return idx.to(torch.int32), cnt.to(torch.int32)


def group_points(points: Tensor, idx: Tensor) -> Tensor:
    """points (B, N, C), idx (B, M, K) -> (B, M, K, C)."""
    rows = torch.arange(points.shape[0], device=points.device)[:, None, None]
    return points[rows, idx.long()]


def knn(xyz1: Tensor, xyz2: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """k nearest dataset points of each query, ascending; ties to the lowest index.

    xyz1 (B, M, 3) dataset, xyz2 (B, Nq, 3) queries. Returns dist2
    (B, Nq, k) float32 squared distances and idx (B, Nq, k) int32.
    """
    m = xyz1.shape[1]
    if not 0 < k <= m:
        raise ValueError(f"knn needs 0 < k <= M, got k={k}, M={m}")
    d2 = _pairwise_dist2(xyz2.float(), xyz1.float())
    dist, order = torch.sort(d2, dim=-1, stable=True)
    return dist[..., :k].contiguous(), order[..., :k].to(torch.int32)


def selection_sort(dist: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """The reference's in-place SelectionSort over full rows (tf_grouping.cu:93-136).

    dist (B, M, N) -> (idx int32, dist float32), both (B, M, N): positions
    0..k-1 hold the k smallest values ascending (a strict ``<`` scan, so ties
    keep the first occurrence), positions k..N-1 the rest in the order the
    swaps leave behind. Step s swaps position s with the first minimum of
    positions s..N-1.
    """
    b, m, n = dist.shape
    vals = dist.float().clone()
    idxs = torch.arange(n, dtype=torch.int32, device=dist.device).expand(b, m, n).clone()
    for s in range(min(k, n)):
        mn = torch.argmin(vals[..., s:], dim=-1, keepdim=True) + s  # first minimum
        for t in (vals, idxs):
            at_s, at_mn = t[..., s : s + 1].clone(), t.gather(-1, mn)
            t.scatter_(-1, mn, at_s)
            t[..., s : s + 1] = at_mn
    return idxs, vals


def select_top_k(k: int, dist: Tensor) -> tuple[Tensor, Tensor]:
    """``selection_sort(dist, k)`` with the reference wrapper's argument order
    (tf_grouping.py:31-43): full rows; callers slice ``[..., :k]``."""
    return selection_sort(dist, k)


def three_nn(xyz1: Tensor, xyz2: Tensor) -> tuple[Tensor, Tensor]:
    """3 nearest xyz2 points of each xyz1 point: dist2 (B, N, 3), idx (B, N, 3)."""
    return knn(xyz2, xyz1, 3)


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------


def interpolation_weights(dist2: Tensor) -> Tensor:
    """Inverse-distance weights with the reference's 1e-10 clamp."""
    inv = 1.0 / torch.clamp_min(dist2, 1e-10)
    return inv / inv.sum(dim=-1, keepdim=True)


PRECISIONS = (None, "highest", "default")


def _feature_dtype(t: Tensor) -> torch.dtype:
    """The type a result of features ``t`` has: its own if floating, else float32."""
    return t.dtype if t.is_floating_point() else torch.float32


def _sum_dtype(*ts: Tensor) -> torch.dtype:
    """The type the interpolation sums in: float32, or float64 where an input
    is float64 (what ``gradcheck`` feeds)."""
    return torch.float64 if any(t.dtype == torch.float64 for t in ts) else torch.float32


def blend_weight(weight: Tensor, precision: str | None, dtype: torch.dtype) -> Tensor:
    """The weights as the blend of ``dtype`` features multiplies them.

    ``None``/``"highest"``: as given. ``"default"``: rounded to the features'
    type first (bfloat16 features: the weights in bfloat16, as the JAX
    package's default-precision path multiplies them); a no-op for float32
    and float64. Widened to the type of the sums either way.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    acc = _sum_dtype(weight) if dtype != torch.float64 else torch.float64
    if precision == "default":
        weight = weight.to(dtype)
    return weight.to(acc)


def three_interpolate(points: Tensor, idx: Tensor, weight: Tensor, precision: str | None = None) -> Tensor:
    """points (B, M, C), idx/weight (B, N, 3) -> (B, N, C) in the points' type.

    ``w0*p[i0] + w1*p[i1] + w2*p[i2]``, as the kernel computes it: the
    gathered rows widened to float32 (float64 stays), the weights as
    ``blend_weight`` gives them, each product rounded, the three summed left
    to right, and the result rounded once to the points' type.
    """
    dtype = _feature_dtype(points)
    w = blend_weight(weight, precision, dtype)[..., None]
    g = group_points(points, idx).to(w.dtype)  # (B, N, 3, C)
    out = g[:, :, 0] * w[:, :, 0] + g[:, :, 1] * w[:, :, 1] + g[:, :, 2] * w[:, :, 2]
    return out.to(dtype)


def three_interpolate_concat(
    points: Tensor, idx: Tensor, weight: Tensor, skip: Tensor, precision: str | None = None
) -> Tensor:
    """``three_interpolate`` followed by the skip features: (B, N, C + C1).

    The feature-propagation concat, ``torch.cat([interpolated, skip], -1)``
    in the promoted type of the two (each widened explicitly), which the
    kernel writes in the same pass.
    """
    blend = three_interpolate(points, idx, weight, precision)
    dtype = torch.promote_types(blend.dtype, _feature_dtype(skip))
    return torch.cat([blend.to(dtype), skip.to(dtype)], dim=-1)


def three_interpolate_grad(
    g: Tensor, idx: Tensor, weight: Tensor, m: int, precision: str | None = None,
    dtype: torch.dtype | None = None,
) -> Tensor:
    """The cotangent of ``three_interpolate``'s ``points``: g (B, N, C) -> (B, M, C).

    ``dpoints[m, c]`` is the sum of ``weight[q, j] * g[q, c]`` over the pairs
    (q, j) with ``idx[q, j] == m`` (ThreeInterpolateGrad): three ``index_add_``
    calls, one per neighbour slot j, in that order, in float32 (float64
    stays), with the weights as ``blend_weight`` gives them for the forward's
    points' type ``dtype`` (default: g's), and the result rounded once to it.
    """
    dtype = _feature_dtype(g) if dtype is None else dtype
    w = blend_weight(weight, precision, dtype)
    acc = torch.promote_types(_sum_dtype(g), w.dtype)
    g, w = g.to(acc), w.to(acc)
    b, _, c = g.shape
    out = torch.zeros((b, m, c), dtype=acc, device=g.device)
    flat = out.view(b * m, c)
    rows = idx.long() + torch.arange(b, device=g.device)[:, None, None] * m  # (B, N, 3)
    for j in range(3):
        flat.index_add_(0, rows[:, :, j].reshape(-1), (g * w[:, :, j, None]).reshape(-1, c))
    return out.to(dtype)


def three_interpolate_weight_grad(g: Tensor, points: Tensor, idx: Tensor) -> Tensor:
    """The cotangent of ``three_interpolate``'s ``weight``: (B, N, 3), in the
    type of the sums (the caller casts it to the weights' type).

    The dot of ``g[q]`` with each of the three gathered rows.
    """
    acc = _sum_dtype(g, points)
    return (group_points(points, idx).to(acc) * g.to(acc)[:, :, None, :]).sum(-1)


def project_group_leaf(inputs: Tensor, w: Tensor, b: Tensor, idx: Tensor) -> Tensor:
    """``group_points(inputs @ w + b, idx)``: (B, N, cin), (cin, f0), (f0,), (B, M, K) -> (B, M, K, f0)."""
    return group_points(inputs @ w + b, idx)


# ---------------------------------------------------------------------------
# Calibrated x-windows (pointnet2_tpu/ops/pallas/ballquery.py:287-410,
# wingather.py:133-298, knn.py:173-320)
#
# The cloud and the queries are sorted by x (a stable sort, as jnp.argsort).
# Each tile of 128 sorted queries looks only at a ``w``-column slice of the
# sorted cloud, and a 0-d bool ``ok`` certifies, on the device, that the slice
# held every candidate: then the outputs equal the exact operator's bit for
# bit. A too-small window gives ``ok`` False and the windowed outputs; the
# caller decides. Each function below takes the kernels it runs as arguments:
# the plain versions by default, the CUDA ones from ``ops.cuda``.
# ---------------------------------------------------------------------------

LANES = 128  # the query tile, and the alignment of every window start


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _x_sort(xyz: Tensor) -> Tensor:
    """The stable ascending order of the x coordinates: (B, N) int64."""
    return torch.argsort(xyz[..., 0], dim=1, stable=True)


def _take_rows(t: Tensor, order: Tensor) -> Tensor:
    """``t[b, order[b]]`` along axis 1, for (B, N) or (B, N, C) tensors."""
    if t.dim() == 2:
        return t.gather(1, order)
    return t.gather(1, order[..., None].expand(-1, -1, t.shape[-1]))


def _bq_window_bounds(xs_x: Tensor, qs_x: Tensor, radius: float, tm: int, w: int):
    """Window start of each query tile and the end of its candidates.

    ``lo`` is the first sorted column at or right of the tile's leftmost
    ``x - r``, clipped so that the window stays in the cloud and floored to a
    128-multiple; ``hi`` is the first column at or right of the rightmost
    ``x + r``. The window ``[lo, lo + w)`` holds every candidate of the tile
    when ``hi - lo <= w``. Returns ``(lo, hi)``, (B, T) int64.
    """
    n = xs_x.shape[1]
    b, m = qs_x.shape
    tiles = qs_x.reshape(b, m // tm, tm)
    r = float(np.float32(radius))
    lo = torch.searchsorted(xs_x, (tiles.amin(-1) - r).contiguous(), side="left")
    hi = torch.searchsorted(xs_x, (tiles.amax(-1) + r).contiguous(), side="left")
    lo = torch.div(lo.clamp(0, max(n - w, 0)), LANES, rounding_mode="floor") * LANES
    return lo, hi


def _bq_window_starts(xs_x: Tensor, qs_x: Tensor, radius: float, tm: int, w: int):
    """Window start of each query tile and the certificate of the ball query,
    ``ok = max(hi - lo) <= w``: ``(lo (B, T) int64, ok)``."""
    lo, hi = _bq_window_bounds(xs_x, qs_x, radius, tm, w)
    return lo, (hi - lo).amax() <= w


def _tile_windows(xs: Tensor, perm: Tensor, lo: Tensor, w: int):
    """Columns ``[lo, lo + w)`` of the sorted cloud for every tile:
    coordinates (B, T, w, 3) and original indices (B, T, w)."""
    b, t = lo.shape
    cols = (lo.long()[:, :, None] + torch.arange(w, device=lo.device)).reshape(b, t * w)
    return _take_rows(xs, cols).reshape(b, t, w, 3), _take_rows(perm.long(), cols).reshape(b, t, w)


def _bq_tile_keys(xs, perm, qs, lo, radius, w, with_pos):
    """In-ball keys of each sorted query over its tile's window, (B, M, w)
    int64, and the sentinel that marks a column out of the ball. A key is the
    column's original index (times ``w`` plus the column with ``with_pos``).
    """
    n = xs.shape[1]
    b, m, _ = qs.shape
    t = lo.shape[1]
    win, orig = _tile_windows(xs, perm, lo, w)
    q = qs.reshape(b, t, m // t, 3)
    in_ball = _dist2(q[:, :, :, None, :], win[:, :, None, :, :]) < squared_radius(radius)
    if with_pos:
        keys = orig[:, :, None, :] * w + torch.arange(w, device=qs.device)
        sentinel = n * w
    else:
        keys, sentinel = orig[:, :, None, :], n
    return torch.where(in_ball, keys, sentinel).reshape(b, m, w), sentinel


def _x_spans(cols_x: Tensor, q_x: Tensor, bound: Tensor | float, strict: bool) -> tuple[Tensor, Tensor]:
    """The run of x-sorted columns ``cols_x (..., 1, W)`` whose rounded
    ``dx * dx`` (``dx = fl(qx - cx)``) stays below ``bound`` (at or below
    with ``strict=False``), for each query of ``q_x (..., TQ, 1)``: ``(first,
    last)``, (..., TQ) int64, ``last >= first``.

    Along the sorted columns ``dx`` falls as ``cx`` grows and ``fl(dx * dx)``
    grows with ``|dx|``, so the columns outside the run form a prefix left of
    the query (``dx > 0``) and a suffix right of it (``dx < 0``): ``first``
    counts the prefix, ``last`` is where the suffix begins.
    """
    dx = q_x - cols_x
    dx2 = dx * dx
    out = dx2 >= bound if strict else dx2 > bound
    first = ((dx > 0) & out).sum(-1)
    last = cols_x.shape[-1] - ((dx < 0) & out).sum(-1)
    return first, torch.maximum(first, last)


def ball_query_tile_spans(xs: Tensor, qs: Tensor, lo: Tensor, radius: float, w: int,
                          hi: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Each sorted query's columns ``[first, last)`` that can be in its ball,
    as the CUDA tiles kernels find them (``csrc/window_bq.cuh``).

    A column with ``fl(dx * dx) >= r2`` is never in the ball: the rounded
    ``dy^2`` and ``dz^2`` added to it are not negative. The in-ball columns of
    a query's range all lie in its span. The range is the tile's window
    ``[lo, lo + w)``, and the span is window-relative; with ``hi`` (the
    round-1 kernel's), a tile with ``hi - lo > w`` takes the whole sorted
    cloud ``[0, N)`` instead, and its queries' spans are columns of the
    sorted cloud. Returns (B, M) int64, in sorted query order.
    """
    b, t = lo.shape
    n = xs.shape[1]
    m = qs.shape[1]
    r2 = squared_radius(radius)
    q_x = qs[..., 0].reshape(b, t, m // t, 1)
    cols = (lo.long()[:, :, None] + torch.arange(w, device=lo.device)).reshape(b, t * w)
    first, last = _x_spans(xs[..., 0].gather(1, cols).reshape(b, t, 1, w), q_x, r2, strict=True)
    if hi is not None:
        whole = _x_spans(xs[..., 0].reshape(b, 1, 1, n), q_x, r2, strict=True)
        fits = ((hi - lo) <= w)[..., None]
        first, last = (torch.where(fits, f, g) for f, g in zip((first, last), whole))
    return first.reshape(b, m), last.reshape(b, m)


def knn_tile_spans(xs: Tensor, qs: Tensor, lo: Tensor, dist_k: Tensor, w: int) -> tuple[Tensor, Tensor]:
    """Each sorted query's window columns ``[first, last)`` with ``fl(dx *
    dx) <= d_k``, its k-th distance: the columns the CUDA windowed kNN's walk
    cannot rule out (``csrc/knn.cu``). Every pick lies there (a column's
    distance is at least its ``fl(dx * dx)``), ties at ``d_k`` included. The
    window is padded past M as ``knn_tiles`` pads it (x = 1e30, out of any
    finite span). xs (B, M, 3) and qs (B, Nq, 3) sorted, lo (B, T) window
    starts, dist_k (B, Nq). Returns (B, Nq) int64, window-relative, in sorted
    query order.
    """
    b, m, _ = xs.shape
    t = lo.shape[1]
    nq = qs.shape[1]
    xs_x = torch.cat([xs[..., 0].float(), xs.new_full((b, round_up(m, LANES) - m), 1e30)], dim=1)
    cols = (lo.long()[:, :, None] + torch.arange(w, device=lo.device)).reshape(b, t * w)
    first, last = _x_spans(xs_x.gather(1, cols).reshape(b, t, 1, w), qs[..., 0].reshape(b, t, nq // t, 1),
                           dist_k.reshape(b, t, nq // t, 1), strict=False)
    return first.reshape(b, nq), last.reshape(b, nq)


def ball_query_tiles(xs, perm, qs, lo, radius: float, nsample: int, w: int):
    """The windowed ball query over sorted tiles (the work of
    ``_ball_query_sliced_kernel``, ballquery.py:247).

    xs (B, N, 3) the x-sorted cloud, perm (B, N) each sorted column's original
    index, qs (B, M, 3) the sorted queries in tiles of M/T, lo (B, T) each
    tile's window start. Per query, the ``nsample`` smallest original indices
    among the in-ball columns of ``[lo, lo + w)``, padded with the first (0 if
    none), and ``min(#in-ball, nsample)``: idx (B, M, nsample), cnt (B, M)
    int32, in sorted query order.
    """
    sel, cnt = _first_k(*_bq_tile_keys(xs, perm, qs, lo, radius, w, with_pos=False), nsample)
    return sel.to(torch.int32), cnt.to(torch.int32)


def ball_query_tiles_pos(xs, perm, qs, lo, radius: float, nsample: int, w: int):
    """``ball_query_tiles`` that also returns each pick's window column (the
    work of ``_bq_sliced_pos_kernel``, wingather.py:54): idx, pos, cnt.

    The keys are ``orig * w + column``; columns are unique, so the smallest
    keys are the smallest original indices, and ``key % w`` is the column.
    """
    sel, cnt = _first_k(*_bq_tile_keys(xs, perm, qs, lo, radius, w, with_pos=True), nsample)
    return (
        torch.div(sel, w, rounding_mode="floor").to(torch.int32),
        (sel % w).to(torch.int32),
        cnt.to(torch.int32),
    )


def window_gather(zp_s: Tensor, lo: Tensor, pos: Tensor) -> Tensor:
    """``out[b, q, s] = zp_s[b, lo[b, tile(q)] + pos[b, q, s]]`` (the work of
    ``_window_gather_kernel``, wingather.py:98): (B, N, C), (B, T), (B, M, K)
    -> (B, M, K, C), M/T queries a tile."""
    t = lo.shape[1]
    m = pos.shape[1]
    rows = lo.long().repeat_interleave(m // t, dim=1)[:, :, None] + pos.long()
    return group_points(zp_s, rows)


def bq_falls_back(n: int, m: int, w: int) -> bool:
    """The static condition under which a windowed ball query runs exact:
    the window covers the cloud, or the queries do not fill whole tiles."""
    return w >= n or m % min(LANES, m) != 0


def ball_query_sliced(
    xyz1: Tensor, xyz2: Tensor, radius: float, nsample: int, window: int,
    exact=ball_query, tiles=ball_query_tiles,
) -> tuple[Tensor, Tensor, Tensor]:
    """Ball query through calibrated x-windows: ``(idx, cnt, ok)``, in the
    original query order; with ``ok`` True equal to ``ball_query``.

    ``window`` is rounded up to a 128-multiple. Where it covers the cloud or
    M is not a multiple of the tile, ``exact`` runs and ``ok`` is True.
    """
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    w = round_up(window, LANES)
    if bq_falls_back(n, m, w):
        idx, cnt = exact(xyz1, xyz2, radius, nsample)
        return idx, cnt, torch.ones((), dtype=torch.bool, device=xyz1.device)
    perm, xs, qperm, qs, lo, ok = ball_query_window_plan(xyz1, xyz2, radius, w)
    idx_s, cnt_s = tiles(xs, perm, qs, lo, radius, nsample, w)
    inv = torch.argsort(qperm, dim=1)
    return _take_rows(idx_s, inv), _take_rows(cnt_s, inv), ok


def ball_query_window_plan(xyz1: Tensor, xyz2: Tensor, radius: float, w: int):
    """What the windowed ball query hands its kernel: ``(perm, xs, qperm, qs,
    lo, ok)``, the cloud's stable x order (int32) and the sorted cloud, the
    queries' order and the sorted queries, each tile's window start (int32)
    and the certificate."""
    perm, xs, qperm, qs, lo, hi = ball_query_window_bounds(xyz1, xyz2, radius, w)
    return perm, xs, qperm, qs, lo, (hi - lo).amax() <= w


def ball_query_window_bounds(xyz1: Tensor, xyz2: Tensor, radius: float, w: int):
    """``ball_query_window_plan`` with each tile's ``hi`` (int32) in place of
    the certificate: ``(perm, xs, qperm, qs, lo, hi)``."""
    x1, x2 = xyz1.float(), xyz2.float()
    perm = _x_sort(x1)
    xs = _take_rows(x1, perm)
    qperm = _x_sort(x2)
    qs = _take_rows(x2, qperm)
    lo, hi = _bq_window_bounds(xs[..., 0].contiguous(), qs[..., 0], radius, min(LANES, x2.shape[1]), w)
    return perm.to(torch.int32), xs, qperm, qs, lo.to(torch.int32), hi.to(torch.int32)


def ball_query_window_tiles(xyz1, xs, perm, qs, lo, hi, radius: float, nsample: int, w: int):
    """The round-1 windowed ball query over sorted tiles (the work of
    ``_ball_query_window_kernel``, ballquery.py:80, with its fallback).

    A tile whose candidates fit its window (``hi - lo <= w``) takes
    ``ball_query_tiles``' picks from ``[lo, lo + w)``; any other tile takes
    the exact ball query of its queries over the unsorted cloud ``xyz1``.
    Either way the result is the exact ball query. idx (B, M, nsample), cnt
    (B, M) int32, in sorted query order.
    """
    b, m, _ = qs.shape
    t = lo.shape[1]
    win_idx, win_cnt = ball_query_tiles(xs, perm, qs, lo, radius, nsample, w)
    full_idx, full_cnt = ball_query(xyz1, qs, radius, nsample)
    fits = ((hi - lo) <= w)[:, :, None].expand(b, t, m // t).reshape(b, m)
    return torch.where(fits[..., None], win_idx, full_idx), torch.where(fits, win_cnt, full_cnt)


def default_bq_window(n: int, nsample: int) -> int:
    """The round-1 window when none is given: ``max(2 * nsample, N // 4)``."""
    return max(2 * nsample, n // 4)


def ball_query_windowed(
    xyz1: Tensor, xyz2: Tensor, radius: float, nsample: int, window: int | None = None,
    exact=ball_query, tiles=ball_query_window_tiles,
) -> tuple[Tensor, Tensor]:
    """The exact ball query through x-sorted windows (``ball_query_windowed``,
    ballquery.py:131-244): idx (B, M, nsample), cnt (B, M), bit-identical to
    ``ball_query``.

    The window, ``window`` or ``default_bq_window``, is rounded up to a
    128-multiple. Where it covers the cloud or M is not a multiple of the
    tile (``min(128, M)``), ``exact`` runs. Otherwise every tile whose
    candidates do not fit its window falls back on its own, inside ``tiles``:
    no certificate leaves the device.
    """
    n = xyz1.shape[1]
    m = xyz2.shape[1]
    w = round_up(window or default_bq_window(n, nsample), LANES)
    if bq_falls_back(n, m, w):
        return exact(xyz1, xyz2, radius, nsample)
    perm, xs, qperm, qs, lo, hi = ball_query_window_bounds(xyz1, xyz2, radius, w)
    idx_s, cnt_s = tiles(xyz1.float(), xs, perm, qs, lo, hi, radius, nsample, w)
    inv = torch.argsort(qperm, dim=1)
    return _take_rows(idx_s, inv), _take_rows(cnt_s, inv)


def pick_wblk(n: int, w: int) -> int | None:
    """The smallest 128-multiple block width >= w that divides n, or None
    (wingather.py:119-129)."""
    for cand in range(round_up(w, LANES), n + 1, LANES):
        if n % cand == 0:
            return cand
    return None


def project_group_sliced(
    inputs: Tensor, w0: Tensor, b0: Tensor, xyz: Tensor, new_xyz: Tensor,
    radius: float, nsample: int, window: int,
    exact=ball_query, tiles=ball_query_tiles_pos, gather=window_gather,
):
    """``group_points(inputs @ w0 + b0, ball_query(xyz, new_xyz))`` through
    calibrated x-windows: ``(grouped, idx, cnt, qperm, inv_q, ok)``.

    On the windowed path ``grouped`` (B, M, K, f0) is in x-sorted query order,
    ``qperm``/``inv_q`` (B, M) are the query sort and its inverse; idx and cnt
    are in the original order. The sorted cloud is projected, so the gather
    reads rows in sorted order. On the static fallback (``exact`` ball query
    and a plain gather) everything is in the original order, ``qperm`` and
    ``inv_q`` are None and ``ok`` is True.
    """
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    w = round_up(window, LANES)
    # The ball query's fallback, or no block width that divides n. The CUDA
    # gather reads rows where they lie and needs no blocks; the condition is
    # kept so that the port and the JAX package take the exact path, and give
    # ``qperm`` None, at the same shapes.
    if bq_falls_back(n, m, w) or pick_wblk(n, w) is None:
        idx, cnt = exact(xyz, new_xyz, radius, nsample)
        grouped = group_points(inputs @ w0 + b0, idx)
        return grouped, idx, cnt, None, None, torch.ones((), dtype=torch.bool, device=xyz.device)
    x1, x2 = xyz.float(), new_xyz.float()
    perm = _x_sort(x1)
    # One row gather for the coordinates and the features.
    cat_s = _take_rows(torch.cat([x1, inputs.float()], dim=-1), perm)
    xs, sorted_inputs = cat_s[..., :3].contiguous(), cat_s[..., 3:]
    qperm = _x_sort(x2)
    qs = _take_rows(x2, qperm)
    lo, ok = _bq_window_starts(xs[..., 0].contiguous(), qs[..., 0], radius, min(LANES, m), w)
    lo = lo.to(torch.int32)
    idx_s, pos_s, cnt_s = tiles(xs, perm.to(torch.int32), qs, lo, radius, nsample, w)
    zp_s = sorted_inputs @ w0 + b0  # (B, N, f0), in sorted order
    grouped_s = gather(zp_s, lo, pos_s)
    inv_q = torch.argsort(qperm, dim=1)
    return grouped_s, _take_rows(idx_s, inv_q), _take_rows(cnt_s, inv_q), qperm, inv_q, ok


def knn_tiles(xs, perm, qs, lo, k: int, w: int) -> tuple[Tensor, Tensor]:
    """The windowed kNN over sorted tiles (the work of ``_knn_sliced_kernel``,
    knn.py:133).

    xs (B, M, 3) the x-sorted dataset, perm (B, M) original indices, qs
    (B, Nq, 3) sorted queries in tiles of 128, lo (B, T) window starts, which
    may reach past M: those columns are padding, at distance +inf. Per query,
    k picks in ascending (distance, original index) order, as k passes of
    "take the minimum, then the lowest original index at that distance, and
    remove it" (with fewer than k finite columns, the remaining picks are
    +inf at the lowest original index of the window). dist2 (B, Nq, k)
    float32 and idx (B, Nq, k) int32, in sorted query order.
    """
    b, m, _ = xs.shape
    nq = qs.shape[1]
    t = lo.shape[1]
    pad = round_up(m, LANES) - m
    xs_p = torch.cat([xs.float(), xs.new_full((b, pad, 3), 1e30)], dim=1)
    perm_p = torch.cat([perm.long(), perm.new_full((b, pad), m).long()], dim=1)
    win, orig = _tile_windows(xs_p, perm_p, lo, w)
    q = qs.reshape(b, t, nq // t, 3)
    orig = orig[:, :, None, :]  # (B, T, 1, w)
    d2 = _dist2(q[:, :, :, None, :], win[:, :, None, :, :])  # (B, T, TQ, w)
    d2 = torch.where(orig < m, d2, float("inf"))
    dists, idxs = [], []
    for _ in range(k):
        dmin = d2.amin(-1, keepdim=True)
        imin = torch.where(d2 == dmin, orig, m).amin(-1, keepdim=True)
        dists.append(dmin)
        idxs.append(imin)
        d2 = torch.where(orig == imin, float("inf"), d2)
    dist = torch.cat(dists, -1).reshape(b, nq, k)
    return dist, torch.cat(idxs, -1).reshape(b, nq, k).to(torch.int32)


def knn_sliced(
    xyz1: Tensor, xyz2: Tensor, k: int, window: int, exact=knn, tiles=knn_tiles,
) -> tuple[Tensor, Tensor, Tensor]:
    """k exact nearest neighbours through calibrated x-windows: ``(dist2, idx, ok)``.

    xyz1 (B, M, 3) dataset, xyz2 (B, Nq, 3) queries. Each tile of 128 sorted
    queries takes the ``w`` columns centred on its span (start rounded to the
    nearest 128-multiple, clipped to the padded dataset); the query count is
    padded to whole tiles with the last sorted query. ``ok`` holds when every
    query's k-th distance is below the squared x-gap to the nearest column
    left out on either side; then the result equals ``knn``. Where ``w >= M``
    or ``Nq < 128``, ``exact`` runs and ``ok`` is True.
    """
    b, m, _ = xyz1.shape
    nq = xyz2.shape[1]
    w = round_up(window, LANES)
    if w >= m or nq < LANES:
        dist, idx = exact(xyz1, xyz2, k)
        return dist, idx, torch.ones((), dtype=torch.bool, device=xyz1.device)
    perm, xs, qperm, qs, lo = knn_window_plan(xyz1, xyz2, w)
    dist_s, idx_s = tiles(xs, perm, qs, lo, k, w)

    # Every column left out lies at least the x-gap away on its side. (A
    # Python inf, not a tensor made from one: that would be a copy to the
    # device, which waits for the stream.)
    xsx = xs[..., 0].contiguous()
    qx = qs[..., 0].reshape(b, -1, LANES)
    lo = lo.long()
    xl = xsx.gather(1, (lo - 1).clamp(0, m - 1))[..., None]
    xr = xsx.gather(1, (lo + w).clamp(0, m - 1))[..., None]
    bl = torch.where((lo > 0)[..., None], torch.square((qx - xl).clamp_min(0.0)), float("inf"))
    br = torch.where((lo + w < m)[..., None], torch.square((xr - qx).clamp_min(0.0)), float("inf"))
    ok = (dist_s[..., k - 1].reshape(qx.shape) < torch.minimum(bl, br)).all()
    inv = torch.argsort(qperm, dim=1)
    return _take_rows(dist_s[:, :nq], inv), _take_rows(idx_s[:, :nq], inv), ok


def knn_window_plan(xyz1: Tensor, xyz2: Tensor, w: int):
    """What the windowed kNN hands its kernel: ``(perm, xs, qperm, qs, lo)``,
    the dataset's stable x order (int32) and the sorted dataset, the queries'
    order and the sorted queries padded to whole tiles with the last one, and
    each tile's window start (int32): centred on the tile's span, rounded to
    the nearest 128-multiple, clipped to the padded dataset."""
    x1, x2 = xyz1.float(), xyz2.float()
    b, m, _ = x1.shape
    nq = x2.shape[1]
    perm = _x_sort(x1)
    xs = _take_rows(x1, perm)
    xsx = xs[..., 0].contiguous()
    qperm = _x_sort(x2)
    qs = _take_rows(x2, qperm)
    nq_pad = round_up(nq, LANES)
    if nq_pad != nq:  # padded rows repeat the last sorted query: a real query's result
        qs = torch.cat([qs, qs[:, -1:].expand(b, nq_pad - nq, 3)], dim=1)
    qx = qs[..., 0].reshape(b, nq_pad // LANES, LANES)
    lo_l = torch.searchsorted(xsx, qx.amin(-1).contiguous(), side="left")
    lo_r = torch.searchsorted(xsx, qx.amax(-1).contiguous(), side="left")
    mid = torch.div(lo_l + lo_r, 2, rounding_mode="floor")
    lo = torch.div(mid - w // 2 + LANES // 2, LANES, rounding_mode="floor") * LANES
    lo = lo.clamp(0, max(round_up(m, LANES) - w, 0))
    return perm.to(torch.int32), xs, qperm, qs.contiguous(), lo.to(torch.int32)


def three_nn_sliced(xyz1: Tensor, xyz2: Tensor, window: int):
    """Windowed exact 3-NN of each xyz1 point among xyz2: ``(dist2, idx, ok)``."""
    return knn_sliced(xyz2, xyz1, 3, window)
