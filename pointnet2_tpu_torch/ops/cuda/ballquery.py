"""Wrappers of ``csrc/ballquery.cu``: the exact and the windowed radius ball query.

- ``ball_query`` replaces ``pointnet2_tpu/ops/pallas/ballquery.py:42``
  (``_ball_query_kernel``); its plain version is ``ops.core.ball_query``.
  A block of warps (``QUERIES_PER_WARP`` queries each) stages the cloud in
  shared memory, tile by tile; ``plan`` picks the warps and the tile from the
  shape and the card's SM count, and the wrapper takes ``route=`` to force one.
- ``ball_query_tiles`` replaces ``ballquery.py:247``
  (``_ball_query_sliced_kernel``); its plain version is
  ``ops.core.ball_query_tiles``. ``tiles_plan`` splits each tile's queries
  over blocks so that the card fills, and the wrapper takes ``route=`` to
  force a split.
- ``ball_query_window_tiles`` replaces ``ballquery.py:80``
  (``_ball_query_window_kernel``) and its wrapper's fallback, tile by tile;
  its plain version is ``ops.core.ball_query_window_tiles``. It runs on the
  tiles kernel's design, a falling-back tile over the whole sorted cloud;
  ``windowed_plan`` splits the tiles over blocks, and the wrapper takes
  ``route=`` to force a split.

The whole calibrated op (sorts, window starts and certificate) and the whole
round-1 op (sorts and window bounds, no host read) are PyTorch composites in
``ops.core`` (``ball_query_sliced``, ``ball_query_windowed``), which ``ops``
runs over these kernels' ``pn2`` operators.
"""

from __future__ import annotations

import functools

import torch

from pointnet2_tpu_torch.ops.core import squared_radius
from pointnet2_tpu_torch.ops.cuda.common import (
    FLOAT, INT, PTR, launch, require, require_int32_range, stream_of,
)

# A column (x, y, z, original index) takes 16 bytes of a block's shared
# memory, up to csrc/window_bq.cuh's kMaxSharedWindow (14528 columns); every
# windowed kernel reads wider spans from device memory. Any nsample: up to
# 32 one slot a lane of a warp, past it the sorted list in the output row.
MAX_SHARED_BYTES = 232448  # H100: 227 KB of dynamic shared memory a block

# The exact kernel (csrc/ballquery.cu): kQ queries a warp, at most 16 warps a
# block, the cloud staged in tiles of up to 4096 points (48 KB), two buffers.
QUERIES_PER_WARP = 4
MAX_WARPS = 16
TILE_POINTS = 4096


def plan(b: int, n: int, m: int, num_sms: int) -> tuple[int, int]:
    """``(warps, tile)`` of the exact kernel for ``b`` clouds of ``n`` points
    and ``m`` queries each on a card of ``num_sms`` SMs.

    The largest block of up to ``MAX_WARPS`` warps that still leaves a block
    for every other SM: each block stages the cloud once, so fewer, larger
    blocks read it fewer times (on the H100 at SA1, B=8, 128 blocks of 16
    warps ran faster than 256 of 8). The tile is the cloud up to
    ``TILE_POINTS`` points, in one buffer when it holds the cloud and two
    otherwise. Raises ``ValueError`` for a shape no route takes.
    """
    if b <= 0 or n <= 0 or m <= 0 or num_sms <= 0:
        raise ValueError(f"the ball query needs B, N, M > 0, got B={b}, N={n}, M={m}")
    warps = MAX_WARPS
    while warps > 1 and 2 * b * -(-m // (warps * QUERIES_PER_WARP)) < num_sms:
        warps //= 2
    if b * -(-m // (warps * QUERIES_PER_WARP)) >= 2**31:
        raise ValueError(f"the ball query's grid of {b} clouds x {m} queries is too large")
    return warps, min(TILE_POINTS, (n + 31) // 32 * 32)


def shared_bytes(n: int, tile: int) -> int:
    """The exact kernel's dynamic shared memory: one or two tiles of (x, y, z)."""
    return (1 if n <= tile else 2) * tile * 12


def check_plan(n: int, route: tuple[int, int]) -> tuple[int, int]:
    """A forced ``(warps, tile)``; raises unless the kernel takes it."""
    warps, tile = route
    if not 1 <= warps <= MAX_WARPS or tile < 32 or tile % 32 or shared_bytes(n, tile) > MAX_SHARED_BYTES:
        raise ValueError(f"not a ball query route: {route}")
    return warps, tile


# The windowed ball query over sorted tiles (csrc/window_bq.cuh): a block
# takes tm / split sorted queries of a tile, one warp a query at a time.
TILES_MAX_WARPS = 16
TILES_WARPS_PER_SM = 32  # the warps in flight on each SM the split aims at
TILES_MIN_QUERIES = 8  # the fewest queries a block of a split tile takes
# The round-1 kernel splits further: at SA2 and SA3 (32 and 16 tiles at B=16)
# 8 queries a block leave fewer blocks than SMs.
WINDOWED_MIN_QUERIES = 4
SM_SHARED_BYTES = 233472  # H100: 228 KB of shared memory an SM, 1 KB of it kept a block


@functools.cache
def tiles_plan(b: int, m: int, tm: int, w: int, num_sms: int, min_queries: int = TILES_MIN_QUERIES) -> tuple[int, int]:
    """``(split, warps)`` of the windowed ball query for ``b`` clouds of ``m``
    sorted queries in tiles of ``tm``, a ``w``-column window, on a card of
    ``num_sms`` SMs: each tile's queries go to ``split`` blocks of ``warps``
    warps.

    One block a tile leaves most of the card idle (64 blocks at SA1, B=8), so
    the plan doubles the split, from 1, until the blocks' warps would give
    each SM ``TILES_WARPS_PER_SM`` (counting only the blocks an SM holds at
    once: its shared memory takes ``SM_SHARED_BYTES // (16 w + 1024)`` staged
    windows), or until a block would take fewer than ``min_queries``
    queries; ``warps`` is one a query up to ``TILES_MAX_WARPS``. Each block
    stages only the columns its queries can reach, so a larger split stages
    more columns in all: the plan stops at the first split that fills the
    card. Raises ``ValueError`` for a shape no route takes.
    """
    if b <= 0 or tm <= 0 or m <= 0 or m % tm or w <= 0 or num_sms <= 0:
        raise ValueError(f"the windowed ball query needs whole tiles, got B={b}, M={m}, tm={tm}, w={w}")
    tiles = m // tm
    staged = w * 16 <= MAX_SHARED_BYTES
    split = 1
    while True:
        warps = min(TILES_MAX_WARPS, tm // split)
        held = min(SM_SHARED_BYTES // (16 * w + 1024) if staged else 32, 64 // warps)
        in_flight = min(b * tiles * split, held * num_sms) * warps
        halves = tm % (2 * split) == 0 and tm // (2 * split) >= min_queries
        if in_flight >= TILES_WARPS_PER_SM * num_sms or not halves:
            return check_tiles_plan(m, tm, (split, warps))
        split *= 2


def check_tiles_plan(m: int, tm: int, route: tuple[int, int]) -> tuple[int, int]:
    """A forced ``(split, warps)`` of the windowed ball query; raises unless
    the kernel takes it: ``split`` dividing the tile, 1 to 32 warps, a grid of
    fewer than 2**31 blocks a cloud."""
    split, warps = route
    if split < 1 or tm % split or not 1 <= warps <= 32 or (m // tm) * split >= 2**31:
        raise ValueError(f"not a windowed ball query route for tiles of {tm}: {route}")
    return split, warps


@functools.cache
def windowed_plan(b: int, n: int, m: int, tm: int, w: int, num_sms: int) -> tuple[int, int]:
    """``(split, warps)`` of the round-1 windowed ball query: ``tiles_plan``
    for blocks that stage up to ``min(n, w)`` columns, down to
    ``WINDOWED_MIN_QUERIES`` queries a block. A fitting tile's block needs at
    most ``w``; a falling-back tile's block whose x-span is wider reads it
    where it lies. (A buffer of ``min(n, 2 w)`` columns staged more of those
    spans but held 3 blocks an SM where ``w`` holds 4, and SA1 ran slower on
    the H100: PERF.md.)"""
    return tiles_plan(b, m, tm, min(n, w), num_sms, WINDOWED_MIN_QUERIES)


@functools.cache
def num_sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ball_query(
    xyz1: torch.Tensor, xyz2: torch.Tensor, radius: float, nsample: int, route=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """xyz1 (B, N, 3) dataset, xyz2 (B, M, 3) queries, float32 CUDA.

    Returns idx (B, M, nsample) int32 and cnt (B, M) int32. ``route``: a
    forced ``(warps, tile)``, else ``plan``'s.
    """
    require(xyz1, "xyz1", torch.float32, (None, None, 3))
    b, n, _ = xyz1.shape
    require(xyz2, "xyz2", torch.float32, (b, None, 3))
    m = xyz2.shape[1]
    if b == 0 or n == 0 or m == 0 or nsample <= 0:
        raise ValueError(f"ball_query needs non-empty inputs, got {tuple(xyz1.shape)}, {tuple(xyz2.shape)}, nsample={nsample}")
    require_int32_range("ball_query", b, n, 3)
    require_int32_range("ball_query", b, m, nsample)
    if route is None:
        route = plan(b, n, m, num_sms(xyz1.device.index))
    warps, tile = check_plan(n, route)
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz1.device)
    cnt = torch.empty((b, m), dtype=torch.int32, device=xyz1.device)
    device, stream = stream_of(xyz1)
    launch(
        "ball_query", "ballquery", "pn2_ball_query",
        [PTR, PTR, INT, INT, INT, FLOAT, INT, INT, INT, PTR, PTR, INT, PTR],
        xyz1.data_ptr(), xyz2.data_ptr(), b, n, m, squared_radius(radius), nsample, warps, tile,
        idx.data_ptr(), cnt.data_ptr(), device, stream,
    )
    return idx, cnt


def check_tiles(xs, perm, qs, lo, nsample: int, w: int) -> tuple[int, int, int, int]:
    """Checks shared by the two windowed ball-query kernels; returns (b, n, m, tm)."""
    require(xs, "xs", torch.float32, (None, None, 3))
    b, n, _ = xs.shape
    require(perm, "perm", torch.int32, (b, n))
    require(qs, "qs", torch.float32, (b, None, 3))
    m = qs.shape[1]
    require(lo, "lo", torch.int32, (b, None))
    t = lo.shape[1]
    if b == 0 or t == 0 or m % t or b > 65535:
        raise ValueError(f"{m} sorted queries do not fill {t} tiles of {b} clouds")
    if nsample <= 0:
        raise ValueError(f"the windowed ball query needs nsample > 0, got {nsample}")
    if not 0 < w <= n or w % 32:
        raise ValueError(f"window {w} must be a multiple of 32 in (0, N={n}]")
    require_int32_range("ball_query_tiles", b, m, nsample)
    require_int32_range("ball_query_tiles", b, n, 3)
    return b, n, m, m // t


def tiles_route(xs, m: int, tm: int, w: int, route=None) -> tuple[int, int]:
    """The ``(split, warps)`` a tiles wrapper launches with: ``tiles_plan``'s
    for ``xs``'s card, or the forced ``route``."""
    b = xs.shape[0]
    if route is None:
        return tiles_plan(b, m, tm, w, num_sms(xs.device.index))
    return check_tiles_plan(m, tm, tuple(route))


def ball_query_tiles(xs, perm, qs, lo, radius: float, nsample: int, w: int, route=None):
    """The windowed ball query over sorted tiles; see ``ops.core.ball_query_tiles``.

    ``lo + w`` must not pass N (the calibrated op clips it so); the kernel
    reads the window where it lies. ``route``: a forced ``(split, warps)``,
    else ``tiles_plan``'s. Returns idx (B, M, nsample), cnt (B, M) int32 in
    sorted query order.
    """
    b, n, m, tm = check_tiles(xs, perm, qs, lo, nsample, w)
    split, warps = tiles_route(xs, m, tm, w, route)
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=xs.device)
    cnt = torch.empty((b, m), dtype=torch.int32, device=xs.device)
    device, stream = stream_of(xs)
    launch(
        "ball_query_sliced", "ballquery", "pn2_ball_query_tiles",
        [PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT, FLOAT, INT, PTR, PTR, INT, PTR],
        xs.data_ptr(), perm.data_ptr(), qs.data_ptr(), lo.data_ptr(), b, n, m, tm, w, split, warps,
        squared_radius(radius), nsample, idx.data_ptr(), cnt.data_ptr(), device, stream,
    )
    return idx, cnt


def ball_query_window_tiles(xyz1, xs, perm, qs, lo, hi, radius: float, nsample: int, w: int, route=None):
    """The round-1 windowed ball query over sorted tiles, each tile with
    ``hi - lo > w`` scanning the whole sorted cloud; see
    ``ops.core.ball_query_window_tiles``, whose signature it keeps (the
    kernel reads no ``xyz1``). Any ``nsample`` and any window width.
    ``route``: a forced ``(split, warps)``, else ``windowed_plan``'s. Returns
    idx (B, M, nsample), cnt (B, M) int32 in sorted query order.
    """
    require(xyz1, "xyz1", torch.float32, (None, None, 3))
    b, n, _ = xyz1.shape
    require(xs, "xs", torch.float32, (b, n, 3))
    require(perm, "perm", torch.int32, (b, n))
    require(qs, "qs", torch.float32, (b, None, 3))
    m = qs.shape[1]
    require(lo, "lo", torch.int32, (b, None))
    t = lo.shape[1]
    require(hi, "hi", torch.int32, (b, t))
    if b == 0 or n == 0 or t == 0 or m % t:
        raise ValueError(f"{m} sorted queries do not fill {t} tiles of {b} clouds of {n} points")
    if nsample <= 0 or w <= 0:
        raise ValueError(f"the windowed ball query needs nsample > 0 and a window > 0, got {nsample}, {w}")
    require_int32_range("ball_query_windowed", b, m, nsample)
    require_int32_range("ball_query_windowed", b, n, 3)
    tm = m // t
    if route is None:
        split, warps = windowed_plan(b, n, m, tm, w, num_sms(xs.device.index))
    else:
        split, warps = check_tiles_plan(m, tm, tuple(route))
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=xs.device)
    cnt = torch.empty((b, m), dtype=torch.int32, device=xs.device)
    device, stream = stream_of(xs)
    launch(
        "ball_query_windowed", "ballquery", "pn2_ball_query_windowed",
        [PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT, FLOAT, INT, PTR, PTR, INT, PTR],
        xs.data_ptr(), perm.data_ptr(), qs.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        b, n, m, tm, w, split, warps, squared_radius(radius), nsample,
        idx.data_ptr(), cnt.data_ptr(), device, stream,
    )
    return idx, cnt

