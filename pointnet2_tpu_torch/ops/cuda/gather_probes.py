"""Wrappers of ``csrc/gather_probes.cu``: the five gather design probes.

Each computes the SA grouping gather, ``out[b, r] = points[b, idx[b, r]]``
(the port's ``ops.core.group_points``), differing in how the indices reach
the row copies:

- ``gather_rows`` replaces ``tools/gather_probe.py:40`` (``_gather_kernel``
  via ``gather_pallas``): tiles of ``min(ROW_TILE, R)`` rows, each index read
  from device memory. Plain version: ``tools.gather_probe.gather_rows_plain``.
- ``gather_rows_staged`` replaces ``tools/sp_gather_probe.py:75``
  (``_sp_row_kernel`` via ``sp_row_gather``): tiles of ``STAGED_TILE`` rows,
  the tile's indices staged in shared memory first. Plain version:
  ``tools.sp_gather_probe.sp_row_plain``.
- ``gather_window_staged`` replaces ``tools/sp_gather_probe.py:137``
  (``_sp_win_kernel`` via ``sp_win_gather``): x-sorted points, each tile of
  ``tm`` queries copying its rows by relative index out of its window (two
  ``w``-row blocks), each tile's span of rows staged whole by ``splits``
  blocks (``plan``). Plain version: ``tools.sp_gather_probe.sp_win_plain``.
- ``gather_fused_idx`` replaces ``tools/fused_gather_probe.py:46``
  (``_vmem_idx_gather_kernel`` via ``vmem_idx_gather``): tiles of
  ``min(FUSED_TILE, R)`` rows, the indices written on chip, emitted as a
  second output and read back for the copies. Plain version:
  ``tools.fused_gather_probe.fused_idx_plain``.
- ``gather_window_out4d`` replaces ``tools/wingather_out4d_probe.py:186``
  (``_window_gather_kernel_4d`` in ``project_group_sliced_4d``): row 9's
  window gather through the tile's two ``wblk``-row blocks, the same kernel
  routine as ``gather_window_staged``, taking the window rows ``rel`` the
  caller computed; its (B, M, K, C) output is the flat rows' memory. Plain
  version: ``tools.wingather_out4d_probe.window_out4d_plain``.

The row width's route (16-byte vectors or floats, lanes a row) is row 9's
``wingather.plan``; the window gathers stage by TMA bulk copies where it
gives 16-byte vectors, by a cooperative load where it gives floats. Each
wrapper takes CUDA tensors only, counts its launches in ``LAUNCHES`` under
its own name, and raises on a shape its kernel does not take. Every index
must lie in [0, N): the kernels do not check it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from pointnet2_tpu_torch.ops.cuda.ballquery import MAX_SHARED_BYTES, num_sms
from pointnet2_tpu_torch.ops.cuda.common import INT, PTR, launch, require, require_int32_range, stream_of
from pointnet2_tpu_torch.ops.cuda.wingather import planned_route

ROW_TILE = 2048  # gather_probe.py:38, tr = min(2048, R)
STAGED_TILE = 4096  # sp_gather_probe.py:66
FUSED_TILE = 4096  # fused_gather_probe.py:50, tr = min(4096, R)
WINDOW_UNROLLS = (4, 8, 16)  # csrc/gather_probes.cu's instantiations, the probe's sweep
# The window gathers' plan (csrc/gather_probes.cu `span_gather`).
BLOCKS_PER_SM = 2  # blocks a wave: two of 80 KB fit an SM at the probes' shapes
MAX_SPLITS = 32  # blocks a tile at most: each one reads the tile's indices
CHUNK_BYTES = 16384  # a chunk of the ring
RING_STAGES = 3  # chunks in flight a block on the bulk route: the kernel's kRingStages
MAX_SPAN_PICKS = 65536  # picks a tile: 16-bit positions in the block's lists
MAX_CLOUDS = 65535  # the grid's y
STAGING = "a cooperative load and __syncthreads()"  # how gather_rows_staged stages a tile's indices


def row_tiles(what: str, r: int, tr: int) -> int:
    """The number of tiles of ``tr`` rows in ``r``; raises unless they are
    whole (the TPU grid ``r // tr`` would drop the rest, or be empty)."""
    if tr <= 0 or r % tr:
        raise ValueError(f"{what}: {r} rows are not a whole number of tiles of {tr}")
    return r // tr


class SpanPlan(NamedTuple):
    """The window gathers' launch: ``splits`` blocks a tile, each staging its
    part of the tile's span in chunks of ``chunk_rows`` rows through a ring of
    ``stages``."""

    splits: int
    chunk_rows: int
    stages: int


@functools.cache
def plan(tiles: int, c: int, bulk: bool, sms: int) -> SpanPlan:
    """The window gathers' ``SpanPlan`` for ``tiles`` (tile, cloud) pairs of
    rows of ``c`` floats on a card of ``sms`` SMs: ``splits`` so that tiles *
    splits is at most ``BLOCKS_PER_SM`` blocks an SM (one wave; at least 1, at
    most ``MAX_SPLITS``), chunks of ``CHUNK_BYTES`` (at least a row), and a
    ring of ``RING_STAGES`` for the bulk route (``bulk``: rows of 16-byte
    vectors), one chunk at a time for the cooperative one."""
    if tiles <= 0 or c <= 0 or sms <= 0:
        raise ValueError(f"the window gathers' plan needs tiles, channels and SMs, got {tiles}, {c}, {sms}")
    splits = min(MAX_SPLITS, max(1, BLOCKS_PER_SM * sms // tiles))
    return SpanPlan(splits, max(1, CHUNK_BYTES // (c * 4)), RING_STAGES if bulk else 1)


def window_shared_bytes(c: int, trk: int, chunk_rows: int, stages: int) -> int:
    """Shared memory of a window gather's block (``span_shared_bytes`` in the
    source): the ring of ``stages`` chunks of ``chunk_rows`` rows of C floats
    (rounded up to 16 bytes), an mbarrier a chunk, 128 bytes of counts, and 8
    bytes a pick of the tile's trk (its cloud row and two 16-bit lists)."""
    ring = -(-stages * chunk_rows * c * 4 // 16) * 16
    return ring + stages * 8 + 128 + trk * 8


def span_route(what: str, points: torch.Tensor, tiles: int, trk: int) -> tuple[bool, int, SpanPlan]:
    """``(vec, lanes, SpanPlan)`` of a window gather: row 9's ``(vec, lanes)``
    (``vec``: the bulk route) and ``plan``'s launch; raises where the picks
    are past 16-bit positions or the block's shared memory does not fit."""
    c = points.shape[2]
    vec, lanes = planned_route(points)
    span = plan(tiles, c, vec, num_sms(points.device.index))
    if trk > MAX_SPAN_PICKS:
        raise ValueError(f"{what}: {trk} picks a tile, past the {MAX_SPAN_PICKS} its 16-bit lists hold")
    need = window_shared_bytes(c, trk, span.chunk_rows, span.stages)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"{what}: a ring of {span.stages} x {span.chunk_rows} rows of {c} floats and {trk} picks take "
            f"{need} bytes, past a block's {MAX_SHARED_BYTES}"
        )
    return vec, lanes, span


def _rows(kernel: str, symbol: str, points: torch.Tensor, idx: torch.Tensor, tile, emit: bool):
    """The three row kernels: ``tile(R)`` rows a block; ``emit``: the fused
    kernel's second output."""
    require(points, "points", torch.float32, (None, None, None))
    b, n, c = points.shape
    require(idx, "idx", torch.int32, (b, None))
    r = idx.shape[1]
    tr = tile(r)
    row_tiles(kernel, r, tr)
    if not 0 < b <= MAX_CLOUDS or n == 0 or c == 0:
        raise ValueError(f"{kernel} needs 1 <= B <= {MAX_CLOUDS}, points and channels, got {tuple(points.shape)}")
    require_int32_range(kernel, n, c)
    require_int32_range(kernel, tr, c)
    vec, lanes = planned_route(points)
    out = torch.empty((b, r, c), dtype=torch.float32, device=points.device)
    idx_out = torch.empty((b, 1, r), dtype=torch.int32, device=points.device) if emit else None
    device, stream = stream_of(points)
    argtypes = [PTR, PTR, INT, INT, INT, INT, INT, INT, INT, PTR] + ([PTR] if emit else []) + [INT, PTR]
    args = [points.data_ptr(), idx.data_ptr(), b, n, r, tr, c, int(vec), lanes, out.data_ptr()]
    args += ([idx_out.data_ptr()] if emit else []) + [device, stream]
    launch(kernel, "gather_probes", symbol, argtypes, *args)
    return (out, idx_out) if emit else out


def gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C) float32, idx (B, R) int32 -> (B, R, C): row
    ``idx[b, r]`` of cloud b, in tiles of ``min(ROW_TILE, R)`` rows whose
    indices are read from device memory."""
    return _rows("gather_rows", "pn2_gather_rows", points, idx, lambda r: min(ROW_TILE, r), emit=False)


def gather_rows_staged(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The same function in tiles of ``STAGED_TILE`` rows (R a multiple of
    it), each tile's indices staged in shared memory before its copies."""
    return _rows("gather_rows_staged", "pn2_gather_rows_staged", points, idx, lambda r: STAGED_TILE, emit=False)


def gather_fused_idx(points: torch.Tensor, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The same function in tiles of ``min(FUSED_TILE, R)`` rows, returning
    the rows (B, R, C) and the indices (B, 1, R) as the block wrote them out
    of its on-chip copy, which its copies read."""
    return _rows("gather_fused_idx", "pn2_gather_fused_idx", points, idx, lambda r: min(FUSED_TILE, r), emit=True)


def relative_indices(idx: torch.Tensor, kblk: torch.Tensor, w: int, tm: int) -> torch.Tensor:
    """``idx`` (B, M, K) relative to each tile's window, ``idx - kblk * w``
    as (B, T, tm * K) int32 (``sp_win_gather``'s ``rel``, ``:111-112``)."""
    b, m, k = idx.shape
    return (idx.reshape(b, m // tm, tm * k) - kblk[:, :, None] * w).to(torch.int32).contiguous()


def gather_window_staged(points: torch.Tensor, idx: torch.Tensor, kblk: torch.Tensor, w: int, tm: int,
                         unroll: int) -> torch.Tensor:
    """points (B, N, C) float32 sorted by x, idx (B, M, K) int32 with each
    tile of ``tm`` queries' indices in [kblk * w, kblk * w + 2w), kblk (B, M
    / tm) int32 -> (B, M * K, C): row ``idx`` of each cloud, through the
    tile's window (blocks kblk and min(kblk + 1, N / w - 1)) by relative
    index, each tile's span staged by ``plan``'s ``splits`` blocks, ``unroll``
    rows in flight a thread."""
    if unroll not in WINDOW_UNROLLS:
        raise ValueError(f"gather_window_staged takes unroll in {WINDOW_UNROLLS}, got {unroll}")
    require(points, "points", torch.float32, (None, None, None))
    b, n, c = points.shape
    require(idx, "idx", torch.int32, (b, None, None))
    m, k = idx.shape[1:]
    if tm <= 0 or m % tm or w <= 0 or n % w or m == 0 or k == 0:
        raise ValueError(
            f"gather_window_staged needs M a multiple of tm and N of w, got M={m}, tm={tm}, N={n}, w={w}, K={k}"
        )
    t, trk = m // tm, tm * k
    require(kblk, "kblk", torch.int32, (b, t))
    if not 0 < b <= MAX_CLOUDS or c == 0:
        raise ValueError(f"gather_window_staged needs 1 <= B <= {MAX_CLOUDS} and channels, got {tuple(points.shape)}")
    require_int32_range("gather_window_staged", n, c)
    require_int32_range("gather_window_staged", trk, c)
    vec, lanes, span = span_route("gather_window_staged", points, b * t, trk)
    rel = relative_indices(idx, kblk, w, tm)
    out = torch.empty((b, m * k, c), dtype=torch.float32, device=points.device)
    device, stream = stream_of(points)
    launch(
        "gather_window_staged", "gather_probes", "pn2_gather_window_staged",
        [PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT, INT, INT, INT, INT, PTR, INT, PTR],
        points.data_ptr(), rel.data_ptr(), kblk.data_ptr(), b, n, c, t, trk, w, int(vec), lanes, unroll,
        span.splits, span.chunk_rows, out.data_ptr(), device, stream,
    )
    return out


def gather_window_out4d(zp_s: torch.Tensor, rel: torch.Tensor, kblk: torch.Tensor, wblk: int, tm: int,
                        k: int) -> torch.Tensor:
    """zp_s (B, N, C) float32 in x-sorted order, rel (B, T, 1, tm * K) int32
    window rows in [0, 2 wblk), kblk (B, T) int32 -> (B, T * tm, K, C):
    ``out[b, t * tm + q, s] = S[rel[b, t, 0, q * K + s]]``, S being blocks
    kblk and min(kblk + 1, N / wblk - 1) of ``wblk`` rows of ``zp_s[b]``:
    ``gather_window_staged``'s routine at the probe's unroll of 4."""
    require(zp_s, "zp_s", torch.float32, (None, None, None))
    b, n, c = zp_s.shape
    require(rel, "rel", torch.int32, (b, None, 1, None))
    t, trk = rel.shape[1], rel.shape[3]
    if tm <= 0 or k <= 0 or trk != tm * k or t == 0:
        raise ValueError(
            f"gather_window_out4d needs whole tiles of tm * K = {tm} * {k} relative indices, got rel "
            f"{tuple(rel.shape)}"
        )
    if wblk <= 0 or n % wblk:
        raise ValueError(f"gather_window_out4d needs N a multiple of wblk, got N={n}, wblk={wblk}")
    require(kblk, "kblk", torch.int32, (b, t))
    if not 0 < b <= MAX_CLOUDS or c == 0:
        raise ValueError(f"gather_window_out4d needs 1 <= B <= {MAX_CLOUDS} and channels, got {tuple(zp_s.shape)}")
    require_int32_range("gather_window_out4d", n, c)
    require_int32_range("gather_window_out4d", trk, c)
    vec, lanes, span = span_route("gather_window_out4d", zp_s, b * t, trk)
    out = torch.empty((b, t * tm, k, c), dtype=torch.float32, device=zp_s.device)
    device, stream = stream_of(zp_s)
    launch(
        "gather_window_out4d", "gather_probes", "pn2_gather_window_out4d",
        [PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT, INT, INT, INT, INT, PTR, INT, PTR],
        zp_s.data_ptr(), rel.data_ptr(), kblk.data_ptr(), b, n, c, t, tm, k, wblk, int(vec), lanes,
        span.splits, span.chunk_rows, out.data_ptr(), device, stream,
    )
    return out
