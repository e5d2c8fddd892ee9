"""Wrappers of ``csrc/wingather.cu``: the fused calibrated grouping of the SA1 eval path.

- ``ball_query_tiles_pos`` replaces ``pointnet2_tpu/ops/pallas/wingather.py:54``
  (``_bq_sliced_pos_kernel``); its plain version is
  ``ops.core.ball_query_tiles_pos``.
- ``window_gather`` replaces ``wingather.py:98`` (``_window_gather_kernel``);
  its plain version is ``ops.core.window_gather``. ``plan`` picks its route
  from the row width and the source's alignment: 16-byte vectors or floats,
  and the lanes a row.

The whole op is the PyTorch composite ``ops.core.project_group_sliced``
(the sorts, window starts, certificate and the projection ``sorted_inputs @
w0 + b0``, as the JAX wrapper leaves them to XLA), which ``ops`` runs over
the two kernels' ``pn2`` operators (and the exact ball query's on the static
fallback).
"""

from __future__ import annotations

import functools

import torch

from pointnet2_tpu_torch.ops.core import squared_radius
from pointnet2_tpu_torch.ops.cuda.ballquery import check_tiles, tiles_route
from pointnet2_tpu_torch.ops.cuda.common import (
    FLOAT, INT, PTR, launch, require, require_int32_range, stream_of,
)

GATHER_LANES = (1, 2, 4, 8, 16)  # lanes a row the kernel is built for (csrc/wingather.cu)


def ball_query_tiles_pos(xs, perm, qs, lo, radius: float, nsample: int, w: int, route=None):
    """``ops.cuda.ball_query_tiles`` that also returns each pick's window
    column: idx, pos (B, M, nsample) and cnt (B, M) int32, sorted query order.
    ``route``: a forced ``(split, warps)``, else ``tiles_plan``'s."""
    b, n, m, tm = check_tiles(xs, perm, qs, lo, nsample, w)
    split, warps = tiles_route(xs, m, tm, w, route)
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=xs.device)
    pos = torch.empty((b, m, nsample), dtype=torch.int32, device=xs.device)
    cnt = torch.empty((b, m), dtype=torch.int32, device=xs.device)
    device, stream = stream_of(xs)
    launch(
        "ball_query_sliced_pos", "wingather", "pn2_ball_query_tiles_pos",
        [PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT, FLOAT, INT, PTR, PTR, PTR, INT, PTR],
        xs.data_ptr(), perm.data_ptr(), qs.data_ptr(), lo.data_ptr(), b, n, m, tm, w, split, warps,
        squared_radius(radius), nsample, idx.data_ptr(), pos.data_ptr(), cnt.data_ptr(),
        device, stream,
    )
    return idx, pos, cnt


@functools.cache
def plan(c: int, aligned: bool) -> tuple[bool, int]:
    """``(vec, lanes)`` of the window gather for rows of C floats: 16-byte
    vectors where C is a multiple of 4 and the source is 16-byte aligned
    (``aligned``; the output always is), else single floats; lanes a row the
    smallest power of two that covers the row's vectors, at most 16 (wider
    rows loop over their channels)."""
    if c <= 0:
        raise ValueError(f"window_gather needs C > 0, got {c}")
    vec = aligned and c % 4 == 0
    vectors = c // 4 if vec else c
    return vec, min(GATHER_LANES[-1], 1 << (vectors - 1).bit_length())


def check_route(route, vec_ok: bool) -> tuple[bool, int]:
    """A forced ``(vec, lanes)`` as the kernel takes it: 16-byte vectors
    only where the rows allow them (``vec_ok``), lanes one of ``GATHER_LANES``."""
    vec, lanes = route
    if (vec and not vec_ok) or lanes not in GATHER_LANES:
        raise ValueError(f"not a window_gather route for these rows: {route} (16-byte vectors allowed: {vec_ok})")
    return bool(vec), int(lanes)


def planned_route(zp_s: torch.Tensor, route=None) -> tuple[bool, int]:
    """The ``(vec, lanes)`` the wrapper launches ``zp_s`` with: ``plan``'s,
    or the forced ``route``."""
    vec, lanes = plan(zp_s.shape[2], zp_s.data_ptr() % 16 == 0)
    return (vec, lanes) if route is None else check_route(route, vec)


def window_gather(zp_s: torch.Tensor, lo: torch.Tensor, pos: torch.Tensor, route=None) -> torch.Tensor:
    """zp_s (B, N, C) float32, lo (B, T) and pos (B, M, K) int32 -> (B, M, K, C):
    row ``lo[b, tile(q)] + pos[b, q, s]`` of ``zp_s[b]``, M/T queries a tile.
    ``route``: a forced ``(vec, lanes)``, else ``planned_route``'s.

    Every ``lo + pos`` must lie in [0, N): the windowed ball query's columns do.
    """
    require(zp_s, "zp_s", torch.float32, (None, None, None))
    b, n, c = zp_s.shape
    require(lo, "lo", torch.int32, (b, None))
    require(pos, "pos", torch.int32, (b, None, None))
    t = lo.shape[1]
    m, k = pos.shape[1:]
    if t == 0 or m % t or c == 0:
        raise ValueError(f"{m} queries do not fill {t} tiles, or no channels (C={c})")
    require_int32_range("window_gather", b, n, c)
    require_int32_range("window_gather", b, t)
    require_int32_range("window_gather", m // t, k, c)  # offsets inside a tile
    vec, lanes = planned_route(zp_s, route)
    out = torch.empty((b, m, k, c), dtype=torch.float32, device=zp_s.device)
    if out.numel() == 0:
        return out
    device, stream = stream_of(zp_s)
    launch(
        "window_gather", "wingather", "pn2_window_gather",
        [PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT, INT, PTR, INT, PTR],
        zp_s.data_ptr(), lo.data_ptr(), pos.data_ptr(), b, n, m, m // t, k, c,
        int(vec), lanes, out.data_ptr(), device, stream,
    )
    return out

