"""Wrappers of ``csrc/wingather.cu``: the fused calibrated grouping of the SA1 eval path.

- ``ball_query_tiles_pos`` replaces ``pointnet2_tpu/ops/pallas/wingather.py:54``
  (``_bq_sliced_pos_kernel``); its plain version is
  ``ops.core.ball_query_tiles_pos``.
- ``window_gather`` replaces ``wingather.py:98`` (``_window_gather_kernel``);
  its plain version is ``ops.core.window_gather``.

``project_group_sliced`` is the whole op with the two kernels (and the exact
ball query on the static fallback): the sorts, window starts, certificate
and the projection ``sorted_inputs @ w0 + b0`` are PyTorch, as the JAX
wrapper leaves them to XLA.
"""

from __future__ import annotations

import torch

from pointnet2_tpu_torch.ops import core
from pointnet2_tpu_torch.ops.core import squared_radius
from pointnet2_tpu_torch.ops.cuda.ballquery import ball_query, check_tiles, tiles_route
from pointnet2_tpu_torch.ops.cuda.common import (
    FLOAT, INT, PTR, launch, require, require_cuda, require_int32_range, stream_of,
)


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


def window_gather(zp_s: torch.Tensor, lo: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """zp_s (B, N, C) float32, lo (B, T) and pos (B, M, K) int32 -> (B, M, K, C):
    row ``lo[b, tile(q)] + pos[b, q, s]`` of ``zp_s[b]``, M/T queries a tile.

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
    out = torch.empty((b, m, k, c), dtype=torch.float32, device=zp_s.device)
    device, stream = stream_of(zp_s)
    launch(
        "window_gather", "wingather", "pn2_window_gather",
        [PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, PTR, INT, PTR],
        zp_s.data_ptr(), lo.data_ptr(), pos.data_ptr(), b, n, m, m // t, k, c,
        out.data_ptr(), device, stream,
    )
    return out


def project_group_sliced(inputs, w0, b0, xyz, new_xyz, radius: float, nsample: int, window: int):
    """``ops.core.project_group_sliced`` with the CUDA kernels:
    ``(grouped, idx, cnt, qperm, inv_q, ok)``."""
    require_cuda(inputs, xyz, new_xyz)
    return core.project_group_sliced(
        inputs, w0, b0, xyz, new_xyz, radius, nsample, window,
        exact=ball_query, tiles=ball_query_tiles_pos, gather=window_gather,
    )
