"""Wrapper of ``csrc/interpolate.cu``: the three_interpolate forward.

Replaces ``pointnet2_tpu/ops/pallas/interpolate.py:48`` (``_ti_kernel``). The
plain version is ``ops.core.three_interpolate``. The backward
(``_ti_bwd_kernel``) belongs to the train step and is not ported yet.
"""

from __future__ import annotations

import torch

from pointnet2_tpu_torch.ops.cuda.common import (
    INT, PTR, launch, require, require_int32_range, stream_of,
)


def three_interpolate(
    points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor
) -> torch.Tensor:
    """points (B, M, C) float32, idx (B, N, 3) int32, weight (B, N, 3) float32 -> (B, N, C).

    The indices are not range-checked here (that would cost a pass and a
    sync); they come from ``three_nn``, which only returns indices below M.
    """
    require(points, "points", torch.float32, (None, None, None))
    b, m, c = points.shape
    require(idx, "idx", torch.int32, (b, None, 3))
    n = idx.shape[1]
    require(weight, "weight", torch.float32, (b, n, 3))
    if b == 0 or m == 0 or n == 0 or c == 0:
        raise ValueError(f"three_interpolate needs non-empty inputs, got {tuple(points.shape)}, {tuple(idx.shape)}")
    require_int32_range("three_interpolate", b, n, c)
    out = torch.empty((b, n, c), dtype=torch.float32, device=points.device)
    device, stream = stream_of(points)
    launch(
        "three_interpolate", "interpolate", "pn2_three_interpolate",
        [PTR, PTR, PTR, INT, INT, INT, INT, PTR, INT, PTR],
        points.data_ptr(), idx.data_ptr(), weight.data_ptr(), b, m, n, c, out.data_ptr(),
        device, stream,
    )
    return out
