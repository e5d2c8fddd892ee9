"""Wrapper of ``csrc/ballquery.cu``: the exact radius ball query.

Replaces ``pointnet2_tpu/ops/pallas/ballquery.py:42`` (``_ball_query_kernel``).
The plain version is ``ops.core.ball_query``.
"""

from __future__ import annotations

import torch

from pointnet2_tpu_torch.ops.core import squared_radius
from pointnet2_tpu_torch.ops.cuda.common import (
    FLOAT, INT, PTR, launch, require, require_int32_range, stream_of,
)


def ball_query(
    xyz1: torch.Tensor, xyz2: torch.Tensor, radius: float, nsample: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """xyz1 (B, N, 3) dataset, xyz2 (B, M, 3) queries, float32 CUDA.

    Returns idx (B, M, nsample) int32 and cnt (B, M) int32.
    """
    require(xyz1, "xyz1", torch.float32, (None, None, 3))
    b, n, _ = xyz1.shape
    require(xyz2, "xyz2", torch.float32, (b, None, 3))
    m = xyz2.shape[1]
    if b == 0 or n == 0 or m == 0 or nsample <= 0:
        raise ValueError(f"ball_query needs non-empty inputs, got {tuple(xyz1.shape)}, {tuple(xyz2.shape)}, nsample={nsample}")
    require_int32_range("ball_query", b, n, 3)
    require_int32_range("ball_query", b, m, nsample)
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz1.device)
    cnt = torch.empty((b, m), dtype=torch.int32, device=xyz1.device)
    device, stream = stream_of(xyz1)
    launch(
        "ball_query", "ballquery", "pn2_ball_query",
        [PTR, PTR, INT, INT, INT, FLOAT, INT, PTR, PTR, INT, PTR],
        xyz1.data_ptr(), xyz2.data_ptr(), b, n, m, squared_radius(radius), nsample,
        idx.data_ptr(), cnt.data_ptr(), device, stream,
    )
    return idx, cnt
