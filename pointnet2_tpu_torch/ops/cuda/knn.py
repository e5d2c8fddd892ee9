"""Wrapper of ``csrc/knn.cu``: exact k nearest neighbours, k <= 16.

Replaces ``pointnet2_tpu/ops/pallas/knn.py:39`` (``_knn_kernel``). The plain
version is ``ops.core.knn``.
"""

from __future__ import annotations

import torch

from pointnet2_tpu_torch.ops.cuda.common import (
    INT, PTR, launch, require, require_int32_range, stream_of,
)

MAX_K = 16


def knn(xyz1: torch.Tensor, xyz2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """xyz1 (B, M, 3) dataset, xyz2 (B, Nq, 3) queries, float32 CUDA.

    Returns dist2 (B, Nq, k) float32 ascending and idx (B, Nq, k) int32.
    """
    require(xyz1, "xyz1", torch.float32, (None, None, 3))
    b, m, _ = xyz1.shape
    require(xyz2, "xyz2", torch.float32, (b, None, 3))
    nq = xyz2.shape[1]
    if not 0 < k <= min(m, MAX_K) or b == 0 or nq == 0:
        raise ValueError(f"knn kernel needs 0 < k <= min(M, {MAX_K}) and non-empty inputs, got k={k}, M={m}, B={b}, Nq={nq}")
    if b > 65535:
        raise ValueError(f"knn kernel takes at most 65535 clouds, got {b}")
    require_int32_range("knn", b, nq, 3)
    dist = torch.empty((b, nq, k), dtype=torch.float32, device=xyz1.device)
    idx = torch.empty((b, nq, k), dtype=torch.int32, device=xyz1.device)
    device, stream = stream_of(xyz1)
    launch(
        "knn", "knn", "pn2_knn",
        [PTR, PTR, INT, INT, INT, INT, PTR, PTR, INT, PTR],
        xyz1.data_ptr(), xyz2.data_ptr(), b, m, nq, k, dist.data_ptr(), idx.data_ptr(),
        device, stream,
    )
    return dist, idx


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3 nearest xyz2 points of each xyz1 point: dist2 (B, N, 3), idx (B, N, 3)."""
    return knn(xyz2, xyz1, 3)
