"""Wrapper of ``csrc/fps.cu``: farthest point sampling with centroids.

Replaces ``pointnet2_tpu/ops/pallas/fps.py:89`` (``_fps_fused_kernel``). The
plain version is ``ops.core.fps_centroids``.
"""

from __future__ import annotations

import torch

from pointnet2_tpu_torch.ops.cuda.common import INT, PTR, launch, require, stream_of

# The running minimum (4 bytes a point) must fit in one block's shared memory.
MAX_POINTS = 56 * 1024


def fps_centroids(xyz: torch.Tensor, npoint: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 3) float32 CUDA -> ((B, npoint) int32 indices, (B, npoint, 3) rows)."""
    require(xyz, "xyz", torch.float32, (None, None, 3))
    b, n, _ = xyz.shape
    if not 0 < npoint <= n or b == 0:
        raise ValueError(f"fps_centroids needs 0 < npoint <= N and B > 0, got {npoint}, {tuple(xyz.shape)}")
    if n > MAX_POINTS:
        raise ValueError(f"fps_centroids kernel takes at most {MAX_POINTS} points, got {n}")
    idx = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    out = torch.empty((b, npoint, 3), dtype=torch.float32, device=xyz.device)
    threads = min(1024, (n + 31) // 32 * 32)
    device, stream = stream_of(xyz)
    launch(
        "fps_centroids", "fps", "pn2_fps_centroids",
        [PTR, INT, INT, INT, PTR, PTR, INT, INT, PTR],
        xyz.data_ptr(), b, n, npoint, idx.data_ptr(), out.data_ptr(), threads, device, stream,
    )
    return idx, out

