"""Wrappers of ``csrc/fps.cu``: farthest point sampling, with and without centroids.

- ``fps_centroids`` replaces ``pointnet2_tpu/ops/pallas/fps.py:89``
  (``_fps_fused_kernel``); its plain version is ``ops.core.fps_centroids``.
- ``farthest_point_sample`` replaces ``fps.py:40`` (``_fps_kernel``), the
  index-only FPS; its plain version is ``ops.core.farthest_point_sample``.
  The same kernel without the row copies: its indices equal
  ``fps_centroids``' bit for bit.
"""

from __future__ import annotations

import torch

from pointnet2_tpu_torch.ops.cuda.common import INT, PTR, launch, require, stream_of

# The running minimum (4 bytes a point) must fit in one block's shared memory.
MAX_POINTS = 56 * 1024


def _check(xyz: torch.Tensor, npoint: int, what: str) -> tuple[int, int, int]:
    """Checks shared by both entries; returns (b, n, threads)."""
    require(xyz, "xyz", torch.float32, (None, None, 3))
    b, n, _ = xyz.shape
    if not 0 < npoint <= n or b == 0:
        raise ValueError(f"{what} needs 0 < npoint <= N and B > 0, got {npoint}, {tuple(xyz.shape)}")
    if n > MAX_POINTS:
        raise ValueError(f"{what} kernel takes at most {MAX_POINTS} points, got {n}")
    return b, n, min(1024, (n + 31) // 32 * 32)


def fps_centroids(xyz: torch.Tensor, npoint: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 3) float32 CUDA -> ((B, npoint) int32 indices, (B, npoint, 3) rows)."""
    b, n, threads = _check(xyz, npoint, "fps_centroids")
    idx = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    out = torch.empty((b, npoint, 3), dtype=torch.float32, device=xyz.device)
    device, stream = stream_of(xyz)
    launch(
        "fps_centroids", "fps", "pn2_fps_centroids",
        [PTR, INT, INT, INT, PTR, PTR, INT, INT, PTR],
        xyz.data_ptr(), b, n, npoint, idx.data_ptr(), out.data_ptr(), threads, device, stream,
    )
    return idx, out


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) float32 CUDA -> (B, npoint) int32 indices."""
    b, n, threads = _check(xyz, npoint, "farthest_point_sample")
    idx = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    device, stream = stream_of(xyz)
    launch(
        "farthest_point_sample", "fps", "pn2_farthest_point_sample",
        [PTR, INT, INT, INT, PTR, INT, INT, PTR],
        xyz.data_ptr(), b, n, npoint, idx.data_ptr(), threads, device, stream,
    )
    return idx
