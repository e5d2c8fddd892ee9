"""Wrappers of ``csrc/knn.cu``: exact k nearest neighbours, k <= 16, whole or windowed.

- ``knn`` replaces ``pointnet2_tpu/ops/pallas/knn.py:39`` (``_knn_kernel``);
  its plain version is ``ops.core.knn``.
- ``knn_tiles`` replaces ``knn.py:133`` (``_knn_sliced_kernel``); its plain
  version is ``ops.core.knn_tiles``. ``knn_sliced`` and ``three_nn_sliced``
  are the whole calibrated op (sorts, window starts and certificate in
  PyTorch) with the two kernels.
"""

from __future__ import annotations

import torch

from pointnet2_tpu_torch.ops import core
from pointnet2_tpu_torch.ops.cuda.ballquery import MAX_WINDOW
from pointnet2_tpu_torch.ops.cuda.common import (
    INT, PTR, launch, require, require_cuda, require_int32_range, stream_of,
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


def knn_tiles(xs, perm, qs, lo, k: int, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The windowed kNN over sorted tiles of 128 queries; see ``ops.core.knn_tiles``.

    Window columns at or past M are padding. Returns dist2 (B, Nq, k) float32
    and idx (B, Nq, k) int32 in sorted query order.
    """
    require(xs, "xs", torch.float32, (None, None, 3))
    b, m, _ = xs.shape
    require(perm, "perm", torch.int32, (b, m))
    require(qs, "qs", torch.float32, (b, None, 3))
    nq = qs.shape[1]
    require(lo, "lo", torch.int32, (b, nq // core.LANES))
    if nq == 0 or nq % core.LANES or b == 0 or b > 65535:
        raise ValueError(f"knn_tiles needs whole tiles of {core.LANES} queries and 1..65535 clouds, got Nq={nq}, B={b}")
    if not 0 < k <= min(m, MAX_K):
        raise ValueError(f"knn_tiles needs 0 < k <= min(M, {MAX_K}), got k={k}, M={m}")
    if not 0 < w <= MAX_WINDOW:
        raise ValueError(f"window {w} must be in (0, {MAX_WINDOW}]")
    require_int32_range("knn_tiles", b, nq, 3)
    require_int32_range("knn_tiles", b, m, 3)
    dist = torch.empty((b, nq, k), dtype=torch.float32, device=xs.device)
    idx = torch.empty((b, nq, k), dtype=torch.int32, device=xs.device)
    device, stream = stream_of(xs)
    launch(
        "knn_sliced", "knn", "pn2_knn_tiles",
        [PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, PTR, PTR, INT, PTR],
        xs.data_ptr(), perm.data_ptr(), qs.data_ptr(), lo.data_ptr(), b, m, nq, w, k,
        dist.data_ptr(), idx.data_ptr(), device, stream,
    )
    return dist, idx


def knn_sliced(xyz1, xyz2, k: int, window: int):
    """``ops.core.knn_sliced`` with the two CUDA kernels: ``(dist2, idx, ok)``."""
    require_cuda(xyz1, xyz2)
    return core.knn_sliced(xyz1, xyz2, k, window, exact=knn, tiles=knn_tiles)


def three_nn_sliced(xyz1, xyz2, window: int):
    """Windowed 3-NN of each xyz1 point among xyz2, with the CUDA kernels: ``(dist2, idx, ok)``."""
    return knn_sliced(xyz2, xyz1, 3, window)
