"""Label densification: sparse predictions -> full-resolution clouds.

Counterpart of ``pointnet2_tpu/ops/densify.py``, and of the reference's
InterpolateLabelWithColor op (tf_ops/tf_interpolate.cpp:52-185): for every
dense point, find the k nearest sparse (predicted) points and take the
majority label, ties broken by which label first reaches the max count in
ascending-distance order, then map labels to the fixed 9-color palette.

Engines of ``densify_labels``:

- ``native``: the C++ grid kNN with OpenMP (``native/densify.cpp``, built by
  ``pointnet2_tpu_torch.native``), for dense clouds of 10^8 points on the host;
- ``scipy``: cKDTree and the same vote in NumPy;
- ``auto``: native, then scipy where the native library cannot be built, as
  the JAX function does;
- ``device``: ``densify_labels_device``, the k nearest by ``ops.knn``, on a
  CUDA device row 3's kernel (``csrc/knn.cu`` ``pn2_knn``, which replaces the
  JAX engine's brute-force top-k, ``:103-172``), then the vote and the
  color lookup in PyTorch on the device (the JAX package computes them
  outside any Pallas kernel as well). It never falls back: a CUDA failure
  raises;
- ``sharded``: the device engine with the dense cloud split over the
  devices of a mesh (``parallel.sharded_ops.densify_labels_sharded``; by
  default every visible card).

The device engine's plain version is the same function with
``impl="torch"`` (``ops.core.knn``), which sorts a (queries, sparse) matrix
and so takes the dense cloud in chunks of ``PLAIN_PAIRS`` pairs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.infer import resolve_device
from pointnet2_tpu_torch.native import densify_labels_native
from pointnet2_tpu_torch.utils.colors import LABEL_COLORS_UINT8

ENGINES = ("auto", "native", "scipy", "device", "sharded")
# Dense points a kNN launch takes: 4M queries keep each chunk's (Q, k)
# distances and indices at 96 MB (k = 3) and its copy from the host at 48 MB
# for clouds of any size, and Q * k inside the kernel's int32 indexing.
MAX_DEVICE_CHUNK = 1 << 22
# (query, sparse point) pairs a chunk of the plain version sorts.
PLAIN_PAIRS = 1 << 25


def _majority_in_distance_order(neighbor_labels: np.ndarray) -> np.ndarray:
    """(Q, k) labels sorted by ascending distance -> (Q,) majority labels.

    Vectorized first-to-reach-max-count majority (tf_interpolate.cpp:100-112).
    """
    q, k = neighbor_labels.shape
    best_count = np.zeros(q, np.int32)
    best_label = neighbor_labels[:, 0].copy()
    for i in range(k):
        lab = neighbor_labels[:, i]
        c = np.zeros(q, np.int32)
        for j in range(i + 1):
            c += neighbor_labels[:, j] == lab
        better = c > best_count
        best_count = np.where(better, c, best_count)
        best_label = np.where(better, lab, best_label)
    return best_label


def majority_vote(neighbor_labels: torch.Tensor) -> torch.Tensor:
    """``_majority_in_distance_order`` on a device: (Q, k) labels in ascending
    distance order -> (Q,) labels, the first to reach the largest count."""
    k = neighbor_labels.shape[1]
    best_count = torch.zeros(neighbor_labels.shape[0], dtype=torch.int32, device=neighbor_labels.device)
    best_label = neighbor_labels[:, 0]
    for i in range(k):
        lab = neighbor_labels[:, i]
        count = (neighbor_labels[:, : i + 1] == lab[:, None]).sum(dim=1, dtype=torch.int32)
        better = count > best_count
        best_count = torch.where(better, count, best_count)
        best_label = torch.where(better, lab, best_label)
    return best_label


def device_chunk(k: int, m: int, kernel: bool) -> int:
    """Dense points a chunk: for the kernel ``MAX_DEVICE_CHUNK``, and fewer where
    Q * k would pass its int32 outputs; for the plain version ``PLAIN_PAIRS``
    pairs with the ``m`` sparse points."""
    if kernel:
        return min(MAX_DEVICE_CHUNK, (2**31 - 1) // k)
    return max(1, PLAIN_PAIRS // m)


def densify_labels_device(
    sparse_points,
    sparse_labels,
    dense_points,
    knn: int = 3,
    device: Optional[str | torch.device] = None,
    impl: Optional[str] = None,
    chunk: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Densification on ``device``: (labels (N,) int32, colors (N, 3) uint8) there.

    ``sparse_points`` (M, 3), ``sparse_labels`` (M,) in [0, 9) and
    ``dense_points`` (N, 3) are tensors or arrays; what is not on ``device``
    goes there, the dense cloud a chunk at a time. ``device=None`` means CUDA,
    which must be present. ``impl`` goes to ``ops.knn``: None runs row 3's
    kernel on a CUDA device, ``"torch"`` the plain version. ``chunk``: dense
    points a kNN call (default ``device_chunk``).
    """
    dev = resolve_device(device)
    sparse = torch.as_tensor(sparse_points).to(dev, torch.float32).contiguous()
    labels = torch.as_tensor(sparse_labels).to(dev).reshape(-1)
    dense = torch.as_tensor(dense_points)
    m, n = sparse.shape[0], dense.shape[0]
    if m == 0 or labels.shape[0] != m:
        raise ValueError(f"densify needs a non-empty sparse cloud with a label a point, got {m} points, "
                         f"{labels.shape[0]} labels")
    k = int(min(knn, m))
    step = chunk or device_chunk(k, m, ops._use_kernel(impl, sparse) and sparse.is_cuda)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    for start in range(0, n, step):
        chunk = dense[start : start + step].to(dev, torch.float32).contiguous()
        _, idx = ops.knn(sparse[None], chunk[None], k, impl=impl)
        out[start : start + chunk.shape[0]] = majority_vote(labels[idx[0].long()])
    colors = torch.as_tensor(LABEL_COLORS_UINT8, device=dev)[out.long()]
    return out, colors


def densify_labels(
    sparse_points: np.ndarray,
    sparse_labels: np.ndarray,
    dense_points: np.ndarray,
    knn: int = 3,
    engine: str = "auto",
    device: Optional[str | torch.device] = None,
    mesh: Optional[Sequence[str | torch.device]] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (dense_labels (N,) int32, dense_colors (N, 3) uint8) on the host.

    ``knn`` is clamped to the sparse count. ``device`` is the ``device``
    engine's (None: CUDA, which must be present); ``mesh`` the ``sharded``
    engine's devices (None: every visible card).
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown densify engine {engine!r}, expected one of {ENGINES}")
    sparse_points = np.ascontiguousarray(sparse_points, np.float32)
    sparse_labels = np.ascontiguousarray(sparse_labels, np.int32)
    dense_points = np.ascontiguousarray(dense_points, np.float32)
    knn = int(min(knn, len(sparse_points)))

    if engine in ("auto", "native"):
        out = densify_labels_native(sparse_points, sparse_labels, dense_points, knn)
        if out is not None:
            return out
        if engine == "native":
            raise RuntimeError("native engine requested but the native library could not be built or refused k")

    if engine == "device":
        labels = densify_labels_device(sparse_points, sparse_labels, dense_points, knn, device)[0].cpu().numpy()
        return labels, LABEL_COLORS_UINT8[labels]

    if engine == "sharded":
        from pointnet2_tpu_torch.parallel.sharded_ops import densify_labels_sharded

        labels = densify_labels_sharded(sparse_points, sparse_labels, dense_points, knn, mesh)
        return labels, LABEL_COLORS_UINT8[labels]

    from scipy.spatial import cKDTree

    tree = cKDTree(sparse_points)
    _, idx = tree.query(dense_points, k=knn, workers=-1)
    if knn == 1:
        idx = idx[:, None]
    labels = _majority_in_distance_order(sparse_labels[idx])
    return labels.astype(np.int32), LABEL_COLORS_UINT8[labels]
