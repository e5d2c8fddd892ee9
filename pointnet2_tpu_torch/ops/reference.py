"""Pure-NumPy oracle implementations of every point-set operator.

These encode, in plain sequential NumPy, the exact semantics of the
reference's native kernels (cited per-function) and serve as golden oracles
for the JAX/Pallas implementations of the JAX package. They are intentionally
slow and simple.

This is the port's own copy of ``pointnet2_tpu/ops/reference.py`` (the port
imports nothing of the JAX package): the oracles ``tools.parity`` holds every
CUDA kernel against.

Reference kernels modeled:
- farthest point sampling   tf_ops/tf_sampling.cu:111-176
- gather points             tf_ops/tf_sampling.cu:178-206
- prob sample               tf_ops/tf_sampling.cu:7-110
- ball query                tf_ops/tf_grouping.cu:3-43
- group points              tf_ops/tf_grouping.cu:45-90
- knn (selection sort)      tf_ops/tf_grouping.cu:93-136
- three_nn                  tf_ops/tf_interpolate.cpp:213-243
- three_interpolate         tf_ops/tf_interpolate.cpp:305-330
- label densification       tf_ops/tf_interpolate.cpp:71-115
"""

from __future__ import annotations

import numpy as np


def farthest_point_sample_np(xyz: np.ndarray, npoint: int) -> np.ndarray:
    """Iterative max-min FPS. Starts from index 0 (like the CUDA kernel).

    Args:
        xyz: (B, N, 3) float array.
        npoint: number of points to select.
    Returns:
        (B, npoint) int32 indices into N.
    """
    b, n, _ = xyz.shape
    idx = np.zeros((b, npoint), dtype=np.int32)
    for bi in range(b):
        pts = xyz[bi].astype(np.float32)
        min_d = np.full((n,), np.float32(1e38), dtype=np.float32)
        old = 0
        idx[bi, 0] = 0
        for j in range(1, npoint):
            d = np.sum((pts - pts[old]) ** 2, axis=-1)
            min_d = np.minimum(min_d, d)
            old = int(np.argmax(min_d))
            idx[bi, j] = old
    return idx


def gather_points_np(points: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """points: (B, N, C), idx: (B, M) -> (B, M, C)."""
    b = points.shape[0]
    return np.stack([points[i, idx[i]] for i in range(b)], axis=0)


def prob_sample_np(cdf_unnormalized: np.ndarray, uniforms: np.ndarray) -> np.ndarray:
    """Sample categorical indices by inverse-CDF binary search.

    cdf_unnormalized: (B, N) nonnegative, cumulative (like cumsum output).
    uniforms: (B, M) in [0, 1).
    Returns (B, M) int32 indices.
    """
    b, n = cdf_unnormalized.shape
    m = uniforms.shape[1]
    out = np.zeros((b, m), dtype=np.int32)
    for i in range(b):
        total = cdf_unnormalized[i, -1]
        q = uniforms[i] * total
        out[i] = np.minimum(
            np.searchsorted(cdf_unnormalized[i], q, side="left"), n - 1
        )
    return out


def ball_query_np(
    xyz1: np.ndarray, xyz2: np.ndarray, radius: float, nsample: int
) -> tuple[np.ndarray, np.ndarray]:
    """Radius ball query with reference semantics.

    For each query point in xyz2, returns the FIRST `nsample` points of xyz1
    (in dataset index order) whose distance is strictly < radius; remaining
    slots are padded with the first in-ball index. Count is capped at nsample.
    Empty balls yield all-zero indices and count 0.

    xyz1: (B, N, 3) dataset, xyz2: (B, M, 3) queries.
    Returns idx (B, M, nsample) int32, cnt (B, M) int32.
    """
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    idx = np.zeros((b, m, nsample), dtype=np.int32)
    cnt = np.zeros((b, m), dtype=np.int32)
    r2 = np.float32(radius) ** 2
    for i in range(b):
        # float32 difference form, matching the CUDA kernel's arithmetic
        # (tf_grouping.cu:28-31) so boundary membership is bit-faithful.
        d2 = np.sum(
            (xyz2[i][:, None, :].astype(np.float32) - xyz1[i][None, :, :].astype(np.float32))
            ** 2,
            axis=-1,
            dtype=np.float32,
        )
        for j in range(m):
            inball = np.nonzero(d2[j] < r2)[0]
            c = min(len(inball), nsample)
            if c > 0:
                idx[i, j, :] = inball[0]
                idx[i, j, :c] = inball[:c]
            cnt[i, j] = c
    return idx, cnt


def group_points_np(points: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """points: (B, N, C), idx: (B, M, K) -> (B, M, K, C)."""
    b = points.shape[0]
    return np.stack([points[i, idx[i]] for i in range(b)], axis=0)


def knn_np(xyz1: np.ndarray, xyz2: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """k nearest neighbors of each query in xyz2 among dataset xyz1.

    Returns (dist2, idx): (B, M, k) squared distances ascending + indices.
    """
    d2 = np.sum(
        (xyz2[:, :, None, :].astype(np.float32) - xyz1[:, None, :, :].astype(np.float32))
        ** 2,
        axis=-1,
        dtype=np.float32,
    )
    order = np.argsort(d2, axis=-1, kind="stable")[:, :, :k]
    dist2 = np.take_along_axis(d2, order, axis=-1)
    return dist2.astype(np.float32), order.astype(np.int32)


def selection_sort_np(dist: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Exact SelectionSort semantics (tf_grouping.cu:93-136).

    Returns FULL (B, M, N) (idx, dist_out) rows: first k positions sorted
    ascending (strict-< selection, ties keep first occurrence), remaining
    positions left in the partially-permuted order of the in-place swaps.
    """
    b, m, n = dist.shape
    out = dist.astype(np.float32).copy()
    outi = np.broadcast_to(np.arange(n, dtype=np.int32), (b, m, n)).copy()
    for bi in range(b):
        for j in range(m):
            row = out[bi, j]
            rowi = outi[bi, j]
            for s in range(min(k, n)):
                mn = s + int(np.argmin(row[s:]))
                if mn != s:
                    row[s], row[mn] = row[mn], row[s]
                    rowi[s], rowi[mn] = rowi[mn], rowi[s]
    return outi, out


def three_nn_np(xyz1: np.ndarray, xyz2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """3 nearest neighbors; returns SQUARED distances (like Open3D KDTree)."""
    return knn_np(xyz2, xyz1, 3)


def three_interpolate_np(
    points: np.ndarray, idx: np.ndarray, weight: np.ndarray
) -> np.ndarray:
    """points: (B, M, C), idx/weight: (B, N, 3) -> (B, N, C)."""
    gathered = group_points_np(points, idx)  # (B, N, 3, C)
    return np.sum(gathered * weight[..., None], axis=2).astype(points.dtype)


def interpolation_weights_np(dist2: np.ndarray) -> np.ndarray:
    """Inverse-distance weights with the reference's 1e-10 clamp.

    Matches util/pointnet_util.py:300-303: d = max(d, 1e-10);
    w = (1/d) / sum(1/d).
    """
    d = np.maximum(dist2, 1e-10)
    inv = 1.0 / d
    return inv / np.sum(inv, axis=-1, keepdims=True)


def densify_labels_np(
    sparse_points: np.ndarray,
    sparse_labels: np.ndarray,
    dense_points: np.ndarray,
    k: int = 3,
) -> np.ndarray:
    """KNN majority-vote label densification.

    For each dense point: find k nearest sparse points (ascending distance)
    and take the majority label; ties broken by which label first reached the
    max count in distance order (matches the C++ unordered_map loop at
    tf_interpolate.cpp:100-112 for k<=3-style small k).
    """
    out = np.zeros((len(dense_points),), dtype=np.int32)
    sp = sparse_points.astype(np.float64)
    for j, p in enumerate(dense_points.astype(np.float64)):
        d2 = np.sum((sp - p) ** 2, axis=-1)
        nn = np.argsort(d2, kind="stable")[:k]
        labels = sparse_labels[nn]
        counts: dict[int, int] = {}
        best_label, best_count = -1, 0
        for lab in labels:
            lab = int(lab)
            counts[lab] = counts.get(lab, 0) + 1
            if counts[lab] > best_count:
                best_label, best_count = lab, counts[lab]
        out[j] = best_label
    return out
