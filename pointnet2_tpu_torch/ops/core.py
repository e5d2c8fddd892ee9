"""Plain PyTorch versions of the point-set operators.

These are the port's counterparts of ``pointnet2_tpu/ops/core.py``. They run
on any device, serve the CPU, and are what every CUDA kernel in
``ops.cuda`` is held against on the card.

Bit parity with the NumPy oracles rests on two rules:

- squared distances use the float32 difference form, written out as
  ``dx*dx + dy*dy + dz*dz`` in that order. Eager PyTorch rounds each
  elementwise op on its own, so the sum is ``((dx² + dy²) + dz²)`` exactly as
  the oracle computes it; a reduction over the last axis promises no order;
- a ball's squared radius is ``np.float32(radius) ** 2``, a float32 square.

Index outputs are int32, as in the JAX package; they are widened to int64
only where ``torch`` indexing needs it.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def squared_radius(radius: float) -> float:
    """The f32 square of ``float32(radius)``, as the oracle and the kernels use it."""
    return float(np.float32(radius) ** 2)


def _dist2(q: Tensor, d: Tensor) -> Tensor:
    """Squared distances between ``q (..., 3)`` and ``d (..., 3)`` (broadcast), f32 difference form."""
    dx = q[..., 0] - d[..., 0]
    dy = q[..., 1] - d[..., 1]
    dz = q[..., 2] - d[..., 2]
    return dx * dx + dy * dy + dz * dz


def _pairwise_dist2(xyz_q: Tensor, xyz_d: Tensor) -> Tensor:
    """(B, M, N) squared distances between queries (B, M, 3) and dataset (B, N, 3)."""
    return _dist2(xyz_q[:, :, None, :], xyz_d[:, None, :, :])


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def farthest_point_sample(xyz: Tensor, npoint: int) -> Tensor:
    """Farthest point sampling: (B, N, 3) float32 -> (B, npoint) int32.

    Slot 0 is index 0; each step takes the first index of the max of the
    running min squared distance, which starts at 1e38.
    """
    b, n, _ = xyz.shape
    xyz = xyz.float()
    rows = torch.arange(b, device=xyz.device)
    min_d = torch.full((b, n), 1e38, dtype=torch.float32, device=xyz.device)
    idx = torch.zeros((b, npoint), dtype=torch.int64, device=xyz.device)
    old = torch.zeros((b,), dtype=torch.int64, device=xyz.device)
    for j in range(1, npoint):
        sel = xyz[rows, old]  # (B, 3)
        min_d = torch.minimum(min_d, _dist2(xyz, sel[:, None, :]))
        old = torch.argmax(min_d, dim=-1)  # first index of the max
        idx[:, j] = old
    return idx.to(torch.int32)


def gather_points(points: Tensor, idx: Tensor) -> Tensor:
    """points (B, N, C), idx (B, M) -> (B, M, C)."""
    rows = torch.arange(points.shape[0], device=points.device)[:, None]
    return points[rows, idx.long()]


def fps_centroids(xyz: Tensor, npoint: int) -> tuple[Tensor, Tensor]:
    """FPS indices and the chosen rows: ((B, npoint) int32, (B, npoint, 3))."""
    idx = farthest_point_sample(xyz, npoint)
    return idx, gather_points(xyz, idx)


# ---------------------------------------------------------------------------
# Grouping
# ---------------------------------------------------------------------------


def ball_query(
    xyz1: Tensor, xyz2: Tensor, radius: float, nsample: int
) -> tuple[Tensor, Tensor]:
    """First ``nsample`` in-ball dataset points per query, in dataset order.

    xyz1 (B, N, 3) dataset, xyz2 (B, M, 3) queries. Membership is the strict
    ``d2 < float32(radius)**2``. Unused slots repeat the first hit, or 0 for
    an empty ball; the count is capped at ``nsample``. Returns idx
    (B, M, nsample) int32 and cnt (B, M) int32.
    """
    b, n, _ = xyz1.shape
    m = xyz2.shape[1]
    d2 = _pairwise_dist2(xyz2.float(), xyz1.float())
    in_ball = d2 < squared_radius(radius)
    iota = torch.arange(n, device=xyz1.device).expand(b, m, n)
    keys = torch.where(in_ball, iota, n)
    k = min(nsample, n)
    sel = torch.topk(keys, k, dim=-1, largest=False, sorted=True).values
    if k < nsample:
        pad = torch.full((b, m, nsample - k), n, dtype=sel.dtype, device=sel.device)
        sel = torch.cat([sel, pad], dim=-1)
    valid = sel < n
    first = sel[..., :1]
    first = torch.where(first < n, first, 0)
    idx = torch.where(valid, sel, first)
    return idx.to(torch.int32), valid.sum(-1).to(torch.int32)


def group_points(points: Tensor, idx: Tensor) -> Tensor:
    """points (B, N, C), idx (B, M, K) -> (B, M, K, C)."""
    rows = torch.arange(points.shape[0], device=points.device)[:, None, None]
    return points[rows, idx.long()]


def knn(xyz1: Tensor, xyz2: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """k nearest dataset points of each query, ascending; ties to the lowest index.

    xyz1 (B, M, 3) dataset, xyz2 (B, Nq, 3) queries. Returns dist2
    (B, Nq, k) float32 squared distances and idx (B, Nq, k) int32.
    """
    m = xyz1.shape[1]
    if not 0 < k <= m:
        raise ValueError(f"knn needs 0 < k <= M, got k={k}, M={m}")
    d2 = _pairwise_dist2(xyz2.float(), xyz1.float())
    dist, order = torch.sort(d2, dim=-1, stable=True)
    return dist[..., :k].contiguous(), order[..., :k].to(torch.int32)


def three_nn(xyz1: Tensor, xyz2: Tensor) -> tuple[Tensor, Tensor]:
    """3 nearest xyz2 points of each xyz1 point: dist2 (B, N, 3), idx (B, N, 3)."""
    return knn(xyz2, xyz1, 3)


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------


def interpolation_weights(dist2: Tensor) -> Tensor:
    """Inverse-distance weights with the reference's 1e-10 clamp."""
    inv = 1.0 / torch.clamp_min(dist2, 1e-10)
    return inv / inv.sum(dim=-1, keepdim=True)


def _floating(t: Tensor) -> Tensor:
    """float32 and float64 pass (float64 is what ``gradcheck`` feeds); anything else becomes float32."""
    return t if t.dtype in (torch.float32, torch.float64) else t.float()


def three_interpolate(points: Tensor, idx: Tensor, weight: Tensor) -> Tensor:
    """points (B, M, C), idx/weight (B, N, 3) -> (B, N, C), float32.

    ``w0*p[i0] + w1*p[i1] + w2*p[i2]``, summed left to right, as the kernel does.
    """
    g = group_points(_floating(points), idx)  # (B, N, 3, C)
    w = _floating(weight)[..., None]
    return g[:, :, 0] * w[:, :, 0] + g[:, :, 1] * w[:, :, 1] + g[:, :, 2] * w[:, :, 2]


def three_interpolate_grad(g: Tensor, idx: Tensor, weight: Tensor, m: int) -> Tensor:
    """The cotangent of ``three_interpolate``'s ``points``: g (B, N, C) -> (B, M, C).

    ``dpoints[m, c]`` is the sum of ``weight[q, j] * g[q, c]`` over the pairs
    (q, j) with ``idx[q, j] == m`` (ThreeInterpolateGrad): three ``index_add_``
    calls, one per neighbour slot j, in that order.
    """
    g = _floating(g)
    w = _floating(weight).to(g.dtype)
    b, _, c = g.shape
    out = torch.zeros((b, m, c), dtype=g.dtype, device=g.device)
    flat = out.view(b * m, c)
    rows = idx.long() + torch.arange(b, device=g.device)[:, None, None] * m  # (B, N, 3)
    for j in range(3):
        flat.index_add_(0, rows[:, :, j].reshape(-1), (g * w[:, :, j, None]).reshape(-1, c))
    return out


def three_interpolate_weight_grad(g: Tensor, points: Tensor, idx: Tensor) -> Tensor:
    """The cotangent of ``three_interpolate``'s ``weight``: (B, N, 3).

    The dot of ``g[q]`` with each of the three gathered rows.
    """
    return (group_points(_floating(points), idx) * _floating(g)[:, :, None, :]).sum(-1)


def project_group_leaf(inputs: Tensor, w: Tensor, b: Tensor, idx: Tensor) -> Tensor:
    """``group_points(inputs @ w + b, idx)``: (B, N, cin), (cin, f0), (f0,), (B, M, K) -> (B, M, K, f0)."""
    return group_points(inputs @ w + b, idx)
