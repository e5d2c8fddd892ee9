"""Point-set operators: public API with dispatch by device.

Each operator on the eval and train paths has a plain PyTorch version in
``ops.core`` and a CUDA kernel in ``ops.cuda``. ``impl`` picks between them:

- ``None`` (default): the kernel for a CUDA tensor, the plain version for a
  CPU tensor;
- ``"torch"``: the plain version on either device, for comparisons;
- ``"cuda"``: the kernel, which raises on a CPU tensor.

There is no fallback: a kernel that fails to build or launch raises.
``group_points`` and ``interpolation_weights`` have no kernel (the JAX
package leaves them to XLA as well). ``three_interpolate`` is differentiable
through its own backward (``three_interpolate_grad``, by the same ``impl``),
``fps_centroids`` gives ``xyz`` the gather's gradient, and
``project_group_leaf`` has the zero-input-gradient backward; see
``ops.autograd``.
"""

from __future__ import annotations

import torch

from pointnet2_tpu_torch.ops import autograd, core, cuda
from pointnet2_tpu_torch.ops.core import gather_points, group_points, interpolation_weights

IMPLS = (None, "torch", "cuda")

__all__ = [
    "fps_centroids",
    "ball_query",
    "knn",
    "three_nn",
    "three_interpolate",
    "three_interpolate_grad",
    "project_group_leaf",
    "gather_points",
    "group_points",
    "interpolation_weights",
]


def _use_kernel(impl: str | None, t: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}, expected one of {IMPLS}")
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    return impl == "cuda" or (impl is None and t.is_cuda)


def fps_centroids(xyz, npoint: int, impl: str | None = None):
    """FPS indices and centroids: (B, N, 3) -> ((B, npoint) int32, (B, npoint, 3))."""
    use_kernel = _use_kernel(impl, xyz)
    if xyz.requires_grad and torch.is_grad_enabled():
        return autograd.FpsCentroids.apply(xyz, npoint, use_kernel)
    if use_kernel:
        return cuda.fps_centroids(xyz, npoint)
    return core.fps_centroids(xyz, npoint)


def ball_query(xyz1, xyz2, radius: float, nsample: int, impl: str | None = None):
    """First ``nsample`` in-ball points in dataset order: idx (B, M, nsample), cnt (B, M)."""
    if _use_kernel(impl, xyz1):
        return cuda.ball_query(xyz1, xyz2, radius, nsample)
    return core.ball_query(xyz1, xyz2, radius, nsample)


def knn(xyz1, xyz2, k: int, impl: str | None = None):
    """k exact nearest neighbours, squared distances ascending: (dist2, idx)."""
    if _use_kernel(impl, xyz1):
        return cuda.knn(xyz1, xyz2, k)
    return core.knn(xyz1, xyz2, k)


def three_nn(xyz1, xyz2, impl: str | None = None):
    """3-NN of each xyz1 point among xyz2, squared distances: (dist2, idx)."""
    if _use_kernel(impl, xyz1):
        return cuda.three_nn(xyz1, xyz2)
    return core.three_nn(xyz1, xyz2)


def three_interpolate(points, idx, weight, impl: str | None = None):
    """Inverse-distance blend of three rows: (B, M, C), (B, N, 3) x2 -> (B, N, C)."""
    return autograd.ThreeInterpolate.apply(points, idx, weight, _use_kernel(impl, points))


def three_interpolate_grad(g, idx, weight, m: int, impl: str | None = None):
    """The ``points`` cotangent of ``three_interpolate``: g (B, N, C) -> (B, m, C)."""
    if _use_kernel(impl, g):
        return cuda.three_interpolate_grad(g, idx, weight, m)
    return core.three_interpolate_grad(g, idx, weight, m)


def project_group_leaf(inputs, w, b, idx):
    """``group_points(inputs @ w + b, idx)`` for an input cloud that needs no gradient."""
    return autograd.ProjectGroupLeaf.apply(inputs, w, b, idx)
