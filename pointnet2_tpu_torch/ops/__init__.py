"""Point-set operators: public API with dispatch by device.

Each operator on the eval and train paths has a plain PyTorch version in
``ops.core`` and a CUDA kernel in ``ops.cuda``. ``impl`` picks between them:

- ``None`` (default): the ``pn2`` operator (``ops.library``), whose
  dispatcher runs the kernel for a CUDA tensor and the plain version for a
  CPU tensor;
- ``"torch"``: the plain version on either device, for comparisons;
- ``"cuda"``: the ``pn2`` operator, which raises here on a CPU tensor.

There is no fallback: a kernel that fails to build or launch raises. The
calibrated-window operators and the round-1 windowed ball query are
composites in PyTorch around ``pn2`` operators, so ``torch.export`` keeps
each kernel as one node of the exported graph.
``ball_query`` also takes ``impl="windowed"``: the round-1 windowed ball
query (x-sorted windows, each tile falling back to the exact scan on its own),
through the ``pn2`` operators on either device.
``group_points``, ``interpolation_weights``, ``prob_sample`` and the
full-row ``selection_sort``/``select_top_k`` have no kernel (the JAX package
leaves them to XLA as well). ``three_interpolate`` is differentiable
through its own backward (``three_interpolate_grad``, by the same ``impl``),
``fps_centroids`` gives ``xyz`` the gather's gradient, and
``project_group_leaf`` has the zero-input-gradient backward; see
``ops.autograd``.

The calibrated-window operators (``*_calibrated``, ``ops/__init__.py:114-219``
of the JAX package) return a 0-d bool ``ok`` on the device beside their
outputs, and never fall back on their own when it is False. Unlike the JAX
package's XLA path, which ignores the window off the TPU, the plain versions
compute the windowed function and its real certificate, on any device.
``calibrate`` picks the windows from sample clouds.
"""

from __future__ import annotations

import torch

from pointnet2_tpu_torch.ops import autograd, core, cuda, library  # noqa: F401  (library registers torch.ops.pn2)
from pointnet2_tpu_torch.ops.core import (
    gather_points,
    group_points,
    interpolation_weights,
    prob_sample,
    select_top_k,
    selection_sort,
)

IMPLS = (None, "torch", "cuda")
pn2 = torch.ops.pn2  # registered by ops.library

__all__ = [
    "farthest_point_sample",
    "fps_centroids",
    "prob_sample",
    "ball_query",
    "knn",
    "three_nn",
    "three_interpolate",
    "three_interpolate_grad",
    "project_group_leaf",
    "ball_query_calibrated",
    "project_group_calibrated",
    "knn_calibrated",
    "three_nn_calibrated",
    "gather_points",
    "group_points",
    "interpolation_weights",
    "selection_sort",
    "select_top_k",
]


def _use_kernel(impl: str | None, t: torch.Tensor, *differentiable: torch.Tensor) -> bool:
    """Whether the call goes through the ``pn2`` operators (``impl`` None or
    "cuda"); "cuda" on a CPU tensor raises.

    The operators have no Autograd kernel, so ``impl=None`` on a CPU tensor
    calls the plain version by name when autograd records through one of
    ``differentiable`` (the inputs a float output depends on): that keeps
    their gradients. The kernels give none, as before the operators.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}, expected one of {IMPLS}")
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    if impl is None and not t.is_cuda and torch.is_grad_enabled():
        return not any(x.requires_grad for x in differentiable)
    return impl != "torch"


def farthest_point_sample(xyz, npoint: int, impl: str | None = None):
    """FPS indices alone: (B, N, 3) -> (B, npoint) int32."""
    if _use_kernel(impl, xyz):
        return pn2.farthest_point_sample(xyz, int(npoint))
    return core.farthest_point_sample(xyz, npoint)


def fps_centroids(xyz, npoint: int, impl: str | None = None):
    """FPS indices and centroids: (B, N, 3) -> ((B, npoint) int32, (B, npoint, 3))."""
    use_kernel = _use_kernel(impl, xyz)
    if xyz.requires_grad and torch.is_grad_enabled():
        return autograd.FpsCentroids.apply(xyz, npoint, use_kernel)
    if use_kernel:
        return pn2.fps_centroids(xyz, int(npoint))
    return core.fps_centroids(xyz, npoint)


def ball_query(xyz1, xyz2, radius: float, nsample: int, impl: str | None = None):
    """First ``nsample`` in-ball points in dataset order: idx (B, M, nsample), cnt (B, M).

    ``impl="windowed"`` takes the round-1 windowed ball query with its default
    window (``core.ball_query_windowed``): the same outputs bit for bit.
    """
    if impl == "windowed":
        return core.ball_query_windowed(
            xyz1, xyz2, float(radius), int(nsample), exact=pn2.ball_query, tiles=pn2.ball_query_window_tiles
        )
    if _use_kernel(impl, xyz1):
        return pn2.ball_query(xyz1, xyz2, float(radius), int(nsample))
    return core.ball_query(xyz1, xyz2, radius, nsample)


def knn(xyz1, xyz2, k: int, impl: str | None = None):
    """k exact nearest neighbours, squared distances ascending: (dist2, idx)."""
    if _use_kernel(impl, xyz1, xyz1, xyz2):
        return pn2.knn(xyz1, xyz2, int(k))
    return core.knn(xyz1, xyz2, k)


def three_nn(xyz1, xyz2, impl: str | None = None):
    """3-NN of each xyz1 point among xyz2, squared distances: (dist2, idx)."""
    if _use_kernel(impl, xyz1, xyz1, xyz2):
        return pn2.knn(xyz2, xyz1, 3)
    return core.three_nn(xyz1, xyz2)


def three_interpolate(points, idx, weight, impl: str | None = None, precision: str | None = None, *, skip=None):
    """Inverse-distance blend of three rows: (B, M, C), (B, N, 3) x2 -> (B, N, C).

    The result has the points' type: the three rows are widened to float32,
    weighted and summed in float32, and rounded once. ``precision``, as in
    the JAX package's ``ops.three_interpolate``: ``None``/``"highest"``
    multiplies by the float32 weights; ``"default"`` rounds them to the
    points' type first (bfloat16 points: bfloat16 weights, the bf16 modes'
    setting). ``skip`` (B, N, C1), the feature-propagation module's own
    keyword: the result is ``torch.cat([blend, skip], -1)`` in the promoted
    type of the two, (B, N, C + C1), which the kernel writes in one pass;
    the skip gets the matching slice of the gradient.
    """
    return autograd.ThreeInterpolate.apply(points, idx, weight, _use_kernel(impl, points), skip, precision)


def three_interpolate_grad(g, idx, weight, m: int, impl: str | None = None, precision: str | None = None,
                           dtype=None):
    """The ``points`` cotangent of ``three_interpolate``: g (B, N, C) -> (B, m, C)
    in ``dtype``, the forward's points' type (default: g's)."""
    if _use_kernel(impl, g, g, weight):
        return pn2.three_interpolate_grad(g, idx, weight, int(m), precision, dtype)
    return core.three_interpolate_grad(g, idx, weight, m, precision, dtype)


def project_group_leaf(inputs, w, b, idx):
    """``group_points(inputs @ w + b, idx)`` for an input cloud that needs no gradient."""
    return autograd.ProjectGroupLeaf.apply(inputs, w, b, idx)


def ball_query_calibrated(xyz1, xyz2, radius: float, nsample: int, window: int, impl: str | None = None):
    """Ball query through calibrated x-windows: ``(idx, cnt, ok)``; with ``ok``
    True the outputs equal ``ball_query``'s. See ``core.ball_query_sliced``."""
    if _use_kernel(impl, xyz1):
        return core.ball_query_sliced(
            xyz1, xyz2, float(radius), int(nsample), window, exact=pn2.ball_query, tiles=pn2.ball_query_tiles
        )
    return core.ball_query_sliced(xyz1, xyz2, radius, nsample, window)


def project_group_calibrated(
    inputs, w0, b0, xyz, new_xyz, radius: float, nsample: int, window: int, impl: str | None = None
):
    """``group_points(inputs @ w0 + b0, ball_query(...))`` through calibrated
    x-windows: ``(grouped, idx, cnt, qperm, inv_q, ok)``. When ``qperm`` is not
    None, ``grouped`` alone is in x-sorted query order. See
    ``core.project_group_sliced``. The kernel path gives ``w0``/``b0`` no
    gradient through the gather: it is for the eval forward."""
    if _use_kernel(impl, xyz, inputs, w0, b0):
        return core.project_group_sliced(
            inputs, w0, b0, xyz, new_xyz, float(radius), int(nsample), window,
            exact=pn2.ball_query, tiles=pn2.ball_query_tiles_pos, gather=pn2.window_gather,
        )
    return core.project_group_sliced(inputs, w0, b0, xyz, new_xyz, radius, nsample, window)


def knn_calibrated(xyz1, xyz2, k: int, window: int, impl: str | None = None):
    """kNN through calibrated x-windows: ``(dist2, idx, ok)``; with ``ok`` True
    equal to ``knn``. See ``core.knn_sliced``."""
    if _use_kernel(impl, xyz1, xyz1, xyz2):
        return core.knn_sliced(xyz1, xyz2, int(k), window, exact=pn2.knn, tiles=pn2.knn_tiles)
    return core.knn_sliced(xyz1, xyz2, k, window)


def three_nn_calibrated(xyz1, xyz2, window: int, impl: str | None = None):
    """3-NN of each xyz1 point among xyz2 through calibrated x-windows: ``(dist2, idx, ok)``."""
    return knn_calibrated(xyz2, xyz1, 3, window, impl)
