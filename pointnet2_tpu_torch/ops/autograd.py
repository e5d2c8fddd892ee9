"""The operators that need a gradient of their own, as ``torch.autograd.Function``s.

Counterparts of the JAX package's ``custom_vjp``s:

- ``ThreeInterpolate`` (``pointnet2_tpu/ops/pallas/interpolate.py:187-218``):
  forward and backward are the ``pn2`` operators of the two kernels of
  ``csrc/interpolate.cu`` (``ops.library``: the kernel on a CUDA tensor, the
  plain version on a CPU tensor), or, for ``impl="torch"``, the plain
  versions; ``idx`` gets no gradient, and the
  weight cotangent is computed only when it is asked for (the model detaches
  the distances, so on the train step it never is). With ``skip`` the forward
  also writes the skip features after the blend (the FP concat); the
  backward hands the blend's channels of the cotangent, a slice read in
  place, to the backward kernel and returns the skip's channels, a view, as
  the skip's gradient (in the skip's type). ``precision`` goes to both
  kernels, and ``dpoints`` comes back in the points' type (bfloat16 in the
  bf16 modes), ``dweight`` in the weights'.
- ``FpsCentroids`` (``pointnet2_tpu/ops/pallas/fps.py:218-249``): the kernel's
  centroids are a copy with no autograd path; the backward re-attaches the
  gather's VJP, a scatter-add of the centroid cotangent into
  ``zeros_like(xyz)``. ``ops.fps_centroids`` goes through it only when ``xyz``
  requires a gradient.
- ``ProjectGroupLeaf`` (``pointnet2_tpu/ops/core.py:153-201``):
  ``group_points(inputs @ w + b, idx)`` whose backward gathers the narrow raw
  inputs again and contracts them with the cotangent, and returns exactly
  zero for ``inputs``: only for an input cloud that needs no gradient.

``use_kernel`` (go through the ``pn2`` operators) is decided by the caller
(``ops._use_kernel``); nothing here falls back from a kernel to a plain version.
"""

from __future__ import annotations

import torch

from pointnet2_tpu_torch.ops import core


class ThreeInterpolate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, idx, weight, use_kernel: bool, skip=None, precision=None):
        ctx.use_kernel = use_kernel
        ctx.precision = precision
        ctx.skip_dtype = None if skip is None else skip.dtype
        ctx.save_for_backward(points, idx, weight)
        if use_kernel:
            return torch.ops.pn2.three_interpolate(points, idx, weight, skip, precision)
        if skip is None:
            return core.three_interpolate(points, idx, weight, precision)
        return core.three_interpolate_concat(points, idx, weight, skip, precision)

    @staticmethod
    def backward(ctx, g):
        points, idx, weight = ctx.saved_tensors
        c = points.shape[2]
        g_points = g[..., :c]  # the whole of g without a skip
        dpoints = dweight = dskip = None
        if ctx.needs_input_grad[0]:
            m = points.shape[1]
            grad = torch.ops.pn2.three_interpolate_grad if ctx.use_kernel else core.three_interpolate_grad
            dpoints = grad(g_points, idx, weight, m, ctx.precision, points.dtype)
        if ctx.needs_input_grad[2]:
            dweight = core.three_interpolate_weight_grad(g_points, points, idx).to(weight.dtype)
        if len(ctx.needs_input_grad) > 4 and ctx.needs_input_grad[4]:
            dskip = g[..., c:].to(ctx.skip_dtype)
        return dpoints, None, dweight, None, dskip, None


class FpsCentroids(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz, npoint: int, use_kernel: bool):
        fn = torch.ops.pn2.fps_centroids if use_kernel else core.fps_centroids
        idx, new_xyz = fn(xyz, npoint)
        ctx.save_for_backward(idx)
        ctx.xyz_shape = xyz.shape
        ctx.mark_non_differentiable(idx)
        return idx, new_xyz

    @staticmethod
    def backward(ctx, _g_idx, g_new):
        (idx,) = ctx.saved_tensors
        grad = torch.zeros(ctx.xyz_shape, dtype=g_new.dtype, device=g_new.device)
        rows = torch.arange(grad.shape[0], device=grad.device)[:, None]
        grad.index_put_((rows, idx.long()), g_new, accumulate=True)
        return grad, None, None


class ProjectGroupLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inputs, w, b, idx):
        ctx.save_for_backward(inputs, idx)
        return core.project_group_leaf(inputs, w, b, idx)

    @staticmethod
    def backward(ctx, g):
        inputs, idx = ctx.saved_tensors
        gathered = core.group_points(inputs, idx)  # (B, M, K, cin): the narrow rows again
        grad_w = torch.einsum("bmkc,bmkf->cf", gathered, g)
        grad_b = g.sum(dim=(0, 1, 2))
        grad_inputs = torch.zeros_like(inputs) if ctx.needs_input_grad[0] else None
        return grad_inputs, grad_w, grad_b, None
