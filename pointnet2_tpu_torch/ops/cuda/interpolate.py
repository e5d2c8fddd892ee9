"""Wrappers of ``csrc/interpolate.cu``: three_interpolate, forward and backward.

``three_interpolate`` replaces ``pointnet2_tpu/ops/pallas/interpolate.py:48``
(``_ti_kernel``); its plain version is ``ops.core.three_interpolate``.
``three_interpolate_grad`` replaces ``interpolate.py:112`` (``_ti_bwd_kernel``);
its plain version is ``ops.core.three_interpolate_grad``. The two are joined
into one differentiable operator in ``ops.autograd``.
"""

from __future__ import annotations

import torch

from pointnet2_tpu_torch.ops.cuda.common import (
    INT, LONG, PTR, launch, require, require_int32_range, stream_of,
)


def three_interpolate(
    points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor
) -> torch.Tensor:
    """points (B, M, C) float32, idx (B, N, 3) int32, weight (B, N, 3) float32 -> (B, N, C).

    The indices are not range-checked here (that would cost a pass and a
    sync); they come from ``three_nn``, which only returns indices below M.
    """
    require(points, "points", torch.float32, (None, None, None))
    b, m, c = points.shape
    require(idx, "idx", torch.int32, (b, None, 3))
    n = idx.shape[1]
    require(weight, "weight", torch.float32, (b, n, 3))
    if b == 0 or m == 0 or n == 0 or c == 0:
        raise ValueError(f"three_interpolate needs non-empty inputs, got {tuple(points.shape)}, {tuple(idx.shape)}")
    require_int32_range("three_interpolate", b, n, c)
    out = torch.empty((b, n, c), dtype=torch.float32, device=points.device)
    device, stream = stream_of(points)
    launch(
        "three_interpolate", "interpolate", "pn2_three_interpolate",
        [PTR, PTR, PTR, INT, INT, INT, INT, PTR, INT, PTR],
        points.data_ptr(), idx.data_ptr(), weight.data_ptr(), b, m, n, c, out.data_ptr(),
        device, stream,
    )
    return out


def three_interpolate_grad(
    g: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor, m: int
) -> torch.Tensor:
    """g (B, N, C) float32, idx (B, N, 3) int32, weight (B, N, 3) float32 -> dpoints (B, M, C).

    ``g`` is a cotangent handed over by autograd and is often a channel slice
    of a wider tensor (the interpolated half of a concat), so it alone may be
    non-contiguous. The kernel reads it through its batch and row strides as
    long as its channels lie next to each other; any other layout (a
    transposed or an expanded cotangent) is copied to a contiguous tensor
    here, explicitly. ``idx`` and ``weight`` are the forward's own tensors and
    must be contiguous already. The kernel sums with float atomics, so the
    last bits of the result vary from run to run.
    """
    require(g, "g", torch.float32, (None, None, None), contiguous=False)
    b, n, c = g.shape
    if g.stride(2) != 1 or g.stride(0) < 0 or g.stride(1) < 0:
        g = g.contiguous()
    require(idx, "idx", torch.int32, (b, n, 3))
    require(weight, "weight", torch.float32, (b, n, 3))
    if b == 0 or m <= 0 or n == 0 or c == 0:
        raise ValueError(f"three_interpolate_grad needs non-empty inputs, got {tuple(g.shape)}, m={m}")
    require_int32_range("three_interpolate_grad", b, n, c)
    require_int32_range("three_interpolate_grad", b, m, c)
    out = torch.empty((b, m, c), dtype=torch.float32, device=g.device)
    device, stream = stream_of(g)
    launch(
        "three_interpolate_grad", "interpolate", "pn2_three_interpolate_grad",
        [PTR, LONG, LONG, PTR, PTR, INT, INT, INT, INT, PTR, INT, PTR],
        g.data_ptr(), g.stride(0), g.stride(1), idx.data_ptr(), weight.data_ptr(), b, m, n, c, out.data_ptr(),
        device, stream,
    )
    return out
