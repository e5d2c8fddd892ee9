"""Wrappers of ``csrc/interpolate.cu``: three_interpolate, forward and backward.

``three_interpolate`` replaces ``pointnet2_tpu/ops/pallas/interpolate.py:48``
(``_ti_kernel``); its plain version is ``ops.core.three_interpolate``, or,
with ``skip``, ``ops.core.three_interpolate_concat``: the feature-propagation
concat written by the same kernel, a warp an output row. ``plan`` picks the
vector width from the shape and the alignment of the rows.
``three_interpolate_grad`` replaces ``interpolate.py:112`` (``_ti_bwd_kernel``);
its plain version is ``ops.core.three_interpolate_grad``. The two are joined
into one differentiable operator in ``ops.autograd``.
"""

from __future__ import annotations

import functools

import torch

from pointnet2_tpu_torch.ops.cuda.common import (
    INT, LONG, PTR, launch, require, require_int32_range, stream_of,
)

THREADS = 256  # the forward's block


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


@functools.cache
def plan(c: int, c1: int, points_aligned: bool, skip_vec_ok: bool) -> tuple[bool, bool]:
    """``(vec, skip_vec)`` of the forward for C interpolated and C1 skip
    channels (C1 = 0 without a skip).

    16-byte loads and stores where the source and the output rows are 16-byte
    aligned (``points`` aligned, C and C + C1 multiples of 4), else 4-byte
    ones; the skip copied 16 bytes at a time where ``skip_vec_ok`` (the skip's
    rows aligned, C1 a multiple of 4) and the rows are vector.
    """
    if c <= 0 or c1 < 0:
        raise ValueError(f"three_interpolate needs C > 0 and C1 >= 0, got {c}, {c1}")
    vec = points_aligned and c % 4 == 0 and (c + c1) % 4 == 0
    return vec, vec and c1 > 0 and skip_vec_ok


def _skip_vec_ok(skip: torch.Tensor | None) -> bool:
    return (
        skip is not None and _aligned(skip) and skip.shape[2] % 4 == 0
        and skip.stride(0) % 4 == 0 and skip.stride(1) % 4 == 0
    )


def planned_route(points: torch.Tensor, skip: torch.Tensor | None = None, route=None) -> tuple[bool, bool]:
    """The ``(vec, skip_vec)`` the wrapper launches ``points`` and ``skip``
    with: ``plan``'s, or the forced ``route`` ``vec``, which may take 4-byte
    accesses where the plan takes 16-byte ones but not the other way round."""
    c1 = 0 if skip is None else skip.shape[2]
    planned = plan(points.shape[2], c1, _aligned(points), _skip_vec_ok(skip))
    if route is None:
        return planned
    if route and not planned[0]:
        raise ValueError(f"not a three_interpolate route for these rows: vec={route} (the plan's {planned[0]})")
    return bool(route), bool(route) and planned[1]


def three_interpolate(
    points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor, skip: torch.Tensor | None = None,
    route=None,
) -> torch.Tensor:
    """points (B, M, C) float32, idx (B, N, 3) int32, weight (B, N, 3) float32 -> (B, N, C).

    With ``skip`` (B, N, C1) float32, returns (B, N, C + C1): the blend, then
    the skip features, as ``torch.cat([blend, skip], -1)``. The skip is read
    through its batch and row strides (FP4's is a channel slice of the input
    cloud); one whose channels are not adjacent is copied to a contiguous
    tensor here, explicitly. The indices are not range-checked here (that
    would cost a pass and a sync); they come from ``three_nn``, which only
    returns indices below M. ``route``: a forced ``vec`` (16-byte accesses
    or not), else ``plan``'s.
    """
    require(points, "points", torch.float32, (None, None, None))
    b, m, c = points.shape
    require(idx, "idx", torch.int32, (b, None, 3))
    n = idx.shape[1]
    require(weight, "weight", torch.float32, (b, n, 3))
    c1 = 0
    if skip is not None:
        require(skip, "skip", torch.float32, (b, n, None), contiguous=False)
        if skip.stride(2) != 1 or skip.stride(0) < 0 or skip.stride(1) < 0:
            skip = skip.contiguous()
        c1 = skip.shape[2]
    if b == 0 or m == 0 or n == 0 or c == 0:
        raise ValueError(f"three_interpolate needs non-empty inputs, got {tuple(points.shape)}, {tuple(idx.shape)}")
    require_int32_range("three_interpolate", b, n, c + c1)
    require_int32_range("three_interpolate", b, m, c)
    vec, skip_vec = planned_route(points, skip, route)
    out = torch.empty((b, n, c + c1), dtype=torch.float32, device=points.device)
    device, stream = stream_of(points)
    launch(
        "three_interpolate", "interpolate", "pn2_three_interpolate",
        [PTR, PTR, PTR, INT, INT, INT, INT, PTR, INT, PTR, LONG, LONG, INT, INT, INT, INT, INT, PTR],
        points.data_ptr(), idx.data_ptr(), weight.data_ptr(), b, m, n, c, out.data_ptr(), c + c1,
        None if skip is None else skip.data_ptr(), 0 if skip is None else skip.stride(0),
        0 if skip is None else skip.stride(1), c1, int(vec), int(skip_vec), THREADS,
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
