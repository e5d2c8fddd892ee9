"""Wrappers of ``csrc/interpolate.cu``: three_interpolate, forward and backward.

``three_interpolate`` replaces ``pointnet2_tpu/ops/pallas/interpolate.py:48``
(``_ti_kernel``); its plain version is ``ops.core.three_interpolate``, or,
with ``skip``, ``ops.core.three_interpolate_concat``: the feature-propagation
concat written by the same kernel, a warp an output row. ``plan`` picks the
vector width from the shape, the element size and the alignment of the rows.
``three_interpolate_grad`` replaces ``interpolate.py:112`` (``_ti_bwd_kernel``);
its plain version is ``ops.core.three_interpolate_grad``, whose order of
summation it keeps, so the two agree bit for bit where PyTorch sums
serially. The two are joined into one differentiable operator in
``ops.autograd``.

Features are float32 or bfloat16 (the bf16 precision modes), each tensor on
its own: the kernels widen bfloat16 to float32, sum in float32 and round
once to the result's type, as the plain versions do, so nothing is cast
before a launch. A launch with any bfloat16 feature tensor counts as
``three_interpolate_bf16`` or ``three_interpolate_grad_bf16``, the kernels'
bfloat16 instances; float32 ones as before.
"""

from __future__ import annotations

import functools

import torch

from pointnet2_tpu_torch.ops.core import PRECISIONS
from pointnet2_tpu_torch.ops.cuda.common import (
    INT, LONG, PTR, launch, require, require_int32_range, stream_of,
)

THREADS = 256  # the forward's block
GRAD_SLOTS = 64  # keys a destination row's bucket holds (csrc/interpolate.cu kSlots)
FEATURE_DTYPES = (torch.float32, torch.bfloat16)


def _aligned(t: torch.Tensor, nbytes: int = 16) -> bool:
    return t.data_ptr() % nbytes == 0


def round_weights(precision: str | None, points_dtype: torch.dtype) -> bool:
    """Whether the weights are rounded to bfloat16 before the blend: under
    ``"default"`` for bfloat16 points (``ops.core.blend_weight``)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return precision == "default" and points_dtype == torch.bfloat16


@functools.cache
def plan(c: int, c1: int, points_aligned: bool, skip_vec_ok: bool, elem: int = 4) -> tuple[bool, bool]:
    """``(vec, skip_vec)`` of the forward for C interpolated and C1 skip
    channels (C1 = 0 without a skip) of points ``elem`` bytes wide (4 for
    float32, 2 for bfloat16).

    16-byte loads and stores where the source and the output rows are 16-byte
    aligned (``points`` aligned, C and C + C1 multiples of 16 / ``elem``),
    else one element a lane; the skip copied 16 bytes at a time where
    ``skip_vec_ok`` (the skip of the output's type, its rows aligned) and the
    rows are vector.
    """
    if c <= 0 or c1 < 0:
        raise ValueError(f"three_interpolate needs C > 0 and C1 >= 0, got {c}, {c1}")
    per = 16 // elem
    vec = points_aligned and c % per == 0 and (c + c1) % per == 0
    return vec, vec and c1 > 0 and skip_vec_ok


def _skip_vec_ok(skip: torch.Tensor | None, out_dtype: torch.dtype) -> bool:
    if skip is None or skip.dtype != out_dtype:
        return False
    per = 16 // skip.element_size()
    return (
        _aligned(skip) and skip.shape[2] % per == 0 and skip.stride(0) % per == 0 and skip.stride(1) % per == 0
    )


def out_dtype(points: torch.Tensor, skip: torch.Tensor | None = None) -> torch.dtype:
    """The forward's result type: the points', or the concat's promoted type."""
    return points.dtype if skip is None else torch.promote_types(points.dtype, skip.dtype)


def planned_route(points: torch.Tensor, skip: torch.Tensor | None = None, route=None) -> tuple[bool, bool]:
    """The ``(vec, skip_vec)`` the wrapper launches ``points`` and ``skip``
    with: ``plan``'s, or the forced ``route`` ``vec``, which may take 4-byte
    accesses where the plan takes 16-byte ones but not the other way round."""
    c1 = 0 if skip is None else skip.shape[2]
    planned = plan(
        points.shape[2], c1, _aligned(points), _skip_vec_ok(skip, out_dtype(points, skip)), points.element_size()
    )
    if route is None:
        return planned
    if route and not planned[0]:
        raise ValueError(f"not a three_interpolate route for these rows: vec={route} (the plan's {planned[0]})")
    return bool(route), bool(route) and planned[1]


def three_interpolate(
    points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor, skip: torch.Tensor | None = None,
    route=None, precision: str | None = None,
) -> torch.Tensor:
    """points (B, M, C) float32 or bfloat16, idx (B, N, 3) int32, weight (B, N, 3) float32 -> (B, N, C).

    With ``skip`` (B, N, C1) float32 or bfloat16, returns (B, N, C + C1): the
    blend, then the skip features, as ``torch.cat([blend, skip], -1)`` in the
    promoted type. The blend has the points' type (rounded once from float32,
    then widened if the row is float32). The skip is read through its batch
    and row strides (FP4's is a channel slice of the input cloud); one whose
    channels are not adjacent is copied to a contiguous tensor here,
    explicitly. The indices are not range-checked here (that would cost a
    pass and a sync); they come from ``three_nn``, which only returns indices
    below M. ``route``: a forced ``vec`` (16-byte accesses or not), else
    ``plan``'s. ``precision`` ``"default"`` rounds the weights to bfloat16
    for bfloat16 points (``round_weights``).
    """
    require(points, "points", FEATURE_DTYPES, (None, None, None))
    b, m, c = points.shape
    require(idx, "idx", torch.int32, (b, None, 3))
    n = idx.shape[1]
    require(weight, "weight", torch.float32, (b, n, 3))
    round_w = round_weights(precision, points.dtype)
    c1 = 0
    if skip is not None:
        require(skip, "skip", FEATURE_DTYPES, (b, n, None), contiguous=False)
        if skip.stride(2) != 1 or skip.stride(0) < 0 or skip.stride(1) < 0:
            skip = skip.contiguous()
        c1 = skip.shape[2]
    if b == 0 or m == 0 or n == 0 or c == 0:
        raise ValueError(f"three_interpolate needs non-empty inputs, got {tuple(points.shape)}, {tuple(idx.shape)}")
    require_int32_range("three_interpolate", b, n, c + c1)
    require_int32_range("three_interpolate", b, m, c)
    vec, skip_vec = planned_route(points, skip, route)
    dtype = out_dtype(points, skip)
    out = torch.empty((b, n, c + c1), dtype=dtype, device=points.device)
    bf16 = torch.bfloat16 in (points.dtype, dtype, None if skip is None else skip.dtype)
    device, stream = stream_of(points)
    launch(
        "three_interpolate_bf16" if bf16 else "three_interpolate", "interpolate", "pn2_three_interpolate",
        [PTR, PTR, PTR, INT, INT, INT, INT, PTR, INT, PTR, LONG, LONG, INT, INT, INT, INT, INT, INT, INT, INT,
         PTR],
        points.data_ptr(), idx.data_ptr(), weight.data_ptr(), b, m, n, c, out.data_ptr(), c + c1,
        None if skip is None else skip.data_ptr(), 0 if skip is None else skip.stride(0),
        0 if skip is None else skip.stride(1), c1, int(points.dtype == torch.bfloat16),
        int(skip is not None and skip.dtype == torch.bfloat16), int(round_w), int(vec), int(skip_vec), THREADS,
        device, stream,
    )
    return out


def grad_vec(g: torch.Tensor, c: int) -> bool:
    """Whether the backward reads ``g`` and writes ``dpoints`` 4 channels a
    lane in one access (16 bytes of float32, 8 of bfloat16): C and g's batch
    and row strides multiples of 4, g aligned to the access (FP1-FP3's
    cotangent slices are; FP4's rows of 131 elements are not)."""
    return c % 4 == 0 and _aligned(g, 4 * g.element_size()) and g.stride(0) % 4 == 0 and g.stride(1) % 4 == 0


def three_interpolate_grad(
    g: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor, m: int, precision: str | None = None,
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """g (B, N, C) float32 or bfloat16, idx (B, N, 3) int32, weight (B, N, 3) float32 -> dpoints (B, M, C).

    ``dpoints`` has ``dtype``, the forward's points' type (default: g's),
    each element summed in float32 and rounded once. ``g`` is a cotangent
    handed over by autograd and is often a channel slice of a wider tensor
    (the interpolated half of a concat), so it alone may be non-contiguous.
    The kernel reads it through its batch and row strides as long as its
    channels lie next to each other; any other layout (a transposed or an
    expanded cotangent) is copied to a contiguous tensor here, explicitly.
    ``idx`` and ``weight`` are the forward's own tensors and must be
    contiguous already. Each element is summed in the plain version's order
    (slot j, then the queries ascending), so the result is the same on every
    run; the pairs' keys, bucketed by destination row, live in ``scratch``.
    ``precision`` ``"default"`` rounds the weights to bfloat16 for a
    bfloat16 ``dtype``, as the forward did.
    """
    require(g, "g", FEATURE_DTYPES, (None, None, None), contiguous=False)
    dtype = g.dtype if dtype is None else dtype
    if dtype not in FEATURE_DTYPES:
        raise ValueError(f"dpoints must be one of {FEATURE_DTYPES}, got {dtype}")
    b, n, c = g.shape
    if g.stride(2) != 1 or g.stride(0) < 0 or g.stride(1) < 0:
        g = g.contiguous()
    require(idx, "idx", torch.int32, (b, n, 3))
    require(weight, "weight", torch.float32, (b, n, 3))
    round_w = round_weights(precision, dtype)
    if b == 0 or m <= 0 or n == 0 or c == 0:
        raise ValueError(f"three_interpolate_grad needs non-empty inputs, got {tuple(g.shape)}, m={m}")
    require_int32_range("three_interpolate_grad", b, n, c)
    require_int32_range("three_interpolate_grad", b, m, c)
    require_int32_range("three_interpolate_grad", b, n, 3)
    out = torch.empty((b, m, c), dtype=dtype, device=g.device)
    scratch = torch.empty(b * m * (1 + GRAD_SLOTS), dtype=torch.int32, device=g.device)
    bf16 = torch.bfloat16 in (g.dtype, dtype)
    device, stream = stream_of(g)
    launch(
        "three_interpolate_grad_bf16" if bf16 else "three_interpolate_grad", "interpolate",
        "pn2_three_interpolate_grad",
        [PTR, LONG, LONG, PTR, PTR, INT, INT, INT, INT, PTR, PTR, INT, INT, INT, INT, INT, PTR],
        g.data_ptr(), g.stride(0), g.stride(1), idx.data_ptr(), weight.data_ptr(), b, m, n, c, out.data_ptr(),
        scratch.data_ptr(), int(g.dtype == torch.bfloat16), int(dtype == torch.bfloat16), int(round_w),
        int(grad_vec(g, c)), device, stream,
    )
    return out
