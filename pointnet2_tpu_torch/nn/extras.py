"""The rest of the reference's layer toolkit: convolutions, a fully connected layer and pools.

An own copy of ``pointnet2_tpu/nn/extras.py`` (tf_util.py:54-665 of the
reference: conv1d/2d/3d, conv2d_transpose, fully_connected, max/avg pool
2d/3d). As there, inputs are channels-last, ``(B, *spatial, C)``, weights are
Xavier-uniform with zero biases, and each layer is followed by an optional
``BatchNorm`` (epsilon 1e-3, the momentum an argument of the call) and a
ReLU (``activation=None`` leaves it out). The BatchNorm follows
``self.training``, as every module of the port does.

Parameters keep flax's names and layouts, so ``convert.state_dict_from_flax``
maps a flax tree onto these modules: ``Conv_0.kernel`` is ``(*kernel_size,
in, out)``, ``ConvTranspose_0.kernel`` ``(kh, kw, in, out)``, ``Dense_0`` an
``nn.Linear`` (its ``weight`` the transposed flax kernel) and
``BatchNorm_0`` the port's ``BatchNorm``.

Padding is flax's: ``"VALID"``, or ``"SAME"``, which gives ``ceil(size /
stride)`` outputs and puts the odd padding row at the end (``lax``'s
``padtype_to_pads``). PyTorch's ``padding="same"`` takes no stride above 1,
so the input is padded with ``F.pad`` first. A flax ``ConvTranspose``
(``transpose_kernel=False``) correlates the stride-dilated, padded input with
the un-flipped kernel; ``F.conv_transpose2d`` correlates with the flipped
kernel, its channels swapped, over padding ``k - 1`` on each side. So the
kernel is flipped and permuted to ``(in, out, kh, kw)``, and the full
transposed convolution is cropped to ``lax``'s padding: ``(2, 1)`` at
``k = 3``, stride 2, ``"SAME"``, which PyTorch's symmetric ``padding`` and
``output_padding`` cannot express.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pointnet2_tpu_torch.nn.layers import BatchNorm, Momentum

PADDINGS = ("SAME", "VALID")
ACTIVATIONS = (None, "relu")


def _check(padding: str, activation: Optional[str]) -> None:
    if padding not in PADDINGS:
        raise ValueError(f"padding must be one of {PADDINGS}, got {padding!r}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {ACTIVATIONS}, got {activation!r}")


def xavier_uniform_(kernel: torch.Tensor) -> torch.Tensor:
    """flax's ``xavier_uniform()`` on a kernel in flax's layout (``(*window,
    in, out)``): U(-l, l), ``l = sqrt(6 / (fan_in + fan_out))``, each fan the
    channel count times the window's size."""
    window = math.prod(kernel.shape[:-2])
    limit = math.sqrt(6.0 / ((kernel.shape[-2] + kernel.shape[-1]) * window))
    with torch.no_grad():
        return kernel.uniform_(-limit, limit)


def same_pads(size: int, window: int, stride: int) -> tuple[int, int]:
    """``lax``'s ``"SAME"`` padding of one axis: ``ceil(size / stride)`` outputs,
    the odd row at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def conv_transpose_pads(window: int, stride: int, padding: str) -> tuple[int, int]:
    """``lax.conv_transpose``'s padding of the stride-dilated input of one axis."""
    if padding == "SAME":
        total = window + stride - 2
        before = window - 1 if stride > window - 1 else -(-total // 2)
    else:
        total = window + stride - 2 + max(window - stride, 0)
        before = window - 1
    return before, total - before


def _pad_spatial(x: torch.Tensor, pads: Sequence[tuple[int, int]], value: float = 0.0) -> torch.Tensor:
    """Pad the trailing spatial axes of a channels-first tensor; ``pads`` in axis order."""
    flat = [p for pair in reversed(pads) for p in pair]
    return F.pad(x, flat, value=value) if any(flat) else x


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1)


class _Kernel(nn.Module):
    """A flax convolution's parameters: ``kernel`` ``(*window, in, out)`` and ``bias``."""

    def __init__(self, window: Sequence[int], in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(xavier_uniform_(torch.empty(*window, in_features, features)))
        self.bias = nn.Parameter(torch.zeros(features))


class _Layer(nn.Module):
    """The optional BatchNorm and ReLU after a layer."""

    def _finish(self, x: torch.Tensor, bn_momentum: Momentum) -> torch.Tensor:
        if self.use_bn:
            x = self.BatchNorm_0(x, bn_momentum)
        return torch.relu(x) if self.activation == "relu" else x


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


class ConvND(_Layer):
    """A strided 1-D, 2-D or 3-D convolution (``len(kernel_size)`` of them)
    over ``(B, *spatial, in_features)``, then BatchNorm and ReLU
    (tf_util conv1d/2d/3d)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Sequence[int],
        strides: Optional[Sequence[int]] = None,
        padding: str = "SAME",
        use_bn: bool = False,
        activation: Optional[str] = "relu",
    ):
        super().__init__()
        _check(padding, activation)
        if len(kernel_size) not in _CONV:
            raise ValueError(f"ConvND is 1-D, 2-D or 3-D, got kernel_size {tuple(kernel_size)}")
        self.window = tuple(kernel_size)
        self.strides = tuple(strides) if strides else (1,) * len(self.window)
        self.padding = padding
        self.use_bn = use_bn
        self.activation = activation
        self.Conv_0 = _Kernel(self.window, in_features, features)
        if use_bn:
            self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor, bn_momentum: Momentum = 0.9) -> torch.Tensor:
        nd = len(self.window)
        h = _channels_first(x)
        if self.padding == "SAME":
            h = _pad_spatial(h, [same_pads(s, k, st) for s, k, st in zip(h.shape[2:], self.window, self.strides)])
        weight = self.Conv_0.kernel.permute(nd + 1, nd, *range(nd))  # (out, in, *window)
        y = _channels_last(_CONV[nd](h, weight, self.Conv_0.bias, stride=self.strides))
        return self._finish(y, bn_momentum)


class ConvTranspose2D(_Layer):
    """A 2-D transposed convolution over ``(B, H, W, in_features)``, flax's
    (``transpose_kernel=False``; ``"SAME"`` gives ``H * stride`` rows), then
    BatchNorm and ReLU (tf_util.conv2d_transpose)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: Sequence[int] = (3, 3),
        strides: Sequence[int] = (2, 2),
        padding: str = "SAME",
        use_bn: bool = False,
        activation: Optional[str] = "relu",
    ):
        super().__init__()
        _check(padding, activation)
        self.window = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding
        self.use_bn = use_bn
        self.activation = activation
        self.ConvTranspose_0 = _Kernel(self.window, in_features, features)
        if use_bn:
            self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor, bn_momentum: Momentum = 0.9) -> torch.Tensor:
        # (kh, kw, in, out) correlated as it is == (in, out, kh, kw) flipped, transposed.
        weight = self.ConvTranspose_0.kernel.permute(2, 3, 0, 1).flip(2, 3)
        full = F.conv_transpose2d(_channels_first(x), weight, stride=self.strides)  # padding k - 1 a side
        # Crop (or widen, for padding past k - 1) to lax's padding of each axis.
        crop = [conv_transpose_pads(k, s, self.padding) for k, s in zip(self.window, self.strides)]
        y = _pad_spatial(full, [(a - (k - 1), b - (k - 1)) for (a, b), k in zip(crop, self.window)])
        return self._finish(_channels_last(y) + self.ConvTranspose_0.bias, bn_momentum)


class FullyConnected(_Layer):
    """A dense layer on the last axis, then BatchNorm and ReLU (tf_util.fully_connected)."""

    def __init__(self, in_features: int, features: int, use_bn: bool = False, activation: Optional[str] = "relu"):
        super().__init__()
        _check("VALID", activation)
        self.use_bn = use_bn
        self.activation = activation
        self.Dense_0 = nn.Linear(in_features, features)
        nn.init.xavier_uniform_(self.Dense_0.weight)
        nn.init.zeros_(self.Dense_0.bias)
        if use_bn:
            self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor, bn_momentum: Momentum = 0.9) -> torch.Tensor:
        return self._finish(self.Dense_0(x), bn_momentum)


def _pool(x: torch.Tensor, window, strides, padding: str, reduce: str) -> torch.Tensor:
    """flax's ``max_pool``/``avg_pool`` over the spatial axes of a channels-last
    input; ``"SAME"`` pads with -inf for the max and with zeros for the mean,
    which divides by the whole window (flax's ``count_include_pad``)."""
    _check(padding, None)
    window, strides = tuple(window), tuple(strides)
    h = _channels_first(x)
    if padding == "SAME":
        pads = [same_pads(s, k, st) for s, k, st in zip(h.shape[2:], window, strides)]
        h = _pad_spatial(h, pads, float("-inf") if reduce == "max" else 0.0)
    nd = len(window)
    fn = getattr(F, f"{reduce}_pool{nd}d")
    return _channels_last(fn(h, window, strides))


def max_pool2d(x, kernel_size=(2, 2), strides=(2, 2), padding="VALID"):
    """(B, H, W, C) max pool (tf_util.max_pool2d)."""
    return _pool(x, kernel_size, strides, padding, "max")


def avg_pool2d(x, kernel_size=(2, 2), strides=(2, 2), padding="VALID"):
    """(B, H, W, C) average pool (tf_util.avg_pool2d)."""
    return _pool(x, kernel_size, strides, padding, "avg")


def max_pool3d(x, kernel_size=(2, 2, 2), strides=(2, 2, 2), padding="VALID"):
    """(B, D, H, W, C) max pool (tf_util.max_pool3d)."""
    return _pool(x, kernel_size, strides, padding, "max")


def avg_pool3d(x, kernel_size=(2, 2, 2), strides=(2, 2, 2), padding="VALID"):
    """(B, D, H, W, C) average pool (tf_util.avg_pool3d)."""
    return _pool(x, kernel_size, strides, padding, "avg")
