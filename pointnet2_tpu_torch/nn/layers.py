"""Base layers: BatchNorm with the reference's conventions, and shared point MLPs.

Counterpart of ``pointnet2_tpu/nn/layers.py``. ``torch.nn.BatchNorm*`` does
not serve: its epsilon is 1e-5, it keeps an unbiased running variance, and
its momentum means the opposite. This ``BatchNorm`` holds ``scale``/``bias``
parameters and moving ``mean``/``var`` buffers under the flax names, and
computes ``(x - mean) * (rsqrt(var + 1e-3) * scale) + bias`` with the moving
statistics in eval mode and with the batch's own in train mode.

The bf16 precision modes (``nn/layers.py:24-92`` of the JAX package) cast
explicitly, never through ``torch.autocast``, which would recast the float32
stages of selective mode and pick its own types for reductions: a
``SharedMLP`` of ``dtype`` bfloat16 runs each linear layer on its input and
its float32 weights cast to bfloat16 at use (the gradients come back to the
float32 weights through the casts), and ``BatchNorm`` takes its statistics
and applies them in float32 over a bfloat16 input, and casts its output back.

Under a process group of more than one rank (``parallel.multihost``) a
train-mode ``BatchNorm`` takes its statistics over the global batch, as the
JAX step does over its mesh-sharded batch: each rank's sums, sums of
squares and row count are summed over the ranks, differentiably (the
backward sums the cotangents over the ranks), and every rank's moving
statistics advance identically.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from pointnet2_tpu_torch.parallel import multihost

Momentum = Union[float, torch.Tensor]


class BatchNorm(nn.Module):
    """Batch normalization over the last axis, epsilon 1e-3.

    In train mode the statistics are taken over every axis but the last,
    the variance as ``mean(x²) − mean(x)²`` (biased), the gradient flows
    through them, and the moving buffers are updated in place as
    ``moving = moving·m + batch·(1 − m)``. The momentum ``m`` is an argument
    of each call (a float or a 0-d tensor) because the train step anneals it.
    An input narrower than the buffers (bfloat16) is widened for the
    statistics and the affine map, and the output has the input's type.
    """

    def __init__(self, features: int, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, momentum: Optional[Momentum] = None) -> torch.Tensor:
        dtype = x.dtype
        x = x.to(torch.promote_types(dtype, self.mean.dtype))
        if self.training:
            if momentum is None:
                raise ValueError("BatchNorm in train mode needs the momentum of this step")
            axes = tuple(range(x.dim() - 1))
            if multihost.data_parallel() is None:
                mean = x.mean(dim=axes)
                var = (x * x).mean(dim=axes) - mean * mean
            else:
                mean, var = _global_moments(x, axes)
            with torch.no_grad():
                self.mean.copy_(self.mean * momentum + mean * (1.0 - momentum))
                self.var.copy_(self.var * momentum + var * (1.0 - momentum))
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.epsilon) * self.scale
        return ((x - mean) * inv + self.bias).to(dtype)


def _global_moments(x: torch.Tensor, axes: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and ``mean(x²) − mean(x)²`` over ``axes`` of the batch of every rank."""
    c = x.shape[-1]
    rows = x.new_full((1,), x.numel() // c)
    sums = multihost.all_reduce_sum(torch.cat([x.sum(dim=axes), (x * x).sum(dim=axes), rows]))
    mean = sums[:c] / sums[2 * c]
    return mean, sums[c : 2 * c] / sums[2 * c] - mean * mean


def dense(layer: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``layer`` on ``x`` in ``dtype``: input, weight and bias cast at use (flax's
    ``Dense(dtype=...)``). ``None``: in the promoted type of the input and the
    weight, so a bfloat16 input meets float32 weights in float32."""
    dtype = dtype or torch.promote_types(x.dtype, layer.weight.dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class SharedMLP(nn.Module):
    """Per-point MLP: [Linear -> BatchNorm -> ReLU] for each width, on the last axis.

    Layers are named ``dense_{i}`` and ``bn_{i}``, as in the flax module.
    ``use_bn=False`` leaves the BatchNorms out: each linear layer, with its
    bias, goes straight into its ReLU. ``dtype`` is the compute type of the
    linear layers (``dense``); the parameters stay float32.
    """

    def __init__(
        self, in_features: int, features: Sequence[int], dtype: Optional[torch.dtype] = None, use_bn: bool = True
    ):
        super().__init__()
        self.depth = len(features)
        self.dtype = dtype
        self.use_bn = use_bn
        for i, f in enumerate(features):
            self.add_module(f"dense_{i}", nn.Linear(in_features, f))
            if use_bn:
                self.add_module(f"bn_{i}", BatchNorm(f))
            in_features = f

    def forward(self, x: torch.Tensor, bn_momentum: Optional[Momentum] = None) -> torch.Tensor:
        for i in range(self.depth):
            x = dense(getattr(self, f"dense_{i}"), x, self.dtype)
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x, bn_momentum)
            x = torch.relu(x)
        return x
