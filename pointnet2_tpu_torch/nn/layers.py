"""Base layers: BatchNorm with the reference's conventions, and shared point MLPs.

Counterpart of ``pointnet2_tpu/nn/layers.py``. ``torch.nn.BatchNorm*`` does
not serve: its epsilon is 1e-5, it keeps an unbiased running variance, and
its momentum means the opposite. This ``BatchNorm`` holds ``scale``/``bias``
parameters and moving ``mean``/``var`` buffers under the flax names, and
computes ``(x - mean) * (rsqrt(var + 1e-3) * scale) + bias`` with the moving
statistics in eval mode and with the batch's own in train mode.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn


Momentum = Union[float, torch.Tensor]


class BatchNorm(nn.Module):
    """Batch normalization over the last axis, epsilon 1e-3.

    In train mode the statistics are taken over every axis but the last,
    the variance as ``mean(x²) − mean(x)²`` (biased), the gradient flows
    through them, and the moving buffers are updated in place as
    ``moving = moving·m + batch·(1 − m)``. The momentum ``m`` is an argument
    of each call (a float or a 0-d tensor) because the train step anneals it.
    """

    def __init__(self, features: int, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, momentum: Optional[Momentum] = None) -> torch.Tensor:
        if self.training:
            if momentum is None:
                raise ValueError("BatchNorm in train mode needs the momentum of this step")
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(dim=axes)
            var = (x * x).mean(dim=axes) - mean * mean
            with torch.no_grad():
                self.mean.copy_(self.mean * momentum + mean * (1.0 - momentum))
                self.var.copy_(self.var * momentum + var * (1.0 - momentum))
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mean) * inv + self.bias


class SharedMLP(nn.Module):
    """Per-point MLP: [Linear -> BatchNorm -> ReLU] for each width, on the last axis.

    Layers are named ``dense_{i}`` and ``bn_{i}``, as in the flax module.
    """

    def __init__(self, in_features: int, features: Sequence[int]):
        super().__init__()
        self.depth = len(features)
        for i, f in enumerate(features):
            self.add_module(f"dense_{i}", nn.Linear(in_features, f))
            self.add_module(f"bn_{i}", BatchNorm(f))
            in_features = f

    def forward(self, x: torch.Tensor, bn_momentum: Optional[Momentum] = None) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"dense_{i}")(x)
            x = torch.relu(getattr(self, f"bn_{i}")(x, bn_momentum))
        return x
