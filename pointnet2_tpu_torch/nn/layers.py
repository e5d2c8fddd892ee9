"""Base layers: BatchNorm with the reference's conventions, and shared point MLPs.

Counterpart of ``pointnet2_tpu/nn/layers.py``. ``torch.nn.BatchNorm*`` does
not serve: its epsilon is 1e-5, it keeps an unbiased running variance, and
its momentum means the opposite. This ``BatchNorm`` holds ``scale``/``bias``
parameters and moving ``mean``/``var`` buffers under the flax names, and
computes the eval form ``(x - mean) * (rsqrt(var + 1e-3) * scale) + bias``.
Train-mode statistics come with the train step.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Eval-mode batch normalization over the last axis, epsilon 1e-3."""

    def __init__(self, features: int, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "BatchNorm runs in eval mode only (moving statistics); call .eval()"
            )
        inv = torch.rsqrt(self.var + self.epsilon) * self.scale
        return (x - self.mean) * inv + self.bias


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"dense_{i}")(x)
            x = torch.relu(getattr(self, f"bn_{i}")(x))
        return x
