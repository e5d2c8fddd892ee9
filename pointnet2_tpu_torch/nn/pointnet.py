"""PointNet++ building blocks: Set Abstraction and Feature Propagation (eval).

Counterpart of ``pointnet2_tpu/nn/pointnet.py`` for the SSG eval forward:

- ``SetAbstraction`` is the pre-projected path (``:239-391``) with max
  pooling. The first MLP layer's linear part runs over all N points before
  grouping, and the centre's xyz projection is subtracted after it:
  ``group(inputs @ w0 + b0, idx) - new_xyz @ w0[:3]``, then ``bn0``, ReLU,
  ``mlp_rest`` and the max over each group.
- ``FeaturePropagation`` is the exact path (``:538-597``): ``three_nn``,
  ``interpolation_weights``, ``three_interpolate``, the skip concat, and a
  ``SharedMLP``.

Other pooling modes, kNN grouping, ``group_all``, calibrated windows and MSG
are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.nn.layers import BatchNorm, SharedMLP


class SetAbstraction(nn.Module):
    """(B, N, 3) xyz + (B, N, C) features -> (B, npoint, 3) centroids,
    (B, npoint, mlp[-1]) pooled features and (B, npoint, nsample) group indices.

    ``in_features`` is C (0 when there are no features). Parameters keep the
    flax layout: ``w0`` is (3 + C, mlp[0]) and is applied as ``x @ w0``.
    """

    def __init__(
        self,
        npoint: int,
        radius: float,
        nsample: int,
        mlp: Sequence[int],
        in_features: int,
        ops_impl: Optional[str] = None,
    ):
        super().__init__()
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.ops_impl = ops_impl
        f0 = mlp[0]
        self.w0 = nn.Parameter(torch.empty(3 + in_features, f0))
        self.b0 = nn.Parameter(torch.zeros(f0))
        self.bn0 = BatchNorm(f0)
        self.mlp_rest = SharedMLP(f0, mlp[1:])

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor]):
        inputs = xyz if points is None else torch.cat([xyz, points], dim=-1)
        _, new_xyz = ops.fps_centroids(xyz, self.npoint, impl=self.ops_impl)
        idx, _ = ops.ball_query(xyz, new_xyz, self.radius, self.nsample, impl=self.ops_impl)
        zp = inputs @ self.w0 + self.b0  # (B, N, f0): layer-1 linear over all points
        zq = new_xyz @ self.w0[:3]  # the centres' xyz projection, no bias
        h = ops.group_points(zp, idx) - zq[:, :, None, :]
        h = torch.relu(self.bn0(h))
        h = self.mlp_rest(h)
        return new_xyz, h.amax(dim=2), idx


class FeaturePropagation(nn.Module):
    """Interpolate (B, M, C2) coarse features onto (B, N, 3) dense points,
    concatenate the (B, N, C1) skip features, and apply a shared MLP."""

    def __init__(self, in_features: int, mlp: Sequence[int], ops_impl: Optional[str] = None):
        super().__init__()
        self.ops_impl = ops_impl
        self.mlp = SharedMLP(in_features, mlp)

    def forward(self, xyz1, xyz2, points1: Optional[torch.Tensor], points2: torch.Tensor):
        dist2, idx = ops.three_nn(xyz1, xyz2, impl=self.ops_impl)
        weight = ops.interpolation_weights(dist2)
        interpolated = ops.three_interpolate(points2, idx, weight, impl=self.ops_impl)
        if points1 is not None:
            interpolated = torch.cat([interpolated, points1], dim=-1)
        return self.mlp(interpolated)
