"""PointNet++ building blocks: Set Abstraction and Feature Propagation.

Counterpart of ``pointnet2_tpu/nn/pointnet.py`` for the SSG model, eval and
train:

- ``SetAbstraction`` is the pre-projected path (``:239-391``) with max
  pooling. The first MLP layer's linear part runs over all N points before
  grouping, and the centre's xyz projection is subtracted after it:
  ``group(inputs @ w0 + b0, idx) - new_xyz @ w0[:3]``, then ``bn0``, ReLU,
  ``mlp_rest`` and the max over each group. With ``leaf_inputs`` (the raw
  cloud, which needs no gradient) the train forward gathers the raw channels,
  subtracts the centre and projects after (``:335-355``), so the backward
  needs no scatter into the cloud; the eval forward takes
  ``ops.project_group_leaf``.
- ``FeaturePropagation`` is the exact path (``:538-597``): ``three_nn``,
  ``interpolation_weights`` of the detached distances, ``three_interpolate``,
  the skip concat, and a ``SharedMLP``.

Both take ``geometry``, the neighbour structure computed beforehand
(``models.precompute_geometry``), in place of their own FPS, ball query or
3-NN. The index searches run under ``no_grad``: no parameter reaches them.

Other pooling modes, kNN grouping, ``group_all``, calibrated windows and MSG
are not ported yet.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch
from torch import nn

from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.nn.layers import BatchNorm, Momentum, SharedMLP


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
        leaf_inputs: bool = False,
    ):
        super().__init__()
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.ops_impl = ops_impl
        self.leaf_inputs = leaf_inputs
        f0 = mlp[0]
        self.w0 = nn.Parameter(torch.empty(3 + in_features, f0))
        self.b0 = nn.Parameter(torch.zeros(f0))
        self.bn0 = BatchNorm(f0)
        self.mlp_rest = SharedMLP(f0, mlp[1:])

    def forward(
        self,
        xyz: torch.Tensor,
        points: Optional[torch.Tensor],
        bn_momentum: Optional[Momentum] = None,
        geometry: Optional[Mapping[str, torch.Tensor]] = None,
    ):
        inputs = xyz if points is None else torch.cat([xyz, points], dim=-1)
        if geometry is not None:
            new_xyz, idx = geometry["new_xyz"], geometry["idx"]
        else:
            _, new_xyz = ops.fps_centroids(xyz, self.npoint, impl=self.ops_impl)
            with torch.no_grad():
                idx, _ = ops.ball_query(xyz, new_xyz, self.radius, self.nsample, impl=self.ops_impl)
        if self.leaf_inputs and self.training:
            # (x - c) @ w0[:3] in place of x @ w0[:3] - c @ w0[:3]: equal up to
            # float32 reassociation, and nothing is scattered back into the cloud.
            grouped_in = ops.group_points(inputs, idx)  # (B, M, K, cin)
            grouped_in = torch.cat(
                [grouped_in[..., :3] - new_xyz[:, :, None, :], grouped_in[..., 3:]], dim=-1
            )
            h = grouped_in @ self.w0 + self.b0
        else:
            if self.leaf_inputs:
                grouped = ops.project_group_leaf(inputs, self.w0, self.b0, idx)
            else:
                zp = inputs @ self.w0 + self.b0  # (B, N, f0): layer-1 linear over all points
                grouped = ops.group_points(zp, idx)
            zq = new_xyz @ self.w0[:3]  # the centres' xyz projection, no bias
            h = grouped - zq[:, :, None, :]
        h = torch.relu(self.bn0(h, bn_momentum))
        h = self.mlp_rest(h, bn_momentum)
        return new_xyz, h.amax(dim=2), idx


class FeaturePropagation(nn.Module):
    """Interpolate (B, M, C2) coarse features onto (B, N, 3) dense points,
    concatenate the (B, N, C1) skip features, and apply a shared MLP."""

    def __init__(self, in_features: int, mlp: Sequence[int], ops_impl: Optional[str] = None):
        super().__init__()
        self.ops_impl = ops_impl
        self.mlp = SharedMLP(in_features, mlp)

    def forward(
        self,
        xyz1: torch.Tensor,
        xyz2: torch.Tensor,
        points1: Optional[torch.Tensor],
        points2: torch.Tensor,
        bn_momentum: Optional[Momentum] = None,
        geometry: Optional[Mapping[str, torch.Tensor]] = None,
    ):
        if geometry is not None:
            dist2, idx = geometry["dist2"], geometry["idx"]
        else:
            with torch.no_grad():
                dist2, idx = ops.three_nn(xyz1, xyz2, impl=self.ops_impl)
        # Distances are geometry, not parameters: no gradient goes back through them.
        weight = ops.interpolation_weights(dist2.detach())
        interpolated = ops.three_interpolate(points2, idx, weight, impl=self.ops_impl)
        if points1 is not None:
            interpolated = torch.cat([interpolated, points1], dim=-1)
        return self.mlp(interpolated, bn_momentum)
