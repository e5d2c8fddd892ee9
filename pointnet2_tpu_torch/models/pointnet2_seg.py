"""PointNet++ SSG semantic segmentation network (eval forward).

Counterpart of ``pointnet2_tpu/models/pointnet2_seg.py:38-178``:

    input (B, N, 3[+3 rgb])
    SA1..SA4: FPS + ball query, MLPs [32,32,64] / [64,64,128] / [128,128,256] / [256,256,512]
    FP1..FP4: [256,256] / [256,256] / [256,128] / [128,128,128]
    head: Linear 128 -> BatchNorm -> ReLU -> (eval: no dropout) -> Linear num_classes

Module names follow the flax tree (``sa1``, ``fp4``, ``fc1_bn``, ...), so
``convert.from_flax_variables`` maps one onto the other by name.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.nn.layers import BatchNorm
from pointnet2_tpu_torch.nn.pointnet import FeaturePropagation, SetAbstraction

SA_MLPS = ([32, 32, 64], [64, 64, 128], [128, 128, 256], [256, 256, 512])
FP_MLPS = ([256, 256], [256, 256], [256, 128], [128, 128, 128])


class PointNet2SemSeg(nn.Module):
    """Input (B, N, 3 + 3*use_color) float32 -> logits (B, N, num_classes)."""

    def __init__(
        self,
        config: Optional[Config] = None,
        num_classes: int = 9,
        use_color: bool = True,
        ops_impl: Optional[str] = None,
    ):
        super().__init__()
        cfg = config or Config()
        self.use_color = bool(use_color)
        # Feature widths per level: l0 (colour or none), then each SA's output.
        widths = [3 if self.use_color else 0] + [mlp[-1] for mlp in SA_MLPS]
        for i, (spec, mlp) in enumerate(zip(cfg.sa_layers, SA_MLPS)):
            self.add_module(
                f"sa{i + 1}",
                SetAbstraction(
                    spec.npoint, spec.radius, spec.nsample, mlp, widths[i], ops_impl
                ),
            )
        coarse = widths[-1]
        for i, mlp in enumerate(FP_MLPS):
            lvl = 3 - i  # target level: 3, 2, 1, 0
            self.add_module(
                f"fp{i + 1}", FeaturePropagation(coarse + widths[lvl], mlp, ops_impl)
            )
            coarse = mlp[-1]
        self.fc1 = nn.Linear(coarse, 128)
        self.fc1_bn = BatchNorm(128)
        self.fc2 = nn.Linear(128, num_classes)

    def forward(self, point_cloud: torch.Tensor) -> torch.Tensor:
        xyzs = [point_cloud[..., :3].contiguous()]
        feats = [point_cloud[..., 3:6] if self.use_color else None]
        for i in range(4):
            new_xyz, new_points, _ = getattr(self, f"sa{i + 1}")(xyzs[-1], feats[-1])
            xyzs.append(new_xyz)
            feats.append(new_points)
        for i in range(4):
            lvl = 3 - i
            feats[lvl] = getattr(self, f"fp{i + 1}")(
                xyzs[lvl], xyzs[lvl + 1], feats[lvl], feats[lvl + 1]
            )
        net = torch.relu(self.fc1_bn(self.fc1(feats[0])))
        return self.fc2(net)
