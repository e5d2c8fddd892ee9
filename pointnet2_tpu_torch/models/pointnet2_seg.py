"""PointNet++ SSG semantic segmentation network, its geometry and its loss.

Counterpart of ``pointnet2_tpu/models/pointnet2_seg.py``:

    input (B, N, 3[+3 rgb])
    SA1..SA4: FPS + ball query, MLPs [32,32,64] / [64,64,128] / [128,128,256] / [256,256,512]
    FP1..FP4: [256,256] / [256,256] / [256,128] / [128,128,128]
    head: Linear 128 -> BatchNorm -> ReLU -> Dropout 0.5 (train only) -> Linear num_classes

Module names follow the flax tree (``sa1``, ``fp4``, ``fc1_bn``, ...), so
``convert.from_flax_variables`` maps one onto the other by name. The forward
follows ``self.training``. ``precompute_geometry`` (``:204-289``) computes
the parameter-free neighbour structure of a batch ahead of the forward;
``weighted_ce_sum``/``weighted_ce_loss`` (``:411-441``) are the weighted cross
entropy divided by the number of non-zero weights.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.nn.layers import BatchNorm, Momentum
from pointnet2_tpu_torch.nn.pointnet import FeaturePropagation, SetAbstraction

SA_MLPS = ([32, 32, 64], [64, 64, 128], [128, 128, 256], [256, 256, 512])
FP_MLPS = ([256, 256], [256, 256], [256, 128], [128, 128, 128])


class PointNet2SemSeg(nn.Module):
    """Input (B, N, 3 + 3*use_color) float32 -> logits (B, N, num_classes).

    ``input_is_leaf`` (default True) treats the input cloud as needing no
    gradient: SA1 then takes the scatter-free leaf path, and the cloud's
    gradient is exactly zero. Set it False where the cloud itself is
    differentiated. ``dropout_rate`` is the head's (0.5 in the reference;
    0.0 switches it off, for comparisons).
    """

    def __init__(
        self,
        config: Optional[Config] = None,
        num_classes: int = 9,
        use_color: bool = True,
        ops_impl: Optional[str] = None,
        input_is_leaf: bool = True,
        dropout_rate: float = 0.5,
    ):
        super().__init__()
        cfg = config or Config()
        self.use_color = bool(use_color)
        if not 0.0 <= dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
        self.dropout_rate = float(dropout_rate)
        self._generator: Optional[torch.Generator] = None
        # Feature widths per level: l0 (colour or none), then each SA's output.
        widths = [3 if self.use_color else 0] + [mlp[-1] for mlp in SA_MLPS]
        for i, (spec, mlp) in enumerate(zip(cfg.sa_layers, SA_MLPS)):
            self.add_module(
                f"sa{i + 1}",
                SetAbstraction(
                    spec.npoint, spec.radius, spec.nsample, mlp, widths[i], ops_impl,
                    leaf_inputs=(i == 0) and input_is_leaf,
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

    def forward(
        self,
        point_cloud: torch.Tensor,
        bn_momentum: Optional[Momentum] = None,
        geometry: Optional[Mapping[str, tuple]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``bn_momentum`` is needed in train mode; ``geometry`` is what
        ``precompute_geometry`` returned for this batch; ``generator`` draws the
        dropout mask (default: one the model keeps on the input's device, seeded with 0)."""
        xyzs = [point_cloud[..., :3].contiguous()]
        feats = [point_cloud[..., 3:6] if self.use_color else None]
        for i in range(4):
            new_xyz, new_points, _ = getattr(self, f"sa{i + 1}")(
                xyzs[-1], feats[-1], bn_momentum,
                None if geometry is None else geometry["sa"][i],
            )
            xyzs.append(new_xyz)
            feats.append(new_points)
        for i in range(4):
            lvl = 3 - i
            feats[lvl] = getattr(self, f"fp{i + 1}")(
                xyzs[lvl], xyzs[lvl + 1], feats[lvl], feats[lvl + 1], bn_momentum,
                None if geometry is None else geometry["fp"][i],
            )
        net = torch.relu(self.fc1_bn(self.fc1(feats[0]), bn_momentum))
        if self.training and self.dropout_rate > 0.0:
            net = self._dropout(net, generator)
        return self.fc2(net)

    def _dropout(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """Zero each element with probability ``dropout_rate``, scale the rest by 1/keep."""
        if generator is None:
            if self._generator is None or self._generator.device != x.device:
                self._generator = torch.Generator(device=x.device).manual_seed(0)
            generator = self._generator
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= self.dropout_rate
        return torch.where(keep, x / (1.0 - self.dropout_rate), torch.zeros((), device=x.device))


@torch.no_grad()
def precompute_geometry(
    point_cloud: torch.Tensor, config: Optional[Config] = None, ops_impl: Optional[str] = None
) -> dict:
    """The neighbour structure of ``PointNet2SemSeg`` for a batch, computed once.

    FPS centroids, ball-query groups and the FP levels' 3-NN depend on the
    coordinates alone, never on parameters, so a gradient-accumulation step
    computes them once at full batch width and hands each microbatch its
    slice (``model(x, geometry=...)``). Returns ``{"sa": ({"new_xyz", "idx"},
    ...), "fp": ({"dist2", "idx"}, ...)}``, every leaf with a leading batch
    axis. The calibrated windows and their certificates are not ported, so
    unlike the JAX function this returns no ``ok``.
    """
    cfg = config or Config()
    xyzs = [point_cloud[..., :3].contiguous()]
    sa = []
    for spec in cfg.sa_layers:
        _, new_xyz = ops.fps_centroids(xyzs[-1], spec.npoint, impl=ops_impl)
        idx, _ = ops.ball_query(xyzs[-1], new_xyz, spec.radius, spec.nsample, impl=ops_impl)
        sa.append({"new_xyz": new_xyz, "idx": idx})
        xyzs.append(new_xyz)
    fp = []
    for i in range(len(FP_MLPS)):
        lvl = 3 - i
        dist2, idx = ops.three_nn(xyzs[lvl], xyzs[lvl + 1], impl=ops_impl)
        fp.append({"dist2": dist2, "idx": idx})
    return {"sa": tuple(sa), "fp": tuple(fp)}


def weighted_ce_sum(
    logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of ``ce * w``, number of non-zero weights), both float32 scalars.

    The two sums of the weighted cross entropy, apart, so that gradient
    accumulation can add them over microbatches and divide once.
    """
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    w = weights.float()
    return (ce * w).sum(), (w != 0).sum().float()


def weighted_ce_loss(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Per-point cross entropy times the point's weight, summed, over the count of non-zero weights."""
    total, nonzero = weighted_ce_sum(logits, labels, weights)
    return total / nonzero.clamp_min(1.0)
