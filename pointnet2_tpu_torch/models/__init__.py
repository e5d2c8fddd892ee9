"""Segmentation models of the port."""

from pointnet2_tpu_torch.models.pointnet2_seg import (
    PointNet2SemSeg,
    PointNet2SemSegMSG,
    model_class,
    msg_scales,
    precompute_geometry,
    weighted_ce_loss,
    weighted_ce_sum,
)

__all__ = [
    "PointNet2SemSeg",
    "PointNet2SemSegMSG",
    "model_class",
    "msg_scales",
    "precompute_geometry",
    "weighted_ce_loss",
    "weighted_ce_sum",
]
