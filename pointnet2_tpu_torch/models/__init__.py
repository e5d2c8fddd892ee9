"""Segmentation models of the port."""

from pointnet2_tpu_torch.models.pointnet2_seg import PointNet2SemSeg

__all__ = ["PointNet2SemSeg"]
