"""Semantic3D and KITTI data on the host: file I/O, sampling, augmentation, voxels, the batch pipeline.

Own copies of the numpy modules of ``pointnet2_tpu/data/`` (the port imports
nothing of the JAX package), ``kitti`` among them, and ``pipeline``,
rewritten for PyTorch: the sampler threads and the copy of each batch to the
card ahead of its step.
"""

from pointnet2_tpu_torch.data.io import (
    PointCloud,
    load_labels,
    read_pcd,
    read_pts,
    read_semantic3d_txt,
    write_labels,
    write_pcd,
)
from pointnet2_tpu_torch.data.voxel import voxel_downsample_with_trace

__all__ = [
    "PointCloud",
    "read_pcd",
    "write_pcd",
    "read_pts",
    "read_semantic3d_txt",
    "load_labels",
    "write_labels",
    "voxel_downsample_with_trace",
]
