"""Hand-written CUDA kernels for Hopper (``sm_90a``), one per Pallas kernel on the path.

Sources are in ``pointnet2_tpu_torch/csrc/``; ``build`` compiles them with
``nvcc`` on first use. Each wrapper takes CUDA tensors only and counts its
launches in ``LAUNCHES``; ``pointnet2_tpu_torch.ops`` routes CPU tensors to the
plain versions instead.
"""

from pointnet2_tpu_torch.ops.cuda.ballquery import ball_query
from pointnet2_tpu_torch.ops.cuda.common import LAUNCHES, reset_launches
from pointnet2_tpu_torch.ops.cuda.fps import fps_centroids
from pointnet2_tpu_torch.ops.cuda.interpolate import three_interpolate, three_interpolate_grad
from pointnet2_tpu_torch.ops.cuda.knn import knn, three_nn

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "fps_centroids",
    "ball_query",
    "knn",
    "three_nn",
    "three_interpolate",
    "three_interpolate_grad",
]
