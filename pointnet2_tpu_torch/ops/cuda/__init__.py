"""Hand-written CUDA kernels for Hopper (``sm_90a``), one per Pallas kernel on the path.

Sources are in ``pointnet2_tpu_torch/csrc/``; ``build`` compiles them with
``nvcc`` on first use. Each wrapper takes CUDA tensors only and counts its
launches in ``LAUNCHES``; ``pointnet2_tpu_torch.ops`` routes CPU tensors to the
plain versions instead. The calibrated-window ops (``*_sliced``) run their
sorts and certificates in PyTorch around two kernels each; the round-1
windowed ball query (``ball_query_windowed``) its sorts and window bounds,
with each tile's fallback inside its kernel.
"""

from pointnet2_tpu_torch.ops.cuda.ballquery import (
    ball_query,
    ball_query_sliced,
    ball_query_tiles,
    ball_query_window_tiles,
    ball_query_windowed,
)
from pointnet2_tpu_torch.ops.cuda.common import LAUNCHES, reset_launches
from pointnet2_tpu_torch.ops.cuda.fps import farthest_point_sample, fps_centroids
from pointnet2_tpu_torch.ops.cuda.interpolate import three_interpolate, three_interpolate_grad
from pointnet2_tpu_torch.ops.cuda.knn import knn, knn_sliced, knn_tiles, three_nn, three_nn_sliced
from pointnet2_tpu_torch.ops.cuda.wingather import (
    ball_query_tiles_pos,
    project_group_sliced,
    window_gather,
)

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "farthest_point_sample",
    "fps_centroids",
    "ball_query",
    "ball_query_window_tiles",
    "ball_query_windowed",
    "ball_query_tiles",
    "ball_query_sliced",
    "ball_query_tiles_pos",
    "window_gather",
    "project_group_sliced",
    "knn",
    "knn_tiles",
    "knn_sliced",
    "three_nn",
    "three_nn_sliced",
    "three_interpolate",
    "three_interpolate_grad",
]
