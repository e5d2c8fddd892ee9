"""Hand-written CUDA kernels for Hopper (``sm_90a``), one per Pallas kernel on the path,
and the twelve of the TPU design probes ported so far (``probes``: FPS and
kNN; ``bq_probes``: the ball queries; ``gather_probes``: the gathers).

Sources are in ``pointnet2_tpu_torch/csrc/``; ``build`` compiles them with
``nvcc`` on first use. Each wrapper takes CUDA tensors only and counts its
launches in ``LAUNCHES``; each is the CUDA implementation of a ``pn2``
operator (``ops.library``), whose CPU implementation is the plain version.
The calibrated-window ops and the round-1 windowed ball query are PyTorch
composites in ``ops.core`` (``*_sliced``, ``ball_query_windowed``: sorts,
window bounds and certificates around two kernels each), which ``ops`` runs
over the ``pn2`` operators.
"""

from pointnet2_tpu_torch.ops.cuda.ballquery import ball_query, ball_query_tiles, ball_query_window_tiles
from pointnet2_tpu_torch.ops.cuda.bq_probes import bq_fat, bq_keys, bq_precut_cond, bq_precut_decomp
from pointnet2_tpu_torch.ops.cuda.common import LAUNCHES, reset_launches
from pointnet2_tpu_torch.ops.cuda.fps import farthest_point_sample, fps_centroids
from pointnet2_tpu_torch.ops.cuda.gather_probes import (
    gather_fused_idx, gather_rows, gather_rows_staged, gather_window_staged,
)
from pointnet2_tpu_torch.ops.cuda.interpolate import three_interpolate, three_interpolate_grad
from pointnet2_tpu_torch.ops.cuda.knn import knn, knn_tiles
from pointnet2_tpu_torch.ops.cuda.probes import fps_packed, fps_remask, knn_argmin, knn_tracked
from pointnet2_tpu_torch.ops.cuda.wingather import ball_query_tiles_pos, window_gather

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "farthest_point_sample",
    "fps_centroids",
    "ball_query",
    "ball_query_window_tiles",
    "ball_query_tiles",
    "ball_query_tiles_pos",
    "window_gather",
    "knn",
    "knn_tiles",
    "three_interpolate",
    "three_interpolate_grad",
    "fps_remask",
    "fps_packed",
    "knn_argmin",
    "knn_tracked",
    "bq_keys",
    "bq_fat",
    "bq_precut_cond",
    "bq_precut_decomp",
    "gather_rows",
    "gather_rows_staged",
    "gather_window_staged",
    "gather_fused_idx",
]
