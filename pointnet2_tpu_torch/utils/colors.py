"""Label <-> color maps and colorization helpers.

An own copy of ``pointnet2_tpu/utils/colors.py`` (the port imports nothing of
the JAX package). Parity with util/point_cloud_util.py:5-50 (and the
duplicated C++ table at tf_ops/tf_interpolate.cpp:45-47).
"""

from __future__ import annotations

import numpy as np

# label -> RGB (0-255); index = label id 0..8
LABEL_COLORS_UINT8 = np.array(
    [
        [255, 255, 255],  # 0 unlabeled: white
        [0, 0, 255],  # 1 man-made terrain: blue
        [128, 0, 0],  # 2 natural terrain: maroon
        [255, 0, 255],  # 3 high vegetation: fuchsia
        [0, 128, 0],  # 4 low vegetation: green
        [255, 0, 0],  # 5 buildings: red
        [128, 0, 128],  # 6 hard scape: purple
        [0, 0, 128],  # 7 scanning artifact: navy
        [128, 128, 0],  # 8 cars: olive
    ],
    dtype=np.uint8,
)


def label_to_colors(labels: np.ndarray) -> np.ndarray:
    """(N,) labels -> (N, 3) int32 colors 0-255 (util/point_cloud_util.py:5-37).

    Single vectorized gather; the reference's one-hot matmul variant for
    small clouds is mathematically identical.
    """
    labels = np.asarray(labels, np.int64)
    if (labels < 0).any() or (labels >= len(LABEL_COLORS_UINT8)).any():
        raise ValueError("label out of range for color map")
    return LABEL_COLORS_UINT8[labels].astype(np.int32)


def colorize_point_cloud(points: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """(N,3) points + (N,) labels -> (N,3) float colors in [0,1]."""
    if len(points) != len(labels):
        raise ValueError("len(points) != len(labels)")
    return label_to_colors(labels).astype(np.float64) / 255.0
