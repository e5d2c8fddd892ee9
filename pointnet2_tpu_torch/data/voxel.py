"""Voxel-grid downsampling with source-index traces.

An own copy of ``pointnet2_tpu/data/voxel.py``: the port imports nothing of
the JAX package.

Replaces open3d.voxel_down_sample_and_trace as used by the reference's
downsample.py:46-64: points are binned into a regular grid anchored at
``min(points) - voxel/2``; each occupied voxel emits the mean of its points,
and the per-voxel *trace* (which source points landed in it) drives
majority-vote label pooling (np.bincount().argmax() per voxel — ties resolve
to the smallest label, same as the reference).

Implemented as a vectorized NumPy hash-grid (no per-voxel Python loop); the
native C++ engine in ``native/`` provides the same binning for huge clouds
(``voxel_assign``, bound by ``pointnet2_tpu_torch.native``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def voxel_keys(points: np.ndarray, voxel_size: float, min_bound: np.ndarray):
    """Integer (N, 3) voxel coordinates for each point."""
    return np.floor((points - min_bound[None, :]) / voxel_size).astype(np.int64)


def voxel_downsample_with_trace(
    points: np.ndarray,
    voxel_size: float,
    colors: Optional[np.ndarray] = None,
    min_bound: Optional[np.ndarray] = None,
):
    """Downsample to one mean point per occupied voxel.

    Returns (ds_points, ds_colors, inverse, counts):
    - ds_points (V, 3): per-voxel mean position;
    - ds_colors (V, 3) or None: per-voxel mean color;
    - inverse (N,): voxel id of each source point (the trace);
    - counts (V,): points per voxel.
    Voxels are ordered by ascending grid key, deterministically.
    """
    points = np.asarray(points, np.float64)
    if min_bound is None:
        # downsample.py:46-47: bounds padded by voxel/2.
        min_bound = points.min(axis=0) - voxel_size * 0.5
    keys3 = voxel_keys(points, voxel_size, np.asarray(min_bound, np.float64))
    # Linearize via mixed radix over the occupied extent.
    kmin = keys3.min(axis=0)
    keys3 = keys3 - kmin
    dims = keys3.max(axis=0) + 1
    linear = (keys3[:, 0] * dims[1] + keys3[:, 1]) * dims[2] + keys3[:, 2]
    uniq, inverse, counts = np.unique(linear, return_inverse=True, return_counts=True)
    nv = len(uniq)

    ds_points = np.zeros((nv, 3), np.float64)
    for c in range(3):
        ds_points[:, c] = np.bincount(inverse, weights=points[:, c], minlength=nv)
    ds_points /= counts[:, None]

    ds_colors = None
    if colors is not None:
        colors = np.asarray(colors, np.float64)
        ds_colors = np.zeros((nv, 3), np.float64)
        for c in range(3):
            ds_colors[:, c] = np.bincount(
                inverse, weights=colors[:, c], minlength=nv
            )
        ds_colors /= counts[:, None]

    return ds_points, ds_colors, inverse.astype(np.int64), counts.astype(np.int64)


def majority_vote_labels(
    inverse: np.ndarray, labels: np.ndarray, num_voxels: int
) -> np.ndarray:
    """Per-voxel majority label; ties -> smallest label (bincount.argmax).

    Vectorized equivalent of the reference's per-voxel loop
    (downsample.py:58-64).
    """
    labels = np.asarray(labels, np.int64)
    num_labels = int(labels.max(initial=0)) + 1
    pair = inverse * num_labels + labels
    pair_counts = np.bincount(pair, minlength=num_voxels * num_labels)
    return pair_counts.reshape(num_voxels, num_labels).argmax(axis=1).astype(np.int32)
