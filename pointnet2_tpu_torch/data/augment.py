"""Point-cloud augmentation (NumPy, host-side).

An own copy of ``pointnet2_tpu/data/augment.py``: the port imports nothing of
the JAX package. ``load_h5`` imports ``h5py`` only when it is called.

Parity with util/provider.py: the training pipeline uses per-cloud random
z-rotation (rotate_point_cloud / rotate_feature_point_cloud, used at
dataset/semantic_dataset.py:305-309); jitter/shift/scale/dropout exist in the
reference but are unused — provided here for completeness.
"""

from __future__ import annotations

import numpy as np

_AXES = {
    "x": lambda c, s: np.array([[1, 0, 0], [0, c, s], [0, -s, c]]),
    "y": lambda c, s: np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]),
    "z": lambda c, s: np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]]),
}


def _rotation(angle: float, axis: str) -> np.ndarray:
    if axis not in _AXES:
        raise ValueError("Wrong rotation axis")
    return _AXES[axis](np.cos(angle), np.sin(angle))


def rotate_point_cloud(
    batch_data: np.ndarray, rotation_axis: str = "z", rng: np.random.RandomState | None = None
) -> np.ndarray:
    """Per-cloud random rotation of (B, N, 3) xyz (util/provider.py:35-69)."""
    if np.ndim(batch_data) != 3:
        raise ValueError("np.ndim(batch_data) != 3, must be (b, n, 3)")
    if batch_data.shape[2] != 3:
        raise ValueError("batch_data.shape[2] != 3, must be (x, y, z)")
    rng = rng or np.random
    out = np.zeros(batch_data.shape, dtype=np.float32)
    for k in range(batch_data.shape[0]):
        rot = _rotation(rng.uniform() * 2 * np.pi, rotation_axis)
        out[k] = batch_data[k].reshape(-1, 3) @ rot
    return out


def rotate_feature_point_cloud(
    batch_data: np.ndarray,
    feature_size: int = 3,
    rotation_axis: str = "z",
    rng: np.random.RandomState | None = None,
) -> np.ndarray:
    """Rotate xyz only, pass features through (util/provider.py:72-103)."""
    rng = rng or np.random
    out = np.zeros(batch_data.shape, dtype=np.float32)
    out[:, :, 3 : 3 + feature_size] = batch_data[:, :, 3 : 3 + feature_size]
    for k in range(batch_data.shape[0]):
        rot = _rotation(rng.uniform() * 2 * np.pi, rotation_axis)
        out[k, :, :3] = batch_data[k, :, :3].reshape(-1, 3) @ rot
    return out


def jitter_point_cloud(
    batch_data: np.ndarray, sigma: float = 0.01, clip: float = 0.05
) -> np.ndarray:
    """Gaussian jitter (util/provider.py:248-259; unused by the pipeline)."""
    jittered = np.clip(sigma * np.random.randn(*batch_data.shape), -clip, clip)
    return batch_data + jittered


def shift_point_cloud(batch_data: np.ndarray, shift_range: float = 0.1) -> np.ndarray:
    """Random per-cloud shift (util/provider.py:262-273)."""
    b = batch_data.shape[0]
    shifts = np.random.uniform(-shift_range, shift_range, (b, 3))
    return batch_data + shifts[:, None, :]


def random_scale_point_cloud(
    batch_data: np.ndarray, scale_low: float = 0.8, scale_high: float = 1.25
) -> np.ndarray:
    """Random per-cloud scale (util/provider.py:276-287)."""
    b = batch_data.shape[0]
    scales = np.random.uniform(scale_low, scale_high, b)
    return batch_data * scales[:, None, None]


def random_point_dropout(
    batch_pc: np.ndarray, max_dropout_ratio: float = 0.875
) -> np.ndarray:
    """Replace a random fraction of points with the first point
    (util/provider.py:290-297)."""
    out = batch_pc.copy()
    for b in range(out.shape[0]):
        dropout_ratio = np.random.random() * max_dropout_ratio
        drop = np.where(np.random.random(out.shape[1]) <= dropout_ratio)[0]
        if len(drop) > 0:
            out[b, drop, :] = out[b, 0, :]
    return out


def shuffle_points(batch_data: np.ndarray) -> np.ndarray:
    """Shuffle point order, same permutation batch-wide (util/provider.py:22-32)."""
    idx = np.arange(batch_data.shape[1])
    np.random.shuffle(idx)
    return batch_data[:, idx, :]


def shuffle_data(data: np.ndarray, labels: np.ndarray):
    """Shuffle batch order (util/provider.py:9-19)."""
    idx = np.arange(len(labels))
    np.random.shuffle(idx)
    return data[idx, ...], labels[idx], idx


def rotate_point_cloud_with_normal(batch_xyz_normal: np.ndarray) -> np.ndarray:
    """Rotate xyz and normals by the same random y rotation
    (util/provider.py:105-125)."""
    out = batch_xyz_normal.copy()
    for k in range(out.shape[0]):
        rot = _rotation(np.random.uniform() * 2 * np.pi, "y")
        out[k, :, 0:3] = out[k, :, 0:3] @ rot
        out[k, :, 3:6] = out[k, :, 3:6] @ rot
    return out


def rotate_point_cloud_by_angle(
    batch_data: np.ndarray, rotation_angle: float
) -> np.ndarray:
    """Deterministic y-rotation of xyz (util/provider.py:170-188)."""
    out = np.zeros(batch_data.shape, dtype=np.float32)
    rot = _rotation(rotation_angle, "y")
    for k in range(batch_data.shape[0]):
        out[k, :, 0:3] = batch_data[k, :, 0:3] @ rot
    return out


def _small_rotation(angle_sigma: float, angle_clip: float) -> np.ndarray:
    angles = np.clip(angle_sigma * np.random.randn(3), -angle_clip, angle_clip)
    rx = np.array(
        [
            [1, 0, 0],
            [0, np.cos(angles[0]), -np.sin(angles[0])],
            [0, np.sin(angles[0]), np.cos(angles[0])],
        ]
    )
    ry = np.array(
        [
            [np.cos(angles[1]), 0, np.sin(angles[1])],
            [0, 1, 0],
            [-np.sin(angles[1]), 0, np.cos(angles[1])],
        ]
    )
    rz = np.array(
        [
            [np.cos(angles[2]), -np.sin(angles[2]), 0],
            [np.sin(angles[2]), np.cos(angles[2]), 0],
            [0, 0, 1],
        ]
    )
    return rz @ ry @ rx


def rotate_perturbation_point_cloud(
    batch_data: np.ndarray, angle_sigma: float = 0.06, angle_clip: float = 0.18
) -> np.ndarray:
    """Small random 3-axis perturbations (util/provider.py:211-245)."""
    out = np.zeros(batch_data.shape, dtype=np.float32)
    for k in range(batch_data.shape[0]):
        out[k] = batch_data[k] @ _small_rotation(angle_sigma, angle_clip)
    return out


def rotate_perturbation_point_cloud_with_normal(
    batch_data: np.ndarray, angle_sigma: float = 0.06, angle_clip: float = 0.18
) -> np.ndarray:
    """Small random 3-axis perturbations of xyz+normals
    (util/provider.py:128-167)."""
    out = np.zeros(batch_data.shape, dtype=np.float32)
    for k in range(batch_data.shape[0]):
        rot = _small_rotation(angle_sigma, angle_clip)
        out[k, :, 0:3] = batch_data[k, :, 0:3] @ rot
        out[k, :, 3:6] = batch_data[k, :, 3:6] @ rot
    return out


def get_data_files(list_filename: str) -> list[str]:
    """Read a file-list manifest (util/provider.py:300-301)."""
    with open(list_filename) as f:
        return [line.rstrip() for line in f]


def load_h5(h5_filename: str):
    """(data, label) from an HDF5 archive (util/provider.py:304-310).

    h5py is optional; raises a clear error when absent.
    """
    try:
        import h5py
    except ImportError as e:  # pragma: no cover
        raise ImportError("load_h5 requires h5py") from e
    with h5py.File(h5_filename, "r") as f:
        return f["data"][:], f["label"][:]
