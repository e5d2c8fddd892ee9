"""KITTI Velodyne dataset for streaming inference.

An own copy of ``pointnet2_tpu/data/kitti.py`` (the port imports nothing of
the JAX package), on the port's ``data.semantic3d.SemanticFileData``: with
the same RandomState it draws the same samples. One difference:
``KittiDataset`` seeds each frame's RandomState (``SAMPLE_SEED``).

Parity with dataset/kitti_dataset.py: each frame is cropped to a box around
the origin (z in [-2, 5], x/y in +-box/2, kitti_dataset.py:15-26), x-sorted,
and served as a single fixed-size z-box batch
(get_batch_of_one_z_box_from_origin, :40-54).

The reference loads drives through pykitti (kitti_dataset.py:92). pykitti is
not a dependency here; instead this module reads the KITTI raw layout
natively: Velodyne scans (`velodyne_points/data/*.bin`, float32 x y z
reflectance), per-sensor timestamps (`timestamps.txt`, nanosecond text),
calibration files (`calib_*.txt`, key: floats), and OXTS GPS/IMU packets
(`oxts/data/*.txt`, 30 fields) including the Mercator-projected world poses
pykitti derives from them — see KittiRawDrive.
"""

from __future__ import annotations

import functools
import glob
import os
from typing import Iterable, Optional

import numpy as np

from pointnet2_tpu_torch.data.semantic3d import LABEL_NAMES, NUM_CLASSES, SemanticFileData


def crop_box(points: np.ndarray, min_bound, max_bound) -> np.ndarray:
    """Axis-aligned crop (open3d.crop_point_cloud equivalent)."""
    mask = np.all((points >= min_bound) & (points <= max_bound), axis=1)
    return points[mask]


def load_velodyne_bin(path: str) -> np.ndarray:
    """One KITTI .bin scan -> (N, 4) float32 [x y z reflectance]."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def iter_velodyne_frames(base_dir: str, date: str, drive: str) -> Iterable[np.ndarray]:
    """Yield (N, 4) scans for a drive; pykitti layout on disk."""
    pattern = os.path.join(
        base_dir,
        date,
        f"{date}_drive_{drive}_sync",
        "velodyne_points",
        "data",
        "*.bin",
    )
    files = sorted(glob.glob(pattern))
    if not files:
        raise FileNotFoundError(f"no velodyne scans under {pattern}")
    for f in files:
        yield load_velodyne_bin(f)


# -- KITTI raw metadata (pykitti.raw equivalent, no dependency) -------------

OXTS_FIELDS = (
    "lat lon alt roll pitch yaw vn ve vf vl vu ax ay az af al au "
    "wx wy wz wf wl wu pos_accuracy vel_accuracy navstat numsats "
    "posmode velmode orimode"
).split()

EARTH_RADIUS = 6378137.0  # Mercator projection radius used by KITTI devkit
SAMPLE_SEED = 0  # each frame's sampler (KittiDataset)


def drive_dir(base_dir: str, date: str, drive: str) -> str:
    return os.path.join(base_dir, date, f"{date}_drive_{drive}_sync")


def load_timestamps(path: str) -> np.ndarray:
    """timestamps.txt ('YYYY-MM-DD HH:MM:SS.nnnnnnnnn') -> float64 seconds."""
    import datetime as dt

    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            base, frac = line.split(".")
            t = dt.datetime.strptime(base, "%Y-%m-%d %H:%M:%S")
            out.append(t.timestamp() + float("0." + frac))
    return np.asarray(out, np.float64)


def load_calib(path: str) -> dict[str, np.ndarray]:
    """calib_*.txt: 'key: v v v ...' lines -> {key: float array}."""
    out: dict[str, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            try:
                out[key.strip()] = np.asarray(
                    [float(v) for v in vals.split()], np.float64
                )
            except ValueError:  # non-numeric entries (calib_time, ...)
                out[key.strip()] = vals.strip()
    return out


def _rotation_from_rpy(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll) (KITTI devkit convention)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


def oxts_to_pose(packets: np.ndarray) -> np.ndarray:
    """(N, 30) OXTS packets -> (N, 4, 4) T_w_imu poses.

    Mercator projection at the first frame's latitude scale, with the first
    frame's translation subtracted so the drive starts at the origin — the
    KITTI raw devkit / pykitti convention (absolute Mercator coordinates are
    ~1e6-1e7 m and would quantize float32 point clouds by decimeters):
    x = s*R*lon*pi/180, y = s*R*log(tan(pi/4 + lat*pi/360)), z = alt.
    """
    lat0 = packets[0, 0]
    scale = np.cos(lat0 * np.pi / 180.0)
    poses = np.zeros((len(packets), 4, 4), np.float64)
    t0 = None
    for i, p in enumerate(packets):
        lat, lon, alt, roll, pitch, yaw = p[:6]
        x = scale * EARTH_RADIUS * lon * np.pi / 180.0
        y = scale * EARTH_RADIUS * np.log(np.tan(np.pi / 4.0 + lat * np.pi / 360.0))
        t = np.array((x, y, alt))
        if t0 is None:
            t0 = t
        poses[i, :3, :3] = _rotation_from_rpy(roll, pitch, yaw)
        poses[i, :3, 3] = t - t0
        poses[i, 3, 3] = 1.0
    return poses


def load_oxts(drive: str) -> tuple[np.ndarray, np.ndarray]:
    """oxts/data/*.txt of a drive dir -> (packets (N, 30), poses (N, 4, 4))."""
    files = sorted(glob.glob(os.path.join(drive, "oxts", "data", "*.txt")))
    if not files:
        raise FileNotFoundError(f"no oxts packets under {drive}")
    packets = np.stack(
        [np.loadtxt(f, dtype=np.float64).reshape(-1)[:30] for f in files]
    )
    return packets, oxts_to_pose(packets)


class KittiRawDrive:
    """Native pykitti.raw equivalent: scans + timestamps + oxts + calib.

    Usage:
        drive = KittiRawDrive(base_dir, "2011_09_26", "0095")
        scan = drive.get_velo(0)            # (N, 4) float32
        t = drive.velo_timestamps           # (F,) float seconds
        packets, poses = drive.oxts         # (F, 30), (F, 4, 4)
        calib = drive.calib                 # merged calib dicts
    """

    def __init__(self, base_dir: str, date: str, drive: str):
        self.path = drive_dir(base_dir, date, drive)
        self.date_dir = os.path.join(base_dir, date)
        self.velo_files = sorted(
            glob.glob(os.path.join(self.path, "velodyne_points", "data", "*.bin"))
        )
        if not self.velo_files:
            raise FileNotFoundError(f"no velodyne scans under {self.path}")

    def __len__(self) -> int:
        return len(self.velo_files)

    def get_velo(self, idx: int) -> np.ndarray:
        return load_velodyne_bin(self.velo_files[idx])

    @functools.cached_property
    def velo_timestamps(self) -> np.ndarray:
        return load_timestamps(
            os.path.join(self.path, "velodyne_points", "timestamps.txt")
        )

    @functools.cached_property
    def oxts(self) -> tuple[np.ndarray, np.ndarray]:
        return load_oxts(self.path)

    @functools.cached_property
    def calib(self) -> dict[str, np.ndarray]:
        out: dict[str, np.ndarray] = {}
        for name in (
            "calib_cam_to_cam.txt",
            "calib_imu_to_velo.txt",
            "calib_velo_to_cam.txt",
        ):
            path = os.path.join(self.date_dir, name)
            if os.path.isfile(path):
                prefix = name.replace("calib_", "").replace(".txt", "")
                for k, v in load_calib(path).items():
                    out[f"{prefix}/{k}"] = v
        return out


class KittiFileData(SemanticFileData):
    """One Velodyne frame, cropped near the origin. No labels/colors."""

    def __init__(self, points: np.ndarray, box_size_x: float, box_size_y: float,
                 rng: Optional[np.random.RandomState] = None):
        self.box_size_x = box_size_x
        self.box_size_y = box_size_y
        self.rng = rng or np.random.RandomState()

        min_bound = [-box_size_x / 2.0, -box_size_y / 2.0, -2.0]
        max_bound = [box_size_x / 2.0, box_size_y / 2.0, 5.0]
        self.points = crop_box(np.asarray(points[:, :3], np.float64), min_bound, max_bound)
        self.labels = np.zeros(len(self.points), dtype=np.int32)
        self.colors = np.zeros_like(self.points)

        sort_idx = np.argsort(self.points[:, 0])
        self.points = self.points[sort_idx]
        self.labels = self.labels[sort_idx]
        self.colors = self.colors[sort_idx]

    def get_batch_of_one_z_box_from_origin(self, num_points_per_sample: int):
        mask = self._get_fix_sized_sample_mask(self.points, num_points_per_sample)
        points = self.points[mask]
        centered = self._center_box(points)
        return centered[None, ...], points[None, ...]


class KittiDataset:
    """All frames of the requested drives, loaded eagerly like the reference.

    Each frame samples from ``np.random.RandomState(SAMPLE_SEED)``, so a run
    draws the same samples every time (the JAX class gives each frame an
    unseeded RandomState).
    """

    def __init__(
        self,
        num_points_per_sample: int,
        base_dir: str,
        dates,
        drives,
        box_size_x: float,
        box_size_y: float,
    ):
        self.num_points_per_sample = num_points_per_sample
        self.num_classes = NUM_CLASSES
        self.labels_names = list(LABEL_NAMES)
        self.box_size_x = box_size_x
        self.box_size_y = box_size_y

        self.list_file_data: list[KittiFileData] = []
        for date in dates:
            for drive in drives:
                print(f"Loading date: {date}, drive: {drive}")
                for frame_idx, scan in enumerate(
                    iter_velodyne_frames(base_dir, date, drive)
                ):
                    fd = KittiFileData(
                        points=scan[:, :3],
                        box_size_x=box_size_x,
                        box_size_y=box_size_y,
                        rng=np.random.RandomState(SAMPLE_SEED),
                    )
                    fd.file_path_without_ext = os.path.join(
                        date, drive, f"{frame_idx:04d}"
                    )
                    self.list_file_data.append(fd)
