"""Fabricated Semantic3D scenes and KITTI drives for the CLIs, and the windows their seeded batches need.

    python -m pointnet2_tpu_torch.tools.scenes [--seed 0] [--device cpu]

``fabricate`` writes a ``.pcd`` and ``.labels`` for every prefix of the train
and validation splits: 13 x 13 x 5 m squares (larger than the 10 x 10 m
box) of 61112 points each, so that at ``semantic.json``'s widths the 9 train
scenes make 4 batches of 16 x 8192 an epoch and the 6 validation scenes 2.
At 362 points a square metre every box holds more than 8192 points, even
the 5 x 5 m of a corner, and the sampler thins each at random: a box with
fewer points repeats its lowest-x points, a step in density along x that
needs wider calibrated windows than the data's. ``chip_smoke.py``'s CLI
phase trains and predicts on these scenes.

``fabricate_raw`` writes raw Semantic3D scenes, what ``cli.preprocess``
and ``cli.downsample`` read: for each prefix a ``.txt`` of ``x y z
intensity r g b`` rows (integer intensity and colours; ``x y z intensity``
without colours) and, unless it is a test scene, a ``.labels`` file of one
integer a row, a fiftieth of them 0 (unlabelled, which downsampling drops).
``write_raw_scene`` writes one such scene from given points and labels.

``fabricate_dense`` writes what ``cli.interpolate`` reads for a split: each
scene's raw dense cloud and its labels (``gt_dir``) and a sparse labelled
cloud (``sparse_dir``), a subset of the dense points, as ``cli.predict``'s
samples are. ``write_drive`` writes a KITTI raw drive (Velodyne scans,
timestamps, OXTS packets, a calibration file) in the layout
``data.kitti`` reads, with scans shaped like an HDL-64E sweep.

``main`` draws the batches that one epoch of ``cli.train --seed S`` draws
(one sampler thread, the first to draw from a fresh dataset a split: the
train split augmented, the validation split not), and prints one JSON line
with the widest window each calibrated operator needs on them:
``ops.calibrate``'s oracles on the FPS centroids of ``ops.fps_centroids``
(the kernel on the card, bit for bit its plain version on the CPU), SA1's
ball query and FP4's 3-NN. A window certifies a batch when it is at least
this wide (rounded up to 128 columns).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.data.io import write_labels, write_pcd
from pointnet2_tpu_torch.data.semantic3d import (
    SemanticDataset,
    map_name_to_file_prefixes,
    train_file_prefixes,
    validation_file_prefixes,
)
from pointnet2_tpu_torch.infer import resolve_device
from pointnet2_tpu_torch.ops import fps_centroids
from pointnet2_tpu_torch.ops.calibrate import required_bq_window, required_fp_window

ROOT = pathlib.Path(__file__).resolve().parents[2]
SCENE_M = (13.0, 13.0, 5.0)
SCENE_POINTS = 61_112


def fabricate(data_dir: pathlib.Path, seed: int) -> None:
    """Points uniform in ``SCENE_M``, colours in [0, 1), labels 1..8 from four
    height bands and the two halves of x."""
    rng = np.random.RandomState(seed)
    n = SCENE_POINTS
    for prefix in train_file_prefixes + validation_file_prefixes:
        pts = rng.rand(n, 3) * SCENE_M
        write_pcd(data_dir / f"{prefix}.pcd", pts, rng.rand(n, 3))
        write_labels(data_dir / f"{prefix}.labels", _band_labels(pts))


RAW_COLORS = np.array([[128, 128, 128], [170, 160, 150], [90, 140, 60], [40, 110, 40], [120, 170, 80],
                       [200, 60, 50], [150, 150, 170], [240, 240, 240], [30, 60, 200]])  # a base colour a label
UNLABELLED_SHARE = 0.02


def write_raw_scene(raw_dir: pathlib.Path, prefix: str, pts: np.ndarray, labels: np.ndarray,
                    rng: np.random.RandomState, colors: bool = True, with_labels: bool = True) -> None:
    """``<prefix>.txt`` with 4 decimals a coordinate, an integer intensity in
    [-100, 100) and, with ``colors``, a colour near its label's base; and with
    ``with_labels`` ``<prefix>.labels``, ``UNLABELLED_SHARE`` of them 0."""
    n = len(pts)
    intensity = rng.randint(-100, 100, n)
    rows = [pts, intensity[:, None]]
    fmt = "%.4f %.4f %.4f %d"
    if colors:
        rows.append(np.clip(RAW_COLORS[labels] + rng.randint(-20, 20, (n, 3)), 0, 255))
        fmt += " %d %d %d"
    _write_rows(raw_dir / f"{prefix}.txt", np.column_stack(rows), fmt)
    if with_labels:
        labels = labels.copy()
        labels[rng.rand(n) < UNLABELLED_SHARE] = 0
        _write_rows(raw_dir / f"{prefix}.labels", labels[:, None], "%d")


def _write_rows(path: pathlib.Path, rows: np.ndarray, fmt: str, block: int = 10_000) -> None:
    """What ``np.savetxt(path, rows, fmt=fmt)`` writes, a block of rows a format operation."""
    with open(path, "w") as f:
        for i in range(0, len(rows), block):
            part = rows[i : i + block]
            f.write((fmt + "\n") * len(part) % tuple(part.ravel().tolist()))


def fabricate_raw(raw_dir: pathlib.Path, seed: int, prefixes, points: Optional[int] = None, colors: bool = True,
                  with_labels: bool = True) -> None:
    """A raw scene a prefix: ``points`` points (``SCENE_POINTS`` by default)
    uniform in ``SCENE_M`` with ``fabricate``'s labels, through ``write_raw_scene``."""
    rng = np.random.RandomState(seed)
    for prefix in prefixes:
        pts = rng.rand(points or SCENE_POINTS, 3) * SCENE_M
        write_raw_scene(raw_dir, prefix, pts, _band_labels(pts), rng, colors, with_labels)


def _band_labels(pts: np.ndarray) -> np.ndarray:
    """Labels 1..8 from four height bands and the two halves of x."""
    return 1 + (pts[:, 2] / SCENE_M[2] * 4).astype(np.int64) + 4 * (pts[:, 0] > SCENE_M[0] / 2)


def dense_scene(rng: np.random.RandomState, n: int) -> tuple[np.ndarray, np.ndarray]:
    """A Semantic3D-like outdoor scan of ``n`` points and labels that follow
    space: 60 % ground over 60 x 60 m (man-made terrain on one half, natural
    on the other), the rest in 12 boxes of buildings, vegetation, hard scape
    and cars, each box's points on its faces. No two points coincide."""
    ground = int(0.6 * n)
    pts = np.empty((n, 3))
    labels = np.empty(n, np.int64)
    pts[:ground, :2] = rng.rand(ground, 2) * 60.0
    pts[:ground, 2] = rng.randn(ground) * 0.05
    labels[:ground] = np.where(pts[:ground, 0] < 30.0, 1, 2)
    boxes = rng.rand(12, 6) * [50.0, 50.0, 0.0, 8.0, 8.0, 12.0] + [2.0, 2.0, 0.0, 1.0, 1.0, 1.0]
    box_labels = np.array([5, 3, 4, 6, 8, 5, 3, 4, 6, 8, 5, 3])
    which = rng.randint(0, 12, n - ground)
    lo, size = boxes[which, :3], boxes[which, 3:]
    local = rng.rand(n - ground, 3) * size
    face = rng.randint(0, 3, n - ground)  # pin one coordinate to a face of the box
    side = rng.rand(n - ground) < 0.5
    rows = np.arange(n - ground)
    local[rows, face] = np.where(side, 0.0, size[rows, face]) + rng.randn(n - ground) * 0.02
    pts[ground:] = lo + local
    labels[ground:] = box_labels[which]
    return pts, labels


def fabricate_dense(gt_dir: pathlib.Path, sparse_dir: pathlib.Path, seed: int, split: str,
                    dense_points: tuple[int, ...], sparse_points: tuple[int, ...]) -> None:
    """For the i-th scene of ``split``: ``dense_points[i]`` raw points with
    colours and labels in ``gt_dir``, and ``sparse_points[i]`` of them, drawn
    without repeats, with their labels in ``sparse_dir``."""
    rng = np.random.RandomState(seed)
    for prefix, n, m in zip(map_name_to_file_prefixes[split], dense_points, sparse_points, strict=True):
        pts, labels = dense_scene(rng, n)
        write_pcd(gt_dir / f"{prefix}.pcd", pts, rng.rand(n, 3))
        write_labels(gt_dir / f"{prefix}.labels", labels)
        pick = rng.choice(n, m, replace=False)
        write_pcd(sparse_dir / f"{prefix}.pcd", pts[pick])
        write_labels(sparse_dir / f"{prefix}.labels", labels[pick])


def write_drive(root: pathlib.Path, seed: int, frames: int, points: int,
                date: str = "2011_09_26", drive: str = "0095") -> pathlib.Path:
    """A KITTI raw drive under ``root``: ``frames`` scans of ``points`` points
    (x y z reflectance, float32), three quarters on the road around the car
    (z = -1.73 m, the sensor's height, at ranges of 3 m plus an exponential of
    15 m mean, at most 80 m: a sweep's rings crowd near the car) and a quarter
    on objects up to 2.5 m high; about 70 000 of 120 000 fall in the 60 x 20 m
    crop of ``data.kitti``. The timestamps, OXTS packets and
    ``calib_imu_to_velo.txt`` of ``tests/test_kitti.py``'s drive. Returns ``root``."""
    rng = np.random.RandomState(seed)
    base = root / date / f"{date}_drive_{drive}_sync"
    velo = base / "velodyne_points" / "data"
    velo.mkdir(parents=True)
    oxts = base / "oxts" / "data"
    oxts.mkdir(parents=True)
    road = int(0.75 * points)
    for i in range(frames):
        r = np.minimum(3.0 + rng.exponential(15.0, points), 80.0)
        theta = rng.uniform(-np.pi, np.pi, points)
        scan = np.empty((points, 4), np.float32)
        scan[:, 0], scan[:, 1] = r * np.cos(theta), r * np.sin(theta)
        scan[:road, 2] = -1.73 + rng.randn(road) * 0.03
        scan[road:, 2] = rng.uniform(-1.73, 2.5, points - road)
        scan[:, 3] = rng.rand(points)
        scan.tofile(velo / f"{i:010d}.bin")
        packet = np.zeros(30)
        packet[:3] = 49.011 + i * 1e-5, 8.417 + i * 1e-5, 112.8
        packet[5] = 0.1 * i
        np.savetxt(oxts / f"{i:010d}.txt", packet[None], fmt="%.9f")
    with open(base / "velodyne_points" / "timestamps.txt", "w") as f:
        for i in range(frames):
            f.write(f"2011-09-26 13:02:{25 + i:02d}.5943603{i}5\n")
    (root / date / "calib_imu_to_velo.txt").write_text(
        "calib_time: 25-May-2012 16:47:16\nR: 1 0 0 0 1 0 0 0 1\nT: 0.1 0.2 0.3\n"
    )
    return root


def window_needs(cfg: Config, seed: int, device: torch.device) -> dict:
    """The widest window SA1's ball query and FP4's 3-NN need on the batches
    one epoch of the train CLI draws, with its eval, from ``cfg.data_path``."""
    sa1 = cfg.sa_layers[0]
    needs: dict = {}
    for split, augment in (("train", True), ("validation", False)):
        ds = SemanticDataset(cfg.num_point, split, bool(cfg.use_color), cfg.box_size_x, cfg.box_size_y,
                             cfg.data_path, seed=seed)
        bq, fp = [], []
        for _ in range(ds.get_num_batches(cfg.batch_size)):
            xyz = np.ascontiguousarray(ds.sample_batch_in_all_files(cfg.batch_size, augment)[0][..., :3])
            cent = fps_centroids(torch.from_numpy(xyz).to(device), sa1.npoint)[1].cpu().numpy()
            for b in range(len(xyz)):
                bq.append(required_bq_window(xyz[b : b + 1], cent[b : b + 1], sa1.radius))
                fp.append(required_fp_window(cent[b : b + 1], xyz[b : b + 1]))
        needs[split] = {"clouds": len(bq), "sa1_bq_columns": max(bq), "fp4_columns": max(fp)}
    return needs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="the CLI's --seed; the scenes are fabricated from it too")
    ap.add_argument("--device", default="cuda", help="cuda (the default, which must be present) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)
    raw = json.loads((ROOT / "semantic.json").read_text())
    with tempfile.TemporaryDirectory(prefix="scenes_") as tmp:
        fabricate(pathlib.Path(tmp), args.seed)
        cfg = Config(**{**raw, "data_path": tmp})
        needs = window_needs(cfg, args.seed, device)
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps({"tool": "scenes", "seed": args.seed, "scene_m": SCENE_M, "scene_points": SCENE_POINTS,
                      "needs": needs, "device": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
