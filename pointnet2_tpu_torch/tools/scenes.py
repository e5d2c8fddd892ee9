"""Fabricated Semantic3D scenes for the CLIs, and the windows their seeded batches need.

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

import numpy as np
import torch

from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.data.io import write_labels, write_pcd
from pointnet2_tpu_torch.data.semantic3d import SemanticDataset, train_file_prefixes, validation_file_prefixes
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
        labels = 1 + (pts[:, 2] / SCENE_M[2] * 4).astype(np.int64) + 4 * (pts[:, 0] > SCENE_M[0] / 2)
        write_pcd(data_dir / f"{prefix}.pcd", pts, rng.rand(n, 3))
        write_labels(data_dir / f"{prefix}.labels", labels)


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
