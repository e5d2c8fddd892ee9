"""Calibrate the ball-query (``--bq_window``) and 3-NN (``--fp_window``) x-windows.

    python -m pointnet2_tpu_torch.tools.bq_window_calibrate --data_path DIR \\
        [--config_file semantic.json] [--num_batches 16] [--margin 1.25] [--device cuda]

Counterpart of the root ``tools/bq_window_calibrate.py``, flag for flag, with
the same printed table, plus ``--device``. It samples training batches as
``cli.train`` does (the port's ``SemanticDataset``, seeded by ``--seed``),
runs FPS at every SA level with ``ops.fps_centroids`` (the CUDA kernel on
the card, its plain version with ``--device cpu``; the default, cuda, must
be present), and measures with ``ops.calibrate``'s oracles the window each
SA level's ball query and each FP level's 3-NN would need to be exact. It
prints each level's spans (p50, p95, max over the batches) and suggested
width (the max times ``--margin``, rounded up to 128 columns), then one
width per operator that is safe at every level where it engages
(``choose_window``).

The suggestions bind at the largest level that engages (SA1's cloud for
``--bq_window``, FP1's coarse cloud for ``--fp_window``): deeper clouds are
narrower than any useful window, and there the calibrated operators run the
exact kernels. The certificates the windowed model reports still guard the
chosen widths on every batch.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.cli import add_device_flag, cli_device
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.data.semantic3d import SemanticDataset
from pointnet2_tpu_torch.ops.calibrate import choose_window, required_bq_window, required_fp_window

_LANES = 128


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--data_path", required=True)
    parser.add_argument("--config_file", default="semantic.json")
    parser.add_argument("--train_set", default="train")
    parser.add_argument("--num_batches", type=int, default=16)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--margin", type=float, default=1.25, help="safety factor on the observed max span")
    parser.add_argument("--seed", type=int, default=0)
    add_device_flag(parser)
    return parser


def level_spans(
    flags: argparse.Namespace, cfg: Config, device: torch.device, impl: Optional[str] = None
) -> tuple[dict, dict]:
    """Each SA level's ball-query span and each FP level's 3-NN span, a list
    over the sampled batches, by level number; the centroids from
    ``ops.fps_centroids`` with ``impl`` on ``device``."""
    ds = SemanticDataset(
        num_points_per_sample=cfg.num_point,
        split=flags.train_set,
        box_size_x=cfg.box_size_x,
        box_size_y=cfg.box_size_y,
        use_color=bool(cfg.use_color),
        path=flags.data_path,
        seed=flags.seed,
    )
    levels = [(i + 1, spec.npoint, spec.radius) for i, spec in enumerate(cfg.sa_layers)]
    spans = {lvl: [] for lvl, _, _ in levels}
    fp_spans = {lvl: [] for lvl, _, _ in levels}
    for _ in range(flags.num_batches):
        data, _, _ = ds.sample_batch_in_all_files(flags.batch_size or cfg.batch_size)
        cloud = np.ascontiguousarray(data[..., :3], np.float32)
        for lvl, npoint, radius in levels:
            _, cent = ops.fps_centroids(torch.from_numpy(cloud).to(device), npoint, impl=impl)
            centroids = cent.cpu().numpy()
            spans[lvl].append(required_bq_window(cloud, centroids, radius))
            # FP level `lvl` interpolates the centroids' features back onto
            # `cloud` by exact 3-NN: dataset = centroids, queries = cloud.
            fp_spans[lvl].append(required_fp_window(centroids, cloud))
            cloud = centroids
    return spans, fp_spans


def suggested(spans: Sequence[int], margin: float) -> int:
    return int(np.ceil(np.max(spans) * margin / _LANES) * _LANES)


def windows(spans: dict, fp_spans: dict, cfg: Config, margin: float) -> tuple[Optional[int], Optional[int]]:
    """One ``(bq_window, fp_window)`` safe at every level where each engages (None: none would)."""
    npoints = [spec.npoint for spec in cfg.sa_layers]
    bq = choose_window([max(spans[lvl]) for lvl in spans], [cfg.num_point] + npoints[:-1], margin)
    fp = choose_window([max(fp_spans[lvl]) for lvl in fp_spans], npoints, margin)
    return bq, fp


def _row(lvl: int, cloud: int, s: np.ndarray, width: int) -> str:
    note = "  (>= cloud size: full exact kernel runs regardless)" if width >= cloud else ""
    return (f"{lvl:>5} {cloud:>8} {int(np.percentile(s, 50)):>6} "
            f"{int(np.percentile(s, 95)):>6} {int(s.max()):>6} {width:>10}{note}")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Print the root tool's table; returns the spans and the two windows."""
    flags = build_parser().parse_args(argv)
    device = cli_device(flags.device)
    cfg = Config.from_json(flags.config_file)
    spans, fp_spans = level_spans(flags, cfg, device)

    print(f"{'level':>5} {'cloud N':>8} {'p50':>6} {'p95':>6} {'max':>6} {'suggested':>10}")
    n = cfg.num_point
    for lvl, spec in enumerate(cfg.sa_layers, start=1):
        print(_row(lvl, n, np.array(spans[lvl]), suggested(spans[lvl], flags.margin)))
        n = spec.npoint

    print("\nFP 3-NN (dataset = the level's centroids, queries = the level-above cloud):")
    print(f"{'level':>5} {'cloud M':>8} {'p50':>6} {'p95':>6} {'max':>6} {'suggested':>10}")
    for lvl, spec in enumerate(cfg.sa_layers, start=1):
        print(_row(lvl, spec.npoint, np.array(fp_spans[lvl]), suggested(fp_spans[lvl], flags.margin)))

    bq, fp = windows(spans, fp_spans, cfg, flags.margin)
    if bq:
        print(f"\n--bq_window {bq}")
    else:
        print("\nwindowing would not engage at SA1 on this data; omit --bq_window")
    if fp:
        print(f"--fp_window {fp}")
    else:
        print("3-NN windowing would not engage at any FP level on this data; omit --fp_window")
    return {"bq_window": bq, "fp_window": fp, "spans": spans, "fp_spans": fp_spans, "device": str(device)}


if __name__ == "__main__":
    main()
