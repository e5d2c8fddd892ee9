"""Inspect a point cloud and its labels: statistics, a PNG render, an HTML viewer.

    python -m pointnet2_tpu_torch.cli.visualize --pcd FILE [--labels FILE] [--out PNG]
        [--max_points 200000] [--stats] [--html FILE]

Counterpart of the root ``visualize.py``, flag for flag and line for line.
The reference opens an interactive Open3D window (visualize.py:9-42); here
the default writes an orthographic top and front scatter to a PNG
(``utils.render``, labels coloured with the reference's palette), ``--stats``
prints the statistics alone, and ``--html`` also writes the interactive
viewer (``utils.html_viewer``). Host work only: no device. The PNG needs
matplotlib, imported only when it is drawn (``utils.render.require_matplotlib``),
so ``--stats`` runs where matplotlib is missing.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from pointnet2_tpu_torch.data.io import load_labels, read_pcd
from pointnet2_tpu_torch.utils.colors import colorize_point_cloud
from pointnet2_tpu_torch.utils.html_viewer import write_html_viewer
from pointnet2_tpu_torch.utils.render import render_cloud_png


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pcd", required=True, help="path to .pcd")
    parser.add_argument("--labels", default=None, help="optional .labels path")
    parser.add_argument("--out", default=None, help="output PNG (default: <pcd>.png)")
    parser.add_argument("--max_points", type=int, default=200_000)
    parser.add_argument("--stats", action="store_true", help="print stats only")
    parser.add_argument(
        "--html",
        default=None,
        help="also write a standalone INTERACTIVE viewer (drag to orbit, "
        "wheel to zoom) to this HTML path — the headless counterpart of the "
        "reference's Open3D window (visualize.py:9-42)",
    )
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Print the statistics, then write what the flags ask; returns the files written."""
    flags = build_parser().parse_args(argv)
    cloud = read_pcd(flags.pcd)
    pts = cloud.points
    print(f"{flags.pcd}: {len(pts)} points")
    print("min:", pts.min(0), "max:", pts.max(0))

    colors = cloud.colors
    if flags.labels:
        labels = load_labels(flags.labels)
        colors = colorize_point_cloud(pts, labels)
        counts = np.bincount(labels, minlength=9)
        for c, n in enumerate(counts):
            print(f"label {c}: {n}")
    written: dict = {"points": len(pts)}
    if flags.stats:
        return written

    out = flags.out or flags.pcd + ".png"
    written["png"] = render_cloud_png(pts, colors, out, max_points=flags.max_points)
    print("wrote", out)
    if flags.html:
        written["html"] = write_html_viewer(pts, colors, flags.html, title=os.path.basename(flags.pcd))
        print("wrote", flags.html)
    return written


if __name__ == "__main__":
    main()
