"""Convert raw Semantic3D ``.txt`` clouds to ``.pcd``, with the port's own IO.

    python -m pointnet2_tpu_torch.cli.preprocess [--raw_dir DIR]

Counterpart of the root ``preprocess.py``, flag for flag: for every prefix of
every split, ``<raw_dir>/<prefix>.txt`` (``x y z intensity r g b`` rows)
becomes ``<raw_dir>/<prefix>.pcd`` (binary, colours where the rows have
them). A scene whose ``.pcd`` exists is skipped, and so is one without its
``.txt``; each prints the root script's line. Host work only: no device, no
kernel. ``--raw_dir`` defaults to ``dataset/semantic_raw`` under the repo's
root, as the root script's does.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

from pointnet2_tpu_torch.data import semantic3d
from pointnet2_tpu_torch.data.io import read_semantic3d_txt, write_pcd

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.realpath(__file__))))


def point_cloud_txt_to_pcd(raw_dir: str, file_prefix: str) -> Optional[int]:
    """``<file_prefix>.txt`` -> ``.pcd`` in ``raw_dir``; the points written, or None if skipped."""
    txt_file = os.path.join(raw_dir, file_prefix + ".txt")
    pcd_file = os.path.join(raw_dir, file_prefix + ".pcd")
    if os.path.isfile(pcd_file):
        print(f"pcd {pcd_file} exists, skipped")
        return None
    if not os.path.isfile(txt_file):
        print(f"txt {txt_file} missing, skipped")
        return None
    print(f"[txt->pcd] {txt_file} -> {pcd_file}")
    cloud = read_semantic3d_txt(txt_file)
    write_pcd(pcd_file, cloud.points, cloud.colors)
    return len(cloud.points)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--raw_dir", default=os.path.join(REPO_ROOT, "dataset", "semantic_raw"))
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Convert every scene; returns the prefixes converted with their points
    and host seconds (reading the ``.txt`` and writing the ``.pcd``), and the
    prefixes skipped."""
    flags = build_parser().parse_args(argv)
    summary: dict = {"converted": [], "points": [], "seconds": [], "skipped": []}
    for file_prefix in semantic3d.all_file_prefixes:
        t0 = time.perf_counter()
        points = point_cloud_txt_to_pcd(flags.raw_dir, file_prefix)
        if points is None:
            summary["skipped"].append(file_prefix)
            continue
        summary["seconds"].append(time.perf_counter() - t0)
        summary["converted"].append(file_prefix)
        summary["points"].append(points)
    return summary


if __name__ == "__main__":
    main()
