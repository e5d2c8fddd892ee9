"""Voxel-downsample raw Semantic3D scenes with majority-vote labels, with the port's own modules.

    python -m pointnet2_tpu_torch.cli.downsample [--voxel_size 0.05] [--raw_dir DIR] [--downsampled_dir DIR]

Counterpart of the root ``downsample.py``, flag for flag: for every prefix of
every split it reads ``<raw_dir>/<prefix>.pcd`` (what ``cli.preprocess``
wrote) and its ``.labels``, drops the label-0 (unlabelled) points, bins the
rest into a voxel grid of ``--voxel_size`` metres with each voxel's source
points traced (``data.voxel.voxel_downsample_with_trace``), and writes
``<downsampled_dir>/<prefix>.pcd`` (each voxel's mean point and colour) and
``.labels`` (each voxel's majority label, ``majority_vote_labels``). A scene
without ``.labels`` is a test scene: it keeps every point and gets a ``.pcd``
only. A scene whose outputs exist is skipped (a ``.pcd``, and the
``.labels`` where the raw scene has labels); a scene without its raw
``.pcd`` raises, as in the root script. Host work only: no device, no
kernel. The directories default to ``dataset/semantic_raw`` and
``dataset/semantic_downsampled`` under the repo's root.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

from pointnet2_tpu_torch.cli.preprocess import REPO_ROOT
from pointnet2_tpu_torch.data import semantic3d
from pointnet2_tpu_torch.data.io import load_labels, read_pcd, write_labels, write_pcd
from pointnet2_tpu_torch.data.voxel import majority_vote_labels, voxel_downsample_with_trace


def down_sample(
    dense_pcd_path: str, dense_label_path: str, sparse_pcd_path: str, sparse_label_path: str, voxel_size: float
) -> Optional[tuple[int, int]]:
    """One scene; the points read and written, or None if it was done already."""
    if os.path.isfile(sparse_pcd_path) and (
        not os.path.isfile(dense_label_path) or os.path.isfile(sparse_label_path)
    ):
        print("Skipped:", dense_pcd_path)
        return None
    print("Processing:", dense_pcd_path)

    cloud = read_pcd(dense_pcd_path)
    try:
        dense_labels = load_labels(dense_label_path)
    except OSError:
        dense_labels = None

    points = cloud.points
    colors = cloud.colors
    print("Num points:", len(points))
    if dense_labels is not None:
        keep = dense_labels != 0
        points = points[keep]
        if colors is not None:
            colors = colors[keep]
        dense_labels = dense_labels[keep]
        print("Num points after 0-skip:", len(points))

    ds_points, ds_colors, inverse, _ = voxel_downsample_with_trace(points, voxel_size, colors)
    print("Num points after down sampling:", len(ds_points))
    write_pcd(sparse_pcd_path, ds_points, ds_colors)
    print("Point cloud written to:", sparse_pcd_path)

    if dense_labels is not None:
        write_labels(sparse_label_path, majority_vote_labels(inverse, dense_labels, len(ds_points)))
        print("Labels written to:", sparse_label_path)
    return len(cloud.points), len(ds_points)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--voxel_size", type=float, default=0.05)
    parser.add_argument("--raw_dir", default=os.path.join(REPO_ROOT, "dataset", "semantic_raw"))
    parser.add_argument("--downsampled_dir", default=os.path.join(REPO_ROOT, "dataset", "semantic_downsampled"))
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Downsample every scene; returns the prefixes done with their points
    before and after and host seconds (reading, binning, voting, writing),
    and the prefixes skipped."""
    flags = build_parser().parse_args(argv)
    os.makedirs(flags.downsampled_dir, exist_ok=True)
    summary: dict = {"downsampled": [], "points": [], "sparse_points": [], "seconds": [], "skipped": []}
    for file_prefix in semantic3d.all_file_prefixes:
        t0 = time.perf_counter()
        done = down_sample(
            os.path.join(flags.raw_dir, file_prefix + ".pcd"),
            os.path.join(flags.raw_dir, file_prefix + ".labels"),
            os.path.join(flags.downsampled_dir, file_prefix + ".pcd"),
            os.path.join(flags.downsampled_dir, file_prefix + ".labels"),
            flags.voxel_size,
        )
        if done is None:
            summary["skipped"].append(file_prefix)
            continue
        summary["seconds"].append(time.perf_counter() - t0)
        summary["downsampled"].append(file_prefix)
        summary["points"].append(done[0])
        summary["sparse_points"].append(done[1])
    return summary


if __name__ == "__main__":
    main()
