"""Colour predicted point clouds by their labels.

    python -m pointnet2_tpu_torch.cli.colorize [--input_dir result/sparse] [--output_dir DIR]

Counterpart of the root ``colorize.py`` (the reference's colorize.py:8-49),
flag for flag and line for line: each ``<prefix>.pcd`` of ``--input_dir``
with a ``<prefix>.labels`` beside it becomes ``<prefix>_colored.pcd`` in
``--output_dir`` (default: the input directory), in the 9-colour label
palette; a ``.pcd`` without labels is reported and skipped, and
``*_colored.pcd`` files are not coloured again. The files are byte for byte
the root script's. Host work only: no device.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

from pointnet2_tpu_torch.data.io import load_labels, read_pcd, write_pcd
from pointnet2_tpu_torch.utils.colors import colorize_point_cloud


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input_dir", default="result/sparse")
    parser.add_argument("--output_dir", default=None, help="default: input_dir")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Colour every labelled cloud; returns the files written."""
    flags = build_parser().parse_args(argv)
    out_dir = flags.output_dir or flags.input_dir
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for pcd_path in sorted(glob.glob(os.path.join(flags.input_dir, "*.pcd"))):
        prefix = os.path.splitext(os.path.basename(pcd_path))[0]
        if prefix.endswith("_colored"):
            continue
        labels_path = os.path.join(flags.input_dir, prefix + ".labels")
        if not os.path.isfile(labels_path):
            print("no labels for", pcd_path)
            continue
        cloud = read_pcd(pcd_path)
        labels = load_labels(labels_path)
        colors = colorize_point_cloud(cloud.points, labels)
        out_path = os.path.join(out_dir, prefix + "_colored.pcd")
        write_pcd(out_path, cloud.points, colors)
        print("wrote", out_path)
        written.append(out_path)
    return written


if __name__ == "__main__":
    main()
