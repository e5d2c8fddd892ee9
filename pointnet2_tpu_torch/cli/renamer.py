"""Rename dense label files to their Semantic3D submission names.

    python -m pointnet2_tpu_torch.cli.renamer [--dense_dir result/dense]

Counterpart of the root ``renamer.py``, flag for flag and line for line: the
last step of the chain preprocess -> downsample -> train -> predict ->
interpolate -> renamer. Every file of ``--dense_dir`` whose name is a key of
``conversion_dict`` (a test scene's ``.labels``, as ``cli.interpolate``
writes it) is renamed to the benchmark's name for that scene; any other file
is left in place and named in a printed line. Host work only: no device.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

conversion_dict = {
    "birdfountain_station1_xyz_intensity_rgb.labels": "birdfountain1.labels",
    "castleblatten_station1_intensity_rgb.labels": "castleblatten1.labels",
    "castleblatten_station5_xyz_intensity_rgb.labels": "castleblatten5.labels",
    "marketplacefeldkirch_station1_intensity_rgb.labels": "marketsquarefeldkirch1.labels",
    "marketplacefeldkirch_station4_intensity_rgb.labels": "marketsquarefeldkirch4.labels",
    "marketplacefeldkirch_station7_intensity_rgb.labels": "marketsquarefeldkirch7.labels",
    "sg27_station10_intensity_rgb.labels": "sg27_10.labels",
    "sg27_station3_intensity_rgb.labels": "sg27_3.labels",
    "sg27_station6_intensity_rgb.labels": "sg27_6.labels",
    "sg27_station8_intensity_rgb.labels": "sg27_8.labels",
    "sg28_station2_intensity_rgb.labels": "sg28_2.labels",
    "sg28_station5_xyz_intensity_rgb.labels": "sg28_5.labels",
    "stgallencathedral_station1_intensity_rgb.labels": "stgallencathedral1.labels",
    "stgallencathedral_station3_intensity_rgb.labels": "stgallencathedral3.labels",
    "stgallencathedral_station6_intensity_rgb.labels": "stgallencathedral6.labels",
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dense_dir", default="result/dense")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Rename every file of ``--dense_dir`` that has a submission name;
    returns the ``(source, destination)`` pairs moved and the names left."""
    flags = build_parser().parse_args(argv)
    summary: dict = {"moved": [], "unknown": []}
    for src_path in glob.glob(os.path.join(flags.dense_dir, "*")):
        dir_name = os.path.dirname(src_path)
        src_name = os.path.basename(src_path)
        dst_name = conversion_dict.get(src_name)
        if dst_name is not None:
            dst_path = os.path.join(dir_name, dst_name)
            os.rename(src_path, dst_path)
            print(f"Moved {src_path} to {dst_path}")
            summary["moved"].append((src_path, dst_path))
        else:
            print("src_name not found in conversion_dict:", src_name)
            summary["unknown"].append(src_name)
    return summary


if __name__ == "__main__":
    main()
