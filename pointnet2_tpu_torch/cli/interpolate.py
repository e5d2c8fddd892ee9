"""Dense label propagation with the port: sparse predictions -> full raw clouds.

    python -m pointnet2_tpu_torch.cli.interpolate [--set validation] [--engine auto|native|scipy|device|sharded]

Counterpart of the root ``interpolate.py``, with its flags by the same names,
and ``--device`` for ``--engine device`` and ``sharded``: for each scene of ``--set`` it
loads ``<sparse_dir>/<scene>.{pcd,labels}`` (what ``cli.predict`` wrote) and
the raw dense cloud ``<gt_dir>/<scene>.pcd``, densifies the labels by a
k-nearest majority vote (``ops.densify.densify_labels``), writes
``<dense_dir>/<scene>.labels`` and ``<scene>_colored.pcd``, and prints each
scene's and the global confusion matrix where ``<gt_dir>/<scene>.labels``
exists. The engine ``auto`` (the default) is the native C++ grid kNN on the
host, or scipy where it cannot be built; ``device`` runs row 3's kNN kernel
on the card (``--device``, CUDA by default, which must be present) and never
falls back; ``sharded`` splits the dense cloud over every visible card
(``parallel.sharded_ops``; with ``--device cpu`` over the CPU alone).
"""

from __future__ import annotations

import argparse
import os
import time
from pprint import pprint
from typing import Optional, Sequence

from pointnet2_tpu_torch.cli import add_device_flag, cli_device, cli_mesh
from pointnet2_tpu_torch.data.io import load_labels, read_pcd, write_labels, write_pcd
from pointnet2_tpu_torch.data.semantic3d import map_name_to_file_prefixes
from pointnet2_tpu_torch.ops.densify import ENGINES, densify_labels
from pointnet2_tpu_torch.utils.metrics import ConfusionMatrix


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--set", default="validation", help="train, validation, test")
    parser.add_argument("--sparse_dir", default="result/sparse")
    parser.add_argument("--dense_dir", default="result/dense")
    parser.add_argument("--gt_dir", default="dataset/semantic_raw")
    parser.add_argument("--knn", type=int, default=3)
    parser.add_argument(
        "--engine", default="auto", choices=ENGINES,
        help="auto: native, else scipy; device: row 3's kNN kernel on --device; sharded: the device engine "
        "with the dense cloud split over every visible card",
    )
    add_device_flag(parser)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Densify every scene of the split; returns each scene's name, dense
    points, the engine's seconds (the host clock around ``densify_labels``,
    the labels back on the host) and the files written."""
    flags = build_parser().parse_args(argv)
    device = cli_device(flags.device) if flags.engine == "device" else None
    mesh = cli_mesh(flags.device) if flags.engine == "sharded" else None

    os.makedirs(flags.dense_dir, exist_ok=True)
    cm_global = ConfusionMatrix(9)
    summary: dict = {"scenes": [], "points": [], "seconds": [], "outputs": []}

    for prefix in map_name_to_file_prefixes[flags.set]:
        print("Interpolating:", prefix, flush=True)
        sparse_cloud = read_pcd(os.path.join(flags.sparse_dir, prefix + ".pcd"))
        sparse_labels = load_labels(os.path.join(flags.sparse_dir, prefix + ".labels"))
        dense_cloud = read_pcd(os.path.join(flags.gt_dir, prefix + ".pcd"))
        try:
            dense_gt = load_labels(os.path.join(flags.gt_dir, prefix + ".labels"))
        except OSError:
            print("dense_gt_labels not found, treat as test set")
            dense_gt = None

        start = time.time()
        dense_labels, dense_colors = densify_labels(
            sparse_cloud.points, sparse_labels, dense_cloud.points, knn=flags.knn, engine=flags.engine,
            device=device, mesh=mesh,
        )
        seconds = time.time() - start
        print(f"KNN interpolation time: {seconds} seconds", flush=True)

        labels_path = os.path.join(flags.dense_dir, prefix + ".labels")
        write_labels(labels_path, dense_labels)
        print("Dense labels written to:", labels_path, flush=True)

        colored_path = os.path.join(flags.dense_dir, prefix + "_colored.pcd")
        write_pcd(colored_path, dense_cloud.points, dense_colors / 255.0)
        print("Dense pcd with color written to:", colored_path, flush=True)

        if dense_gt is not None:
            cm = ConfusionMatrix(9)
            cm.increment_from_list(dense_gt, dense_labels)
            cm.print_metrics()
            cm_global.increment_from_list(dense_gt, dense_labels)
        summary["scenes"].append(prefix)
        summary["points"].append(len(dense_labels))
        summary["seconds"].append(seconds)
        summary["outputs"].append((labels_path, colored_path))

    pprint("Global results")
    cm_global.print_metrics()
    return summary


if __name__ == "__main__":
    main()
