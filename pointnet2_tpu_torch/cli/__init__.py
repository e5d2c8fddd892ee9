"""The port's command-line entry points, counterparts of the root ``preprocess.py``,
``downsample.py``, ``train.py``, ``predict.py``, ``interpolate.py``, ``renamer.py``, ``kitti_predict.py``,
``serve.py``, ``benchmark.py``, ``visualize.py``, ``colorize.py`` and ``kitti_visualize.py``.

    python -m pointnet2_tpu_torch.cli.preprocess [--raw_dir dataset/semantic_raw]
    python -m pointnet2_tpu_torch.cli.downsample [--voxel_size 0.05]
    python -m pointnet2_tpu_torch.cli.train --config_file semantic.json
    python -m pointnet2_tpu_torch.cli.predict --ckpt log/semantic/model.pt
    python -m pointnet2_tpu_torch.cli.interpolate --set validation [--engine device]
    python -m pointnet2_tpu_torch.cli.renamer [--dense_dir result/dense]
    python -m pointnet2_tpu_torch.cli.kitti_predict --ckpt log/semantic/model.pt --kitti_root DIR --save
    python -m pointnet2_tpu_torch.cli.serve --artifact result/export
    python -m pointnet2_tpu_torch.cli.benchmark [--ckpt log/semantic/model.pt] [--bq_window 3072 --fp_window 512]
    python -m pointnet2_tpu_torch.cli.visualize --pcd FILE [--labels FILE] [--stats] [--html FILE]
    python -m pointnet2_tpu_torch.cli.colorize [--input_dir result/sparse]
    python -m pointnet2_tpu_torch.cli.kitti_visualize --kitti_root DIR

Each takes the JAX script's flags by the same names. ``preprocess``,
``downsample``, ``renamer`` and the three visualizers are host work and take no more
(the PNGs need matplotlib, imported only to draw); the others take
``--device``: CUDA by default, which must be present (``--device cpu`` runs
the plain versions of the operators, for tests; ``interpolate`` uses it for
``--engine device`` and ``--engine sharded`` only). ``train`` and
``predict`` run over several processes with ``--dist_coordinator``,
``--dist_num_processes`` and ``--dist_process_id`` (``parallel.multihost``:
one process a device). The tools beside them (``pointnet2_tpu_torch.tools``)
include ``convert_checkpoint`` (a reference TF checkpoint to the port's
``.pt``; ``--device``, CUDA by default), ``bq_window_calibrate`` (the
windows to pass as ``--bq_window``/``--fp_window``; ``--device``, CUDA by
default) and ``scalars_to_tb`` (a run's
``scalars.jsonl`` to TensorBoard event files; needs ``tensorboardX``).
"""

from __future__ import annotations

import argparse

import torch

from pointnet2_tpu_torch.infer import resolve_device
from pointnet2_tpu_torch.parallel.mesh import create_mesh


def add_device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", default="cuda",
        help="torch device; the default, cuda, must be present (there is no fallback). "
        "cpu runs the plain versions of the operators",
    )


def add_dist_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--dist_coordinator", default=None,
        help="host:port of process 0's rendezvous; with --dist_num_processes > 1 each process joins one "
        "torch.distributed group and drives one device (cuda:(process id mod card count), or --device cpu)",
    )
    parser.add_argument("--dist_num_processes", type=int, default=None, help="the number of processes")
    parser.add_argument("--dist_process_id", type=int, default=None, help="this process's index in [0, processes)")


def cli_device(name: str) -> torch.device:
    """``cuda`` must be present and raises without it; any other name is taken as given."""
    return resolve_device(None if name == "cuda" else name)


def cli_mesh(name: str) -> tuple[torch.device, ...]:
    """The devices a sharded run splits over: for ``cuda`` every visible card
    (raises without one), for any other name that device alone."""
    return create_mesh() if name == "cuda" else (cli_device(name),)
