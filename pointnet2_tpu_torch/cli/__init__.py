"""The port's command-line entry points, counterparts of the root ``train.py``,
``predict.py``, ``interpolate.py`` and ``kitti_predict.py``.

    python -m pointnet2_tpu_torch.cli.train --config_file semantic.json
    python -m pointnet2_tpu_torch.cli.predict --ckpt log/semantic/model.pt
    python -m pointnet2_tpu_torch.cli.interpolate --set validation [--engine device]
    python -m pointnet2_tpu_torch.cli.kitti_predict --ckpt log/semantic/model.pt --kitti_root DIR --save

Each takes the JAX script's flags by the same names, and ``--device``: CUDA
by default, which must be present (``--device cpu`` runs the plain versions
of the operators, for tests; ``interpolate`` uses it for ``--engine device``
only). A flag of a mode the port does not have yet raises
``NotImplementedError`` naming the ROADMAP item that will bring it.
"""

from __future__ import annotations

import argparse

import torch

from pointnet2_tpu_torch.infer import resolve_device

_MULTI_PROCESS = "queue 1 item 10 (multi-process)"

# Flag -> (the value that means "off", the ROADMAP item that will bring it).
NOT_PORTED_FLAGS = {
    "sharded": (False, _MULTI_PROCESS),
    "dist_coordinator": (None, _MULTI_PROCESS),
    "dist_num_processes": (None, _MULTI_PROCESS),
    "dist_process_id": (None, _MULTI_PROCESS),
    "dist_sampling": ("sharded", _MULTI_PROCESS),
}


def refuse_not_ported(flags: argparse.Namespace) -> None:
    """Raise ``NotImplementedError`` for the first flag set to a mode not ported yet."""
    for name, (off, item) in NOT_PORTED_FLAGS.items():
        value = getattr(flags, name, off)
        if value != off:
            raise NotImplementedError(f"--{name} {value!r} is not ported yet: ROADMAP.md {item}")


def add_device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", default="cuda",
        help="torch device; the default, cuda, must be present (there is no fallback). "
        "cpu runs the plain versions of the operators",
    )


def cli_device(name: str) -> torch.device:
    """``cuda`` must be present and raises without it; any other name is taken as given."""
    return resolve_device(None if name == "cuda" else name)
