"""One rank of a group: data-parallel train steps, or a CLI, for holding them to one process.

    python -m pointnet2_tpu_torch.tools.dist_step --spec SPEC.json --out PREFIX \
        --dist_coordinator localhost:PORT --dist_num_processes 2 --dist_process_id R
    python -m pointnet2_tpu_torch.tools.dist_step cli {train,predict,...} PREFIX [the CLI's flags]

``SPEC`` is a JSON object:

- ``config``: ``Config`` fields (the rest default);
- ``device``: "cuda" (this rank's card, ``parallel.multihost``) or "cpu";
- ``backend``: "gloo", "nccl" or null (the rule of ``parallel.multihost``);
- ``deterministic``: run every step under PyTorch's deterministic algorithms;
- ``plain_after``: then leave the group and run every case again in the same
  process without it (the plain ``Trainer`` step, for bit comparisons);
- ``cases``: each ``{"arch", "accum_steps", "dtype"`` ("float32" or
  "float64"), ``"ops_impl"`` (the Trainer's: null for the kernels on a card,
  "torch" for the plain versions, which float64 needs there),
  ``"dropout_rate", "optimizer", "weights_seed", "batch_seed", "steps",
  "control"}`` (``CASE`` holds the defaults). ``control`` "rank_batch_norm"
  breaks the step on purpose: each rank's BatchNorm takes its own rows'
  statistics, the fault that the gates against one process must see.

Every rank joins the group (of any size, one included), takes its rows
(``multihost.local_rows``) of each case's global batches
(``train_profile.train_batch`` of ``config.batch_size`` clouds) and writes
``PREFIX.rank<R>.pt``: ``{"cases": [...], "plain": [...]}``, a record a
case (``run_case``). ``run_case`` in a process without a group is the
one-process run of the same case on the global batches: the reference.

``cli MODULE PREFIX ARGS`` runs ``pointnet2_tpu_torch.cli.MODULE``'s
``main(ARGS)`` and writes its summary, with the kernels' launches over the
run (``launches``), to ``PREFIX.rank<R>.json`` (``R`` from
``--dist_process_id`` among ``ARGS``, 0 without it); ``run_cli_ranks``
starts a group of them.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import pathlib
import sys
import time
from typing import Callable, Optional, Sequence
from unittest import mock

import torch

from pointnet2_tpu_torch import convert
from pointnet2_tpu_torch.cli import add_dist_flags
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.ops import cuda
from pointnet2_tpu_torch.parallel import multihost
from pointnet2_tpu_torch.nn import layers
from pointnet2_tpu_torch.parallel.launch import dist_flags, run_ranks
from pointnet2_tpu_torch.train import Trainer
from pointnet2_tpu_torch.train_profile import train_batch
from pointnet2_tpu_torch.utils.bench import deterministic_algorithms

CASE = dict(arch="ssg", accum_steps=1, dtype="float32", ops_impl=None, dropout_rate=0.5, optimizer="adam",
            weights_seed=0, batch_seed=0, steps=1, control=None)


def _rank_moments(x: torch.Tensor, axes: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``rank_batch_norm`` control's statistics: this rank's rows alone."""
    mean = x.mean(dim=axes)
    return mean, (x * x).mean(dim=axes) - mean * mean


def _control(name: Optional[str]):
    if name is None:
        return contextlib.nullcontext()
    if name == "rank_batch_norm":
        return mock.patch.object(layers, "_global_moments", _rank_moments)
    raise ValueError(f"unknown control {name!r}")


def run_case(cfg: Config, case: dict, device: torch.device, deterministic: bool = False) -> dict:
    """``case``'s steps on this rank's rows of its global batches (all of them
    without a group), from seeded weights (``convert.init_variables``,
    ``bn_stats="random"``), dropout drawn from ``step_generator`` of seed
    ``weights_seed + 1``. Returns each step's loss, accuracy and host ms, the
    last step's confusion and parameter gradients, the state after the last
    step, and the kernels' launches over the steps, all on the CPU."""
    case = {**CASE, **case}
    cfg = cfg.replace(optimizer=case["optimizer"])
    trainer = Trainer(cfg, device=device, arch=case["arch"], accum_steps=case["accum_steps"],
                      ops_impl=case["ops_impl"], dropout_rate=case["dropout_rate"],
                      dropout_seed=case["weights_seed"] + 1)
    trainer.load_variables(
        convert.init_variables(cfg, trainer.num_classes, case["weights_seed"], bn_stats="random", arch=case["arch"])
    )
    if case["dtype"] == "float64":
        trainer.model.double()
    batches = [multihost.local_rows(train_batch(cfg, cfg.batch_size, case["batch_seed"] + i))
               for i in range(case["steps"])]
    losses, accuracies, step_ms = [], [], []
    cuda.reset_launches()
    with deterministic_algorithms() if deterministic else contextlib.nullcontext(), _control(case["control"]):
        for batch in batches:
            t0 = time.perf_counter()
            metrics = trainer.train_step(batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
            accuracies.append(float(metrics["accuracy"]))
    return {
        "case": case,
        "losses": losses,
        "accuracies": accuracies,
        "step_ms": step_ms,
        "confusion": metrics["confusion"].cpu(),
        "grads": {name: p.grad.detach().cpu() for name, p in trainer.model.named_parameters()},
        "state": {name: t.detach().cpu() for name, t in trainer.model.state_dict().items()},
        "launches": dict(cuda.LAUNCHES),
        "rank": multihost.process_index(),
        "world": multihost.process_count(),
        "backend": multihost.backend(),
    }


def rank_argv(spec: str, out: str, world: int) -> Callable[[int, str], list[str]]:
    """``parallel.launch.run_ranks``'s ``argv_of`` running this tool on ``world`` processes."""
    return lambda rank, coordinator: [
        sys.executable, "-m", "pointnet2_tpu_torch.tools.dist_step", "--spec", str(spec), "--out", str(out),
        *dist_flags(rank, world, coordinator),
    ]


def cli_rank(module: str, out: str, argv: Sequence[str]) -> None:
    """The ``cli`` mode (see the module docstring)."""
    argv = list(argv)
    summary = importlib.import_module(f"pointnet2_tpu_torch.cli.{module}").main(argv)
    summary["launches"] = dict(cuda.LAUNCHES)
    rank = int(argv[argv.index("--dist_process_id") + 1]) if "--dist_process_id" in argv else 0
    pathlib.Path(f"{out}.rank{rank}.json").write_text(json.dumps(summary, default=lambda o: o.tolist()))


def run_cli_ranks(module: str, out: str | pathlib.Path, argv: Sequence[str], world: int,
                  **run_ranks_kw) -> tuple[list[dict], list[str]]:
    """``world`` processes of the CLI ``module`` on ``argv`` plus each one's
    ``--dist_*`` flags (``parallel.launch.run_ranks``, which takes
    ``run_ranks_kw``): each process's summary and output, in rank order."""
    outputs = run_ranks(
        lambda rank, coordinator: [sys.executable, "-m", "pointnet2_tpu_torch.tools.dist_step", "cli", module,
                                   str(out), *argv, *dist_flags(rank, world, coordinator)],
        world, **run_ranks_kw,
    )
    return [json.loads(pathlib.Path(f"{out}.rank{r}.json").read_text()) for r in range(world)], outputs


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["cli"]:
        cli_rank(argv[1], argv[2], argv[3:])
        return 0
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--spec", required=True, help="the JSON spec (see the module docstring)")
    parser.add_argument("--out", required=True, help="prefix of this rank's .pt file")
    add_dist_flags(parser)
    flags = parser.parse_args(argv)
    with open(flags.spec) as f:
        spec = json.load(f)
    cfg = Config(**spec["config"])
    device = multihost.initialize(flags.dist_coordinator, flags.dist_num_processes, flags.dist_process_id,
                                  spec.get("device", "cuda"), spec.get("backend"))
    deterministic = bool(spec.get("deterministic"))
    out = {"cases": [run_case(cfg, case, device, deterministic) for case in spec["cases"]], "plain": []}
    multihost.barrier()
    multihost.shutdown()
    if spec.get("plain_after"):
        out["plain"] = [run_case(cfg, case, device, deterministic) for case in spec["cases"]]
    torch.save(out, f"{flags.out}.rank{flags.dist_process_id}.pt")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
