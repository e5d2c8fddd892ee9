"""Start the ranks of a multi-process run on this host, each a subprocess.

``run_ranks`` gives each rank its command line (the ``--dist_*`` flags of the
port's entry points take ``coordinator``, a free ``localhost`` port), waits
for all of them within one deadline, and raises, after killing every rank
still running, as soon as one rank fails or the deadline passes: a stuck
rendezvous fails the run instead of hanging it.
"""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional, Sequence

from pointnet2_tpu_torch.parallel.multihost import TIMEOUT_ENV

PACKAGE_PARENT = pathlib.Path(__file__).resolve().parents[2]


def free_port() -> int:
    """A TCP port of ``localhost`` that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_flags(rank: int, world: int, coordinator: str) -> list[str]:
    """The entry points' ``--dist_*`` flags of ``rank``."""
    return ["--dist_coordinator", coordinator, "--dist_num_processes", str(world), "--dist_process_id", str(rank)]


def run_ranks(
    argv_of: Callable[[int, str], Sequence[str]],
    world: int,
    timeout: float,
    group_timeout: Optional[float] = None,
    env: Optional[dict] = None,
    cwd: Optional[str | os.PathLike] = None,
) -> list[str]:
    """Run ``world`` ranks, rank ``r`` as ``argv_of(r, "localhost:PORT")``;
    returns each rank's output (stdout and stderr together), in rank order.

    ``timeout``: seconds for all of them; ``group_timeout``: the process
    group's timeout in each rank (``PN2_DIST_TIMEOUT_S``); ``env``: variables
    set on top of this process's (the port's package is put on
    ``PYTHONPATH``). Raises ``RuntimeError`` with every rank's output when a
    rank exits non-zero or the time runs out, the other ranks killed first.
    """
    coordinator = f"localhost:{free_port()}"
    child_env = {**os.environ, **(env or {})}
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(PACKAGE_PARENT), child_env.get("PYTHONPATH", "")) if p
    )
    if group_timeout is not None:
        child_env[TIMEOUT_ENV] = str(group_timeout)
    with tempfile.TemporaryDirectory(prefix="pn2_ranks_") as tmp:
        logs = [open(pathlib.Path(tmp) / f"rank{r}.log", "w+") for r in range(world)]
        procs = [
            subprocess.Popen(list(argv_of(r, coordinator)), stdout=logs[r], stderr=subprocess.STDOUT,
                             env=child_env, cwd=cwd)
            for r in range(world)
        ]
        deadline = time.monotonic() + timeout
        failure = None
        try:
            while failure is None and any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
                if bad:
                    failure = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                elif time.monotonic() > deadline:
                    failure = f"the ranks did not finish within {timeout} s"
                else:
                    time.sleep(0.05)
            if failure is None:
                bad = [r for r, p in enumerate(procs) if p.returncode != 0]
                if bad:
                    failure = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outputs = []
        for log in logs:
            log.seek(0)
            outputs.append(log.read())
            log.close()
    if failure is not None:
        tails = "\n".join(f"--- rank {r} ---\n{out[-4000:]}" for r, out in enumerate(outputs))
        raise RuntimeError(f"{failure}\n{tails}")
    return outputs
