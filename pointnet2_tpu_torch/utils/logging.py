"""Run logging: text log, progress bar, JSONL scalar history.

An own copy of ``pointnet2_tpu/utils/logging.py`` (the port imports nothing of
the JAX package): ``log_train.txt`` and ``scalars.jsonl`` are written the
same way. ``export_tensorboard``, which turns the JSONL history into
TensorBoard event files with ``tensorboardX``, is not ported yet (ROADMAP
queue 1 item 5's remainder); it reads these files as they are.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time


class RunLogger:
    def __init__(self, logdir: str | pathlib.Path, filename: str = "log_train.txt"):
        self.logdir = pathlib.Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._fout = open(self.logdir / filename, "a")
        self._scalars = open(self.logdir / "scalars.jsonl", "a")

    def log(self, msg: str) -> None:
        self._fout.write(msg + "\n")
        self._fout.flush()
        print(msg)

    def scalars(self, step: int, tag: str, **values) -> None:
        rec = {"step": int(step), "tag": tag, "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._scalars.write(json.dumps(rec) + "\n")
        self._scalars.flush()

    def close(self) -> None:
        self._fout.close()
        self._scalars.close()


class NullLogger:
    """RunLogger stand-in for a process that must not write the run's files:
    messages go to stdout, prefixed with the process index."""

    def __init__(self, process_index: int = 0):
        self._prefix = f"[proc {process_index}] "

    def log(self, msg: str) -> None:
        print(self._prefix + msg)

    def scalars(self, step: int, tag: str, **values) -> None:
        pass

    def close(self) -> None:
        pass


def update_progress(progress, bar_length: int = 10) -> None:
    """In-place console progress bar; values outside [0, 1] (or non-numbers) clamp."""
    try:
        frac = min(max(float(progress), 0.0), 1.0)
    except (TypeError, ValueError):
        frac = 0.0
    filled = round(frac * bar_length)
    sys.stdout.write(f"\rProgress: [{'#' * filled}{'-' * (bar_length - filled)}] {frac * 100:g}%")
    sys.stdout.flush()
