"""Run logging: text log, progress bar, JSONL scalar history, TensorBoard export.

An own copy of ``pointnet2_tpu/utils/logging.py`` (the port imports nothing of
the JAX package): ``log_train.txt`` and ``scalars.jsonl`` are written the
same way, and ``export_tensorboard`` turns the JSONL history into
TensorBoard event files with ``tensorboardX``, one run directory a tag.
``tensorboardX`` is imported only by that function; where it is absent
(the H100 machine has none) the function raises ``ImportError``.
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


def export_tensorboard(logdir: str | pathlib.Path, out_dir: str | pathlib.Path | None = None) -> list[pathlib.Path]:
    """Convert ``<logdir>/scalars.jsonl`` into TensorBoard event files, one
    run a tag: ``<out>/<tag>/events.*`` (``out`` defaults to ``<logdir>/tb``),
    the reference's per-split FileWriters (train.py:400-407), so that
    ``tensorboard --logdir <logdir>/tb`` shows them. Returns the run
    directories in the order their tags first appear."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError as e:
        raise ImportError(
            "export_tensorboard needs tensorboardX (pip install tensorboardX); scalars.jsonl is plain JSON lines"
        ) from e

    logdir = pathlib.Path(logdir)
    out = pathlib.Path(out_dir) if out_dir else logdir / "tb"
    scalars_path = logdir / "scalars.jsonl"
    if not scalars_path.is_file():
        raise FileNotFoundError(scalars_path)
    writers: dict = {}
    written: list[pathlib.Path] = []
    try:
        with open(scalars_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                tag = rec.pop("tag", "default")
                step = int(rec.pop("step", 0))
                walltime = rec.pop("time", None)
                if tag not in writers:
                    run_dir = out / tag
                    run_dir.mkdir(parents=True, exist_ok=True)
                    writers[tag] = SummaryWriter(logdir=str(run_dir))
                    written.append(run_dir)
                for key, value in rec.items():
                    writers[tag].add_scalar(key, float(value), step, walltime=walltime)
    finally:
        for w in writers.values():
            w.close()
    return written
