"""The per-op time table of a ``torch.profiler`` run: ``gpu-profile.txt``.

Counterpart of ``pointnet2_tpu/utils/xplane.py``'s ``OpRow``,
``aggregate_ops``, ``format_report`` and ``write_op_report`` (the reference's
``tf-profile.txt``), which read XLA's XPlane traces. Here the rows come from
the profiler's own events (``profile.key_averages()``), as
``predict_profile`` reads them:

- with device activity, one row a CUDA kernel: its launches, its summed
  device time, µs a launch and its share of the profile's exclusive device
  time (kernels do not nest, so the shares add up to 100 %). The port's
  kernels are named by their entry points (``pn2_fps_centroids``, ...,
  ``KERNEL_NAMES``), every other kernel by the name the profiler gives it;
- without any (a CPU profile), one row an operator, by its own host time
  (its children's excluded), under the same columns.

XPlane's per-op ``bytes_accessed`` has no source in ``torch.profiler``, so
the table has no memory column; the file's header says so.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Iterable

from torch.autograd import DeviceType

from pointnet2_tpu_torch.utils.bench import KERNEL_SYMBOLS, event_device_us

# ``KERNEL_SYMBOLS`` key -> the C entry point of ``csrc/`` that launches it
# (the kernel table's names).
KERNEL_NAMES = {
    "fps_centroids": "pn2_fps_centroids",
    "farthest_point_sample": "pn2_farthest_point_sample",
    "fps_barrier_chain": "pn2_fps_barrier_chain",
    "ball_query": "pn2_ball_query",
    "knn": "pn2_knn",
    "three_interpolate": "pn2_three_interpolate",
    "three_interpolate_grad": "pn2_three_interpolate_grad",
    "ball_query_sliced": "pn2_ball_query_tiles",
    "ball_query_sliced_pos": "pn2_ball_query_tiles_pos",
    "window_gather": "pn2_window_gather",
    "knn_sliced": "pn2_knn_tiles",
    "ball_query_windowed": "pn2_ball_query_windowed",
}


@dataclasses.dataclass
class OpRow:
    name: str
    line: str  # "device": a kernel's time on the card; "host": an operator's own CPU time
    count: int
    total_us: float

    @property
    def total_ms(self) -> float:
        return self.total_us / 1e3

    @property
    def avg_us(self) -> float:
        return self.total_us / max(self.count, 1)


def kernel_name(name: str) -> str:
    """The port's entry-point name for one of its kernels, else ``name``."""
    for key, symbol in KERNEL_SYMBOLS.items():
        if symbol in name:
            return KERNEL_NAMES[key]
    return name


def aggregate_ops(events: Iterable) -> list[OpRow]:
    """Rows of ``key_averages()`` events, by total time, largest first: the
    CUDA kernels where any ran, else every operator's own host time."""
    events = list(events)
    rows: dict[str, OpRow] = {}
    for ev in events:
        us = event_device_us(ev)
        if ev.device_type != DeviceType.CUDA or us <= 0:
            continue
        name = kernel_name(ev.key)
        row = rows.setdefault(name, OpRow(name, "device", 0, 0.0))
        row.count += ev.count
        row.total_us += us
    if not rows:
        for ev in events:
            if ev.device_type != DeviceType.CPU or ev.self_cpu_time_total <= 0:
                continue
            row = rows.setdefault(ev.key, OpRow(ev.key, "host", 0, 0.0))
            row.count += ev.count
            row.total_us += float(ev.self_cpu_time_total)
    return sorted(rows.values(), key=lambda r: -r.total_us)


def format_report(rows: list[OpRow], top: int = 60, title: str = "per-op profile") -> str:
    """The table: op, line, count, total ms, µs a call and share of the
    exclusive time, for the ``top`` rows, and one line for the rest."""
    total = sum(r.total_us for r in rows) or 1.0
    out = [
        f"# {title}",
        "",
        f"{'op':60s} {'line':>8s} {'count':>8s} {'total_ms':>10s} {'avg_us':>10s} {'share':>7s}",
    ]
    for r in rows[:top]:
        name = r.name if len(r.name) <= 60 else r.name[:57] + "..."
        out.append(
            f"{name:60s} {r.line:>8s} {r.count:8d} {r.total_ms:10.3f} {r.avg_us:10.1f} "
            f"{100 * r.total_us / total:6.2f}%"
        )
    if len(rows) > top:
        rest = sum(r.total_us for r in rows[top:])
        out.append(
            f"{'... ' + str(len(rows) - top) + ' more ops':60s} {'':>8s} {'':>8s} {rest / 1e3:10.3f} "
            f"{'':>10s} {100 * rest / total:6.2f}%"
        )
    out.append("")
    out.append(
        "# share denominator = the rows' exclusive time: the kernels' device time (kernels do not "
        "nest), or on a profile without device activity the operators' own host time. No memory "
        "column: torch.profiler records no bytes accessed per op (XPlane's bytes_accessed)."
    )
    return "\n".join(out) + "\n"


def write_op_report(prof, out_path: str | pathlib.Path, top: int = 60) -> list[OpRow]:
    """Aggregate a finished ``torch.profiler.profile`` and write the table to
    ``out_path``; returns every row."""
    rows = aggregate_ops(prof.key_averages())
    line = rows[0].line if rows else "device"
    title = (
        f"per-op profile — {'CUDA kernels, device time' if line == 'device' else 'operators, own host time'}"
        f" — {len(rows)} ops from torch.profiler"
    )
    pathlib.Path(out_path).write_text(format_report(rows, top=top, title=title))
    return rows
