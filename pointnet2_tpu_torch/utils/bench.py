"""The port's one timer and one bound, for ``chip_smoke.py`` and the tools.

The counterpart of ``pointnet2_tpu/utils/bench.py`` (``slope_time``), whose
hazards are the TPU's (a 26 ms dispatch, ``block_until_ready`` returning
early). On the card a kernel's time is CUDA events around a run of launches:

- ``cuda_ms``: the median over ``reps`` runs of ``inner`` calls in a row,
  after ``warmup`` calls, of the device time between two events divided by
  ``inner``. A call whose kernel is shorter than its host-side launch
  measures the launch;
- ``bound``: the least time the card could take for the same work, the
  larger of the bytes it must move over the memory rate and its operations
  over the float32 rate (no tensor cores), the H100 SXM's published peaks at
  700 W; a card set to a lower power limit runs slower, so every record
  carries ``card_line()`` beside it.

Nothing here runs on the CPU: ``cuda_ms`` needs a CUDA device and raises
without one.
"""

from __future__ import annotations

import statistics
import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, published


def cuda_ms(fn, reps: int = 10, inner: int = 5, warmup: int = 2) -> float:
    """Device time of one call of ``fn``, in ms (see the module docstring)."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_ms times on a CUDA device, and there is none")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """``(ms, "bytes" or "operations")``: the larger of the two least times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def require_device(device: str) -> torch.device:
    """The device a tool runs on: "cuda" (the card, the default of every tool)
    or "cpu" (plain versions, no times). Raises when the card is asked for and
    there is none: no tool falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on the card, or pass --device cpu for the plain versions")
    return dev
