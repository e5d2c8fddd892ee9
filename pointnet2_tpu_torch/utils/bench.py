"""The port's one timer and one bound, for ``chip_smoke.py`` and the tools.

The counterpart of ``pointnet2_tpu/utils/bench.py`` (``slope_time``), whose
hazards are the TPU's (a 26 ms dispatch, ``block_until_ready`` returning
early). On the card a kernel's time is CUDA events around a run of launches:

- ``cuda_ms``: the median over ``reps`` runs of ``inner`` calls in a row,
  after ``warmup`` calls, of the device time between two events divided by
  ``inner``. A call whose kernel is shorter than its host-side launch
  measures the launch;
- ``device_ms``: the device time of one call's launches of one kernel,
  summed from ``torch.profiler``'s kernel durations. Where the host's side
  of a launch takes longer than the kernel (the small levels), ``cuda_ms``
  measures the host's enqueue rate and this the kernel;
- ``deterministic_algorithms``: PyTorch's deterministic algorithms for the
  checks that compare a kernel path with a plain path bit for bit (the
  plain versions' scatters then sum in a fixed order on the card too); no
  path that is timed or served runs under it;
- ``bound``: the least time the card could take for the same work, the
  larger of the bytes it must move over the memory rate and its operations
  over the float32 rate (no tensor cores), the H100 SXM's published peaks at
  700 W; a card set to a lower power limit runs slower, so every record
  carries ``card_line()`` beside it.

Nothing here runs on the CPU: ``cuda_ms`` needs a CUDA device and raises
without one.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, published

# LAUNCHES key -> a part of the kernel's name as the profiler shows it.
KERNEL_SYMBOLS = {
    "fps_centroids": "fps_kernel<true",
    "farthest_point_sample": "fps_kernel<false",
    "fps_barrier_chain": "barrier_chain_kernel",
    "ball_query": "ball_query_kernel(",
    "knn": "knn_kernel",  # knn_kernel<K> (k <= 16) and knn_kernel_list
    "three_interpolate": "three_interpolate_kernel",
    # Every kernel of the backward: zero, fill and sum<kVec>.
    "three_interpolate_grad": "three_interpolate_grad_",
    "ball_query_sliced": "ball_query_tiles_kernel<false,",  # <kWithPos, kSlots>
    "ball_query_sliced_pos": "ball_query_tiles_kernel<true,",
    "window_gather": "window_gather_kernel",
    "knn_sliced": "knn_tiles_kernel",
    "ball_query_windowed": "ball_query_windowed_kernel",
}


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


def event_device_us(event) -> float:
    """A profiler event's own device time in us (the attribute's name differs by version)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def device_ms(fn, kernel: str, calls: int = 20, warmup: int = 2, tries: int = 3) -> float:
    """Device time of ``kernel``'s launches (``KERNEL_SYMBOLS``) in one call
    of ``fn``, in ms: the profiler's kernel durations over ``calls`` calls.
    A profiling session that records none of them (the card's tracer has
    dropped a whole session now and then) is run again, ``tries`` in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("device_ms times on a CUDA device, and there is none")
    symbol = KERNEL_SYMBOLS[kernel]
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(
            event_device_us(ev) for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and symbol in ev.key
        )
        if us > 0.0:
            return us / 1e3 / calls
    raise RuntimeError(f"the profiler saw no device time for {kernel} ({symbol!r}) in {tries} sessions")


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` inside the
    block, the previous setting restored after it. ``index_add_`` and
    ``index_put_(accumulate=True)`` on the card then sum each element in the
    order of their source rows, as on the CPU, where they run serially;
    operations with no deterministic version (cuBLAS without a workspace
    setting) warn instead of raising, and ``torch.empty`` fills its memory."""
    enabled = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(enabled, warn_only=warn_only)


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
