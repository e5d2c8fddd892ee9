"""The port's timers and one bound, for ``chip_smoke.py`` and the tools.

The counterpart of ``pointnet2_tpu/utils/bench.py``. ``slope_time`` is its
``slope_time``: the time of a step from the slope between two chains of
steps, each step's output folded into the next step's input, so that no
step can be skipped and fixed costs (a launch queue filling, a final read)
cancel. The JAX function's other hazards are the TPU's (a 26 ms dispatch,
``block_until_ready`` returning early). On the card a kernel's time is CUDA
events around a run of launches:

- ``cuda_ms``: the median over ``reps`` runs of ``inner`` calls in a row,
  after ``warmup`` calls, of the device time between two events divided by
  ``inner``. A call whose kernel is shorter than its host-side launch
  measures the launch;
- ``device_ms``: the device time of one call's launches of one kernel,
  summed from ``torch.profiler``'s kernel durations. Where the host's side
  of a launch takes longer than the kernel (the small levels), ``cuda_ms``
  measures the host's enqueue rate and this the kernel. The card's tracer
  loses the first launches of a session (in a process that has run long,
  up to 4 in most sessions), and now and then a whole session; so a
  session makes lead-in calls before its timed ones, counts only the
  launches inside its ``TIMED`` range, and is run again unless it kept
  every launch issued there (``ops.cuda.LAUNCHES``). When no session comes
  back whole, the whole call is timed by CUDA events, with a warning;
- ``deterministic_algorithms``: PyTorch's deterministic algorithms for the
  checks that compare a kernel path with a plain path bit for bit (the
  plain versions' scatters then sum in a fixed order on the card too); no
  path that is timed or served runs under it;
- ``bound``: the least time the card could take for the same work, the
  larger of the bytes it must move over the memory rate and its operations
  over the float32 rate (no tensor cores), the H100 SXM's published peaks at
  700 W; a card set to a lower power limit runs slower, so every record
  carries ``card_line()`` beside it.

Only ``slope_time`` runs on the CPU (on the host's clock, for tests):
``cuda_ms`` and ``device_ms`` need a CUDA device and raise without one.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import time
import warnings

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, published

# LAUNCHES key -> a part of the kernel's name as the profiler shows it.
KERNEL_SYMBOLS = {
    "fps_centroids": "fps_kernel<true",
    "farthest_point_sample": "fps_kernel<false",
    "fps_barrier_chain": "barrier_chain_kernel",
    "fps_probe_chain": "fps_probe_chain_kernel",  # <kRec16>: the probes' exchange alone
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
    # The design probes (ops/cuda/probes.py, ops/cuda/bq_probes.py).
    "fps_remask": "fps_remask_kernel",
    "fps_packed": "fps_packed_kernel",
    "knn_argmin": "knn_argmin_kernel",
    "knn_tracked": "knn_tracked_kernel",
    "bq_keys": "bq_keys_kernel",  # <kI16, kQ, kV>
    "bq_fat": "bq_fat_kernel",  # <kQ, kV>
    # Both row-7 probe sites of the one pre-cut kernel (<kWithPos, kSlots>),
    # and its instance with window columns (row 8's probe site).
    "bq_precut_cond": "ball_query_precut_kernel<false,",
    "bq_precut_decomp": "ball_query_precut_kernel<false,",
    "bq_precut_pos": "ball_query_precut_kernel<true,",
    # The gather probes (ops/cuda/gather_probes.py), each <V, kLanes> but the
    # window kernels, <kBulk, kLanes, kUnroll> and <kBulk, kLanes>.
    "gather_rows": "gather_rows_kernel",
    "gather_rows_staged": "gather_rows_staged_kernel",
    "gather_window_staged": "gather_window_staged_kernel",
    "gather_fused_idx": "gather_fused_idx_kernel",
    "gather_window_out4d": "gather_window_out4d_kernel",
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


def slope_time(step_fn, x: torch.Tensor, K0: int = 2, K1: int = 10, reps: int = 3) -> float:
    """Median seconds a call of ``step_fn``, from chains of K0 and of K1 calls.

    ``step_fn``: carry -> tensor (any shape); ``x``, a floating tensor, is
    the first carry and the timed input. Each output is folded into the next
    carry by ``c + out.sum() * 1e-38`` (the carry's value does not change; the
    next call waits for this one's output). Each chain runs once to warm up;
    then ``reps`` times, on a distinct input each repetition (``x + (i + 1) *
    1e-7``), each chain ending in one read of the carry's sum. Returns
    (median t(K1) - median t(K0)) / (K1 - K0), as the JAX function does: CUDA
    events on the carry's device when it is a card (synchronised before each
    chain), the host's clock on the CPU.
    """
    on_card = x.device.type == "cuda"
    eps = torch.tensor(1e-38, dtype=torch.float32, device=x.device)

    def chain(c: torch.Tensor, k: int) -> float:
        if on_card:
            torch.cuda.synchronize(x.device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        for _ in range(k):
            out = step_fn(c)
            c = c + (out.sum().float() * eps).to(c.dtype)
        float(c.sum())
        if on_card:
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        return time.perf_counter() - t0

    chain(x, K0)
    chain(x, K1)  # warm
    t0s, t1s = [], []
    for i in range(reps):
        xi = x + (i + 1) * 1e-7
        t0s.append(chain(xi, K0))
        t1s.append(chain(xi, K1))
    return (statistics.median(t1s) - statistics.median(t0s)) / (K1 - K0)


def event_device_us(event) -> float:
    """A profiler event's own device time in us (the attribute's name differs by version)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


TIMED = "device_ms: the timed calls"  # the profiler range around a session's timed calls


def timed_launches(prof, symbol: str) -> tuple[int, float, list[int], int]:
    """Of a finished ``torch.profiler.profile`` session: the runtime's
    kernel launches (``cudaLaunchKernel*``) inside its ``TIMED`` range, in
    order, each matched to its kernel by correlation id. Returns the
    launches of kernels whose name holds ``symbol``, their summed device us,
    the places (0 first) of the launches whose kernel the tracer did not
    keep, and how many launches the range holds."""
    from torch.autograd import DeviceType

    events = prof.events()
    ranges = [e.time_range for e in events if e.device_type == DeviceType.CPU and e.name == TIMED]
    launches = sorted((e for e in events if e.device_type == DeviceType.CPU and "LaunchKernel" in e.name
                       and any(r.start <= e.time_range.start <= r.end for r in ranges)),
                      key=lambda e: e.time_range.start)
    kernels = {e.id: e for e in events if e.device_type != DeviceType.CPU}
    mine = [kernels[e.id] for e in launches if e.id in kernels and symbol in kernels[e.id].name]
    lost = [i for i, e in enumerate(launches) if e.id not in kernels]
    return len(mine), sum(k.time_range.elapsed_us() for k in mine), lost, len(launches)


def device_ms(fn, kernel: str, calls: int = 20, warmup: int = 2, tries: int = 3,
              launches: int | None = None) -> float:
    """Device time of ``kernel``'s launches (``KERNEL_SYMBOLS``) in one call
    of ``fn``, in ms: the profiler's kernel durations over ``calls`` calls.

    The card's tracer loses the first launches of a session: none or one in
    a fresh process, up to 4 (once 14) in one that has run long
    (``tools.profiler_losses``; PERF.md §6). So a session first makes
    ``lead`` calls (``calls // 4``) and then the ``calls`` timed ones inside
    a ``TIMED`` range, whose launches alone count (``timed_launches``). It
    must keep every one of the kernel's launches in that range that was
    issued: the rise of ``ops.cuda.LAUNCHES[kernel]`` over the timed calls,
    or ``launches`` a call for a kernel whose wrapper counts none (the FPS
    chains). A session that keeps fewer, or none, is run again with twice
    the lead, ``tries`` in all. When no session came back whole, the time
    is ``cuda_ms`` of one call of ``fn`` over ``calls`` runs, all of the
    call's device work counted, and a ``RuntimeWarning`` says so, with the
    launches each short session kept and the places of those it lost."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from pointnet2_tpu_torch.ops.cuda.common import LAUNCHES

    if not torch.cuda.is_available():
        raise RuntimeError("device_ms times on a CUDA device, and there is none")
    symbol = KERNEL_SYMBOLS[kernel]
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    short, lead = [], max(1, calls // 4)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                fn()
            before = LAUNCHES[kernel]
            with record_function(TIMED):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
        issued = calls * launches if launches is not None else LAUNCHES[kernel] - before
        seen, us, lost, total = timed_launches(prof, symbol)
        if us > 0.0 and seen >= issued:
            return us / 1e3 / calls
        if seen:
            short.append(f"{seen} of {issued} after a lead of {lead} calls (lost at {lost} of {total} launches)")
        lead *= 2
    if short:
        warnings.warn(
            f"the profiler kept fewer launches of {kernel} ({symbol!r}) than were issued in every one of {tries} "
            f"sessions: {'; '.join(short)}; timing the whole call by CUDA events instead",
            RuntimeWarning, stacklevel=2,
        )
    else:
        warnings.warn(
            f"the profiler saw no device time for {kernel} ({symbol!r}) in {tries} sessions; "
            "timing the whole call by CUDA events instead",
            RuntimeWarning, stacklevel=2,
        )
    return cuda_ms(fn, reps=calls, inner=1, warmup=0)


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
