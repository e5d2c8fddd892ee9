"""Where the card's tracer loses kernel launches in a ``device_ms`` session.

    python -m pointnet2_tpu_torch.tools.profiler_losses [--sessions 20] [--calls 20]

``utils.bench.device_ms`` sums ``torch.profiler``'s kernel durations over a
session of ``calls`` calls, and the tracer now and then keeps fewer kernels
than were launched. This tool runs such sessions of three kernels: the
re-masking FPS probe at its probe shape (64 x 8192 -> 1024, some 0.8 ms a
launch), the same kernel at a tiny shape (1 x 1000 -> 8, microseconds a
launch) and row 6's exchange alone (``ops.cuda.fps.barrier_chain``), each
in three kinds of session:

- ``plain``: the calls, then ``torch.cuda.synchronize()``;
- ``lead-in``: two more calls before them, in the same session (``device_ms``
  makes lead-in calls, and counts only the launches after them);
- ``settled``: a 50 ms sleep after the synchronize, before the session ends.

Each launch is matched to its kernel by the profiler's correlation id (the
runtime's ``cudaLaunchKernel*`` event and the kernel share it:
``utils.bench.timed_launches``, with every call in the range). For each
kernel and kind of session the tool prints one line: the sessions that kept
every launch, the launches kept of those issued, and where in its session
(the launch's place, 0 first) each lost launch lay; ``main`` returns every
session's counts. The card only.
"""

from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch

from pointnet2_tpu_torch.ops import cuda
from pointnet2_tpu_torch.ops.cuda import fps as cuda_fps
from pointnet2_tpu_torch.utils.bench import TIMED, KERNEL_SYMBOLS, card_line, require_device, timed_launches

KINDS = {"plain": (0, 0.0), "lead-in": (2, 0.0), "settled": (0, 0.05)}  # (calls before, seconds after)


def session(fn, kernel: str, calls: int, lead: int, settle: float) -> dict:
    """One profiled session of ``lead + calls`` calls of ``fn`` (one launch
    each): the launches issued, those whose kernel the profiler kept, and
    the places of the lost ones."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(TIMED):  # every call of the session counts here
            for _ in range(lead + calls):
                fn()
            torch.cuda.synchronize()
        if settle:
            time.sleep(settle)
    kernels, _, lost, total = timed_launches(prof, KERNEL_SYMBOLS[kernel])
    return {"issued": lead + calls, "runtime_launches": total, "kernels": kernels,
            "matched": total - len(lost), "lost_at": lost}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=20, help="sessions of each kernel and kind")
    ap.add_argument("--calls", type=int, default=20, help="calls a session, as device_ms's default")
    args = ap.parse_args(argv)
    device = require_device("cuda")
    card = card_line()
    rng = np.random.RandomState(0)
    big = torch.from_numpy((rng.rand(64, 8192, 3) * 10).astype(np.float32)).to(device)
    tiny = torch.from_numpy((rng.rand(1, 1000, 3) * 10).astype(np.float32)).to(device)
    route = cuda_fps.planned_route(big, 1024, rows=False)
    runs = {
        "fps_remask 64x8192->1024": (lambda: cuda.fps_remask(big, 1024, True), "fps_remask"),
        "fps_remask 1x1000->8": (lambda: cuda.fps_remask(tiny, 8, True), "fps_remask"),
        "barrier_chain 64 clusters": (lambda: cuda_fps.barrier_chain(64, 1024, route), "fps_barrier_chain"),
    }
    summary = {"card": card, "calls": args.calls, "sessions": args.sessions, "rows": {}}
    for name, (fn, kernel) in runs.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        for kind, (lead, settle) in KINDS.items():
            rows = [session(fn, kernel, args.calls, lead, settle) for _ in range(args.sessions)]
            whole = sum(r["matched"] == r["issued"] for r in rows)
            places = collections.Counter(i for r in rows for i in r["lost_at"])
            summary["rows"][f"{name}, {kind}"] = {"whole": whole, "sessions": rows}
            print(f"{name}, {kind}: {whole} of {args.sessions} sessions whole; kept "
                  f"{sum(r['matched'] for r in rows)} of {sum(r['issued'] for r in rows)} launches "
                  f"(runtime events {sum(r['runtime_launches'] for r in rows)}, kernels "
                  f"{sum(r['kernels'] for r in rows)}); lost at {dict(sorted(places.items()))} | {card}", flush=True)
    return summary


if __name__ == "__main__":
    main()
