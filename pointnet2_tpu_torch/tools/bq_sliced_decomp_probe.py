"""Probe: the windowed ball query's time taken apart.

    python -m pointnet2_tpu_torch.tools.bq_sliced_decomp_probe [--device cpu]

The counterpart of the JAX repo's ``tools/bq_sliced_decomp_probe.py``, at
its shapes and seed (those of ``bq_cond_probe`` with a 2048-column window).
Its TPU columns time apart the parts of the windowed ball query: the kernel
on windows cut beforehand, the cut, the sorts with the window search, and
the exact kernel. Here the kernel on the cut windows is
``csrc/bq_probes.cu``'s ``pn2_ball_query_precut``
(``ops.cuda.bq_precut_decomp``), and the tool adds the port's own answer
beside it: row 7 reading the same windows in place
(``ops.cuda.ball_query_tiles`` at the same window starts). Five columns:
kernel (pre-cut), in-place (row 7), cut, sorts (the stable x sorts and the
window search, ``searchsorted``, as the port's calibrated ball query runs
them) and full (row 2, ``ops.cuda.ball_query``). At this window most tiles' candidates
do not fit (the tool prints the predicate), so the outputs are not the exact
ball query and are held to row 7 in place instead: both take the picks
within each tile's ``[lo, lo + W)``, so they agree bit for bit whether a
tile fits or not. The times: three interleaved rounds by
``utils.bench.slope_time`` and ``cuda_ms``, with the card's name and power
limit. On the CPU (``--device cpu``) the plain versions run and no time is
taken. ``main(argv, shapes=...)`` runs another size. A kernel that misses
row 7 makes the tool raise.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pointnet2_tpu_torch.ops import core, cuda
from pointnet2_tpu_torch.tools.bq_cond_probe import cut, fits_of, precut_plain, precut_plan
from pointnet2_tpu_torch.tools.bq_i16_probe import row2, same, timed_rounds
from pointnet2_tpu_torch.utils.bench import card_line, require_device

SHAPES = dict(b=8, n=8192, m=1024, nsample=32, radius=0.1, window=2048, rounds=3)


def kernel_only(plan: dict, n: int, radius: float, nsample: int, win: torch.Tensor | None = None):
    """The kernel on the plan's cut windows (or on ``win``): idx (B, T, tm,
    ns), cnt (B, T, 1, tm) in sorted query order. The kernel for CUDA tensors,
    the plain version for CPU ones."""
    win = plan["win"] if win is None else win
    if win.device.type == "cpu":
        return precut_plain(win, plan["permw"], plan["q_tiles"], n, radius, nsample)
    return cuda.bq_precut_decomp(win, plan["permw"], plan["q_tiles"], n, radius, nsample)


def in_place(plan: dict, radius: float, nsample: int, w: int, xs: torch.Tensor | None = None):
    """Row 7 reading the same windows in place: idx (B, M, ns), cnt (B, M) in sorted query order."""
    xs = plan["xs"] if xs is None else xs
    b, t, tm, _ = plan["q_tiles"].shape
    args = (xs, plan["perm"], plan["q_tiles"].reshape(b, t * tm, 3), plan["lo"], radius, nsample, w)
    if xs.device.type == "cpu":
        return core.ball_query_tiles(*args)
    return cuda.ball_query_tiles(*args)


def sorts_only(xyz1: torch.Tensor, xyz2: torch.Tensor, radius: float, w: int) -> torch.Tensor:
    """The sorts and the window search as the port's calibrated ball query
    runs them (``ops.core.ball_query_window_bounds``): each tile's window
    start, (B, T) int32."""
    return core.ball_query_window_bounds(xyz1, xyz2, radius, w)[4]


def main(argv=None, shapes: dict = SHAPES) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu: the plain versions, no times")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    b, n, m, ns, r, w = (shapes[k] for k in ("b", "n", "m", "nsample", "radius", "window"))

    x1_np = np.random.RandomState(0).rand(b, n, 3).astype(np.float32)
    x2_np = np.ascontiguousarray(x1_np[:, ::n // m][:, :m])
    xyz1, xyz2 = torch.from_numpy(x1_np).to(device), torch.from_numpy(x2_np).to(device)
    plan = precut_plan(xyz1, xyz2, r, w)
    fits = bool(fits_of(plan, w))
    tiles_fit = int(((plan["hi"] - plan["lo"]) <= w).sum())
    print(f"W={w}: the windows fit={fits} ({tiles_fit} of {plan['lo'].numel()} tiles; "
          f"max(hi - lo)={int((plan['hi'] - plan['lo']).amax())})", flush=True)
    idx_k, cnt_k = kernel_only(plan, n, r, ns)
    row7 = in_place(plan, r, ns, w)
    exact = {"in_place": same((idx_k.reshape(b, m, ns), cnt_k.reshape(b, m)), row7)}
    print(f"kernel on cut windows vs row 7 in place at the same starts: equal={exact['in_place']}", flush=True)
    if not all(exact.values()):
        raise AssertionError(f"a ball-query probe kernel misses its reference: {exact}")

    summary = {"shape": f"B={b} N={n} M={m} nsample={ns} r={r} W={w}", "fits": fits, "tiles_fit": tiles_fit,
               "exact": exact, "rounds": []}
    if device.type != "cuda":
        print("times: taken on the card only")
        return summary
    card = card_line()
    xs_t = plan["xs"].transpose(1, 2).contiguous()
    columns = {
        "kernel": (lambda c: kernel_only(plan, n, r, ns, win=c)[0], plan["win"], lambda: kernel_only(plan, n, r, ns)),
        "in-place": (lambda c: in_place(plan, r, ns, w, xs=c)[0], plan["xs"], lambda: in_place(plan, r, ns, w)),
        "cut": (lambda c: cut(c, plan["lo"], w), xs_t, lambda: cut(xs_t, plan["lo"], w)),
        "sorts": (lambda c: sorts_only(c, xyz2, r, w), xyz1, lambda: sorts_only(xyz1, xyz2, r, w)),
        "full": (lambda c: row2(c, xyz2, r, ns)[0], xyz1, lambda: row2(xyz1, xyz2, r, ns)),
    }
    summary.update(rounds=timed_rounds(columns, shapes["rounds"], card), card=card)
    return summary


if __name__ == "__main__":
    main()
