"""Probe: what the windowed ball query's fallback guard costs.

    python -m pointnet2_tpu_torch.tools.bq_cond_probe [--device cpu]

The counterpart of the JAX repo's ``tools/bq_cond_probe.py``, at its shapes
and seed (8 clouds of 8192 points from ``RandomState(0)``, every 8th point
as a query, nsample 32, r = 0.1, a 3072-column window). Its TPU columns are
the windowed ball query with its ``lax.cond`` fallback, the same pipeline
with the cond removed (``make_nocond``: sorts, window starts, the windows
cut by dynamic slices, row 7's kernel on them, the inverse query order),
the pipeline behind a cond whose other branch is zeros (``make_dummycond``)
and the exact kernel. Here the kernel on the cut windows is
``csrc/bq_probes.cu``'s ``pn2_ball_query_precut``
(``ops.cuda.bq_precut_cond``), and the cond is a guard it reads on the
device: a block that finds ``fits`` 0 writes the zeros, with no host read
and no second launch. The columns: with-cond (the port's calibrated ball
query, ``ops.ball_query_calibrated``: row 7 reading its windows in place,
with its certificate), no-cond, dummy-cond and full (row 2). The tool
prints the guard's predicate (``max(hi - lo) <= W``), then whether each
variant gives row 2's indices and counts and the oracle's
(``ops.reference.ball_query_np`` on the first 2 clouds) where the windows
fit, or the dummy branch's zeros where they do not, then three interleaved
rounds of the four columns by ``utils.bench.slope_time`` and ``cuda_ms``,
with the card's name and power limit. On the CPU (``--device cpu``) the
plain versions run and no time is taken. ``main(argv, shapes=...)`` runs
another size. A variant that misses its reference makes the tool raise.

The plain version of the kernel (``precut_plain``) writes out row 7's TPU
kernel on the cut windows: the (B, T, tm, W) distances summed from zero,
the keys (a column's original index where it is in the ball and below N,
else N), nsample sweeps of a row min, the picks padded by the first.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.ops import core, cuda, reference
from pointnet2_tpu_torch.tools.bq_i16_probe import (
    LANES, oracle_exact, pad_by_first, row2, same, sweeps, timed_rounds,
)
from pointnet2_tpu_torch.utils.bench import card_line, require_device

SHAPES = dict(b=8, n=8192, m=1024, nsample=32, radius=0.1, window=3072, oracle_clouds=2, rounds=3)


def cut(xs_t: torch.Tensor, lo: torch.Tensor, w: int) -> torch.Tensor:
    """Columns ``[lo, lo + w)`` of each tile from a (B, C, N) tensor: (B, T, C, W)."""
    b, c, _ = xs_t.shape
    t = lo.shape[1]
    cols = lo[:, :, None, None] + torch.arange(w, device=lo.device)
    return xs_t[:, None].expand(b, t, c, xs_t.shape[-1]).gather(3, cols.expand(b, t, c, w))


def precut_plan(xyz1: torch.Tensor, xyz2: torch.Tensor, radius: float, window: int):
    """``make_nocond``'s pipeline up to the kernel, queries in tiles of
    min(128, M): a dict of the sorts (``perm``, ``xs``, ``qperm``,
    ``q_tiles``), each tile's window start ``lo`` and candidates' end ``hi``
    (``ops.core.ball_query_window_bounds``: stable x sorts, the float32
    ``searchsorted`` of the tile's min x - r and max x + r, the start clipped
    and floored to 128 as the JAX tools do), and the cut windows ``win`` (B,
    T, 3, W) float32 and ``permw`` (B, T, 1, W) int32."""
    n, m = xyz1.shape[1], xyz2.shape[1]
    tm = min(LANES, m)
    if not 0 < window <= n:
        raise ValueError(f"the window must hold 1 to N={n} columns, got {window}")
    if m % tm:
        raise ValueError(f"{m} queries do not fill tiles of {tm}")
    perm, xs, qperm, qs, lo, hi = core.ball_query_window_bounds(xyz1, xyz2, radius, window)
    return {
        "perm": perm, "xs": xs, "qperm": qperm, "q_tiles": qs.reshape(qs.shape[0], m // tm, tm, 3),
        "lo": lo, "hi": hi,
        "win": cut(xs.transpose(1, 2), lo, window).contiguous(),
        "permw": cut(perm[:, None, :], lo, window).contiguous(),
    }


def fits_of(plan: dict, window: int) -> torch.Tensor:
    """The guard's predicate, ``max(hi - lo) <= W``, as a 0-d int32 tensor on the plan's device."""
    return ((plan["hi"] - plan["lo"]).amax() <= window).int()


def precut_plain(win, permw, q_tiles, n: int, radius: float, nsample: int, fits=None):
    """Row 7's TPU kernel on the cut windows: win (B, T, 3, W), permw (B, T, 1,
    W), q_tiles (B, T, tm, 3) -> idx (B, T, tm, nsample), cnt (B, T, 1, tm)
    int32; with ``fits`` (0-d) 0, zeros."""
    d2 = torch.zeros((*q_tiles.shape[:3], win.shape[-1]), dtype=torch.float32, device=win.device)
    for c in range(3):
        diff = q_tiles[..., c:c + 1] - win[:, :, c:c + 1, :]
        d2 = d2 + diff * diff
    in_ball = (d2 < core.squared_radius(radius)) & (permw < n)
    keys = torch.where(in_ball, permw, n)
    idx = pad_by_first(sweeps(keys, n, nsample), n)
    cnt = in_ball.sum(-1).clamp_max(nsample).int()[:, :, None, :]
    if fits is not None:
        idx, cnt = (torch.where(fits != 0, x, 0) for x in (idx, cnt))
    return idx, cnt


def precut(win, permw, q_tiles, n: int, radius: float, nsample: int, fits=None):
    """Row 7's function on cut windows: the kernel for CUDA tensors (it raises
    on what it does not take), the plain version for CPU ones."""
    if win.device.type == "cpu":
        return precut_plain(win, permw, q_tiles, n, radius, nsample, fits)
    return cuda.bq_precut_cond(win, permw, q_tiles, n, radius, nsample, fits)


def in_query_order(plan: dict, idx_t: torch.Tensor, cnt_t: torch.Tensor):
    """The kernel's (B, T, tm, ns) / (B, T, 1, tm) outputs in sorted query
    order, put back in the original order: idx (B, M, ns), cnt (B, M)."""
    b, t, tm, ns = idx_t.shape
    inv = torch.argsort(plan["qperm"], dim=1)
    return core._take_rows(idx_t.reshape(b, t * tm, ns), inv), core._take_rows(cnt_t.reshape(b, t * tm), inv)


def nocond(xyz1: torch.Tensor, xyz2: torch.Tensor, radius: float, nsample: int, window: int):
    """``make_nocond``: the pipeline with the kernel on the cut windows, no guard."""
    plan = precut_plan(xyz1, xyz2, radius, window)
    return in_query_order(plan, *precut(plan["win"], plan["permw"], plan["q_tiles"], xyz1.shape[1], radius, nsample))


def dummycond(xyz1: torch.Tensor, xyz2: torch.Tensor, radius: float, nsample: int, window: int):
    """``make_dummycond``: the same behind the guard ``max(hi - lo) <= W``,
    zeros where it fails; the guard is read on the device."""
    plan = precut_plan(xyz1, xyz2, radius, window)
    fits = fits_of(plan, window)
    return in_query_order(
        plan, *precut(plan["win"], plan["permw"], plan["q_tiles"], xyz1.shape[1], radius, nsample, fits)
    )


def main(argv=None, shapes: dict = SHAPES) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu: the plain versions, no times")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    b, n, m, ns, r, w, o = (shapes[k] for k in ("b", "n", "m", "nsample", "radius", "window", "oracle_clouds"))

    x1_np = np.random.RandomState(0).rand(b, n, 3).astype(np.float32)
    x2_np = np.ascontiguousarray(x1_np[:, ::n // m][:, :m])
    xyz1, xyz2 = torch.from_numpy(x1_np).to(device), torch.from_numpy(x2_np).to(device)
    fits = bool(fits_of(precut_plan(xyz1, xyz2, r, w), w))
    print(f"W={w}: the windows fit (max(hi - lo) <= W)={fits}", flush=True)
    want = reference.ball_query_np(x1_np[:o], x2_np[:o], r, ns)
    full = row2(xyz1, xyz2, r, ns)
    got = {"no-cond": nocond(xyz1, xyz2, r, ns, w), "dummy-cond": dummycond(xyz1, xyz2, r, ns, w)}
    idx_c, cnt_c, ok = ops.ball_query_calibrated(xyz1, xyz2, r, ns, w)
    exact = {}
    if fits:
        for name, out in {**got, "with-cond": (idx_c, cnt_c)}.items():
            exact[name] = {"row2": same(out, full), "oracle": oracle_exact(out, want, o)}
            print(f"{name}: exact vs row 2={exact[name]['row2']}; vs the oracle on {o} clouds="
                  f"{exact[name]['oracle']}", flush=True)
        exact["with-cond"]["ok"] = bool(ok)
    else:
        zeros = all(not bool(x.any()) for x in got["dummy-cond"])
        exact["dummy-cond"] = {"zeros": zeros}
        print(f"dummy-cond: the other branch's zeros={zeros}; with-cond ok={bool(ok)} (False: its "
              f"windows miss candidates)", flush=True)
        exact["with-cond"] = {"ok_is_false": not bool(ok)}
    if not all(all(e.values()) for e in exact.values()):
        raise AssertionError(f"a ball-query probe kernel misses its reference: {exact}")

    summary = {"shape": f"B={b} N={n} M={m} nsample={ns} r={r} W={w}", "fits": fits, "exact": exact, "rounds": []}
    if device.type != "cuda":
        print("times: taken on the card only")
        return summary
    card = card_line()
    columns = {
        "with-cond": (lambda c: ops.ball_query_calibrated(c, xyz2, r, ns, w)[0], xyz1,
                      lambda: ops.ball_query_calibrated(xyz1, xyz2, r, ns, w)),
        "no-cond": (lambda c: nocond(c, xyz2, r, ns, w)[0], xyz1, lambda: nocond(xyz1, xyz2, r, ns, w)),
        "dummy-cond": (lambda c: dummycond(c, xyz2, r, ns, w)[0], xyz1, lambda: dummycond(xyz1, xyz2, r, ns, w)),
        "full": (lambda c: row2(c, xyz2, r, ns)[0], xyz1, lambda: row2(xyz1, xyz2, r, ns)),
    }
    summary.update(rounds=timed_rounds(columns, shapes["rounds"], card), card=card)
    return summary


if __name__ == "__main__":
    main()
