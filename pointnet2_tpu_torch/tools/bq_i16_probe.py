"""Probe: int16 against int32 keys in the ball query's first-k extraction sweeps.

    python -m pointnet2_tpu_torch.tools.bq_i16_probe [--device cpu]

The counterpart of the JAX repo's ``tools/bq_i16_probe.py``, at its shapes
and seed (SA1's chunk: 8 clouds of 8192 points from ``RandomState(0)``, the
first 1024 points plus 0.001 as queries, nsample 32, r = 0.1). Its TPU
kernel builds each query's key row (the column where it is in the ball,
else N) and extracts the picks by nsample full-width min sweeps, with keys
of 32 or 16 bits. Here the kernel is ``csrc/bq_probes.cu``'s
``pn2_bq_keys`` (``ops.cuda.bq_keys``): each block stages its cloud in
shared memory, whole up to 18432 points and else through a ring of
chunks, by TMA bulk copies where its chunks are 16-byte aligned and else
by its own loads; a warp takes 2 queries, building each query's keys in
registers a segment at a time (4 words a lane: 4 columns of int32 keys, or
8 of int16 two to a word) and taking the picks by warp-wide min sweeps
over the segment. The width is the only difference: both widths run one
plan, ``ops.cuda.bq_probes.key_plan``'s warps a block. The tool prints
whether both widths give row 2's indices and counts (``ops.cuda.ball_query``) and
the oracle's (``ops.reference.ball_query_np`` on the first 2 clouds), and
each other's, each width's plan (warps, kq, v) and staging, then three
interleaved rounds of int32, int16 and row 2: ``utils.bench.slope_time``
(the JAX tool's timer) and ``cuda_ms`` beside it, with the card's name and
power limit. On the CPU (``--device cpu``) the plain versions run and no
time is taken. ``main(argv, shapes=...)`` runs another size (the CPU tests
do). A variant that misses its reference makes the tool raise.

The plain version writes out the probe's formulation: the cloud padded to
whole 128-column lanes with 1e30, the (B, M, Npad) distance rows summed
from zero as the kernel sums them, the keys cast to the width, then nsample
sweeps of a row min, each setting the keys equal to it to N.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from pointnet2_tpu_torch.ops import core, cuda, reference
from pointnet2_tpu_torch.ops.cuda import bq_probes
from pointnet2_tpu_torch.utils.bench import card_line, cuda_ms, require_device, slope_time

LANES = 128  # the TPU kernel pads N to whole lanes
SHAPES = dict(b=8, n=8192, m=1024, nsample=32, radius=0.1, oracle_clouds=2, rounds=3)


def sweeps(keys: torch.Tensor, n: int, nsample: int) -> torch.Tensor:
    """nsample sweeps over the last axis of ``keys`` (N marks an absent
    column): each takes the row's min, the sweep's pick, and sets the keys
    equal to it to N. Returns the picks (N past the hits), int32."""
    sel = []
    for _ in range(nsample):
        kmin = keys.amin(-1, keepdim=True)
        sel.append(kmin)
        keys = torch.where(keys == kmin, torch.full_like(keys, n), keys)
    return torch.cat(sel, -1).int()


def pad_by_first(sel: torch.Tensor, n: int) -> torch.Tensor:
    """The picks with every N replaced by the first pick, or by 0 when there is none."""
    first = sel[..., :1]
    first = torch.where(first < n, first, 0)
    return torch.where(sel < n, sel, first)


def padded_cloud(xyz1: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) -> (B, 3, Npad) float32, the columns past N at 1e30."""
    n = xyz1.shape[1]
    return F.pad(xyz1.float().transpose(1, 2), (0, -n % LANES), value=1e30)


def bq_keys_plain(xyz1: torch.Tensor, xyz2: torch.Tensor, radius: float, nsample: int, use_i16: bool):
    """The probe's formulation: xyz1 (B, N, 3), xyz2 (B, M, 3) -> idx (B, M,
    nsample), cnt (B, M) int32; keys int16 (``use_i16``) or int32."""
    n = xyz1.shape[1]
    x1 = padded_cloud(xyz1)
    x2 = xyz2.float()
    d2 = torch.zeros((x2.shape[0], x2.shape[1], x1.shape[-1]), dtype=torch.float32, device=x1.device)
    for c in range(3):
        diff = x2[:, :, c:c + 1] - x1[:, c:c + 1, :]
        d2 = d2 + diff * diff
    col = torch.arange(x1.shape[-1], device=x1.device)
    in_ball = (d2 < core.squared_radius(radius)) & (col < n)
    keys = torch.where(in_ball, col, n).to(torch.int16 if use_i16 else torch.int32)
    cnt = in_ball.sum(-1).clamp_max(nsample).int()
    return pad_by_first(sweeps(keys, n, nsample), n), cnt


def bq_keys(xyz1: torch.Tensor, xyz2: torch.Tensor, radius: float, nsample: int, use_i16: bool):
    """Row 2's function by first-k sweeps: the kernel for CUDA tensors (it
    raises on what it does not take), the plain version for CPU ones."""
    if xyz1.device.type == "cpu":
        return bq_keys_plain(xyz1, xyz2, radius, nsample, use_i16)
    return cuda.bq_keys(xyz1, xyz2, radius, nsample, use_i16)


def row2(xyz1: torch.Tensor, xyz2: torch.Tensor, radius: float, nsample: int):
    """The production exact ball query: the kernel on the card, the plain version on the CPU."""
    if xyz1.device.type == "cpu":
        return core.ball_query(xyz1, xyz2, radius, nsample)
    return cuda.ball_query(xyz1, xyz2, radius, nsample)


def probe_clouds(shapes: dict, device: torch.device) -> tuple[np.ndarray, np.ndarray, torch.Tensor, torch.Tensor]:
    """The JAX tool's inputs: ``RandomState(0)`` clouds in the unit cube and
    their first M points plus 0.001, as numpy arrays and on ``device``."""
    b, n, m = shapes["b"], shapes["n"], shapes["m"]
    xyz1 = np.random.RandomState(0).rand(b, n, 3).astype(np.float32)
    xyz2 = (xyz1[:, :m] + np.float32(0.001)).astype(np.float32)
    return xyz1, xyz2, torch.from_numpy(xyz1).to(device), torch.from_numpy(xyz2).to(device)


def same(a: tuple, b: tuple) -> bool:
    """Whether two (idx, cnt) pairs are equal bit for bit."""
    return all(bool(torch.equal(x, y)) for x, y in zip(a, b))


def oracle_exact(got: tuple, want: tuple, clouds: int) -> bool:
    """(idx, cnt) on the first ``clouds`` clouds against the oracle's numpy pair."""
    return all(bool((g[:clouds].cpu().numpy() == w).all()) for g, w in zip(got, want))


def timed_rounds(columns: dict, rounds: int, card: str) -> list:
    """``rounds`` interleaved rounds of every column: ``name -> (step_fn, x,
    call)``, timed by ``slope_time(step_fn, x)`` and ``cuda_ms(call)``. Prints
    a line a round; returns each round's ms by column."""
    out = []
    for rep in range(rounds):
        t = {}
        for name, (step_fn, x, call) in columns.items():
            t[name] = slope_time(step_fn, x) * 1e3
            t[f"{name}_events"] = cuda_ms(call)
        print(f"rep {rep}: " + "  ".join(f"{name} {t[name]:7.3f} ms (events {t[name + '_events']:7.3f})"
                                         for name in columns) + f" | {card}", flush=True)
        out.append(t)
    return out


def main(argv=None, shapes: dict = SHAPES) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu: the plain versions, no times")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    b, n, m, ns, r, o = (shapes[k] for k in ("b", "n", "m", "nsample", "radius", "oracle_clouds"))

    x1_np, x2_np, xyz1, xyz2 = probe_clouds(shapes, device)
    want = reference.ball_query_np(x1_np[:o], x2_np[:o], r, ns)
    full = row2(xyz1, xyz2, r, ns)
    got = {width: bq_keys(xyz1, xyz2, r, ns, width == "i16") for width in ("i32", "i16")}
    exact = {}
    for width, out in got.items():
        exact[width] = {"row2": same(out, full), "oracle": oracle_exact(out, want, o)}
        print(f"{width}: exact vs row 2={exact[width]['row2']}; vs the oracle on {o} clouds="
              f"{exact[width]['oracle']}", flush=True)
    agree = same(got["i32"], got["i16"])
    print(f"i16 vs i32 agree={agree}", flush=True)
    if not (agree and all(all(e.values()) for e in exact.values())):
        raise AssertionError(f"a ball-query probe kernel misses its reference: {exact}, agree={agree}")

    summary = {"shape": f"B={b} N={n} M={m} nsample={ns} r={r}", "exact": exact, "agree": agree, "rounds": []}
    if device.type != "cuda":
        print("times: taken on the card only")
        return summary
    card = card_line()
    summary["plans"] = {}
    for width in ("i32", "i16"):
        warps, how = bq_probes.key_route(xyz1, m, width == "i16")
        kq, v = bq_probes.SWEEP_KQ, bq_probes.SWEEP_V
        summary["plans"][width] = {"warps": warps, "kq": kq, "v": v, "staging": how}
        print(f"{width} plan: {warps} warps a block, kq={kq}, v={v}, staged by {how}", flush=True)
    columns = {
        "i32": (lambda c: bq_keys(c, xyz2, r, ns, False)[0], xyz1, lambda: bq_keys(xyz1, xyz2, r, ns, False)),
        "i16": (lambda c: bq_keys(c, xyz2, r, ns, True)[0], xyz1, lambda: bq_keys(xyz1, xyz2, r, ns, True)),
        "row2": (lambda c: row2(c, xyz2, r, ns)[0], xyz1, lambda: row2(xyz1, xyz2, r, ns)),
    }
    summary.update(rounds=timed_rounds(columns, shapes["rounds"], card), card=card)
    return summary


if __name__ == "__main__":
    main()
