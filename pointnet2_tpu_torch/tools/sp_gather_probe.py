"""Probe: gathers whose indices, or whose window of rows, are staged on chip before the copies.

    python -m pointnet2_tpu_torch.tools.sp_gather_probe [eval32] [eval] [train] [--device cpu]

The counterpart of the JAX repo's ``tools/sp_gather_probe.py``, at its
regimes and seed: N = 8192 points sorted by x, M = 1024 queries in tiles of
128, K = 32 indices a query inside each tile's span of 3072 rows (blocks of
W = 4096), from ``RandomState(0)``; ``eval32`` 8 clouds of 32 channels (SA1's
pre-projected width), ``eval`` 8 x 64, ``train`` 4 x 8; all three by
default. Its TPU kernels are ``sp_row`` (the whole index array prefetched
into SMEM, rows copied from the VMEM cloud in tiles of 4096) and ``sp_win``
(each tile's two W-row blocks, the second clamped at the cloud's end, in one
(2W, C) VMEM scratch, rows copied by relative index, unroll 4 / 8 / 16).
Here they are ``csrc/gather_probes.cu``'s ``pn2_gather_rows_staged``
(``ops.cuda.gather_rows_staged``: a tile's indices staged in shared memory
first) and ``pn2_gather_window_staged`` (``ops.cuda.gather_window_staged``:
the window staged a 16-byte channel slice at a time, 2W x 16 bytes). The
tool checks on the host that every relative index lies in [0, 2W), prints
whether each variant equals ``group_points`` (the JAX tool's ``xla``) and
row 9 (``window_gather``: at window start 0 for ``sp_row``, at ``kblk * W``
for ``sp_win``), then three interleaved rounds of every column by
``utils.bench.slope_time`` and ``cuda_ms``, each column's GB/s of output,
and the kernels' device ms by the profiler, with the card's name and power
limit. On the CPU (``--device cpu``) the plain versions run and no time is
taken. ``main(argv, shapes=...)`` runs other sizes. A variant that misses
its reference makes the tool raise.

The plain versions write out the probes' tiling: ``sp_row_plain`` takes
each tile of 4096 rows in turn; ``sp_win_plain`` builds each tile's (2W, C)
scratch from its two clamped blocks and indexes it by the relative indices.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pointnet2_tpu_torch.ops import cuda
from pointnet2_tpu_torch.ops.cuda.gather_probes import (
    STAGED_TILE, STAGING, WINDOW_UNROLLS, relative_indices, window_shared_bytes,
)
from pointnet2_tpu_torch.tools.bq_i16_probe import timed_rounds
from pointnet2_tpu_torch.tools.gather_probe import (
    group_points, kernel_device_ms, report_rates, row9, row9_at_zero, tiled_take,
)
from pointnet2_tpu_torch.utils.bench import card_line, require_device

REGIMES = {  # sp_gather_probe.py:294-302
    "eval32": dict(label="eval SA1 zp regime", b=8, c=32),
    "eval": dict(label="eval chunk regime", b=8, c=64),
    "train": dict(label="train micro regime", b=4, c=8),
}
SHAPES = dict(n=8192, m=1024, k=32, span=3072, w=4096, tm=128, rounds=3, regimes=REGIMES)


def sp_row_plain(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The probe's tiling: (B, N, C), (B, R) -> (B, R, C) in tiles of 4096 rows."""
    return tiled_take("gather_rows_staged", points, idx, STAGED_TILE)


def sp_win_plain(points: torch.Tensor, idx: torch.Tensor, kblk: torch.Tensor, w: int, tm: int) -> torch.Tensor:
    """The probe's staging: points (B, N, C), idx (B, M, K), kblk (B, M / tm)
    -> (B, M * K, C). Each tile's (2W, C) scratch is blocks kblk and
    min(kblk + 1, N / W - 1) of W rows; its rows are read at ``idx - kblk * W``."""
    b, n, c = points.shape
    m, k = idx.shape[1:]
    if tm <= 0 or m % tm or w <= 0 or n % w:
        raise ValueError(f"sp_win needs M a multiple of tm and N of w, got M={m}, tm={tm}, N={n}, w={w}")
    first = kblk.long()[..., None] * w
    second = torch.clamp(kblk.long() + 1, max=n // w - 1)[..., None] * w
    ar = torch.arange(w, device=points.device)
    window_rows = torch.cat([first + ar, second + ar], -1)  # (B, T, 2W)
    scratch = torch.take_along_dim(points[:, None], window_rows[..., None], dim=2)  # (B, T, 2W, C)
    rel = relative_indices(idx, kblk, w, tm).long()
    return torch.take_along_dim(scratch, rel[..., None], dim=2).reshape(b, m * k, c)


def sp_row(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P10: the kernel for CUDA tensors, the plain version for CPU ones."""
    if points.device.type == "cpu":
        return sp_row_plain(points, idx)
    return cuda.gather_rows_staged(points, idx)


def sp_win(points: torch.Tensor, idx: torch.Tensor, kblk: torch.Tensor, w: int, tm: int, unroll: int) -> torch.Tensor:
    """P11 at ``unroll``: the kernel for CUDA tensors, the plain version for CPU ones."""
    if points.device.type == "cpu":
        if unroll not in WINDOW_UNROLLS:
            raise ValueError(f"sp_win takes unroll in {WINDOW_UNROLLS}, got {unroll}")
        return sp_win_plain(points, idx, kblk, w, tm)
    return cuda.gather_window_staged(points, idx, kblk, w, tm, unroll)


def regime_inputs(b: int, c: int, shapes: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``run_regime``'s inputs (``sp_gather_probe.py:227-241``): points (B,
    N, C) rising in x with 1e-3 noise, idx (B, M, K) inside each tile's span
    from its base, kblk (B, T) = base // W, from ``RandomState(0)``."""
    n, m, k, span, w, tm = (shapes[key] for key in ("n", "m", "k", "span", "w", "tm"))
    rng = np.random.RandomState(0)
    pts = np.sort(rng.rand(b, n).astype(np.float32))[..., None] * np.ones((1, 1, c), np.float32)
    pts += rng.rand(b, n, c).astype(np.float32) * 1e-3
    t = m // tm
    base = np.minimum((np.arange(t) * (n - span) // max(t - 1, 1)), n - span).astype(np.int32)
    base = np.broadcast_to(base, (b, t)).copy()
    idx = (base[:, :, None, None] + rng.randint(0, span, (b, t, tm, k))).astype(np.int32).reshape(b, m, k)
    return pts, idx, (base // w).astype(np.int32)


def check_window(idx: np.ndarray, kblk: np.ndarray, w: int, tm: int) -> None:
    """The invariant the production path certifies (``sp_gather_probe.py:242-244``):
    every index in [kblk * W, kblk * W + 2W) of its tile."""
    b, m, k = idx.shape
    rel = idx.reshape(b, m // tm, tm * k) - kblk[:, :, None] * w
    if not ((rel >= 0).all() and (rel < 2 * w).all()):
        raise AssertionError(f"a relative index leaves [0, 2W): min {rel.min()}, max {rel.max()}, W={w}")


def run_regime(name: str, regime: dict, shapes: dict, device: torch.device) -> dict:
    b, c = regime["b"], regime["c"]
    n, m, k, span, w, tm = (shapes[key] for key in ("n", "m", "k", "span", "w", "tm"))
    print(f"\n== {name}: {regime['label']}: B={b} N={n} C={c} M={m} K={k} (span {span}, block w {w}, tile {tm}) ==",
          flush=True)
    pts_np, idx_np, kblk_np = regime_inputs(b, c, shapes)
    check_window(idx_np, kblk_np, w, tm)
    pts, idx3, kblk = (torch.from_numpy(a).to(device) for a in (pts_np, idx_np, kblk_np))
    idx = idx3.view(b, m * k)
    lo = kblk * w
    rel3 = relative_indices(idx3, kblk, w, tm).view(b, m, k)

    want = group_points(pts, idx, m, k)
    got = sp_row(pts, idx)
    exact = {"sp_row": {"group_points": bool(torch.equal(got, want)),
                        "row9": bool(torch.equal(got, row9_at_zero(pts, idx, m, k)))}}
    win_row9 = row9(pts, lo, rel3).view(b, m * k, c)
    for u in WINDOW_UNROLLS:
        got = sp_win(pts, idx3, kblk, w, tm, u)
        exact[f"sp_win/u{u}"] = {"group_points": bool(torch.equal(got, want)),
                                 "row9": bool(torch.equal(got, win_row9))}
    print(f"sp_row stages each tile's {STAGED_TILE} indices by {STAGING}; sp_win stages 2W x 16 bytes a slice "
          f"({window_shared_bytes(w, tm * k)} bytes of shared memory with the relative indices)", flush=True)
    for variant, e in exact.items():
        print(f"{variant}: exact vs group_points={e['group_points']}; vs row 9={e['row9']}", flush=True)
    if not all(all(e.values()) for e in exact.values()):
        raise AssertionError(f"a gather probe kernel misses its reference: {exact}")

    summary = {"shape": f"B={b} N={n} C={c} M={m} K={k} W={w} span={span}", "exact": exact}
    if device.type != "cuda":
        return summary
    card = card_line()
    columns = {
        "group_points": (lambda p: group_points(p, idx, m, k), pts, lambda: group_points(pts, idx, m, k)),
        "row9": (lambda p: row9_at_zero(p, idx, m, k), pts, lambda: row9_at_zero(pts, idx, m, k)),
        "sp_row": (lambda p: sp_row(p, idx), pts, lambda: sp_row(pts, idx)),
        "row9_win": (lambda p: row9(p, lo, rel3), pts, lambda: row9(pts, lo, rel3)),
    }
    for u in WINDOW_UNROLLS:
        columns[f"sp_win/u{u}"] = (lambda p, u=u: sp_win(p, idx3, kblk, w, tm, u), pts,
                                   lambda u=u: sp_win(pts, idx3, kblk, w, tm, u))
    rounds = timed_rounds(columns, shapes["rounds"], card)
    calls = {"sp_row": ("gather_rows_staged", lambda: sp_row(pts, idx)),
             "row9": ("window_gather", lambda: row9_at_zero(pts, idx, m, k)),
             "row9_win": ("window_gather", lambda: row9(pts, lo, rel3))}
    calls.update({f"sp_win/u{u}": ("gather_window_staged", lambda u=u: sp_win(pts, idx3, kblk, w, tm, u))
                  for u in WINDOW_UNROLLS})
    summary.update(rounds=rounds, card=card, rates=report_rates(rounds, columns, b * m * k * c * 4, b * m * k),
                   device_ms=kernel_device_ms(calls, card))
    return summary


def main(argv=None, shapes: dict = SHAPES) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("regimes", nargs="*", help=f"any of {', '.join(shapes['regimes'])} (default: all)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu: the plain versions, no times")
    args = ap.parse_args(argv)
    unknown = [r for r in args.regimes if r not in shapes["regimes"]]
    if unknown:
        ap.error(f"unknown regimes {unknown}: choose from {list(shapes['regimes'])}")
    device = require_device(args.device)
    out = {name: run_regime(name, regime, shapes, device)
           for name, regime in shapes["regimes"].items() if not args.regimes or name in args.regimes}
    if device.type != "cuda":
        print("times: taken on the card only")
    return out


if __name__ == "__main__":
    main()
