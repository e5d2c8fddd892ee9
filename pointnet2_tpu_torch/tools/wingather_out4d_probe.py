"""Probe: the windowed grouping with its gather writing (B, M, K, C) by (query, pick).

    python -m pointnet2_tpu_torch.tools.wingather_out4d_probe [--device cpu]

The counterpart of the JAX repo's ``tools/wingather_out4d_probe.py``, at its
shape and seed: 8 clouds of 8192 points in 8 x 8 x 4.9 m boxes with 6 input
channels from ``RandomState(0)``, a projection to 32 channels (``randn *
0.1``), 1024 FPS centroids, K = 32, r = 0.5, a 3072-column window. Its A is
the shipped ``project_group_sliced`` (rows 8 and 9, writing (B, T, tm * K,
C) and reshaping); its B, ``project_group_sliced_4d``, runs row 8's kernel
on windows cut up front (``(B, T, 3, W)`` coordinates and ``(B, T, 1, W)``
original indices, each a dynamic slice at the tile's aligned start) and a
gather that stages the tile's two ``wblk``-row blocks and writes each pick as
a (1, 1, C) slab of the (B, M, K, C) output. Here A is the port's
``ops.project_group_calibrated`` (``core.project_group_sliced`` over
``pn2_ball_query_tiles_pos`` and ``pn2_window_gather``), and B's kernels
are ``csrc/bq_probes.cu``'s ``pn2_ball_query_precut_pos``
(``ops.cuda.bq_precut_pos``: the pre-cut windows' ball query with each
pick's window column) and
``csrc/gather_probes.cu``'s ``pn2_gather_window_out4d``
(``ops.cuda.gather_window_out4d``: each tile's span of whole rows staged by
bulk copies over several blocks, P11's routine). The card's layout of (B, M, K, C)
is the flat one, so what B changes there is how the kernels are fed and
address their output. The tool prints both window certificates and whether
B's grouped rows, indices and counts equal A's, then three interleaved rounds
of A and B by ``utils.bench.slope_time`` and ``cuda_ms``, and each of B's
kernels' device ms by the profiler beside row 8 reading its windows in place
and row 9, with the card's name and power limit. On the CPU (``--device
cpu``) the plain versions run and no time is taken. ``main(argv,
shapes=...)`` runs another size. A certificate that fails, or a B that
misses A, makes the tool raise.

The plain versions write out the TPU kernels: ``precut_pos_plain`` builds
each tile's (tm, W) keys ``orig * W + column`` (``n * W`` out of the ball),
takes nsample sweeps of a row min and pads by the first pick;
``window_out4d_plain`` builds each tile's (2 wblk, C) scratch from its two
blocks, the second clamped at the cloud's last block, and indexes it.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.ops import core, cuda
from pointnet2_tpu_torch.tools.bq_cond_probe import cut
from pointnet2_tpu_torch.tools.bq_i16_probe import pad_by_first, sweeps, timed_rounds
from pointnet2_tpu_torch.tools.gather_probe import kernel_device_ms
from pointnet2_tpu_torch.tools.sp_gather_probe import span_info, span_line
from pointnet2_tpu_torch.utils.bench import card_line, require_device

BOX = (8.0, 8.0, 4.9)  # wingather_out4d_probe.py:203, metres
SHAPES = dict(b=8, n=8192, m=1024, k=32, c_in=6, f0=32, window=3072, radius=0.5, rounds=3)


def probe_inputs(shapes: dict, device: torch.device):
    """The JAX tool's inputs (``:199-211``): ``RandomState(0)`` points in
    the boxes, ``inputs`` (B, N, C_IN) their coordinates then uniform
    features, ``w0`` (C_IN, F0) and ``b0`` (F0,) ``randn * 0.1``; returns
    ``(inputs, w0, b0, xyz)`` float32 on ``device``."""
    b, n, c_in, f0 = (shapes[key] for key in ("b", "n", "c_in", "f0"))
    rng = np.random.RandomState(0)
    xyz = np.zeros((b, n, 3), np.float32)
    xyz[:] = rng.rand(b, n, 3) * list(BOX)
    inputs = np.concatenate([xyz, rng.rand(b, n, c_in - 3).astype(np.float32)], axis=-1)
    w0 = rng.randn(c_in, f0).astype(np.float32) * 0.1
    b0 = rng.randn(f0).astype(np.float32) * 0.1
    return tuple(torch.from_numpy(a).to(device) for a in (inputs, w0, b0, xyz))


def precut_pos_plain(win, permw, q_tiles, n: int, radius: float, nsample: int):
    """Row 8's TPU kernel on the cut windows: win (B, T, 3, W), permw (B, T,
    1, W), q_tiles (B, T, tm, 3) -> idx, pos (B, T, tm, nsample), cnt (B, T,
    1, tm) int32. Keys ``orig * W + column`` where in the ball and ``orig <
    n``, else ``n * W``; the nsample smallest, padded by the first (0 for an
    empty ball); ``key // W`` the index, ``key % W`` the column."""
    w = win.shape[-1]
    sent = n * w
    if sent >= 2**31:
        raise ValueError(f"keys orig * W + column need N * W < 2**31, got N={n}, W={w}")
    d2 = torch.zeros((*q_tiles.shape[:3], w), dtype=torch.float32, device=win.device)
    for c in range(3):
        diff = q_tiles[..., c:c + 1] - win[:, :, c:c + 1, :]
        d2 = d2 + diff * diff
    in_ball = (d2 < core.squared_radius(radius)) & (permw < n)
    keys = torch.where(in_ball, permw * w + torch.arange(w, dtype=torch.int32, device=win.device), sent)
    sel = pad_by_first(sweeps(keys, sent, nsample), sent)
    cnt = in_ball.sum(-1).clamp_max(nsample).int()[:, :, None, :]
    return torch.div(sel, w, rounding_mode="floor").int(), (sel % w).int(), cnt


def bq_precut_pos(win, permw, q_tiles, n: int, radius: float, nsample: int):
    """P13: the kernel for CUDA tensors (it raises on what it does not take),
    the plain version for CPU ones."""
    if win.device.type == "cpu":
        return precut_pos_plain(win, permw, q_tiles, n, radius, nsample)
    return cuda.bq_precut_pos(win, permw, q_tiles, n, radius, nsample)


def window_out4d_plain(zp_s: torch.Tensor, rel: torch.Tensor, kblk: torch.Tensor, wblk: int, tm: int,
                       k: int) -> torch.Tensor:
    """``_window_gather_kernel_4d``'s staging: zp_s (B, N, C), rel (B, T, 1,
    tm * K), kblk (B, T) -> (B, T * tm, K, C). Each tile's (2 wblk, C)
    scratch is blocks kblk and min(kblk + 1, N / wblk - 1); pick (q, s) is
    its row ``rel[b, t, 0, q * K + s]``."""
    b, n, c = zp_s.shape
    t, trk = rel.shape[1], rel.shape[3]
    if wblk <= 0 or n % wblk or tm <= 0 or k <= 0 or trk != tm * k:
        raise ValueError(f"window_out4d needs N a multiple of wblk and tm * K indices a tile, got N={n}, "
                         f"wblk={wblk}, tm={tm}, K={k}, rel {tuple(rel.shape)}")
    first = kblk.long()[..., None] * wblk
    second = torch.clamp(kblk.long() + 1, max=n // wblk - 1)[..., None] * wblk
    ar = torch.arange(wblk, device=zp_s.device)
    rows = torch.cat([first + ar, second + ar], -1)  # (B, T, 2 wblk)
    scratch = torch.take_along_dim(zp_s[:, None], rows[..., None], dim=2)  # (B, T, 2 wblk, C)
    picked = torch.take_along_dim(scratch, rel[:, :, 0, :, None].long(), dim=2)  # (B, T, tm * K, C)
    return picked.reshape(b, t * tm, k, c)


def window_out4d(zp_s: torch.Tensor, rel: torch.Tensor, kblk: torch.Tensor, wblk: int, tm: int,
                 k: int) -> torch.Tensor:
    """P14: the kernel for CUDA tensors, the plain version for CPU ones."""
    if zp_s.device.type == "cpu":
        return window_out4d_plain(zp_s, rel, kblk, wblk, tm, k)
    return cuda.gather_window_out4d(zp_s, rel, kblk, wblk, tm, k)


def window_plan(inputs, xyz, new_xyz, radius: float, window: int) -> dict:
    """``project_group_sliced_4d``'s steps up to its ball query (``:75-119``):
    the shapes (``tm``, ``t``, ``w``, ``wblk``), the sorts (``perm`` int32,
    ``xs``, ``sorted_inputs``, ``qperm``, ``qs``, ``q_tiles``), each tile's
    aligned start ``lo`` (int32) and the certificate ``ok``, and the cut
    windows ``win`` (B, T, 3, W) and ``permw`` (B, T, 1, W). The sorts and
    starts are the port's ``project_group_sliced``'s. Raises where the JAX
    function asserts: a window that covers the cloud, partial tiles, or no
    block width dividing N."""
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    tm = min(core.LANES, m)
    w = core.round_up(window, core.LANES)
    wblk = core.pick_wblk(n, w)
    if w >= n or m % tm or wblk is None:
        raise ValueError(f"the 4-D grouping needs W < N, whole tiles of {tm} and a block width dividing N, "
                         f"got N={n}, M={m}, W={w}")
    x1, x2 = xyz.float(), new_xyz.float()
    perm = core._x_sort(x1)
    cat_s = core._take_rows(torch.cat([x1, inputs.float()], dim=-1), perm)
    xs, sorted_inputs = cat_s[..., :3].contiguous(), cat_s[..., 3:]
    qperm = core._x_sort(x2)
    qs = core._take_rows(x2, qperm)
    lo, ok = core._bq_window_starts(xs[..., 0].contiguous(), qs[..., 0], radius, tm, w)
    lo = lo.to(torch.int32)
    perm = perm.to(torch.int32)
    return {
        "tm": tm, "t": m // tm, "w": w, "wblk": wblk, "perm": perm, "xs": xs, "sorted_inputs": sorted_inputs,
        "qperm": qperm, "qs": qs, "q_tiles": qs.reshape(b, m // tm, tm, 3), "lo": lo, "ok": ok,
        "win": cut(xs.transpose(1, 2), lo, w).contiguous(), "permw": cut(perm[:, None, :], lo, w).contiguous(),
    }


def relative_rows(pos_s: torch.Tensor, lo: torch.Tensor, wblk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(kblk, rel)`` of ``:157-159``: each tile's first block ``lo //
    wblk`` (B, T) and its picks' window rows ``pos + lo mod wblk``, (B, T,
    1, tm * K), both int32."""
    b, t = pos_s.shape[:2]
    kblk = torch.div(lo, wblk, rounding_mode="floor").to(torch.int32)
    off = (lo - kblk * wblk).to(torch.int32)
    rel = (pos_s.reshape(b, t, -1) + off[:, :, None])[:, :, None, :]
    return kblk, rel.to(torch.int32).contiguous()


def project_group_sliced_4d(inputs, w0, b0, xyz, new_xyz, radius: float, nsample: int, window: int):
    """The probe's ``project_group_sliced_4d`` (``:72-197``): ``(grouped,
    idx, cnt, qperm, inv_q, ok)`` as the port's ``core.project_group_sliced``
    returns them (``grouped`` (B, M, K, f0) in x-sorted query order, ``idx``
    and ``cnt`` in the original order), through P13 on the cut windows and
    P14 on the sorted projection."""
    b = xyz.shape[0]
    m = new_xyz.shape[1]
    k = nsample
    plan = window_plan(inputs, xyz, new_xyz, radius, window)
    idx_s, pos_s, cnt_s = bq_precut_pos(plan["win"], plan["permw"], plan["q_tiles"], xyz.shape[1], radius, k)
    zp_s = plan["sorted_inputs"] @ w0 + b0  # (B, N, f0), in sorted order
    kblk, rel = relative_rows(pos_s, plan["lo"], plan["wblk"])
    grouped_s = window_out4d(zp_s, rel, kblk, plan["wblk"], plan["tm"], k)
    inv_q = torch.argsort(plan["qperm"], dim=1)
    idx = core._take_rows(idx_s.reshape(b, m, k), inv_q)
    cnt = core._take_rows(cnt_s.reshape(b, m), inv_q)
    return grouped_s, idx, cnt, plan["qperm"], inv_q, plan["ok"]


def main(argv=None, shapes: dict = SHAPES) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu: the plain versions, no times")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    b, n, m, k, f0, w, r = (shapes[key] for key in ("b", "n", "m", "k", "f0", "window", "radius"))

    inputs, w0, b0, xyz = probe_inputs(shapes, device)
    new_xyz = ops.fps_centroids(xyz, m)[1]
    shipped = lambda x: ops.project_group_calibrated(x, w0, b0, xyz, new_xyz, r, k, w)
    out4d = lambda x: project_group_sliced_4d(x, w0, b0, xyz, new_xyz, r, k, w)
    a, got = shipped(inputs), out4d(inputs)
    ok = {"shipped": bool(a[5]), "4d": bool(got[5])}
    print(f"window certificate: shipped={ok['shipped']} 4d={ok['4d']}", flush=True)
    if not all(ok.values()):
        raise AssertionError(f"the window certificate fails at W={w}: {ok}")
    exact = {name: bool(torch.equal(x, y)) for name, x, y in zip(("grouped", "idx", "cnt"), a, got)}
    print("4D (M, K, C) out vs shipped (T, TRK, C) + reshape: "
          + "; ".join(f"{name} equal={same}" for name, same in exact.items()), flush=True)
    if not all(exact.values()):
        raise AssertionError(f"the 4-D variant misses the shipped path: {exact}")
    del a, got

    plan = window_plan(inputs, xyz, new_xyz, r, w)
    summary = {"shape": f"B={b} N={n} M={m} K={k} C={f0} W={plan['w']} wblk={plan['wblk']} r={r}",
               "ok": ok, "exact": exact, "rounds": []}
    staging = "P14 stages each tile's span of whole rows, split over blocks"
    if device.type != "cuda":
        print(staging)
        print("times: taken on the card only")
        return summary
    card = card_line()
    win_args = (plan["win"], plan["permw"], plan["q_tiles"], n, r, k)
    idx_s, pos_s, cnt_s = cuda.bq_precut_pos(*win_args)
    zp_s = plan["sorted_inputs"] @ w0 + b0
    kblk, rel = relative_rows(pos_s, plan["lo"], plan["wblk"])
    print(staging + span_line(zp_s, rel, kblk, plan["wblk"], plan["tm"] * k, "gather_window_out4d"), flush=True)
    summary["span"] = span_info("gather_window_out4d", zp_s, rel, kblk, plan["wblk"], plan["tm"] * k)
    columns = {
        "shipped (T,TRK,C)+reshape": (lambda x: shipped(x)[0][..., :1], inputs, lambda: shipped(inputs)),
        "4D (M,K,C) direct out": (lambda x: out4d(x)[0][..., :1], inputs, lambda: out4d(inputs)),
    }
    rounds = timed_rounds(columns, shapes["rounds"], card)
    pos = pos_s.reshape(b, m, k)
    calls = {
        "P13 bq_precut_pos": ("bq_precut_pos", lambda: cuda.bq_precut_pos(*win_args)),
        "row8 in place": ("ball_query_sliced_pos",
                          lambda: cuda.ball_query_tiles_pos(plan["xs"], plan["perm"], plan["qs"], plan["lo"], r, k,
                                                            plan["w"])),
        "P14 gather_window_out4d": ("gather_window_out4d",
                                    lambda: cuda.gather_window_out4d(zp_s, rel, kblk, plan["wblk"], plan["tm"], k)),
        "row9": ("window_gather", lambda: cuda.window_gather(zp_s, plan["lo"], pos)),
    }
    summary.update(rounds=rounds, card=card, device_ms=kernel_device_ms(calls, card))
    return summary


if __name__ == "__main__":
    main()
