"""Probe: query tiles of 128 against 256 for the ball query, keys built chunk by chunk.

    python -m pointnet2_tpu_torch.tools.bq_fat_probe [--device cpu]

The counterpart of the JAX repo's ``tools/bq_fat_probe.py``, at its shapes
and seed (those of ``bq_i16_probe``). Its TPU kernel never holds the
full-width distances: it builds each 128-column chunk of a (tm, Npad) key
block in turn, then streams every min sweep through the block chunk by
chunk, and asks whether fatter tiles (tm = 256, fewer programs) pay. Here
the kernel is ``csrc/bq_probes.cu``'s ``pn2_bq_fat`` (``ops.cuda.bq_fat``):
a block takes tm queries; for each 128-column chunk it builds the (tm, 128)
keys in shared memory and each query extracts the chunk's hits by min
sweeps, until all tm queries have nsample picks. The tool prints whether
both tiles give row 2's indices and counts and the oracle's (on the first 2
clouds), then three interleaved rounds of the JAX tool's columns: shipped
(row 2, ``ops.cuda.ball_query``), chunked128 and chunked256, by
``utils.bench.slope_time`` and ``cuda_ms``, with the card's name and power
limit. On the CPU (``--device cpu``) the plain versions run and no time is
taken. ``main(argv, shapes=...)`` runs another size. A variant that misses
its reference makes the tool raise.

The plain version writes out the probe's formulation: the cloud padded to
whole lanes and the queries to whole tiles with 1e30, the keys and counts
built a 128-column chunk at a time, then nsample sweeps whose min runs over
the chunks (an integer min, exact in any order) and sets the keys equal to
it to N.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from pointnet2_tpu_torch.ops import core, cuda, reference
from pointnet2_tpu_torch.tools.bq_i16_probe import (
    LANES, oracle_exact, pad_by_first, padded_cloud, probe_clouds, row2, same, timed_rounds,
)
from pointnet2_tpu_torch.utils.bench import card_line, require_device

TILES = (128, 256)
SHAPES = dict(b=8, n=8192, m=1024, nsample=32, radius=0.1, oracle_clouds=2, rounds=3)


def bq_fat_plain(xyz1: torch.Tensor, xyz2: torch.Tensor, radius: float, nsample: int, tm: int):
    """The probe's formulation: xyz1 (B, N, 3), xyz2 (B, M, 3) -> idx (B, M,
    nsample), cnt (B, M) int32, the queries in tiles of ``tm``."""
    n = xyz1.shape[1]
    m = xyz2.shape[1]
    x1 = padded_cloud(xyz1)
    x2 = F.pad(xyz2.float(), (0, 0, 0, -m % tm), value=1e30)
    b, mpad, npad = x2.shape[0], x2.shape[1], x1.shape[-1]
    r2 = core.squared_radius(radius)
    q = [x2[:, :, c:c + 1] for c in range(3)]
    keys = torch.empty((b, mpad, npad), dtype=torch.int32, device=x1.device)
    cnt = torch.zeros((b, mpad, LANES), dtype=torch.int32, device=x1.device)
    for blk in range(npad // LANES):
        sl = slice(blk * LANES, (blk + 1) * LANES)
        dx, dy, dz = (q[c] - x1[:, c:c + 1, sl] for c in range(3))
        d2 = dx * dx + dy * dy + dz * dz
        col = torch.arange(blk * LANES, (blk + 1) * LANES, device=x1.device)
        in_ball = (d2 < r2) & (col < n)
        keys[..., sl] = torch.where(in_ball, col, n)
        cnt += in_ball
    chunks = keys.view(b, mpad, npad // LANES, LANES)
    sel = []
    for _ in range(nsample):
        kmin = chunks.amin(-2).amin(-1, keepdim=True)
        sel.append(kmin)
        chunks = torch.where(chunks == kmin[..., None], n, chunks)
    idx = pad_by_first(torch.cat(sel, -1), n)
    return idx[:, :m].contiguous(), cnt.sum(-1).clamp_max(nsample)[:, :m].int()


def bq_fat(xyz1: torch.Tensor, xyz2: torch.Tensor, radius: float, nsample: int, tm: int):
    """Row 2's function, ``tm`` queries sharing chunk-built keys: the kernel
    for CUDA tensors (it raises on what it does not take), the plain version
    for CPU ones."""
    if xyz1.device.type == "cpu":
        return bq_fat_plain(xyz1, xyz2, radius, nsample, tm)
    return cuda.bq_fat(xyz1, xyz2, radius, nsample, tm)


def main(argv=None, shapes: dict = SHAPES) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu: the plain versions, no times")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    b, n, m, ns, r, o = (shapes[k] for k in ("b", "n", "m", "nsample", "radius", "oracle_clouds"))

    x1_np, x2_np, xyz1, xyz2 = probe_clouds(shapes, device)
    want = reference.ball_query_np(x1_np[:o], x2_np[:o], r, ns)
    full = row2(xyz1, xyz2, r, ns)
    exact = {}
    for tm in TILES:
        out = bq_fat(xyz1, xyz2, r, ns, tm)
        exact[tm] = {"row2": same(out, full), "oracle": oracle_exact(out, want, o)}
        print(f"tm={tm}: exact vs row 2={exact[tm]['row2']}; vs the oracle on {o} clouds="
              f"{exact[tm]['oracle']}", flush=True)
    if not all(all(e.values()) for e in exact.values()):
        raise AssertionError(f"a ball-query probe kernel misses its reference: {exact}")

    summary = {"shape": f"B={b} N={n} M={m} nsample={ns} r={r}", "exact": exact, "rounds": []}
    if device.type != "cuda":
        print("times: taken on the card only")
        return summary
    card = card_line()
    columns = {"shipped128": (lambda c: row2(c, xyz2, r, ns)[0], xyz1, lambda: row2(xyz1, xyz2, r, ns))}
    for tm in TILES:
        columns[f"chunked{tm}"] = (lambda c, tm=tm: bq_fat(c, xyz2, r, ns, tm)[0], xyz1,
                                   lambda tm=tm: bq_fat(xyz1, xyz2, r, ns, tm))
    summary.update(rounds=timed_rounds(columns, shapes["rounds"], card), card=card)
    return summary


if __name__ == "__main__":
    main()
