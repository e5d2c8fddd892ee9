"""Probe: query tiles of 128 against 256 for the ball query, keys built chunk by chunk.

    python -m pointnet2_tpu_torch.tools.bq_fat_probe [--device cpu] [--routes]

The counterpart of the JAX repo's ``tools/bq_fat_probe.py``, at its shapes
and seed (those of ``bq_i16_probe``). Its TPU kernel never holds the
full-width distances: it builds each 128-column chunk of a (tm, Npad) key
block in turn, then streams every min sweep through the block chunk by
chunk, and asks whether fatter tiles (tm = 256, fewer programs) pay. Here
the kernel is ``csrc/bq_probes.cu``'s ``pn2_bq_fat`` (``ops.cuda.bq_fat``):
a tile of tm queries is a thread-block cluster whose blocks split its
queries (``ops.cuda.bq_probes.fat_plan``: of the cluster sizes up to 8,
the fewest waves by the card's residency answers, then the most blocks);
the cloud goes by in chunks of 1024 points, each fetched once for the tile
by one TMA bulk copy multicast to every block of the cluster, and each
warp builds int32 keys in registers and sweeps them as ``bq_i16_probe``'s
kernel does, at its one shape (2 queries a warp, 4 words a lane). tm is
the only variable: a tile of 256 is twice the blocks of a tile of 128. The
tool prints whether both tiles give row 2's indices and counts and the
oracle's (on the first 2 clouds), each tile's plan (blocks a tile, chunk
columns, route, the card's residency answers), then three interleaved
rounds of the JAX tool's columns: shipped (row 2, ``ops.cuda.ball_query``),
chunked128 and chunked256, by ``utils.bench.slope_time`` and ``cuda_ms``,
with the card's name and power limit. ``--routes`` adds a line a tile: the
device ms (``device_ms``) at every cluster size the plan chooses from,
each held to row 2. On the CPU (``--device cpu``) the plain versions run
and no time is taken.
``main(argv, shapes=...)`` runs another size. A variant that misses its
reference makes the tool raise.

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
from pointnet2_tpu_torch.ops.cuda import bq_probes
from pointnet2_tpu_torch.tools.bq_i16_probe import (
    LANES, oracle_exact, pad_by_first, padded_cloud, probe_clouds, row2, same, timed_rounds,
)
from pointnet2_tpu_torch.utils.bench import card_line, device_ms, require_device

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


def routes_line(tm: int, run, base: tuple, card: str) -> dict:
    """Device ms of ``run`` at every cluster size of ``bq_probes.fat_sizes(tm)``,
    each forced by pointing ``bq_probes.fat_plan`` at it and held to ``base``
    (row 2's pair); one line. The plan is put back after each."""
    out = {}
    kept = bq_probes.fat_plan
    for k in bq_probes.fat_sizes(tm):
        try:
            bq_probes.fat_plan = lambda *args, k=k: k
            if not same(run(), base):
                raise AssertionError(f"tm={tm} on {k} blocks a tile misses row 2")
            out[k] = device_ms(run, "bq_fat")
        finally:
            bq_probes.fat_plan = kept
    print(f"routes tm={tm}: " + "; ".join(f"{k} blocks {ms:.5f} ms" for k, ms in out.items()) + f" | {card}",
          flush=True)
    return out


def main(argv=None, shapes: dict = SHAPES) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu: the plain versions, no times")
    ap.add_argument("--routes", action="store_true", help="also time every cluster size the plan chooses from")
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
    summary["plans"] = {}
    for tm in TILES:
        cluster, route = bq_probes.fat_route(xyz1, m, tm)
        resident = {k: bq_probes.fat_resident(xyz1.device.index, n, tm, k) for k in bq_probes.fat_sizes(tm)}
        warps = tm // (cluster * bq_probes.SWEEP_KQ)
        summary["plans"][tm] = {"blocks_a_tile": cluster, "chunk_columns": bq_probes.CHUNK_POINTS, "route": route,
                                "warps": warps, "resident_clusters": resident}
        print(f"tm={tm} plan: {cluster} blocks a tile of {warps} warps, chunks of {bq_probes.CHUNK_POINTS} "
              f"columns, {route}; resident clusters by size {resident}", flush=True)
    columns = {"shipped128": (lambda c: row2(c, xyz2, r, ns)[0], xyz1, lambda: row2(xyz1, xyz2, r, ns))}
    for tm in TILES:
        columns[f"chunked{tm}"] = (lambda c, tm=tm: bq_fat(c, xyz2, r, ns, tm)[0], xyz1,
                                   lambda tm=tm: bq_fat(xyz1, xyz2, r, ns, tm))
    summary.update(rounds=timed_rounds(columns, shapes["rounds"], card), card=card)
    if args.routes:
        summary["routes_device_ms"] = {
            tm: routes_line(tm, lambda tm=tm: bq_fat(xyz1, xyz2, r, ns, tm), full, card) for tm in TILES
        }
    return summary


if __name__ == "__main__":
    main()
