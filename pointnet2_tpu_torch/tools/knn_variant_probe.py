"""Probe: two selection-pass formulations of exact kNN against the production kernel.

    python -m pointnet2_tpu_torch.tools.knn_variant_probe [--device cpu]

The counterpart of the JAX repo's ``tools/knn_variant_probe.py``, at its
shapes and seed (FP4's 3-NN: 64 clouds, 8192 queries, 1024 references,
``RandomState(0)`` times 10). Its two TPU kernels make k passes over each
query's whole distance row: v1 a full-width min and argmin per pass, v3 an
index-tracking (value, index) candidate a lane and one cross-lane pick.
Here they are ``csrc/knn_probes.cu``'s ``pn2_knn_argmin`` and
``pn2_knn_tracked`` (``ops.cuda.probes.knn_argmin`` / ``knn_tracked``),
which keep each pass's formulation (v1: a min reduction, then one for the
lowest column holding it; v3: one (value, column) reduction) but build no
row: each block stages its cloud, each warp sweeps its queries' distances in
registers a segment at a time and merges each pass into a running top-k.
The tool prints whether each gives the oracle's indices and distances bit
for bit (``ops.reference.knn_np`` on the first 2 clouds), then v1, the
production ``pn2_knn`` (row 3, ``ops.cuda.knn``) and v3 timed by
``utils.bench.slope_time``, each with its ratio to v1, then the three
kernels' device ms (``utils.bench.device_ms``), v1 / v3 and the launch plan
(``ops.cuda.probes.knn_plan``), with the card's name and power limit. On
the CPU (``--device cpu``) the plain versions run and no time is taken.
``main(argv, shapes=...)`` runs another size.

The plain versions write out the probes' formulations: the whole (B, Nq, M)
distance row, ``((dx*dx + dy*dy) + dz*dz)`` as the oracle sums it, then k
passes, each taking the least value and the first column that holds it (an
explicit rule: ``torch.min``'s index is not promised to be the first) and
setting that column to +inf. They run ``PLAIN_ROW_BYTES`` of rows at a time.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from pointnet2_tpu_torch.ops import cuda, reference
from pointnet2_tpu_torch.ops.cuda import probes as cuda_probes
from pointnet2_tpu_torch.utils.bench import card_line, device_ms, require_device, slope_time

LANES = 128  # v3's lanes: each pass keeps a candidate for each of 128 columns
SHAPES = dict(b=64, nq=8192, m=1024, k=3, oracle_clouds=2)
PLAIN_ROW_BYTES = 1 << 29  # the plain versions' distance rows at a time (FP4 at B=64: 2.1 GB in all)


def distance_rows(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """(B, Nq, M) float32 squared distances, each term and sum rounded as the oracle's."""
    q, r = xyz2.float()[:, :, None, :], xyz1.float()[:, None, :, :]
    dx, dy, dz = (q[..., c] - r[..., c] for c in range(3))
    return (dx * dx + dy * dy) + dz * dz


def _by_clouds(fn, xyz1: torch.Tensor, xyz2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``fn(d2, k)`` over runs of clouds whose rows take ``PLAIN_ROW_BYTES``."""
    b, m = xyz1.shape[:2]
    if not 0 < k <= m:
        raise ValueError(f"knn needs 0 < k <= M, got k={k}, M={m}")
    step = max(1, PLAIN_ROW_BYTES // (xyz2.shape[1] * m * 4))
    parts = [fn(distance_rows(xyz1[lo:lo + step], xyz2[lo:lo + step]), k) for lo in range(0, b, step)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]).int()


def _passes(d2: torch.Tensor, k: int, pick) -> tuple[torch.Tensor, torch.Tensor]:
    """k passes of ``pick(d2) -> (least, column)``, each column then set to +inf."""
    dists, cols = [], []
    for _ in range(k):
        least, col = pick(d2)
        dists.append(least)
        cols.append(col)
        d2.scatter_(-1, col, float("inf"))
    return torch.cat(dists, -1), torch.cat(cols, -1)


def _argmin_pick(d2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """v1: the row's min, then the first column that holds it."""
    col = torch.arange(d2.shape[-1], device=d2.device)
    least = d2.amin(-1, keepdim=True)
    return least, torch.where(d2 == least, col, d2.shape[-1]).amin(-1, keepdim=True)


def _tracked_pick(d2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """v3: over 128-column blocks each lane keeps the least value of its
    column in them and the earliest block holding it (a strict ``<`` scan);
    then the least over the lanes and the first index among the equal."""
    *lead, mpad = d2.shape
    nb = mpad // LANES
    blocks = d2.view(*lead, nb, LANES)
    vals = blocks.amin(-2)
    first = torch.where(blocks == vals.unsqueeze(-2), torch.arange(nb, device=d2.device)[:, None], nb).amin(-2)
    index = first * LANES + torch.arange(LANES, device=d2.device)
    least = vals.amin(-1, keepdim=True)
    return least, torch.where(vals == least, index, mpad).amin(-1, keepdim=True)


def knn_argmin_plain(xyz1: torch.Tensor, xyz2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """v1's formulation: xyz1 (B, M, 3) references, xyz2 (B, Nq, 3) queries
    -> dist2 (B, Nq, k) float32 ascending, idx (B, Nq, k) int32."""
    return _by_clouds(lambda d2, k: _passes(d2, k, _argmin_pick), xyz1, xyz2, k)


def knn_tracked_plain(xyz1: torch.Tensor, xyz2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """v3's formulation, the same function: the rows padded with +inf to whole 128-column blocks."""
    def run(d2, k):
        m = d2.shape[-1]
        return _passes(F.pad(d2, (0, -m % LANES), value=float("inf")), k, _tracked_pick)

    return _by_clouds(run, xyz1, xyz2, k)


def knn_argmin(xyz1: torch.Tensor, xyz2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN, v1's passes: the kernel for CUDA tensors (it raises on what
    it does not take), the plain version for CPU ones."""
    if xyz1.device.type == "cpu":
        return knn_argmin_plain(xyz1, xyz2, k)
    return cuda.knn_argmin(xyz1, xyz2, k)


def knn_tracked(xyz1: torch.Tensor, xyz2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN, v3's passes: the kernel for CUDA tensors, the plain version for CPU ones."""
    if xyz1.device.type == "cpu":
        return knn_tracked_plain(xyz1, xyz2, k)
    return cuda.knn_tracked(xyz1, xyz2, k)


def main(argv=None, shapes: dict = SHAPES) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu: the plain versions, no times")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    b, nq, m, k, o = shapes["b"], shapes["nq"], shapes["m"], shapes["k"], shapes["oracle_clouds"]

    rng = np.random.RandomState(0)
    queries = (rng.rand(b, nq, 3) * 10).astype(np.float32)
    refs = (rng.rand(b, m, 3) * 10).astype(np.float32)
    want_d, want_i = reference.knn_np(refs[:o], queries[:o], k)
    s, t = torch.from_numpy(refs).to(device), torch.from_numpy(queries).to(device)
    exact = {}
    for name, fn in (("legacy-v1", knn_argmin), ("v3", knn_tracked)):
        d, i = fn(s[:o], t[:o], k)
        exact[name] = {"index": bool((i.cpu().numpy() == want_i).all()),
                       "distance": bool((d.cpu().numpy() == want_d).all())}
        print(f"{name} index-exact vs oracle: {exact[name]['index']}; distances bit for bit: "
              f"{exact[name]['distance']}", flush=True)
    if not all(all(e.values()) for e in exact.values()):
        raise AssertionError(f"a kNN probe kernel misses the oracle: {exact}")

    summary = {"shape": f"B={b} Nq={nq} M={m} k={k}", "exact": exact, "times_ms": None}
    if device.type != "cuda":
        print("times: taken on the card only")
        return summary
    card = card_line()
    t1, t2, t3 = (slope_time(lambda q, fn=fn: fn(s, q, k)[0], t) * 1e3
                  for fn in (knn_argmin, cuda.knn, knn_tracked))
    print(f"B={b} Nq={nq} M={m} k={k}: legacy argmin {t1:.3f} ms | production pn2_knn {t2:.3f} ms ({t1 / t2:.2f}x) | "
          f"index-tracking {t3:.3f} ms ({t1 / t3:.2f}x) | {card}", flush=True)
    dev = {name: device_ms(lambda fn=fn: fn(s, t, k), kernel)
           for name, fn, kernel in (("v1", knn_argmin, "knn_argmin"), ("pn2_knn", cuda.knn, "knn"),
                                    ("v3", knn_tracked, "knn_tracked"))}
    plan = dict(zip(("warps", "shared_bytes"), cuda_probes.knn_plan(b, m, nq, k)))
    print(f"device ms: legacy argmin {dev['v1']:.5f} | production pn2_knn {dev['pn2_knn']:.5f} | index-tracking "
          f"{dev['v3']:.5f} | v1 / v3 {dev['v1'] / dev['v3']:.3f} | plan {plan} | {card}", flush=True)
    summary.update(times_ms={"v1": t1, "pn2_knn": t2, "v3": t3}, device_ms=dev, plan=plan, card=card)
    return summary


if __name__ == "__main__":
    main()
