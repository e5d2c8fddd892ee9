"""Probe: FPS with G clouds served by one program, against row 6's kernel.

    python -m pointnet2_tpu_torch.tools.fps_packed_probe [--device cpu] [--routes]

The counterpart of the JAX repo's ``tools/fps_packed_probe.py``, at its
shapes and seed (64 clouds of 8192 points, ``RandomState(0)`` times 10,
1024 picks, G = 2, 4, 8). There G groups of 8 clouds share one program's
serial loop. Here the kernel is ``csrc/fps_probes.cu``'s ``pn2_fps_packed``
(``ops.cuda.probes.fps_packed``): one thread block cluster serves G clouds,
so the chain of npoint - 1 exchanges that bounds rows 1 and 6 is paid once
for G of them, on ``ceil(B / G)`` clusters. The tool prints, for each G,
whether its indices are the oracle's (``ops.reference.farthest_point_sample_np``
on the first 4 clouds) and row 6's on all 64, then the production
``pn2_farthest_point_sample`` (row 6) and each G timed by
``utils.bench.slope_time`` at B = 64, each with its ratio to row 6, the
``(cluster, threads, ppt)`` each ran (the card's answer to how many
clusters of each size it holds at once picks it) and the card's name and
power limit, and one line of device ms (``utils.bench.device_ms``): row
6 and each G, each with ``chain_ms``, row 6's exchange alone
(``ops.cuda.fps.barrier_chain``) over the clusters and blocks it launches.
Then the same for larger batches (B = 128, 256, 512 of the same kind of
cloud, one line each, device ms beside): packing can pay only where B
passes the clusters the card holds at once, which B = 64 does not.
``--routes`` adds a line for each G at B = 64: the device ms of every route
``ops.cuda.probes.packed_candidates`` offers (the plan made to answer each
in turn), beside the plan's.
On the CPU (``--device cpu``) the plain versions run and no time is taken.
``main(argv, shapes=...)`` runs another size.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pointnet2_tpu_torch.ops import core, cuda, reference
from pointnet2_tpu_torch.ops.cuda import fps as cuda_fps
from pointnet2_tpu_torch.ops.cuda import probes
from pointnet2_tpu_torch.tools.fps_mask_probe import fps_steps, lane_planes
from pointnet2_tpu_torch.utils.bench import card_line, device_ms, require_device, slope_time

SHAPES = dict(b=64, n=8192, npoint=1024, groups=(2, 4, 8), oracle_clouds=4, sweep=(128, 256, 512))


def fps_packed_plain(xyz: torch.Tensor, npoint: int, g: int) -> torch.Tensor:
    """The probe's formulation in PyTorch: (B, N, 3) -> (B, npoint) int32.
    The clouds go G at a time (B padded with empty clouds to a multiple of
    G), each group's G clouds side by side with per-cloud reductions, the
    padding re-masked every step as the TPU kernel does."""
    b, n, _ = xyz.shape
    groups = -(-b // g)
    planes = lane_planes(xyz, groups * g).reshape(groups, g, 3, -1)
    idx = fps_steps(planes[:, :, 0], planes[:, :, 1], planes[:, :, 2], n, npoint, True)
    return idx.reshape(groups * g, npoint)[:b].int()


def fps_packed(xyz: torch.Tensor, npoint: int, g: int) -> torch.Tensor:
    """Index-only FPS, ``g`` clouds a program, (B, N, 3) float32 -> (B,
    npoint) int32: the kernel for a CUDA tensor (it raises on what it does
    not take), the plain version for a CPU one."""
    if xyz.device.type == "cpu":
        return fps_packed_plain(xyz, npoint, g)
    return cuda.fps_packed(xyz, npoint, g)


def main(argv=None, shapes: dict = SHAPES) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu: the plain versions, no times")
    ap.add_argument("--routes", action="store_true", help="also time every route of each G at B = 64")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    on_card = device.type == "cuda"
    b, n, m, o = shapes["b"], shapes["n"], shapes["npoint"], shapes["oracle_clouds"]
    row6 = cuda.farthest_point_sample if on_card else core.farthest_point_sample

    rng = np.random.RandomState(0)
    cloud = (rng.rand(b, n, 3) * 10).astype(np.float32)
    xyz = torch.from_numpy(cloud).to(device)
    want = reference.farthest_point_sample_np(cloud[:o], m)
    base = row6(xyz, m)
    exact = {}
    for g in shapes["groups"]:
        got = fps_packed(xyz, m, g)
        exact[g] = bool((got[:o].cpu().numpy() == want).all()) and bool(torch.equal(got, base))
        print(f"G={g}: exact={exact[g]} (the oracle's indices on the first {o} clouds, row 6's on all {b})",
              flush=True)
    if not all(exact.values()):
        raise AssertionError(f"a packed FPS misses the oracle or row 6: {exact}")

    summary = {"shape": f"B={b} N={n} npoint={m}", "exact": exact, "times_ms": None}
    batches = {bs: torch.from_numpy((rng.rand(bs, n, 3) * 10).astype(np.float32)).to(device)
               for bs in shapes["sweep"]}
    if not on_card:
        for bs, x in batches.items():
            ok = all(torch.equal(fps_packed(x, m, g), row6(x, m)) for g in shapes["groups"])
            print(f"B={bs}: exact={ok} (row 6's indices, G={list(shapes['groups'])})", flush=True)
            if not ok:
                raise AssertionError(f"a packed FPS misses row 6 at B={bs}")
        print("times: taken on the card only")
        return summary
    card = card_line()
    route = cuda_fps.planned_route(xyz, m, rows=False)
    t0 = slope_time(lambda c: row6(c, m), xyz, K0=2, K1=6) * 1e3
    print(f"current (row 6, pn2_farthest_point_sample, 1/cluster, route {route}): {t0:.3f} ms at B={b} | {card}",
          flush=True)
    summary["times_ms"] = {"row6": t0}
    summary["routes"] = {"row6": route}
    for g in shapes["groups"]:
        route = probes.packed_route(xyz, m, g)
        t = slope_time(lambda c, g=g: fps_packed(c, m, g), xyz, K0=2, K1=6) * 1e3
        print(f"packed G={g} ({g}/cluster, route {route}): {t:.3f} ms at B={b} ({t0 / t:.2f}x) | {card}", flush=True)
        summary["times_ms"][f"G={g}"] = t
        summary["routes"][f"G={g}"] = route
    summary["device_ms"] = device_line(xyz, m, shapes["groups"], card)
    if args.routes:
        summary["routes_device_ms"] = {g: routes_line(xyz, m, g, base, card) for g in shapes["groups"]}
    summary["sweep"] = {bs: batch_line(x, m, shapes["groups"], card) for bs, x in batches.items()}
    summary["card"] = card
    return summary


def device_line(xyz: torch.Tensor, npoint: int, groups, card: str) -> dict:
    """Device ms of row 6 and each packed G at one batch, each with the
    chain of its route (row 6's exchange over the same clusters and
    blocks); one line."""
    b = xyz.shape[0]
    runs = {"row6": (lambda: cuda.farthest_point_sample(xyz, npoint), "farthest_point_sample",
                     cuda_fps.planned_route(xyz, npoint, rows=False), b)}
    for g in groups:
        runs[f"G={g}"] = (lambda g=g: cuda.fps_packed(xyz, npoint, g), "fps_packed",
                          probes.packed_route(xyz, npoint, g), -(-b // g))
    out = {}
    for name, (run, kernel, route, clusters) in runs.items():
        out[name] = {"ms": device_ms(run, kernel), "route": route,
                     "chain_ms": device_ms(lambda r=route, k=clusters: cuda_fps.barrier_chain(k, npoint, r),
                                           "fps_barrier_chain", launches=1)}
    print(f"device at B={b}: " + "; ".join(f"{name} {r['ms']:.5f} ms (route {r['route']}, chain {r['chain_ms']:.5f})"
                                          for name, r in out.items()) + f" | {card}", flush=True)
    return out


def routes_line(xyz: torch.Tensor, npoint: int, g: int, base: torch.Tensor, card: str) -> dict:
    """Device ms of ``g`` clouds a cluster on every route of
    ``packed_candidates``, each held to row 6's indices; one line. Each
    route runs with ``probes.packed_device_plan`` answering it, and the
    plan is put back after."""
    b, n, _ = xyz.shape
    planned, plan = probes.packed_route(xyz, npoint, g), probes.packed_device_plan
    out = {}
    try:
        for c, (threads, ppt) in probes.packed_candidates(n, g).items():
            probes.packed_device_plan = lambda *args, r=(c, threads, ppt): r
            route = probes.packed_route(xyz, npoint, g)
            run = lambda: cuda.fps_packed(xyz, npoint, g)
            if not torch.equal(run(), base):
                raise AssertionError(f"packed G={g} on route {route} misses row 6")
            out[str(route)] = device_ms(run, "fps_packed")
    finally:
        probes.packed_device_plan = plan
    print(f"routes G={g} at B={b} (plan {planned}): " + "; ".join(f"{r} {ms:.5f} ms" for r, ms in out.items())
          + f" | {card}", flush=True)
    return out


def batch_line(xyz: torch.Tensor, npoint: int, groups, card: str) -> dict:
    """Row 6 and each packed G at one batch on the card: each G's indices
    held to row 6's, each timed by ``slope_time`` with its route; one line."""
    b = xyz.shape[0]
    base = cuda.farthest_point_sample(xyz, npoint)
    out = {"row6": {"route": cuda_fps.planned_route(xyz, npoint, rows=False),
                    "ms": slope_time(lambda c: cuda.farthest_point_sample(c, npoint), xyz, K0=2, K1=6) * 1e3}}
    for g in groups:
        if not torch.equal(cuda.fps_packed(xyz, npoint, g), base):
            raise AssertionError(f"packed G={g} misses row 6 at B={b}")
        out[f"G={g}"] = {"route": probes.packed_route(xyz, npoint, g),
                         "ms": slope_time(lambda c, g=g: cuda.fps_packed(c, npoint, g), xyz, K0=2, K1=6) * 1e3}
    t0 = out["row6"]["ms"]
    parts = [f"row 6 route {out['row6']['route']} {t0:.3f} ms"] + [
        f"G={g} route {out[f'G={g}']['route']} {out[f'G={g}']['ms']:.3f} ms ({t0 / out[f'G={g}']['ms']:.2f}x)"
        for g in groups
    ]
    print(f"B={b}: exact=True; " + "; ".join(parts) + f" | {card}", flush=True)
    out["device_ms"] = device_line(xyz, npoint, groups, card)
    return out


if __name__ == "__main__":
    main()
