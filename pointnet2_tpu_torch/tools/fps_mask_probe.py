"""Probe: the FPS step with the padding slots re-masked every step, against masking them once.

    python -m pointnet2_tpu_torch.tools.fps_mask_probe [--device cpu]

The counterpart of the JAX repo's ``tools/fps_mask_probe.py``, at its shapes
and seed (64 clouds of 8192 points, ``RandomState(0)`` times 10, 1024
picks). Its kernel there seeds the padded lanes' running minimum at -1 and
asks whether re-masking them each step costs anything. Here the kernel is
``csrc/fps_probes.cu``'s ``pn2_fps_remask`` (``ops.cuda.probes.fps_remask``):
row 6's design, the slots past N seeded at -1 once, or re-masked on every
step. The tool prints whether both give the oracle's indices
(``ops.reference.farthest_point_sample_np`` on the first 4 clouds) and
each other's on all 64, then three interleaved rounds of both kernels' times:
``utils.bench.slope_time`` (the JAX tool's timer) and ``cuda_ms`` beside
it, with the card's name and power limit; then one line of device ms
(``utils.bench.device_ms``): both kernels, row 6 (``pn2_farthest_point_sample``)
and ``chain_ms``, row 6's exchange alone (``ops.cuda.fps.barrier_chain``)
at the route all three launch with. On the CPU (``--device cpu``)
the plain versions run and no time is taken. ``main(argv, shapes=...)``
runs another size (the CPU tests do).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from pointnet2_tpu_torch.ops import cuda, reference
from pointnet2_tpu_torch.ops.cuda import fps as cuda_fps
from pointnet2_tpu_torch.utils.bench import card_line, cuda_ms, device_ms, require_device, slope_time

LANES = 128  # the TPU kernel pads N to whole lanes
SHAPES = dict(b=64, n=8192, npoint=1024, oracle_clouds=4, rounds=3)


def fps_steps(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, n: int, npoint: int,
              remask: bool) -> torch.Tensor:
    """The TPU probes' step loop over coordinate planes ``(..., npad)`` whose
    lanes at or past ``n`` are padding: the running minimum starts at 1e38
    (-1 in the padding), slot 0 is lane 0, and each step folds in the
    distance to the last pick (with ``remask`` the padding's replaced by -1
    first) and takes the first lane of the maximum. Returns ``(...,
    npoint)`` int64 lanes."""
    npad = x.shape[-1]
    col = torch.arange(npad, device=x.device)
    valid = col < n
    mind = torch.full_like(x, 1e38).masked_fill(~valid, -1.0)
    old = torch.zeros(x.shape[:-1] + (1,), dtype=torch.long, device=x.device)
    picks = [old]
    for _ in range(1, npoint):
        dx = x - x.gather(-1, old)
        dy = y - y.gather(-1, old)
        dz = z - z.gather(-1, old)
        d = (dx * dx + dy * dy) + dz * dz
        if remask:
            d = torch.where(valid, d, -1.0)
        mind = torch.minimum(mind, d)
        top = mind.amax(-1, keepdim=True)
        old = torch.where(mind == top, col, npad).amin(-1, keepdim=True)
        picks.append(old)
    return torch.cat(picks, -1)


def lane_planes(xyz: torch.Tensor, clouds: int | None = None) -> torch.Tensor:
    """(B, N, 3) -> (clouds, 3, npad) float32: the coordinates as planes, N
    padded with zeros to whole lanes and B with empty clouds to ``clouds``."""
    b, n, _ = xyz.shape
    npad = -(-n // LANES) * LANES
    planes = F.pad(xyz.float().transpose(1, 2), (0, npad - n))
    return F.pad(planes, (0, 0, 0, 0, 0, (clouds or b) - b))


def fps_remask_plain(xyz: torch.Tensor, npoint: int, remask: bool) -> torch.Tensor:
    """The probe's formulation in PyTorch: (B, N, 3) -> (B, npoint) int32,
    the step loop with (``remask``) or without the per-step ``where``."""
    planes = lane_planes(xyz)
    return fps_steps(planes[:, 0], planes[:, 1], planes[:, 2], xyz.shape[1], npoint, remask).int()


def fps_remask(xyz: torch.Tensor, npoint: int, remask: bool) -> torch.Tensor:
    """Index-only FPS, (B, N, 3) float32 -> (B, npoint) int32: the kernel for
    a CUDA tensor (it raises on what it does not take), the plain version for
    a CPU one."""
    if xyz.device.type == "cpu":
        return fps_remask_plain(xyz, npoint, remask)
    return cuda.fps_remask(xyz, npoint, remask)


def main(argv=None, shapes: dict = SHAPES) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu: the plain versions, no times")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    b, n, m, o = shapes["b"], shapes["n"], shapes["npoint"], shapes["oracle_clouds"]

    rng = np.random.RandomState(0)
    cloud = (rng.rand(b, n, 3) * 10).astype(np.float32)
    xyz = torch.from_numpy(cloud).to(device)
    want = reference.farthest_point_sample_np(cloud[:o], m)
    got = {remask: fps_remask(xyz, m, remask) for remask in (True, False)}
    exact = {remask: bool((idx[:o].cpu().numpy() == want).all()) for remask, idx in got.items()}
    agree = bool(torch.equal(got[True], got[False]))
    for remask in (True, False):
        print(f"remask={remask} exact={exact[remask]} (the oracle's indices on the first {o} clouds)")
    print(f"masked vs unmasked agree={agree} on all {b} clouds", flush=True)
    if not (agree and all(exact.values())):
        raise AssertionError("masked vs unmasked disagree, or either misses the oracle")

    summary = {"shape": f"B={b} N={n} npoint={m}", "exact": exact, "agree": agree, "rounds": []}
    if device.type != "cuda":
        print("times: taken on the card only")
        return summary
    card = card_line()
    for rep in range(shapes["rounds"]):
        t = {}
        for remask in (True, False):
            t[remask] = (slope_time(lambda c, r=remask: fps_remask(c, m, r), xyz) * 1e3,
                         cuda_ms(lambda r=remask: fps_remask(xyz, m, r)))
        print(f"rep {rep}: remask {t[True][0]:7.3f} ms (events {t[True][1]:7.3f})   "
              f"no-remask {t[False][0]:7.3f} ms (events {t[False][1]:7.3f}) | {card}", flush=True)
        summary["rounds"].append({"remask_ms": t[True][0], "remask_events_ms": t[True][1],
                                  "no_remask_ms": t[False][0], "no_remask_events_ms": t[False][1]})
    route = cuda_fps.planned_route(xyz, m, rows=False)
    dev = {f"remask={r}": device_ms(lambda r=r: fps_remask(xyz, m, r), "fps_remask") for r in (True, False)}
    dev["row6"] = device_ms(lambda: cuda.farthest_point_sample(xyz, m), "farthest_point_sample")
    dev["chain"] = device_ms(lambda: cuda_fps.barrier_chain(b, m, route), "fps_barrier_chain", launches=1)
    print(f"device: remask {dev['remask=True']:.5f} ms, no-remask {dev['remask=False']:.5f} ms, "
          f"row 6 {dev['row6']:.5f} ms; chain {dev['chain']:.5f} ms (route {route}) | {card}", flush=True)
    summary.update(device_ms=dev, route=route, card=card)
    return summary


if __name__ == "__main__":
    main()
