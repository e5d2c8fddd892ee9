"""Composite SA and FP stages at ``semantic.json`` widths, timed on the card.

    python -m pointnet2_tpu_torch.tools.stage_bench [--device cpu] [--small]

The counterpart of the JAX repo's ``tools/stage_bench.py``, through the
port's op surface (``pointnet2_tpu_torch.ops``, kernels on the card):

- ``sa_sample_group``: ``ops.farthest_point_sample`` -> ``gather_points`` ->
  ``ball_query`` -> ``group_points`` of the coordinates (centred) and the
  features, at the four SA levels, once with the exact ball query and once
  with the round-1 windowed one (``impl="windowed"``);
- ``group``: ``group_points`` alone, at SA1 and SA2 widths;
- ``fp_interpolate``: ``three_nn`` -> ``interpolation_weights`` ->
  ``three_interpolate`` at the four FP levels.

Batches of 16 clouds (``semantic.json``'s batch) as ``bench.py`` makes them
(xyz uniform in 8 x 8 x 4.9 m, features uniform in [0, 1)), seeded. One
JSON line a stage and shape: ``ms`` (CUDA events, ``utils.bench.cuda_ms``),
the kernels' launches in one call, the card. With ``--device cpu`` each
stage runs once on the plain versions (``--small``: two clouds of at most
1024 points) and ``ms`` is null: nothing is measured.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.ops import cuda
from pointnet2_tpu_torch.utils.bench import card_line, cuda_ms, require_device

# (N, npoint, radius, nsample, input channels) of the SA levels; FP (N, M, C).
SA = [(8192, 1024, 0.5, 32, 6), (1024, 256, 1.0, 32, 64), (256, 64, 2.0, 32, 128), (64, 16, 4.0, 32, 256)]
GROUP = [(8192, 1024, 32, 64), (1024, 256, 32, 128)]
FP = [(8192, 1024, 128), (1024, 256, 256), (256, 64, 256), (64, 16, 512)]
SMALL_SA = [(1024, 256, 0.5, 16, 6), (256, 64, 1.0, 16, 16)]
SMALL_GROUP = [(1024, 256, 16, 16)]
SMALL_FP = [(1024, 256, 32), (64, 16, 64)]
BATCH, SMALL_BATCH = 16, 2


def sample_and_group(x: torch.Tensor, npoint: int, radius: float, nsample: int, bq_impl=None):
    """The SA composite on x (B, N, 3 + C): grouped centred coordinates and features."""
    xyz, feats = x[..., :3].contiguous(), x[..., 3:]
    new_xyz = ops.gather_points(xyz, ops.farthest_point_sample(xyz, npoint)).contiguous()
    idx, _ = ops.ball_query(xyz, new_xyz, radius, nsample, impl=bq_impl)
    return ops.group_points(xyz, idx) - new_xyz[:, :, None, :], ops.group_points(feats, idx)


def fp_interpolate(dense: torch.Tensor, coarse: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """The FP composite: 3-NN of each dense point among the coarse ones, blended."""
    d2, idx = ops.three_nn(dense, coarse)
    return ops.three_interpolate(feats, idx, ops.interpolation_weights(d2))


def _record(stage, shape, card, fn, timed):
    before = dict(cuda.LAUNCHES)
    fn()
    launches = {k: v - before.get(k, 0) for k, v in cuda.LAUNCHES.items() if v != before.get(k, 0)}
    row = {"stage": stage, "shape": shape, "ms": cuda_ms(fn) if timed else None,
           "launches": launches if timed else None, "card": card}
    print(json.dumps(row), flush=True)
    return row


def run(device: torch.device, small: bool) -> list[dict]:
    timed = device.type == "cuda"
    batch = SMALL_BATCH if small else BATCH
    card = card_line() if timed else "cpu (not measured)"
    rng = np.random.RandomState(0)

    def cloud(n: int, c: int) -> torch.Tensor:
        x = rng.rand(batch, n, 3 + c).astype(np.float32)
        x[..., :3] *= np.float32([8.0, 8.0, 4.9])
        return torch.from_numpy(x).to(device)

    rows = []
    for n, m, r, ns, cin in SMALL_SA if small else SA:
        x = cloud(n, cin)
        for bq in ("exact", "windowed"):
            impl = "windowed" if bq == "windowed" else None
            rows.append(_record(
                "sa_sample_group", f"B={batch} N={n} npoint={m} r={r} nsample={ns} cin={cin} ball_query={bq}",
                card, lambda x=x, m=m, r=r, ns=ns, impl=impl: sample_and_group(x, m, r, ns, impl), timed,
            ))
    for n, m, ns, c in SMALL_GROUP if small else GROUP:
        feats = torch.from_numpy(rng.rand(batch, n, c).astype(np.float32)).to(device)
        idx = torch.from_numpy(rng.randint(0, n, (batch, m, ns)).astype(np.int32)).to(device)
        rows.append(_record(
            "group", f"B={batch} N={n} M={m} K={ns} C={c}", card,
            lambda feats=feats, idx=idx: ops.group_points(feats, idx), timed,
        ))
    for n, m, c in SMALL_FP if small else FP:
        dense = cloud(n, 0)
        coarse = cloud(m, 0)
        feats = torch.from_numpy(rng.rand(batch, m, c).astype(np.float32)).to(device)
        rows.append(_record(
            "fp_interpolate", f"B={batch} N={n} M={m} C={c}", card,
            lambda dense=dense, coarse=coarse, feats=feats: fp_interpolate(dense, coarse, feats), timed,
        ))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--small", action="store_true", help="small shapes")
    args = ap.parse_args(argv)
    run(require_device(args.device), args.small)
    return 0


if __name__ == "__main__":
    sys.exit(main())
