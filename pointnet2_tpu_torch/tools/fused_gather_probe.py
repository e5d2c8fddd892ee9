"""Probe: a gather by indices the kernel wrote on chip, emitted and read back.

    python -m pointnet2_tpu_torch.tools.fused_gather_probe [--device cpu]

The counterpart of the JAX repo's ``tools/fused_gather_probe.py``, at its
shape and seed: 8 clouds of 8192 points x 32 channels (``randn``), 32768
indices a cloud (``randint``), ``RandomState(0)``. It gates fusing the
grouping gather into the ball query: the kernel writes its index tile out,
as a fused ball query would, and copies rows by the indices it reads back
from its own on-chip copy. On the TPU that read (a scalar from VMEM) did not
legalize and the JAX tool printed ``FAILED``. Here the kernel is
``csrc/gather_probes.cu``'s ``pn2_gather_fused_idx``
(``ops.cuda.gather_fused_idx``): a block a (cloud, tile of 4096 rows) writes
the tile's indices into shared memory, writes them out from there as the
second output (B, 1, R), and copies the rows by them. The tool prints whether
the rows equal ``group_points`` (the JAX tool's ``take_along_axis``) and row 9
(one window a cloud at 0) and the emitted indices the input, then three
interleaved rounds of the kernel, ``sp_row`` (the same tiles with the indices
staged from memory, ``ops.cuda.gather_rows_staged``), ``group_points`` and
row 9 by ``utils.bench.slope_time`` and ``cuda_ms``, the ns a row and the
kernels' device ms, with the card's name and power limit. On the CPU
(``--device cpu``) the plain version runs and no time is taken.
``main(argv, shapes=...)`` runs another size. A variant that misses its
reference makes the tool raise.

The plain version: ``take_along_dim`` of each tile of min(4096, R) rows, and
the indices as (B, 1, R).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pointnet2_tpu_torch.ops import cuda
from pointnet2_tpu_torch.ops.cuda.gather_probes import FUSED_TILE
from pointnet2_tpu_torch.tools.bq_i16_probe import timed_rounds
from pointnet2_tpu_torch.tools.gather_probe import group_points, kernel_device_ms, report_rates, row9_at_zero, tiled_take
from pointnet2_tpu_torch.tools.sp_gather_probe import sp_row
from pointnet2_tpu_torch.utils.bench import card_line, require_device

SHAPES = dict(b=8, n=8192, c=32, r=32768, rounds=3)


def fused_idx_plain(points: torch.Tensor, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The probe's tiling: (B, N, C), (B, R) -> rows (B, R, C) in tiles of
    min(4096, R), and the indices (B, 1, R)."""
    rows = tiled_take("gather_fused_idx", points, idx, min(FUSED_TILE, idx.shape[1]))
    return rows, idx[:, None, :].clone()


def fused_idx_gather(points: torch.Tensor, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel for CUDA tensors (it raises on what it does not take), the
    plain version for CPU ones."""
    if points.device.type == "cpu":
        return fused_idx_plain(points, idx)
    return cuda.gather_fused_idx(points, idx)


def probe_inputs(shapes: dict, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX tool's inputs: ``RandomState(0)`` points ``randn(B, N, C)`` and
    indices ``randint(0, N, size=(B, R))``, on ``device``."""
    b, n, c, r = (shapes[key] for key in ("b", "n", "c", "r"))
    rng = np.random.RandomState(0)
    pts = rng.randn(b, n, c).astype(np.float32)
    idx = rng.randint(0, n, size=(b, r)).astype(np.int32)
    return torch.from_numpy(pts).to(device), torch.from_numpy(idx).to(device)


def main(argv=None, shapes: dict = SHAPES) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu: the plain versions, no times")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    b, n, c, r = (shapes[key] for key in ("b", "n", "c", "r"))

    pts, idx = probe_inputs(shapes, device)
    rows, idx_out = fused_idx_gather(pts, idx)
    exact = {"group_points": bool(torch.equal(rows, group_points(pts, idx, r, 1))),
             "indices": bool(torch.equal(idx_out, idx[:, None, :])),
             "row9": bool(torch.equal(rows, row9_at_zero(pts, idx, r, 1)))}
    print(f"fused-index gather (indices written on chip, emitted, read back) runs; exact vs group_points="
          f"{exact['group_points']}; emitted indices equal the input={exact['indices']}; vs row 9={exact['row9']}",
          flush=True)
    if not all(exact.values()):
        raise AssertionError(f"a gather probe kernel misses its reference: {exact}")

    summary = {"shape": f"B={b} N={n} C={c} R={r}", "exact": exact, "rounds": []}
    if device.type != "cuda":
        print("times: taken on the card only")
        return summary
    card = card_line()
    columns = {
        "fused_idx": (lambda p: fused_idx_gather(p, idx)[0], pts, lambda: fused_idx_gather(pts, idx)),
        "sp_row": (lambda p: sp_row(p, idx), pts, lambda: sp_row(pts, idx)),
        "group_points": (lambda p: group_points(p, idx, r, 1), pts, lambda: group_points(pts, idx, r, 1)),
        "row9": (lambda p: row9_at_zero(p, idx, r, 1), pts, lambda: row9_at_zero(pts, idx, r, 1)),
    }
    rounds = timed_rounds(columns, shapes["rounds"], card)
    summary.update(
        rounds=rounds, card=card, rates=report_rates(rounds, columns, b * r * c * 4, b * r),
        device_ms=kernel_device_ms({"fused_idx": ("gather_fused_idx", lambda: fused_idx_gather(pts, idx)),
                                    "sp_row": ("gather_rows_staged", lambda: sp_row(pts, idx)),
                                    "row9": ("window_gather", lambda: row9_at_zero(pts, idx, r, 1))}, card),
    )
    return summary


if __name__ == "__main__":
    main()
