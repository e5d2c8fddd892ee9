"""Probe: a row gather whose kernel reads each index from memory, against the port's gather.

    python -m pointnet2_tpu_torch.tools.gather_probe [--device cpu]

The counterpart of the JAX repo's ``tools/gather_probe.py``, at its shape and
seed: SA1's grouping gather, 64 clouds of 8192 points x 64 channels from
``RandomState(0)`` (``rand``), 1024 x 32 indices a cloud (``randint``). Its
TPU kernel holds the cloud in VMEM and copies one row a loop step, indices
from a blocked SMEM input in tiles of 2048. Here the kernel is
``csrc/gather_probes.cu``'s ``pn2_gather_rows`` (``ops.cuda.gather_rows``):
one block a (cloud, tile), each row's lanes reading its index from device
memory. The tool prints whether it equals ``group_points`` (the port's
grouping gather, PyTorch indexing: the JAX tool's ``take_along_axis``) and
row 9 (``window_gather`` with one window a cloud starting at 0), then three
interleaved rounds of the three by ``utils.bench.slope_time`` (the JAX
tool's timer) and ``cuda_ms``, the kernels' device ms by the profiler, the
output's GB/s and the ns a row, with the card's name and power limit. On
the CPU (``--device cpu``) the plain versions run and no time is taken.
``main(argv, shapes=...)`` runs another size. A variant that misses its
reference makes the tool raise.

The plain version writes out the probe's tiling: ``take_along_dim`` of each
tile's rows. The other gather probes (``sp_gather_probe``,
``fused_gather_probe``) share this module's helpers.
"""

from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from pointnet2_tpu_torch.ops import core, cuda
from pointnet2_tpu_torch.ops.cuda.gather_probes import ROW_TILE, row_tiles
from pointnet2_tpu_torch.tools.bq_i16_probe import timed_rounds
from pointnet2_tpu_torch.utils.bench import card_line, device_ms, require_device

SHAPES = dict(b=64, n=8192, c=64, m=1024, k=32, rounds=3)


def tiled_take(what: str, points: torch.Tensor, idx: torch.Tensor, tr: int) -> torch.Tensor:
    """(B, N, C), (B, R) -> (B, R, C): ``take_along_dim`` of each tile of
    ``tr`` rows in turn, as the TPU grid walks them (whole tiles only)."""
    b, r = idx.shape
    out = torch.empty((b, r, points.shape[2]), dtype=points.dtype, device=points.device)
    for j in range(row_tiles(what, r, tr)):
        rows = slice(j * tr, (j + 1) * tr)
        out[:, rows] = torch.take_along_dim(points, idx[:, rows, None].long(), dim=1)
    return out


def gather_rows_plain(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The probe's tiling: (B, N, C), (B, R) -> (B, R, C) in tiles of min(2048, R)."""
    return tiled_take("gather_rows", points, idx, min(ROW_TILE, idx.shape[1]))


def gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors (it raises on what it does not take), the
    plain version for CPU ones."""
    if points.device.type == "cpu":
        return gather_rows_plain(points, idx)
    return cuda.gather_rows(points, idx)


def row9(points: torch.Tensor, lo: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Row 9, the window gather: ``ops.cuda.window_gather`` on the card,
    its plain version (``ops.core.window_gather``) on the CPU."""
    if points.device.type == "cpu":
        return core.window_gather(points, lo, pos)
    return cuda.window_gather(points, lo, pos)


def group_points(points: torch.Tensor, idx: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """The port's grouping gather on (B, M * K) indices, as (B, M * K, C)."""
    b = idx.shape[0]
    return core.group_points(points, idx.view(b, m, k)).view(b, m * k, -1)


def row9_at_zero(points: torch.Tensor, idx: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """Row 9 with one window a cloud starting at row 0, as (B, M * K, C)."""
    b = idx.shape[0]
    lo = torch.zeros((b, 1), dtype=torch.int32, device=points.device)
    return row9(points, lo, idx.view(b, m, k)).view(b, m * k, -1)


def report_rates(rounds: list, names, out_bytes: int, rows: int) -> dict:
    """Each column's median event ms over the rounds as GB/s of output and
    ns a row; prints a line a column."""
    out = {}
    for name in names:
        ms = statistics.median(t[f"{name}_events"] for t in rounds)
        out[name] = {"ms": ms, "gb_per_s_out": out_bytes / ms / 1e6, "ns_per_row": ms * 1e6 / rows}
        print(f"{name:>14}: {ms:8.4f} ms ({out[name]['gb_per_s_out']:7.1f} GB/s out, "
              f"{out[name]['ns_per_row']:.3f} ns/row)", flush=True)
    return out


def kernel_device_ms(calls: dict, card: str) -> dict:
    """The profiler's device ms of each ``name -> (kernel, call)``; prints them."""
    out = {name: device_ms(call, kernel) for name, (kernel, call) in calls.items()}
    print("device ms: " + "  ".join(f"{name} {ms:.5f}" for name, ms in out.items()) + f" | {card}", flush=True)
    return out


def probe_inputs(shapes: dict, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX tool's inputs: ``RandomState(0)`` points ``rand(B, N, C)`` and
    indices ``randint(0, N, (B, M * K))``, on ``device``."""
    b, n, c, m, k = (shapes[key] for key in ("b", "n", "c", "m", "k"))
    rng = np.random.RandomState(0)
    pts = rng.rand(b, n, c).astype(np.float32)
    idx = rng.randint(0, n, (b, m * k)).astype(np.int32)
    return torch.from_numpy(pts).to(device), torch.from_numpy(idx).to(device)


def main(argv=None, shapes: dict = SHAPES) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu: the plain versions, no times")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    b, n, c, m, k = (shapes[key] for key in ("b", "n", "c", "m", "k"))

    pts, idx = probe_inputs(shapes, device)
    got = gather_rows(pts, idx)
    exact = {"group_points": bool(torch.equal(got, group_points(pts, idx, m, k))),
             "row9": bool(torch.equal(got, row9_at_zero(pts, idx, m, k)))}
    print(f"gather_rows: exact vs group_points={exact['group_points']}; vs row 9={exact['row9']}", flush=True)
    if not all(exact.values()):
        raise AssertionError(f"a gather probe kernel misses its reference: {exact}")
    del got

    summary = {"shape": f"B={b} N={n} C={c} R={m * k}", "exact": exact, "rounds": []}
    if device.type != "cuda":
        print("times: taken on the card only")
        return summary
    card = card_line()
    columns = {
        "gather_rows": (lambda p: gather_rows(p, idx), pts, lambda: gather_rows(pts, idx)),
        "group_points": (lambda p: group_points(p, idx, m, k), pts, lambda: group_points(pts, idx, m, k)),
        "row9": (lambda p: row9_at_zero(p, idx, m, k), pts, lambda: row9_at_zero(pts, idx, m, k)),
    }
    rounds = timed_rounds(columns, shapes["rounds"], card)
    summary.update(
        rounds=rounds, card=card, rates=report_rates(rounds, columns, b * m * k * c * 4, b * m * k),
        device_ms=kernel_device_ms({"gather_rows": ("gather_rows", lambda: gather_rows(pts, idx)),
                                    "row9": ("window_gather", lambda: row9_at_zero(pts, idx, m, k))}, card),
    )
    return summary


if __name__ == "__main__":
    main()
