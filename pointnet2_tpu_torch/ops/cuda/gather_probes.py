"""Wrappers of ``csrc/gather_probes.cu``: the four gather design probes.

Each computes the SA grouping gather, ``out[b, r] = points[b, idx[b, r]]``
(the port's ``ops.core.group_points``), differing in how the indices reach
the row copies:

- ``gather_rows`` replaces ``tools/gather_probe.py:40`` (``_gather_kernel``
  via ``gather_pallas``): tiles of ``min(ROW_TILE, R)`` rows, each index read
  from device memory. Plain version: ``tools.gather_probe.gather_rows_plain``.
- ``gather_rows_staged`` replaces ``tools/sp_gather_probe.py:75``
  (``_sp_row_kernel`` via ``sp_row_gather``): tiles of ``STAGED_TILE`` rows,
  the tile's indices staged in shared memory first. Plain version:
  ``tools.sp_gather_probe.sp_row_plain``.
- ``gather_window_staged`` replaces ``tools/sp_gather_probe.py:137``
  (``_sp_win_kernel`` via ``sp_win_gather``): x-sorted points, each tile of
  ``tm`` queries copying its rows out of its two staged ``w``-row blocks by
  relative index. Plain version: ``tools.sp_gather_probe.sp_win_plain``.
- ``gather_fused_idx`` replaces ``tools/fused_gather_probe.py:46``
  (``_vmem_idx_gather_kernel`` via ``vmem_idx_gather``): tiles of
  ``min(FUSED_TILE, R)`` rows, the indices written on chip, emitted as a
  second output and read back for the copies. Plain version:
  ``tools.fused_gather_probe.fused_idx_plain``.

The row width's route (16-byte vectors or floats, lanes a row) is row 9's
``wingather.plan``. Each wrapper takes CUDA tensors only, counts its launches
in ``LAUNCHES`` under its own name, and raises on a shape its kernel does not
take. Every index must lie in [0, N): the kernels do not check it.
"""

from __future__ import annotations

import torch

from pointnet2_tpu_torch.ops.cuda.ballquery import MAX_SHARED_BYTES
from pointnet2_tpu_torch.ops.cuda.common import INT, PTR, launch, require, require_int32_range, stream_of
from pointnet2_tpu_torch.ops.cuda.wingather import planned_route

ROW_TILE = 2048  # gather_probe.py:38, tr = min(2048, R)
STAGED_TILE = 4096  # sp_gather_probe.py:66
FUSED_TILE = 4096  # fused_gather_probe.py:50, tr = min(4096, R)
WINDOW_UNROLLS = (4, 8, 16)  # csrc/gather_probes.cu's instantiations, the probe's sweep
MAX_CLOUDS = 65535  # the grid's y
STAGING = "a cooperative load and __syncthreads()"  # how gather_rows_staged stages a tile's indices


def row_tiles(what: str, r: int, tr: int) -> int:
    """The number of tiles of ``tr`` rows in ``r``; raises unless they are
    whole (the TPU grid ``r // tr`` would drop the rest, or be empty)."""
    if tr <= 0 or r % tr:
        raise ValueError(f"{what}: {r} rows are not a whole number of tiles of {tr}")
    return r // tr


def window_shared_bytes(w: int, trk: int) -> int:
    """Shared memory of ``gather_window_staged``'s block: the window's 2w rows
    of one 16-byte channel slice, and the tile's trk relative indices."""
    return 2 * w * 16 + trk * 4


def _rows(kernel: str, symbol: str, points: torch.Tensor, idx: torch.Tensor, tile, emit: bool):
    """The three row kernels: ``tile(R)`` rows a block; ``emit``: the fused
    kernel's second output."""
    require(points, "points", torch.float32, (None, None, None))
    b, n, c = points.shape
    require(idx, "idx", torch.int32, (b, None))
    r = idx.shape[1]
    tr = tile(r)
    row_tiles(kernel, r, tr)
    if not 0 < b <= MAX_CLOUDS or n == 0 or c == 0:
        raise ValueError(f"{kernel} needs 1 <= B <= {MAX_CLOUDS}, points and channels, got {tuple(points.shape)}")
    require_int32_range(kernel, n, c)
    require_int32_range(kernel, tr, c)
    vec, lanes = planned_route(points)
    out = torch.empty((b, r, c), dtype=torch.float32, device=points.device)
    idx_out = torch.empty((b, 1, r), dtype=torch.int32, device=points.device) if emit else None
    device, stream = stream_of(points)
    argtypes = [PTR, PTR, INT, INT, INT, INT, INT, INT, INT, PTR] + ([PTR] if emit else []) + [INT, PTR]
    args = [points.data_ptr(), idx.data_ptr(), b, n, r, tr, c, int(vec), lanes, out.data_ptr()]
    args += ([idx_out.data_ptr()] if emit else []) + [device, stream]
    launch(kernel, "gather_probes", symbol, argtypes, *args)
    return (out, idx_out) if emit else out


def gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C) float32, idx (B, R) int32 -> (B, R, C): row
    ``idx[b, r]`` of cloud b, in tiles of ``min(ROW_TILE, R)`` rows whose
    indices are read from device memory."""
    return _rows("gather_rows", "pn2_gather_rows", points, idx, lambda r: min(ROW_TILE, r), emit=False)


def gather_rows_staged(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The same function in tiles of ``STAGED_TILE`` rows (R a multiple of
    it), each tile's indices staged in shared memory before its copies."""
    return _rows("gather_rows_staged", "pn2_gather_rows_staged", points, idx, lambda r: STAGED_TILE, emit=False)


def gather_fused_idx(points: torch.Tensor, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The same function in tiles of ``min(FUSED_TILE, R)`` rows, returning
    the rows (B, R, C) and the indices (B, 1, R) as the block wrote them out
    of its on-chip copy, which its copies read."""
    return _rows("gather_fused_idx", "pn2_gather_fused_idx", points, idx, lambda r: min(FUSED_TILE, r), emit=True)


def relative_indices(idx: torch.Tensor, kblk: torch.Tensor, w: int, tm: int) -> torch.Tensor:
    """``idx`` (B, M, K) relative to each tile's window, ``idx - kblk * w``
    as (B, T, tm * K) int32 (``sp_win_gather``'s ``rel``, ``:111-112``)."""
    b, m, k = idx.shape
    return (idx.reshape(b, m // tm, tm * k) - kblk[:, :, None] * w).to(torch.int32).contiguous()


def gather_window_staged(points: torch.Tensor, idx: torch.Tensor, kblk: torch.Tensor, w: int, tm: int,
                         unroll: int) -> torch.Tensor:
    """points (B, N, C) float32 sorted by x, idx (B, M, K) int32 with each
    tile of ``tm`` queries' indices in [kblk * w, kblk * w + 2w), kblk (B, M
    / tm) int32 -> (B, M * K, C): row ``idx`` of each cloud, copied out of
    the tile's two staged w-row blocks (kblk and min(kblk + 1, N / w - 1)) by
    relative index, ``unroll`` rows in flight a thread."""
    if unroll not in WINDOW_UNROLLS:
        raise ValueError(f"gather_window_staged takes unroll in {WINDOW_UNROLLS}, got {unroll}")
    require(points, "points", torch.float32, (None, None, None))
    b, n, c = points.shape
    require(idx, "idx", torch.int32, (b, None, None))
    m, k = idx.shape[1:]
    if tm <= 0 or m % tm or w <= 0 or n % w or m == 0 or k == 0:
        raise ValueError(
            f"gather_window_staged needs M a multiple of tm and N of w, got M={m}, tm={tm}, N={n}, w={w}, K={k}"
        )
    t, trk = m // tm, tm * k
    require(kblk, "kblk", torch.int32, (b, t))
    if window_shared_bytes(w, trk) > MAX_SHARED_BYTES:
        raise ValueError(
            f"gather_window_staged: a slice of 2w = {2 * w} rows and {trk} relative indices take "
            f"{window_shared_bytes(w, trk)} bytes, past a block's {MAX_SHARED_BYTES}"
        )
    if not 0 < b <= MAX_CLOUDS or c == 0:
        raise ValueError(f"gather_window_staged needs 1 <= B <= {MAX_CLOUDS} and channels, got {tuple(points.shape)}")
    require_int32_range("gather_window_staged", n, c)
    require_int32_range("gather_window_staged", trk, c)
    rel = relative_indices(idx, kblk, w, tm)
    vec, _ = planned_route(points)
    out = torch.empty((b, m * k, c), dtype=torch.float32, device=points.device)
    device, stream = stream_of(points)
    launch(
        "gather_window_staged", "gather_probes", "pn2_gather_window_staged",
        [PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT, INT, PTR, INT, PTR],
        points.data_ptr(), rel.data_ptr(), kblk.data_ptr(), b, n, c, t, trk, w, int(vec), unroll,
        out.data_ptr(), device, stream,
    )
    return out
