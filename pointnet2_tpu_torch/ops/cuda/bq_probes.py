"""Wrappers of ``csrc/bq_probes.cu``: the four ball-query design probes.

- ``bq_keys`` replaces ``tools/bq_i16_probe.py:36`` (``_kernel``, call
  ``:88``): row 2's function by ``nsample`` first-k min sweeps over each
  query's key row, keys int32 (``i16=False``) or int16 (``True``; N <=
  ``MAX_N_I16``). Plain version: ``tools.bq_i16_probe.bq_keys_plain``.
- ``bq_fat`` replaces ``tools/bq_fat_probe.py:53`` (``_kernel``, call
  ``:110``): the same function, ``tm`` = 128 or 256 queries a block sharing
  128-column chunks of keys. Plain version: ``tools.bq_fat_probe.bq_fat_plain``.
- ``bq_precut_cond`` replaces ``tools/bq_cond_probe.py:62`` (row 7's
  ``_ball_query_sliced_kernel`` in ``make_nocond``, and behind
  ``make_dummycond``'s ``lax.cond`` as ``fits``), ``bq_precut_decomp``
  ``tools/bq_sliced_decomp_probe.py:69`` (the same kernel in
  ``kernel_only``): one CUDA entry, ``pn2_ball_query_precut``, counted under
  the site that launched it. Row 7's function on windows cut beforehand.
  Plain version: ``tools.bq_cond_probe.precut_plain``.

Each takes CUDA tensors only, counts its launches in ``LAUNCHES`` (``bq_keys``,
``bq_fat``, ``bq_precut_cond``, ``bq_precut_decomp``) and raises on a shape
its kernel does not take.
"""

from __future__ import annotations

import torch

from pointnet2_tpu_torch.ops.core import squared_radius
from pointnet2_tpu_torch.ops.cuda.ballquery import MAX_SHARED_BYTES, num_sms, tiles_plan
from pointnet2_tpu_torch.ops.cuda.common import FLOAT, INT, PTR, launch, require, require_int32_range, stream_of

MAX_KEY_WARPS = 16
MAX_N_I16 = 32767  # the largest key, n, fits an int16
MAX_N_I32 = MAX_SHARED_BYTES // 4  # one warp's row of int32 keys in a block's shared memory
FAT_TILES = (128, 256)  # csrc/bq_probes.cu's instantiations of the fat kernel


def key_warps(n: int, i16: bool) -> int:
    """Warps a block of ``bq_keys``: one query a warp, as many as have room
    for their key rows (n int32 words, or ceil(n / 2) words of two int16), up
    to ``MAX_KEY_WARPS``; raises past the kernel's limits."""
    if n < 1 or n > (MAX_N_I16 if i16 else MAX_N_I32):
        width, most = ("int16", MAX_N_I16) if i16 else ("int32", MAX_N_I32)
        raise ValueError(f"bq_keys takes 0 < N <= {most} with {width} keys, got N={n}")
    row = 4 * (-(-n // 2) if i16 else n)
    return min(MAX_KEY_WARPS, MAX_SHARED_BYTES // row)


def _check_exact(what: str, xyz1: torch.Tensor, xyz2: torch.Tensor, nsample: int) -> tuple[int, int, int]:
    require(xyz1, "xyz1", torch.float32, (None, None, 3))
    b, n, _ = xyz1.shape
    require(xyz2, "xyz2", torch.float32, (b, None, 3))
    m = xyz2.shape[1]
    if not 0 < b <= 65535 or n == 0 or m == 0 or nsample <= 0:
        raise ValueError(
            f"{what} needs 1 <= B <= 65535, points, queries and nsample > 0, got "
            f"{tuple(xyz1.shape)}, {tuple(xyz2.shape)}, nsample={nsample}"
        )
    require_int32_range(what, b, n, 3)
    require_int32_range(what, b, m, nsample)
    return b, n, m


def bq_keys(xyz1: torch.Tensor, xyz2: torch.Tensor, radius: float, nsample: int, i16: bool):
    """xyz1 (B, N, 3) dataset, xyz2 (B, M, 3) queries, float32 CUDA -> idx (B,
    M, nsample), cnt (B, M) int32: row 2's, by sweeps over int32 or int16 keys."""
    b, n, m = _check_exact("bq_keys", xyz1, xyz2, nsample)
    warps = key_warps(n, i16)
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz1.device)
    cnt = torch.empty((b, m), dtype=torch.int32, device=xyz1.device)
    device, stream = stream_of(xyz1)
    launch(
        "bq_keys", "bq_probes", "pn2_bq_keys",
        [PTR, PTR, INT, INT, INT, FLOAT, INT, INT, INT, PTR, PTR, INT, PTR],
        xyz1.data_ptr(), xyz2.data_ptr(), b, n, m, squared_radius(radius), nsample, int(i16), warps,
        idx.data_ptr(), cnt.data_ptr(), device, stream,
    )
    return idx, cnt


def bq_fat(xyz1: torch.Tensor, xyz2: torch.Tensor, radius: float, nsample: int, tm: int):
    """The same function as ``bq_keys``, ``tm`` (128 or 256) queries a block
    sharing chunk-built keys."""
    if tm not in FAT_TILES:
        raise ValueError(f"bq_fat takes tiles of {FAT_TILES} queries, got {tm}")
    b, n, m = _check_exact("bq_fat", xyz1, xyz2, nsample)
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz1.device)
    cnt = torch.empty((b, m), dtype=torch.int32, device=xyz1.device)
    device, stream = stream_of(xyz1)
    launch(
        "bq_fat", "bq_probes", "pn2_bq_fat",
        [PTR, PTR, INT, INT, INT, FLOAT, INT, INT, PTR, PTR, INT, PTR],
        xyz1.data_ptr(), xyz2.data_ptr(), b, n, m, squared_radius(radius), nsample, tm,
        idx.data_ptr(), cnt.data_ptr(), device, stream,
    )
    return idx, cnt


def precut_route(b: int, t: int, tm: int, w: int, device: int) -> tuple[int, int]:
    """``(split, warps)`` of the pre-cut kernel: row 7's plan (``ops.cuda.ballquery.tiles_plan``)."""
    return tiles_plan(b, t * tm, tm, w, num_sms(device))


def _precut(site: str, win, permw, q_tiles, n: int, radius: float, nsample: int, fits=None):
    require(win, "win", torch.float32, (None, None, 3, None))
    b, t, _, w = win.shape
    require(permw, "permw", torch.int32, (b, t, 1, w))
    require(q_tiles, "q_tiles", torch.float32, (b, t, None, 3))
    tm = q_tiles.shape[2]
    if fits is not None:
        require(fits, "fits", torch.int32, ())
    if not 0 < b <= 65535 or t == 0 or tm == 0 or w == 0 or n <= 0 or nsample <= 0:
        raise ValueError(
            f"{site} needs 1 <= B <= 65535, tiles, queries, a window, N and nsample > 0, got "
            f"{tuple(win.shape)}, {tuple(q_tiles.shape)}, N={n}, nsample={nsample}"
        )
    require_int32_range(site, b, t, 3, w)
    require_int32_range(site, b, t, tm, nsample)
    split, warps = precut_route(b, t, tm, w, win.device.index)
    idx = torch.empty((b, t, tm, nsample), dtype=torch.int32, device=win.device)
    cnt = torch.empty((b, t, 1, tm), dtype=torch.int32, device=win.device)
    device, stream = stream_of(win)
    launch(
        site, "bq_probes", "pn2_ball_query_precut",
        [PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, FLOAT, INT, INT, INT, PTR, PTR, INT, PTR],
        win.data_ptr(), permw.data_ptr(), q_tiles.data_ptr(), None if fits is None else fits.data_ptr(),
        b, t, tm, w, n, squared_radius(radius), nsample, split, warps, idx.data_ptr(), cnt.data_ptr(),
        device, stream,
    )
    return idx, cnt


def bq_precut_cond(win, permw, q_tiles, n: int, radius: float, nsample: int, fits=None):
    """win (B, T, 3, W) and permw (B, T, 1, W) int32: each tile's cut window of
    the x-sorted cloud of ``n`` points; q_tiles (B, T, tm, 3) sorted by x;
    ``fits`` None or a 0-d int32 CUDA tensor (0: every output 0, the dummy
    branch). -> idx (B, T, tm, nsample), cnt (B, T, 1, tm) int32: row 7's
    function on the cut windows (``bq_cond_probe``'s site)."""
    return _precut("bq_precut_cond", win, permw, q_tiles, n, radius, nsample, fits)


def bq_precut_decomp(win, permw, q_tiles, n: int, radius: float, nsample: int):
    """The same kernel with no guard, as ``bq_sliced_decomp_probe``'s site."""
    return _precut("bq_precut_decomp", win, permw, q_tiles, n, radius, nsample)
