"""Wrappers of ``csrc/bq_probes.cu``: the five ball-query design probes.

- ``bq_keys`` replaces ``tools/bq_i16_probe.py:36`` (``_kernel``, call
  ``:88``): row 2's function by first-k min sweeps over keys of 32 bits
  (``i16=False``) or 16 (``True``; N <= ``MAX_N_I16``), in registers a
  segment at a time over a cloud each block stages (``key_plan``). Plain
  version: ``tools.bq_i16_probe.bq_keys_plain``.
- ``bq_fat`` replaces ``tools/bq_fat_probe.py:53`` (``_kernel``, call
  ``:110``): the same function over int32 keys, a tile of ``tm`` = 128 or 256
  queries a thread-block cluster whose blocks split it, each chunk of the
  cloud fetched once for the tile (``fat_plan``). Plain version:
  ``tools.bq_fat_probe.bq_fat_plain``.
- ``bq_precut_cond`` replaces ``tools/bq_cond_probe.py:62`` (row 7's
  ``_ball_query_sliced_kernel`` in ``make_nocond``, and behind
  ``make_dummycond``'s ``lax.cond`` as ``fits``), ``bq_precut_decomp``
  ``tools/bq_sliced_decomp_probe.py:69`` (the same kernel in
  ``kernel_only``): one CUDA entry, ``pn2_ball_query_precut``, counted under
  the site that launched it. Row 7's function on windows cut beforehand.
  Plain version: ``tools.bq_cond_probe.precut_plain``.
- ``bq_precut_pos`` replaces ``tools/wingather_out4d_probe.py:125`` (row 8's
  ``_bq_sliced_pos_kernel`` in ``project_group_sliced_4d``): the same kernel
  with each pick's window column, entry ``pn2_ball_query_precut_pos``. Row
  8's function on windows cut beforehand. Plain version:
  ``tools.wingather_out4d_probe.precut_pos_plain``.

Each takes CUDA tensors only, counts its launches in ``LAUNCHES`` (``bq_keys``,
``bq_fat``, ``bq_precut_cond``, ``bq_precut_decomp``, ``bq_precut_pos``) and
raises on a shape its kernel does not take.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pointnet2_tpu_torch.ops.cuda import build
from pointnet2_tpu_torch.ops.core import squared_radius
from pointnet2_tpu_torch.ops.cuda.ballquery import num_sms, tiles_plan
from pointnet2_tpu_torch.ops.cuda.common import FLOAT, INT, PTR, launch, require, require_int32_range, stream_of

MAX_N_I16 = 32767  # the largest key, n, fits an int16
FAT_TILES = (128, 256)  # the TPU probe's tiles
CLUSTER_SIZES = (1, 2, 4, 8)  # blocks a tile: up to the portable cluster
MAX_SWEEP_WARPS = 16
# csrc/bq_probes.cu's one sweep shape: kq queries a warp, v words of keys a lane.
SWEEP_KQ, SWEEP_V = 2, 4
CHUNK_POINTS = 1024  # a staged chunk of 12 KB
MAX_WHOLE_CHUNKS = 18  # a cloud of up to 18432 points is staged whole
RING_SLOTS = 4  # past that, through a ring of 4 chunks


def staged_whole(n: int) -> bool:
    """Whether a sweep block stages a cloud of ``n`` points whole (else through the ring)."""
    return -(-n // CHUNK_POINTS) <= MAX_WHOLE_CHUNKS


def sweep_shared_bytes(n: int) -> int:
    """A sweep block's shared memory: the staged chunks (the whole cloud, or
    the ring) and an 8-byte mbarrier a chunk slot."""
    return (-(-n // CHUNK_POINTS) if staged_whole(n) else RING_SLOTS) * (12 * CHUNK_POINTS + 8)


def staging(xyz1: torch.Tensor) -> str:
    """How a sweep block stages the cloud, as the C launch chooses it:
    ``bulk`` (TMA bulk copies, where every chunk is 16-byte aligned: the
    array and N % 4 == 0) or ``cooperative`` (the block's own loads)."""
    return "bulk" if xyz1.data_ptr() % 16 == 0 and xyz1.shape[1] % 4 == 0 else "cooperative"


def key_plan(b: int, n: int, m: int, i16: bool, sms: int) -> int:
    """Warps a block of ``bq_keys``, both widths alike: the fewest (the most
    blocks) with at most one block an SM, else 16. Raises past the keys'
    limits."""
    if n < 1 or (i16 and n > MAX_N_I16):
        raise ValueError(f"bq_keys takes 0 < N <= {MAX_N_I16} with int16 keys, got N={n}")
    for warps in (1, 2, 4, 8):
        if b * -(-m // (warps * SWEEP_KQ)) <= sms:
            return warps
    return MAX_SWEEP_WARPS


def fat_sizes(tm: int) -> list[int]:
    """The cluster sizes whose blocks take ``tm`` queries in whole warps of
    ``SWEEP_KQ``, at most ``MAX_SWEEP_WARPS`` a block."""
    return [k for k in CLUSTER_SIZES if tm % (k * SWEEP_KQ) == 0 and tm // (k * SWEEP_KQ) <= MAX_SWEEP_WARPS]


def fat_waves(b: int, m: int, tm: int, cluster: int, resident: dict[int, int]) -> int:
    """Waves of ``bq_fat``'s grid at ``cluster`` blocks a tile: its tiles
    over the clusters of that size the card holds at once (``resident``)."""
    return -(-b * -(-m // tm) // resident[cluster])


def fat_plan(b: int, m: int, tm: int, resident: dict[int, int]) -> int:
    """Blocks a tile (a cluster) of ``bq_fat``: of ``fat_sizes(tm)``, the
    fewest waves by the card's answers (``resident``:
    ``cudaOccupancyMaxActiveClusters`` a size), then the most blocks, which
    spreads a grid over the most SMs (on the H100, with 4 queries a warp, a
    tile of 256 at the probe shape took 0.1497 ms on 8 blocks against 0.1673
    on 4, each in two waves; PERF.md §6)."""
    return min(fat_sizes(tm), key=lambda k: (fat_waves(b, m, tm, k, resident), -k))


@functools.cache
def fat_resident(device: int, n: int, tm: int, cluster: int) -> int:
    """The card's answer (``cudaOccupancyMaxActiveClusters``) for the fat
    kernel's launch on clouds of ``n`` points, once a shape."""
    lib = build.load("bq_probes")
    fn = lib.pn2_bq_fat_active
    fn.argtypes = [INT, INT, INT, INT, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    build.check(lib, "pn2_bq_fat_active_error_string", fn(n, tm, cluster, device, ctypes.byref(out)),
                "bq_fat occupancy")
    return out.value


def key_route(xyz1: torch.Tensor, m: int, i16: bool) -> tuple[int, str]:
    """``(warps, staging)`` ``bq_keys`` launches ``xyz1`` with."""
    b, n, _ = xyz1.shape
    return key_plan(b, n, m, i16, num_sms(xyz1.device.index)), staging(xyz1)


def fat_route(xyz1: torch.Tensor, m: int, tm: int) -> tuple[int, str]:
    """``(cluster, route)`` ``bq_fat`` launches ``xyz1`` with: a tile's
    blocks by ``fat_plan`` on the card's answers; the route is
    ``staging``'s, ``multicast`` where bulk copies feed a cluster."""
    b, n, _ = xyz1.shape
    device = xyz1.device.index
    cluster = fat_plan(b, m, tm, {k: fat_resident(device, n, tm, k) for k in fat_sizes(tm)})
    how = staging(xyz1)
    return cluster, "multicast" if how == "bulk" and cluster > 1 else how


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
    warps = key_plan(b, n, m, i16, num_sms(xyz1.device.index))
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
    """The same function as ``bq_keys`` over int32 keys, ``tm`` (128 or 256)
    queries a cluster sharing each fetched chunk of the cloud."""
    if tm not in FAT_TILES:
        raise ValueError(f"bq_fat takes tiles of {FAT_TILES} queries, got {tm}")
    b, n, m = _check_exact("bq_fat", xyz1, xyz2, nsample)
    cluster, _ = fat_route(xyz1, m, tm)
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz1.device)
    cnt = torch.empty((b, m), dtype=torch.int32, device=xyz1.device)
    device, stream = stream_of(xyz1)
    launch(
        "bq_fat", "bq_probes", "pn2_bq_fat",
        [PTR, PTR, INT, INT, INT, FLOAT, INT, INT, INT, PTR, PTR, INT, PTR],
        xyz1.data_ptr(), xyz2.data_ptr(), b, n, m, squared_radius(radius), nsample, tm, cluster,
        idx.data_ptr(), cnt.data_ptr(), device, stream,
    )
    return idx, cnt


def precut_route(b: int, t: int, tm: int, w: int, device: int) -> tuple[int, int]:
    """``(split, warps)`` of the pre-cut kernel: row 7's plan (``ops.cuda.ballquery.tiles_plan``)."""
    return tiles_plan(b, t * tm, tm, w, num_sms(device))


def _check_precut(site: str, win, permw, q_tiles, n: int, nsample: int) -> tuple[int, int, int, int]:
    """Checks shared by the pre-cut entries; returns (b, t, tm, w)."""
    require(win, "win", torch.float32, (None, None, 3, None))
    b, t, _, w = win.shape
    require(permw, "permw", torch.int32, (b, t, 1, w))
    require(q_tiles, "q_tiles", torch.float32, (b, t, None, 3))
    tm = q_tiles.shape[2]
    if not 0 < b <= 65535 or t == 0 or tm == 0 or w == 0 or n <= 0 or nsample <= 0:
        raise ValueError(
            f"{site} needs 1 <= B <= 65535, tiles, queries, a window, N and nsample > 0, got "
            f"{tuple(win.shape)}, {tuple(q_tiles.shape)}, N={n}, nsample={nsample}"
        )
    require_int32_range(site, b, t, 3, w)
    require_int32_range(site, b, t, tm, nsample)
    return b, t, tm, w


def _precut(site: str, win, permw, q_tiles, n: int, radius: float, nsample: int, fits=None):
    b, t, tm, w = _check_precut(site, win, permw, q_tiles, n, nsample)
    if fits is not None:
        require(fits, "fits", torch.int32, ())
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


def bq_precut_pos(win, permw, q_tiles, n: int, radius: float, nsample: int):
    """win (B, T, 3, W), permw (B, T, 1, W) int32 and q_tiles (B, T, tm, 3) as
    ``bq_precut_cond`` takes them -> idx, pos (B, T, tm, nsample), cnt (B, T,
    1, tm) int32: row 8's function on the cut windows (``wingather_out4d_probe``'s
    site), ``pos`` each pick's window column (a slot past the count the first
    pick's, 0 for an empty ball)."""
    b, t, tm, w = _check_precut("bq_precut_pos", win, permw, q_tiles, n, nsample)
    split, warps = precut_route(b, t, tm, w, win.device.index)
    idx = torch.empty((b, t, tm, nsample), dtype=torch.int32, device=win.device)
    pos = torch.empty((b, t, tm, nsample), dtype=torch.int32, device=win.device)
    cnt = torch.empty((b, t, 1, tm), dtype=torch.int32, device=win.device)
    device, stream = stream_of(win)
    launch(
        "bq_precut_pos", "bq_probes", "pn2_ball_query_precut_pos",
        [PTR, PTR, PTR, INT, INT, INT, INT, INT, FLOAT, INT, INT, INT, PTR, PTR, PTR, INT, PTR],
        win.data_ptr(), permw.data_ptr(), q_tiles.data_ptr(), b, t, tm, w, n, squared_radius(radius), nsample,
        split, warps, idx.data_ptr(), pos.data_ptr(), cnt.data_ptr(), device, stream,
    )
    return idx, pos, cnt
