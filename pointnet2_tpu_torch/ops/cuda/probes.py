"""Wrappers of ``csrc/fps_probes.cu`` and ``csrc/knn_probes.cu``: the FPS and kNN design probes.

- ``fps_remask`` replaces ``tools/fps_mask_probe.py:28`` (``_kernel``):
  row 6's index-only FPS, the slots past N seeded once (``remask=False``)
  or re-masked every step (``True``, in the warps that hold such a slot).
  It launches with row 6's plan (``ops.cuda.fps.device_plan``). Plain
  version: ``tools.fps_mask_probe.fps_remask_plain``.
- ``fps_packed`` replaces ``tools/fps_packed_probe.py:43``
  (``_fps_packed_kernel``): the same function, ``g`` clouds a cluster (2, 4
  or 8; one cloud a cluster is ``fps_remask(..., remask=False)``), each
  block's threads in ``g`` groups of ``threads``, a cloud's slice each.
  ``packed_plan`` places ``ceil(B / g)`` clusters over ``packed_candidates``
  (the fewest waves, by the card's answer for the packed kernel, then the
  smaller block and cluster).
  Plain version: ``tools.fps_packed_probe.fps_packed_plain``.
- Both send one 16-byte record a warp, cloud and step; ``probe_chain``
  runs that exchange alone, for timing (``csrc/fps_probes.cu``'s header).
- ``knn_argmin`` replaces ``tools/knn_variant_probe.py:32``
  (``_knn_kernel_v1``), ``knn_tracked`` ``:95`` (``_knn_kernel_v3``): exact
  kNN, each query's distances swept in registers a segment at a time over a
  cloud each block stages (as ``bq_probes``' sweeps do) and merged into a
  running top-k by v1's passes (a min, then the lowest column holding it) or
  v3's (one (value, column) reduction); ``knn_plan``. Plain versions:
  ``tools.knn_variant_probe.knn_argmin_plain`` / ``knn_tracked_plain``.

Each takes float32 CUDA tensors only, counts its launches in ``LAUNCHES``
(``fps_remask``, ``fps_packed``, ``knn_argmin``, ``knn_tracked``) and raises
on a shape its kernel does not take. The kNN kernels take k <= 32 (a pick a
lane) and any M within int32 indexing.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pointnet2_tpu_torch.ops.cuda import build
from pointnet2_tpu_torch.ops.cuda import fps as cuda_fps
from pointnet2_tpu_torch.ops.cuda.ballquery import MAX_SHARED_BYTES
from pointnet2_tpu_torch.ops.cuda.bq_probes import sweep_shared_bytes
from pointnet2_tpu_torch.ops.cuda.common import INT, PTR, launch, require, require_int32_range, stream_of

GROUPS = (2, 4, 8)  # clouds a cluster of the packed kernel (its C entry takes 1 as well)
MAX_K = 32  # a pick a lane


def fps_remask(xyz: torch.Tensor, npoint: int, remask: bool) -> torch.Tensor:
    """(B, N, 3) float32 CUDA -> (B, npoint) int32 indices, row 6's, on row 6's plan."""
    b, n, c, threads, ppt = cuda_fps._route(xyz, npoint, False, "fps_remask", None)
    idx = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    device, stream = stream_of(xyz)
    launch(
        "fps_remask", "fps_probes", "pn2_fps_remask",
        [PTR, INT, INT, INT, PTR, INT, INT, INT, INT, INT, PTR],
        xyz.data_ptr(), b, n, npoint, idx.data_ptr(), int(remask), c, threads, ppt, device, stream,
    )
    return idx


def packed_shape(n: int, cluster: int, g: int) -> tuple[int, int] | None:
    """``(threads, ppt)`` of each of a block's ``g`` groups for the slice of
    ``n`` points one of ``cluster`` blocks owns: row 6's rule
    (``ops.cuda.fps.block_shape``) with the block's ``g * threads`` threads
    within ``max_threads(ppt)``. None if no block holds it."""
    s = cuda_fps.slice_points(n, cluster)
    for ppt in cuda_fps.PPTS:
        threads = max(32, (-(-s // ppt) + 31) // 32 * 32)
        limit = cuda_fps.max_threads(ppt)
        if threads <= (cuda_fps.SMALL_BLOCK if ppt < 8 else limit) and g * threads <= limit:
            return threads, ppt
    return None


def packed_candidates(n: int, g: int) -> dict[int, tuple[int, int]]:
    """Cluster size -> ``(threads a group, ppt)`` for every route of ``g``
    clouds a cluster: the slices fit one block, and each keeps at least
    ``MIN_BLOCK_POINTS`` of its cloud unless C = 1, as row 6's (counting a
    block's ``g`` slices together let clusters of 16 in at N = 8192, which
    took 1.4-2.0 x the cluster of 8 on the H100: PERF.md §6). ``g = 1``
    is row 6's ``candidates``."""
    out = {}
    for c in cuda_fps.CLUSTERS:
        shape = packed_shape(n, c, g)
        if shape is not None and (c == 1 or n >= c * cuda_fps.MIN_BLOCK_POINTS):
            out[c] = shape
    return out


def packed_plan(b: int, n: int, g: int, resident: dict[int, int]) -> tuple[int, int, int]:
    """``(cluster, threads a group, ppt)`` for ``b`` clouds, ``ceil(b / g)``
    clusters, over ``packed_candidates`` with ``resident`` clusters of each
    size (0 if none): the fewest waves; among equals the smaller block, as
    row 6 keeps its blocks small, then the smaller cluster (fewer records a
    cloud and step; row 6 takes the larger). On the H100 at B = 64 this
    picks the fastest route of every G: G = 2 took 0.78 ms on blocks of 256
    against 0.88-0.99 on blocks of 512, G = 4 0.89 on clusters of 4 against
    1.03 on clusters of 8 (PERF.md §6). Raises ``ValueError`` for a shape no
    route takes."""
    clusters = -(-b // g)
    options = [(-(-clusters // resident[c]), g * threads, c, threads, ppt)
               for c, (threads, ppt) in packed_candidates(n, g).items() if resident.get(c, 0) > 0]
    if not options:
        raise ValueError(f"no FPS route for N={n}, G={g} on this card (resident clusters {resident})")
    return min(options)[2:]


@functools.cache
def packed_resident(device: int, g: int, cluster: int, threads: int, ppt: int) -> int:
    """The card's answer (``cudaOccupancyMaxActiveClusters``) for the packed kernel, once a shape."""
    lib = build.load("fps_probes")
    fn = lib.pn2_fps_packed_active_clusters
    fn.argtypes = [INT, INT, INT, INT, INT, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    build.check(lib, "pn2_fps_packed_active_clusters_error_string",
                fn(g, cluster, threads, ppt, device, ctypes.byref(out)), "fps_packed occupancy")
    return out.value


@functools.cache
def packed_device_plan(device: int, b: int, n: int, g: int) -> tuple[int, int, int]:
    """``packed_plan`` with the card's answers, once a shape a process."""
    resident = {c: packed_resident(device, g, c, threads, ppt)
                for c, (threads, ppt) in packed_candidates(n, g).items()}
    return packed_plan(b, n, g, resident)


def packed_route(xyz: torch.Tensor, npoint: int, g: int) -> tuple[int, int, int]:
    """The ``(cluster, threads, ppt)`` ``fps_packed`` launches ``xyz`` with,
    ``threads`` a block's (``g`` groups), by ``packed_device_plan``; raises
    on a shape the kernel does not take."""
    if g not in GROUPS:
        raise ValueError(f"fps_packed takes {GROUPS} clouds a cluster, got {g}")
    require(xyz, "xyz", torch.float32, (None, None, 3))
    b, n, _ = xyz.shape
    if not 0 < npoint <= n or b == 0:
        raise ValueError(f"fps_packed needs 0 < npoint <= N and B > 0, got {npoint}, {tuple(xyz.shape)}")
    require_int32_range("fps_packed", b, n, 3)
    c, threads, ppt = packed_device_plan(xyz.device.index, b, n, g)
    return c, g * threads, ppt


def fps_packed(xyz: torch.Tensor, npoint: int, g: int) -> torch.Tensor:
    """(B, N, 3) float32 CUDA -> (B, npoint) int32 indices, row 6's, ``g``
    clouds a cluster, on ``packed_route``'s plan."""
    c, threads, ppt = packed_route(xyz, npoint, g)
    b, n, _ = xyz.shape
    idx = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    device, stream = stream_of(xyz)
    launch(
        "fps_packed", "fps_probes", "pn2_fps_packed",
        [PTR, INT, INT, INT, PTR, INT, INT, INT, INT, INT, PTR],
        xyz.data_ptr(), b, n, npoint, idx.data_ptr(), g, c, threads // g, ppt, device, stream,
    )
    return idx


def probe_chain(clusters: int, npoint: int, g: int, route: tuple[int, int, int], device: int = 0) -> None:
    """``npoint - 1`` steps of the probe kernels' exchange alone in
    ``clusters`` clusters of ``route`` (``(cluster, threads a block, ppt)``,
    ``g`` groups a block): the chain they pay, for timing only (not a kernel
    of any path: it counts no launch)."""
    c, threads, _ = route
    lib = build.load("fps_probes")
    fn = lib.pn2_fps_probe_chain
    fn.argtypes = [INT, INT, INT, INT, INT, INT, PTR]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream
    build.check(lib, "pn2_fps_probe_chain_error_string", fn(clusters, npoint, g, c, threads // g, device, stream),
                "fps probe chain")


def knn_plan(b: int, m: int, nq: int, k: int) -> tuple[int, int]:
    """``(warps a block, shared bytes)`` of the kNN probe kernels for ``b``
    clouds of ``m`` references and ``nq`` queries. The bytes are the staged
    cloud's (``bq_probes.sweep_shared_bytes``: whole up to 18432 points,
    else a ring of 4 chunks); the warps, 4 queries each, 16 where those
    bytes leave room for two blocks an SM at most (M > 6144), else 8. On
    the H100 16 warps took 0.88 / 0.87 of the time of 8 at SA1 (M = 8192,
    k = 32) and 1.02 / 1.04 at the probe shape (M = 1024, k = 3), argmin /
    tracked (PERF.md §6).
    Raises on k > 32, k > M, B > 65535 or an empty input."""
    if not 0 < k <= min(m, MAX_K) or not 0 < b <= 65535 or nq == 0:
        raise ValueError(
            f"the kNN probe kernels need 0 < k <= min(M, {MAX_K}), 1 <= B <= 65535 and queries, "
            f"got k={k}, M={m}, B={b}, Nq={nq}"
        )
    shared = sweep_shared_bytes(m)
    return (16 if 3 * shared > MAX_SHARED_BYTES else 8), shared


def _knn(kernel: str, symbol: str, xyz1: torch.Tensor, xyz2: torch.Tensor, k: int):
    require(xyz1, "xyz1", torch.float32, (None, None, 3))
    b, m, _ = xyz1.shape
    require(xyz2, "xyz2", torch.float32, (b, None, 3))
    nq = xyz2.shape[1]
    warps, _ = knn_plan(b, m, nq, k)
    require_int32_range(kernel, b, nq, k)
    require_int32_range(kernel, b, m, 3)
    dist = torch.empty((b, nq, k), dtype=torch.float32, device=xyz1.device)
    idx = torch.empty((b, nq, k), dtype=torch.int32, device=xyz1.device)
    device, stream = stream_of(xyz1)
    launch(
        kernel, "knn_probes", symbol,
        [PTR, PTR, INT, INT, INT, INT, INT, PTR, PTR, INT, PTR],
        xyz1.data_ptr(), xyz2.data_ptr(), b, m, nq, k, warps, dist.data_ptr(), idx.data_ptr(), device, stream,
    )
    return dist, idx


def knn_argmin(xyz1: torch.Tensor, xyz2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """xyz1 (B, M, 3) references, xyz2 (B, Nq, 3) queries, float32 CUDA ->
    dist2 (B, Nq, k) float32 ascending, idx (B, Nq, k) int32; v1's passes."""
    return _knn("knn_argmin", "pn2_knn_argmin", xyz1, xyz2, k)


def knn_tracked(xyz1: torch.Tensor, xyz2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The same function as ``knn_argmin``, with v3's passes."""
    return _knn("knn_tracked", "pn2_knn_tracked", xyz1, xyz2, k)
