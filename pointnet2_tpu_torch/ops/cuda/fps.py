"""Wrappers of ``csrc/fps.cu``: farthest point sampling, with and without centroids.

- ``fps_centroids`` replaces ``pointnet2_tpu/ops/pallas/fps.py:89``
  (``_fps_fused_kernel``); its plain version is ``ops.core.fps_centroids``.
- ``farthest_point_sample`` replaces ``fps.py:40`` (``_fps_kernel``), the
  index-only FPS; its plain version is ``ops.core.farthest_point_sample``.
  The same kernel without the row copies: its indices equal
  ``fps_centroids``' bit for bit.

The kernel runs one thread block cluster of C blocks per cloud, each thread
holding PPT points in registers. ``plan`` picks ``(C, threads, PPT)`` from
the shape and the card's answer to how many clusters of each size it holds
at once (``resident_clusters``); it is plain Python, so the CPU tests reach
it. Each wrapper takes ``route=`` to force one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pointnet2_tpu_torch.ops.cuda import build
from pointnet2_tpu_torch.ops.cuda.common import INT, PTR, launch, require, stream_of

CLUSTERS = (16, 8, 4, 2, 1)  # 16 is past the portable 8; the H100 takes it
PPTS = (1, 2, 4, 8, 16)  # the kernel's instantiations
SMALL_BLOCK = 128  # a warp on each of an SM's four schedulers
# Below this a block's scan is not worth an exchange across blocks: on the
# H100 a cloud of 1024 points runs faster in one block behind __syncthreads
# than in a cluster of 4, and 8192 fastest in a cluster of 8 (PERF.md).
MIN_BLOCK_POINTS = 1024
BLOCK_POINTS = 512 * 16  # the most one block holds
MAX_POINTS = max(CLUSTERS) * BLOCK_POINTS


def max_threads(ppt: int) -> int:
    """The largest block for ``ppt`` points a thread (4 registers a point):
    64 registers a thread at 1024 threads, 128 at 512."""
    return 1024 if ppt <= 4 else 512


def slice_points(n: int, cluster: int) -> int:
    """The points each block of a cluster owns: ceil(n / cluster)."""
    return -(-n // cluster)


def block_shape(n: int, cluster: int) -> tuple[int, int] | None:
    """``(threads, ppt)`` for the slice of ``n`` points one of ``cluster``
    blocks owns: the fewest points a thread for which at most 128 threads
    (one warp a scheduler) hold the slice; past 1024 points, 8 or 16 points
    a thread on up to 512 threads. None if no block holds the slice."""
    s = slice_points(n, cluster)
    for ppt in PPTS:
        threads = max(32, (-(-s // ppt) + 31) // 32 * 32)
        if threads <= (SMALL_BLOCK if ppt < 8 else max_threads(ppt)):
            return threads, ppt
    return None


def candidates(n: int) -> dict[int, tuple[int, int]]:
    """Cluster size -> ``(threads, ppt)`` for every route that can take
    ``n`` points: the slice fits one block, and a block keeps at least
    ``MIN_BLOCK_POINTS`` unless C = 1."""
    out = {}
    for c in CLUSTERS:
        shape = block_shape(n, c)
        if shape is not None and (c == 1 or n >= c * MIN_BLOCK_POINTS):
            out[c] = shape
    return out


def plan(b: int, n: int, resident: dict[int, int]) -> tuple[int, int, int]:
    """``(cluster, threads, ppt)`` for ``b`` clouds of ``n`` points.

    ``resident`` maps each cluster size of ``candidates(n)`` to how many such
    clusters the card runs at once (0 if none). The route with the fewest
    waves of clusters wins (one wave where all ``b`` fit), the larger cluster
    among equals. Raises ``ValueError`` for a shape no route takes.
    """
    if b <= 0 or n <= 0:
        raise ValueError(f"FPS needs B > 0 and N > 0, got B={b}, N={n}")
    if n > MAX_POINTS:
        raise ValueError(f"the FPS kernel takes at most {MAX_POINTS} points, got {n}")
    best = None
    for c, (threads, ppt) in candidates(n).items():
        if resident.get(c, 0) <= 0:
            continue
        waves = -(-b // resident[c])
        if best is None or waves < best[0]:
            best = (waves, c, threads, ppt)
    if best is None:
        raise ValueError(f"no FPS route for N={n} on this card (resident clusters {resident})")
    return best[1:]


def check_plan(n: int, route: tuple[int, int, int]) -> tuple[int, int, int]:
    """A forced ``(cluster, threads, ppt)``; raises unless the kernel takes it for ``n``."""
    c, threads, ppt = route
    if c not in CLUSTERS or ppt not in PPTS or threads % 32 or not 32 <= threads <= max_threads(ppt):
        raise ValueError(f"not an FPS route: {route}")
    if threads * ppt < slice_points(n, c):
        raise ValueError(f"route {route} holds {threads * ppt} points a block, fewer than N={n} needs")
    return c, threads, ppt


@functools.cache
def resident_clusters(device: int, rows: bool, cluster: int, threads: int, ppt: int) -> int:
    """The card's answer (``cudaOccupancyMaxActiveClusters``), once a shape."""
    lib = build.load("fps")
    fn = lib.pn2_fps_active_clusters
    fn.argtypes = [INT, INT, INT, INT, INT, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    build.check(lib, "pn2_fps_active_clusters_error_string",
                fn(int(rows), cluster, threads, ppt, device, ctypes.byref(out)), "fps occupancy")
    return out.value


@functools.cache
def device_plan(device: int, rows: bool, b: int, n: int) -> tuple[int, int, int]:
    """``plan`` with the card's answers, made once a shape a process: it is on
    the host's path of every call."""
    resident = {
        c: resident_clusters(device, rows, c, threads, ppt) for c, (threads, ppt) in candidates(n).items()
    }
    return plan(b, n, resident)


def _route(xyz: torch.Tensor, npoint: int, rows: bool, what: str, route) -> tuple[int, int, int, int, int]:
    """Checks shared by both entries; returns (b, n, cluster, threads, ppt)."""
    require(xyz, "xyz", torch.float32, (None, None, 3))
    b, n, _ = xyz.shape
    if not 0 < npoint <= n or b == 0:
        raise ValueError(f"{what} needs 0 < npoint <= N and B > 0, got {npoint}, {tuple(xyz.shape)}")
    if n > MAX_POINTS:
        raise ValueError(f"{what} kernel takes at most {MAX_POINTS} points, got {n}")
    if route is not None:
        return (b, n, *check_plan(n, route))
    return (b, n, *device_plan(xyz.device.index, rows, b, n))


def planned_route(xyz: torch.Tensor, npoint: int, rows: bool = True) -> tuple[int, int, int]:
    """The ``(cluster, threads, ppt)`` the wrapper would launch ``xyz`` with."""
    return _route(xyz, npoint, rows, "fps", None)[2:]


def fps_centroids(xyz: torch.Tensor, npoint: int, route=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 3) float32 CUDA -> ((B, npoint) int32 indices, (B, npoint, 3) rows).

    ``route``: a forced ``(cluster, threads, ppt)``, else ``plan``'s."""
    b, n, c, threads, ppt = _route(xyz, npoint, True, "fps_centroids", route)
    idx = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    out = torch.empty((b, npoint, 3), dtype=torch.float32, device=xyz.device)
    device, stream = stream_of(xyz)
    launch(
        "fps_centroids", "fps", "pn2_fps_centroids",
        [PTR, INT, INT, INT, PTR, PTR, INT, INT, INT, INT, PTR],
        xyz.data_ptr(), b, n, npoint, idx.data_ptr(), out.data_ptr(), c, threads, ppt, device, stream,
    )
    return idx, out


def farthest_point_sample(xyz: torch.Tensor, npoint: int, route=None) -> torch.Tensor:
    """(B, N, 3) float32 CUDA -> (B, npoint) int32 indices.

    ``route``: a forced ``(cluster, threads, ppt)``, else ``plan``'s."""
    b, n, c, threads, ppt = _route(xyz, npoint, False, "farthest_point_sample", route)
    idx = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    device, stream = stream_of(xyz)
    launch(
        "farthest_point_sample", "fps", "pn2_farthest_point_sample",
        [PTR, INT, INT, INT, PTR, INT, INT, INT, INT, PTR],
        xyz.data_ptr(), b, n, npoint, idx.data_ptr(), c, threads, ppt, device, stream,
    )
    return idx


def barrier_chain(b: int, npoint: int, route: tuple[int, int, int], device: int = 0) -> None:
    """``npoint - 1`` empty cluster-barrier steps of ``b`` clusters laid out
    as ``route``: the latency bound of an FPS call, for timing only (not a
    kernel of any path: it counts no launch)."""
    c, threads, _ = route
    lib = build.load("fps")
    fn = lib.pn2_fps_barrier_chain
    fn.argtypes = [INT, INT, INT, INT, INT, PTR]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream
    build.check(lib, "pn2_fps_barrier_chain_error_string", fn(b, npoint, c, threads, device, stream),
                "fps barrier chain")
