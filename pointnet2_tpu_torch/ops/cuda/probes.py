"""Wrappers of ``csrc/fps_probes.cu`` and ``csrc/knn_probes.cu``: the FPS and kNN design probes.

- ``fps_remask`` replaces ``tools/fps_mask_probe.py:28`` (``_kernel``):
  row 6's index-only FPS, the slots past N seeded once (``remask=False``)
  or re-masked every step (``True``). It launches with row 6's plan
  (``ops.cuda.fps.device_plan``). Plain version:
  ``tools.fps_mask_probe.fps_remask_plain``.
- ``fps_packed`` replaces ``tools/fps_packed_probe.py:43``
  (``_fps_packed_kernel``): the same function, ``g`` clouds a cluster
  (2, 4 or 8; one cloud a cluster is ``fps_remask(..., remask=False)``), planned as row 6 over ``ceil(B / g)`` clusters with ``g *
  ppt`` points a thread (``ops.cuda.fps.plan(..., g=g)``, the card's answer
  for the packed kernel). Plain version: ``tools.fps_packed_probe.fps_packed_plain``.
- ``knn_argmin`` replaces ``tools/knn_variant_probe.py:32``
  (``_knn_kernel_v1``), ``knn_tracked`` ``:95`` (``_knn_kernel_v3``): exact
  kNN by k whole-row passes. Plain versions:
  ``tools.knn_variant_probe.knn_argmin_plain`` / ``knn_tracked_plain``.

Each takes float32 CUDA tensors only, counts its launches in ``LAUNCHES``
(``fps_remask``, ``fps_packed``, ``knn_argmin``, ``knn_tracked``) and raises
on a shape its kernel does not take. The kNN kernels keep a block's
references and a row of M floats a warp in shared memory: k <= 32 and M <=
``MAX_M`` = 14528.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pointnet2_tpu_torch.ops.cuda import build
from pointnet2_tpu_torch.ops.cuda import fps as cuda_fps
from pointnet2_tpu_torch.ops.cuda.ballquery import MAX_SHARED_BYTES
from pointnet2_tpu_torch.ops.cuda.common import INT, PTR, launch, require, require_int32_range, stream_of

GROUPS = (2, 4, 8)  # clouds a cluster: csrc/fps_probes.cu's instantiations
MAX_K = 32  # a pick a lane
MAX_WARPS = 8
QUERIES_PER_WARP = 4  # a block takes warps x this many queries
MAX_M = MAX_SHARED_BYTES // 16  # the references and one warp's row: (3 + 1) x M floats


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
    """``ops.cuda.fps.plan`` for ``g`` clouds a cluster with the card's answers."""
    resident = {
        c: packed_resident(device, g, c, threads, ppt) for c, (threads, ppt) in cuda_fps.candidates(n, g).items()
    }
    return cuda_fps.plan(b, n, resident, g)


def packed_route(xyz: torch.Tensor, npoint: int, g: int) -> tuple[int, int, int]:
    """The ``(cluster, threads, ppt)`` ``fps_packed`` launches ``xyz`` with;
    raises on a shape the kernel does not take."""
    if g not in GROUPS:
        raise ValueError(f"fps_packed takes {GROUPS} clouds a cluster, got {g}")
    require(xyz, "xyz", torch.float32, (None, None, 3))
    b, n, _ = xyz.shape
    if not 0 < npoint <= n or b == 0:
        raise ValueError(f"fps_packed needs 0 < npoint <= N and B > 0, got {npoint}, {tuple(xyz.shape)}")
    require_int32_range("fps_packed", b, n, 3)
    return packed_device_plan(xyz.device.index, b, n, g)


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
        xyz.data_ptr(), b, n, npoint, idx.data_ptr(), g, c, threads, ppt, device, stream,
    )
    return idx


def knn_warps(m: int) -> int:
    """Warps a block of the kNN probe kernels: up to ``MAX_WARPS``, as many
    as have room for their rows beside the references; raises past ``MAX_M``."""
    warps = min(MAX_WARPS, MAX_SHARED_BYTES // (4 * m) - 3)
    if warps < 1:
        raise ValueError(f"the kNN probe kernels take M <= {MAX_M} (a row in shared memory), got M={m}")
    return warps


def _knn(kernel: str, symbol: str, xyz1: torch.Tensor, xyz2: torch.Tensor, k: int):
    require(xyz1, "xyz1", torch.float32, (None, None, 3))
    b, m, _ = xyz1.shape
    require(xyz2, "xyz2", torch.float32, (b, None, 3))
    nq = xyz2.shape[1]
    if not 0 < k <= min(m, MAX_K) or not 0 < b <= 65535 or nq == 0:
        raise ValueError(
            f"{kernel} needs 0 < k <= min(M, {MAX_K}), 1 <= B <= 65535 and queries, got k={k}, M={m}, B={b}, Nq={nq}"
        )
    require_int32_range(kernel, b, nq, k)
    require_int32_range(kernel, b, m, 3)
    warps = knn_warps(m)
    dist = torch.empty((b, nq, k), dtype=torch.float32, device=xyz1.device)
    idx = torch.empty((b, nq, k), dtype=torch.int32, device=xyz1.device)
    device, stream = stream_of(xyz1)
    launch(
        kernel, "knn_probes", symbol,
        [PTR, PTR, INT, INT, INT, INT, INT, INT, PTR, PTR, INT, PTR],
        xyz1.data_ptr(), xyz2.data_ptr(), b, m, nq, k, warps, warps * QUERIES_PER_WARP,
        dist.data_ptr(), idx.data_ptr(), device, stream,
    )
    return dist, idx


def knn_argmin(xyz1: torch.Tensor, xyz2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """xyz1 (B, M, 3) references, xyz2 (B, Nq, 3) queries, float32 CUDA ->
    dist2 (B, Nq, k) float32 ascending, idx (B, Nq, k) int32; v1's passes."""
    return _knn("knn_argmin", "pn2_knn_argmin", xyz1, xyz2, k)


def knn_tracked(xyz1: torch.Tensor, xyz2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The same function as ``knn_argmin``, with v3's passes."""
    return _knn("knn_tracked", "pn2_knn_tracked", xyz1, xyz2, k)
