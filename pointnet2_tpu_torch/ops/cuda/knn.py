"""Wrappers of ``csrc/knn.cu``: exact k nearest neighbours, whole or windowed.

- ``knn`` replaces ``pointnet2_tpu/ops/pallas/knn.py:39`` (``_knn_kernel``);
  its plain version is ``ops.core.knn``. For k <= 16 (the register route) S
  lanes share a query, each keeping a top-k of every S-th reference in
  registers, merged by butterfly shuffles; ``plan`` picks S and the block
  from the shape and the card's SM count (once a shape a process), and the
  wrapper takes ``route=`` to force one. For k > 16 (the list route) one warp a query keeps its sorted
  list in shared memory.
- ``knn_tiles`` replaces ``knn.py:133`` (``_knn_sliced_kernel``); its plain
  version is ``ops.core.knn_tiles``. For k <= 16 each warp's queries walk
  outward from their place in the x-sorted window, 8 columns of one side a
  step, and stop exactly where the rounded dx^2 passes each query's k-th
  distance; one block of 128 threads a tile, one a query. The whole
  calibrated op (sorts, window starts and certificate) is the PyTorch
  composite ``ops.core.knn_sliced``, which ``ops`` runs over the two
  kernels' ``pn2`` operators.

Limits: any 1 <= k <= M up to ``MAX_K`` = 29056, the most pairs of 8 bytes
one warp's list holds in a block's 227 KB of shared memory; any window (one
wider than shared memory holds beside the lists is read from device memory).
"""

from __future__ import annotations

import functools

import torch

from pointnet2_tpu_torch.ops import core
from pointnet2_tpu_torch.ops.cuda.ballquery import MAX_SHARED_BYTES, num_sms
from pointnet2_tpu_torch.ops.cuda.common import (
    INT, PTR, launch, require, require_int32_range, stream_of,
)

MAX_REGISTER_K = 16  # csrc/knn.cu instantiates the register route for k = 1..16
MAX_K = MAX_SHARED_BYTES // 8  # the list route: k (distance, index) pairs a warp
MAX_THREADS = 256  # the register route's block
LIST_WARPS = 4  # the list route's block, where the lists fit
MAX_LIST_WARPS = 8
# The register route splits a query over more lanes until the launch has
# this many threads an SM (12 warps), as long as every lane keeps
# MIN_REFS_PER_LANE points. Measured on the H100 (tools.op_bench's routes at
# the four FP levels, B=8 and 16, PERF.md): more lanes only help while the
# launch has fewer threads than that; past it each doubling costs, since a
# lane's own top-k takes more inserts the fewer points it sees.
TARGET_THREADS_PER_SM = 384
MIN_REFS_PER_LANE = 16


def block_threads(nq: int, lanes: int) -> int:
    """The register route's block: up to 256 threads, no more than one
    cloud's queries need."""
    return min(MAX_THREADS, -(-nq * lanes // 32) * 32)


def check_grid(b: int, nq: int, lanes: int, threads: int) -> None:
    """Raises unless the launch's ``b * ceil(nq / (threads / lanes))`` blocks
    fit the kernel's int."""
    if b * -(-nq // (threads // lanes)) >= 2**31:
        raise ValueError(f"the kNN grid of {b} clouds x {nq} queries is too large")


@functools.cache
def plan(b: int, nq: int, m: int, k: int, num_sms: int) -> tuple[int, int]:
    """``(lanes, threads)`` of the kNN kernel for ``b`` clouds of ``m``
    references and ``nq`` queries each, on a card of ``num_sms`` SMs.

    k <= 16: the fewest lanes a query (a power of two up to 32) that give the
    launch ``TARGET_THREADS_PER_SM`` threads an SM, as long as every lane
    keeps ``MIN_REFS_PER_LANE`` points; blocks of up to 256 threads, no
    larger than one cloud's queries need. k > 16: one warp a query (32
    lanes), ``LIST_WARPS`` warps a block or as many as have room for their
    lists. Raises ``ValueError`` for a shape no route takes. Cached: it is
    on the host's path of every call.
    """
    if b <= 0 or nq <= 0 or m <= 0 or num_sms <= 0 or not 0 < k <= m:
        raise ValueError(f"kNN needs B, Nq > 0 and 0 < k <= M, got B={b}, Nq={nq}, M={m}, k={k}")
    require_int32_range("knn", b, nq, k)
    require_int32_range("knn", b, m, 3)
    if k > MAX_K:
        raise ValueError(f"the kNN kernel takes k <= {MAX_K} (a warp's list in shared memory), got {k}")
    if k > MAX_REGISTER_K:
        lanes, threads = 32, 32 * min(LIST_WARPS, MAX_SHARED_BYTES // (k * 8))
    else:
        lanes = 1
        while (lanes < 32 and m // (2 * lanes) >= MIN_REFS_PER_LANE
               and b * nq * lanes < num_sms * TARGET_THREADS_PER_SM):
            lanes *= 2
        threads = block_threads(nq, lanes)
    check_grid(b, nq, lanes, threads)
    return lanes, threads


def check_plan(b: int, nq: int, k: int, route: tuple[int, int]) -> tuple[int, int]:
    """A forced ``(lanes, threads)``; raises unless the kernel takes it for
    ``k`` and its grid for ``b`` clouds of ``nq`` queries."""
    lanes, threads = route
    if threads % 32 or threads < 32 or lanes not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"not a kNN route: {route}")
    if k <= MAX_REGISTER_K and threads > MAX_THREADS:
        raise ValueError(f"not a kNN route for k={k}: {route}")
    if k > MAX_REGISTER_K and (lanes != 32 or threads > 32 * MAX_LIST_WARPS or threads // 32 * k * 8 > MAX_SHARED_BYTES):
        raise ValueError(f"not a kNN list route for k={k}: {route}")
    check_grid(b, nq, lanes, threads)
    return lanes, threads


def knn(xyz1: torch.Tensor, xyz2: torch.Tensor, k: int, route=None) -> tuple[torch.Tensor, torch.Tensor]:
    """xyz1 (B, M, 3) dataset, xyz2 (B, Nq, 3) queries, float32 CUDA.

    Returns dist2 (B, Nq, k) float32 ascending and idx (B, Nq, k) int32.
    ``route``: a forced ``(lanes, threads)``, else ``plan``'s.
    """
    require(xyz1, "xyz1", torch.float32, (None, None, 3))
    b, m, _ = xyz1.shape
    require(xyz2, "xyz2", torch.float32, (b, None, 3))
    nq = xyz2.shape[1]
    if not 0 < k <= min(m, MAX_K) or b == 0 or nq == 0:
        raise ValueError(f"knn kernel needs 0 < k <= min(M, {MAX_K}) and non-empty inputs, got k={k}, M={m}, B={b}, Nq={nq}")
    if route is None:
        lanes, threads = plan(b, nq, m, k, num_sms(xyz1.device.index))
    else:
        require_int32_range("knn", b, nq, k)
        require_int32_range("knn", b, m, 3)
        lanes, threads = check_plan(b, nq, k, route)
    dist = torch.empty((b, nq, k), dtype=torch.float32, device=xyz1.device)
    idx = torch.empty((b, nq, k), dtype=torch.int32, device=xyz1.device)
    device, stream = stream_of(xyz1)
    launch(
        "knn", "knn", "pn2_knn",
        [PTR, PTR, INT, INT, INT, INT, INT, INT, PTR, PTR, INT, PTR],
        xyz1.data_ptr(), xyz2.data_ptr(), b, m, nq, k, lanes.bit_length() - 1, threads,
        dist.data_ptr(), idx.data_ptr(), device, stream,
    )
    return dist, idx


def knn_tiles(xs, perm, qs, lo, k: int, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The windowed kNN over sorted tiles of 128 queries; see ``ops.core.knn_tiles``.

    Window columns at or past M are padding. Returns dist2 (B, Nq, k) float32
    and idx (B, Nq, k) int32 in sorted query order.
    """
    require(xs, "xs", torch.float32, (None, None, 3))
    b, m, _ = xs.shape
    require(perm, "perm", torch.int32, (b, m))
    require(qs, "qs", torch.float32, (b, None, 3))
    nq = qs.shape[1]
    require(lo, "lo", torch.int32, (b, nq // core.LANES))
    if nq == 0 or nq % core.LANES or b == 0 or b > 65535:
        raise ValueError(f"knn_tiles needs whole tiles of {core.LANES} queries and 1..65535 clouds, got Nq={nq}, B={b}")
    if not 0 < k <= min(m, MAX_K):
        raise ValueError(f"knn_tiles needs 0 < k <= min(M, {MAX_K}), got k={k}, M={m}")
    if w <= 0:
        raise ValueError(f"window {w} must be positive")
    require_int32_range("knn_tiles", b, nq, k)
    require_int32_range("knn_tiles", b, m, 3)
    dist = torch.empty((b, nq, k), dtype=torch.float32, device=xs.device)
    idx = torch.empty((b, nq, k), dtype=torch.int32, device=xs.device)
    device, stream = stream_of(xs)
    launch(
        "knn_sliced", "knn", "pn2_knn_tiles",
        [PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, PTR, PTR, INT, PTR],
        xs.data_ptr(), perm.data_ptr(), qs.data_ptr(), lo.data_ptr(), b, m, nq, w, k,
        dist.data_ptr(), idx.data_ptr(), device, stream,
    )
    return dist, idx

