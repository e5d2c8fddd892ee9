"""Point-sharded ops: the big-cloud stages split over several devices.

Counterpart of ``pointnet2_tpu/parallel/sharded_ops.py``. The points of one
cloud are independent of one another in these stages, so the query (or
dense) points are split over the devices of a mesh (``parallel.mesh``; a
device may repeat) and the reference (sparse) points are copied to each
distinct device; no collective runs. Each shard runs the single-device op
on its device, row 3's kNN kernel on a card and its plain version on the
CPU, and the results come back to the host in the original order, equal to
the single-device op's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.ops.densify import densify_labels_device
from pointnet2_tpu_torch.parallel.mesh import create_mesh


def _pad_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _split(points, multiple: int, mesh: Sequence[torch.device]) -> tuple[int, list[torch.Tensor]]:
    """``points`` (N, 3) padded with zero rows to a multiple of ``multiple``,
    as float32 on the host, cut into ``len(mesh)`` equal shards: (N, shards)."""
    pts = torch.as_tensor(points).to("cpu", torch.float32)
    n = pts.shape[0]
    padded = torch.zeros((_pad_to(n, multiple), 3), dtype=torch.float32)
    padded[:n] = pts
    return n, list(padded.chunk(len(mesh)))


def _replicas(x: torch.Tensor, mesh: Sequence[torch.device]) -> dict[torch.device, torch.Tensor]:
    """``x`` on each distinct device of ``mesh``, copied once a device."""
    return {d: x.to(d).contiguous() for d in dict.fromkeys(mesh)}


def knn_sharded(xyz_refs, xyz_queries, k: int, mesh: Optional[Sequence[str | torch.device]] = None):
    """Exact kNN with the QUERY points sharded over ``mesh`` (default: every
    visible card). xyz_refs (M, 3), xyz_queries (N, 3); the queries are padded
    to a multiple of ``len(mesh) * 8``. Returns (dist2 (N, k) float32, idx
    (N, k) int32) on the host, ascending, equal to ``ops.knn`` on one device;
    each shard is one ``ops.knn`` call on its device."""
    mesh = create_mesh(mesh)
    n, shards = _split(xyz_queries, len(mesh) * 8, mesh)
    refs = _replicas(torch.as_tensor(np.asarray(xyz_refs, np.float32)), mesh)
    parts = [ops.knn(refs[d][None], q.to(d)[None], k) for d, q in zip(mesh, shards)]  # all launched, then read
    d2 = torch.cat([p[0][0].cpu() for p in parts])
    idx = torch.cat([p[1][0].cpu() for p in parts])
    return d2[:n], idx[:n]


def three_nn_sharded(xyz_targets, xyz_refs, mesh: Optional[Sequence[str | torch.device]] = None):
    """Sharded exact 3-NN (squared distances), the targets sharded over ``mesh``."""
    return knn_sharded(xyz_refs, xyz_targets, 3, mesh)


def densify_labels_sharded(
    sparse_points,
    sparse_labels,
    dense_points,
    knn: int,
    mesh: Optional[Sequence[str | torch.device]] = None,
    chunk: Optional[int] = None,
) -> np.ndarray:
    """kNN majority-vote densification with the dense cloud sharded over
    ``mesh`` (default: every visible card): (N,) int32 labels on the host.

    The dense cloud is padded to a multiple of ``len(mesh) * 128``; each
    shard runs the device engine (``ops.densify.densify_labels_device``,
    ``chunk`` dense points a kNN call, default its own) on its device, with
    the sparse points and labels copied there once. Equal to the device
    engine on one device."""
    mesh = create_mesh(mesh)
    n, shards = _split(dense_points, len(mesh) * 128, mesh)
    sparse = _replicas(torch.as_tensor(np.asarray(sparse_points, np.float32)), mesh)
    labels = _replicas(torch.as_tensor(np.asarray(sparse_labels, np.int32)), mesh)
    parts = [densify_labels_device(sparse[d], labels[d], shard, knn, device=d, chunk=chunk)[0]
             for d, shard in zip(mesh, shards)]  # all launched, then read
    return torch.cat([p.cpu() for p in parts])[:n].numpy()
