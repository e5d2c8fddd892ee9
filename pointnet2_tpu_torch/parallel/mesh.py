"""Devices a batch is split over.

Counterpart of ``pointnet2_tpu/parallel/mesh.py``. A "mesh" here is a tuple
of ``torch.device``s: by default every visible CUDA device. A device may
appear more than once (several shards on one card), which is how one card
runs a sharded path, and how the CPU tests run several shards. Parameters
are replicated by giving each distinct device its own copy of the model;
``shard_batch`` splits dim 0 over the mesh in order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def create_mesh(devices: Optional[Sequence[str | torch.device]] = None) -> tuple[torch.device, ...]:
    """The given devices, or every visible CUDA device; raises without one."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible: pass the devices of the mesh (for example ['cpu', 'cpu'])")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def shard_batch(batch, mesh: Sequence[torch.device]):
    """``batch`` (an array or tensor, or a dict, list or tuple of them) split
    along dim 0 into ``len(mesh)`` equal shards, shard ``i`` on ``mesh[i]``:
    a list with one such structure a device. Dim 0 must divide by the
    mesh size."""
    n = len(mesh)

    def cut(x, i: int):
        t = torch.as_tensor(x)
        if t.shape[0] % n:
            raise ValueError(f"batch dim {t.shape[0]} must divide by the mesh size {n}")
        size = t.shape[0] // n
        return t[i * size : (i + 1) * size].to(mesh[i])

    return [tree_map(lambda x, i=i: cut(x, i), batch) for i in range(n)]


def pad_batch_to_devices(batch_size: int, num_devices: int) -> int:
    """Smallest per-step batch >= batch_size divisible by the mesh size."""
    return -(-batch_size // num_devices) * num_devices


def tree_map(fn, tree):
    """``fn`` on every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
