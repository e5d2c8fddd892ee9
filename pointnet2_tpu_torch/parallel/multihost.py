"""Processes: the distributed init, the collectives the train step needs, and rows.

Counterpart of ``pointnet2_tpu/parallel/multihost.py``. The data-parallel
unit is the process: each one drives one device, ``cuda:(rank mod
device_count)`` (or the CPU), and the processes together form one
``torch.distributed`` group, the counterpart of the JAX mesh over processes.

The backend: NCCL where every rank has a card of its own (a CUDA device and
no more processes than visible cards), gloo otherwise, that is on the CPU or
with ranks sharing a card (NCCL refuses two ranks on one GPU). Over gloo a
CUDA tensor is copied to host memory for each collective and back (the
computation stays on the card). The group's timeout is
``DEFAULT_TIMEOUT_S``, or the seconds in the environment variable
``PN2_DIST_TIMEOUT_S``: the first rank to reach a kernel builds it while the
others wait at their first collective.

What reads the group: ``BatchNorm`` (global batch statistics) and the head's
dropout (the global batch's masks) in train mode when ``data_parallel()``
names more than one rank, and ``Trainer`` steps (global gradient sums,
loss denominator and metrics) whenever a group is active.
"""

from __future__ import annotations

import datetime
import hashlib
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from pointnet2_tpu_torch.parallel.mesh import tree_map

DEFAULT_TIMEOUT_S = 600.0
TIMEOUT_ENV = "PN2_DIST_TIMEOUT_S"


def choose_backend(device: torch.device, num_processes: int) -> str:
    """``nccl`` when each of ``num_processes`` ranks can have a card of its own, else ``gloo``."""
    if device.type == "cuda" and num_processes <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(
    coordinator: str,
    num_processes: int,
    process_id: int,
    device: str | torch.device = "cuda",
    backend: Optional[str] = None,
) -> torch.device:
    """Join the group of ``num_processes`` ranks as ``process_id``, through the
    TCP store of rank 0 at ``coordinator`` (``host:port``); returns this
    rank's device: for ``cuda`` without an index ``cuda:(process_id mod
    device_count)``, made the current device. ``backend`` None follows the
    rule of the module docstring. Raises where CUDA is asked for and absent."""
    if coordinator is None or process_id is None:
        raise ValueError("a distributed run needs --dist_coordinator and --dist_process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside [0, {num_processes})")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the distributed run asks for CUDA and no CUDA device is available")
        if device.index is None:
            device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend or choose_backend(device, num_processes)
    timeout = datetime.timedelta(seconds=float(os.environ.get(TIMEOUT_ENV, DEFAULT_TIMEOUT_S)))
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes, rank=process_id,
                            timeout=timeout)
    return device


def maybe_initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str | torch.device = "cuda",
    backend: Optional[str] = None,
) -> torch.device:
    """``initialize`` for more than one process; a no-op returning ``device`` otherwise."""
    if num_processes is None or num_processes <= 1:
        return torch.device(device)
    return initialize(coordinator, num_processes, process_id, device, backend)


def shutdown() -> None:
    """Leave the group, if there is one."""
    if active():
        dist.destroy_process_group()


def active() -> bool:
    """Whether this process is in an initialized group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def _rank_and_world() -> tuple[int, int]:
    return (dist.get_rank(), dist.get_world_size()) if active() else (0, 1)


def process_index() -> int:
    return _rank_and_world()[0]


def process_count() -> int:
    return _rank_and_world()[1]


def backend() -> Optional[str]:
    return dist.get_backend() if active() else None


def data_parallel() -> Optional[tuple[int, int]]:
    """``(rank, world size)`` of the active group when it has more than one rank, else None."""
    rank, world = _rank_and_world()
    return (rank, world) if world > 1 else None


def barrier() -> None:
    """Every rank waits here for the others; a no-op without a group."""
    if not active():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def all_reduce_(t: torch.Tensor, op: dist.ReduceOp = dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the group in place (through host memory over gloo for
    a CUDA tensor); ``t`` itself without a group."""
    if not active():
        return t
    if t.is_cuda and dist.get_backend() == "gloo":
        host = t.cpu()
        dist.all_reduce(host, op)
        t.copy_(host)
    else:
        dist.all_reduce(t, op)
    return t


class _AllReduceSum(torch.autograd.Function):
    """The group's sum; its backward is the group's sum of the cotangents."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone())


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the group, differentiable."""
    return _AllReduceSum.apply(t)


def allgather_host(array) -> np.ndarray:
    """Every rank's ``array`` (equal shapes and types), stacked in rank order: (world, *shape)."""
    a = np.ascontiguousarray(array)
    if not active():
        return a[None]
    t = torch.from_numpy(a)
    if dist.get_backend() == "nccl":
        t = t.to(torch.cuda.current_device())
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return np.stack([o.cpu().numpy() for o in out])


def local_rows(batch, process_index: Optional[int] = None, process_count: Optional[int] = None):
    """This process's leading-dim slice of a globally sampled batch (an array,
    or a dict, list or tuple of them): rows ``[pid * local, (pid + 1) * local)``.

    Used by ``--dist_sampling replicated``: every process draws the same
    global batch from an identically seeded sampler and keeps only its rows,
    so the global batch equals a one-process run's with the same seed.
    """
    rank, world = _rank_and_world()
    pid = rank if process_index is None else process_index
    nproc = world if process_count is None else process_count

    def cut(x):
        if x.shape[0] % nproc:
            raise ValueError(f"global batch dim {x.shape[0]} must divide by the process count {nproc}")
        local = x.shape[0] // nproc
        return x[pid * local : (pid + 1) * local]

    return tree_map(cut, batch)


def _state_digest(module: torch.nn.Module) -> int:
    """A 63-bit hash of the bytes of every parameter and buffer, in order."""
    h = hashlib.blake2b(digest_size=8)
    for name, t in module.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return int.from_bytes(h.digest(), "little") >> 1


def assert_replicated(module: torch.nn.Module) -> None:
    """Raise unless every rank holds the same parameters and buffers, bit for
    bit (the counterpart of ``replicate_state_on_mesh``: each rank initialises
    or restores the same state on its own). A no-op without a group."""
    if not active():
        return
    digests = allgather_host(np.array([_state_digest(module)], np.int64))[:, 0]
    if len(set(digests.tolist())) != 1:
        raise RuntimeError(f"the ranks hold different model states: digests {digests.tolist()}")
