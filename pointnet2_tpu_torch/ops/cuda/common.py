"""What every kernel wrapper shares: input checks, the launch, the launch count.

A wrapper checks its tensors (device, dtype, shape, contiguity) and raises on
what its kernel does not take, allocates the outputs with ``torch.empty``,
launches on PyTorch's current stream, raises if the launch returned a CUDA
error, and only then adds one to its entry in ``LAUNCHES``.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from pointnet2_tpu_torch.ops.cuda import build

# Kernel name -> launches since the last reset. Only wrappers add to it.
LAUNCHES: collections.Counter = collections.Counter()

PTR = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong
FLOAT = ctypes.c_float

# (source, symbol) -> the ctypes function, with its argtypes set.
_entries: dict = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def require(
    t: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple, contiguous: bool = True
) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and ``shape``.

    ``shape`` may hold None for a dimension that is not fixed. With
    ``contiguous=False`` the layout is the caller's to settle.
    """
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor for the kernel")
    if t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
        want is not None and got != want for got, want in zip(t.shape, shape)
    ):
        raise ValueError(f"{what} must have shape {shape}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def require_int32_range(what: str, *sizes: int) -> None:
    """Raise if a product of sizes overflows the kernels' int indexing."""
    total = 1
    for s in sizes:
        total *= s
    if total >= 2**31:
        raise ValueError(f"{what}: {total} elements exceed the kernel's int32 indexing")


def launch(kernel: str, source: str, symbol: str, argtypes: list, *args) -> None:
    """Call ``symbol`` of ``csrc/<source>.cu``, raise on a CUDA error, count it."""
    lib = build.load(source)
    fn = _entries.get((source, symbol))
    if fn is None:
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[(source, symbol)] = fn
    build.check(lib, f"{symbol}_error_string", fn(*args), kernel)
    LAUNCHES[kernel] += 1


def stream_of(t: torch.Tensor) -> tuple[int, int]:
    """(device index, current stream handle) for a CUDA tensor."""
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream
