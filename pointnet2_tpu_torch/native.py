"""ctypes bindings of the native host engine (``native/densify.cpp``): grid kNN, the vote, the colors.

An own copy of ``pointnet2_tpu/native.py`` (the port imports nothing of the
JAX package), with its own build: the port compiles the repo's
``native/densify.cpp`` with ``native/Makefile``'s flags into
``pointnet2_tpu_torch/build/`` (listed in ``.gitignore``), never into
``native/``, under a name that carries a hash of the source, the compiler,
the flags and the host CPU (``-march=native``). An edited source, or another
CPU, gets a new library, so a stale one is never loaded; a library is
written under a temporary name and moved into place, so a process never
loads one another process is still writing. ``native/`` is the JAX package's, and its own
loader rebuilds ``native/libpn2native.so`` in place.

The engine replaces the reference's Open3D-based InterpolateLabelWithColor
op (tf_ops/tf_interpolate.cpp:52-185). Where there is no compiler, or the
build fails, ``get_lib`` returns None and ``densify_labels_native`` None,
and ``ops.densify``'s ``auto`` engine takes scipy's cKDTree instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
from typing import Optional

import numpy as np

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent
SOURCE = PACKAGE_DIR.parent / "native" / "densify.cpp"
BUILD_DIR = PACKAGE_DIR / "build"
# native/Makefile's CXXFLAGS and LDFLAGS.
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17", "-Wall")
LD_FLAGS = ("-shared", "-fopenmp")

# ``library_path`` of a source -> its loaded library with the argtypes set (None: no compiler built it).
_libs: dict[pathlib.Path, Optional[ctypes.CDLL]] = {}


def _host_cpu() -> bytes:
    """The CPU's model and feature flags, which ``-march=native`` compiles for."""
    try:
        lines = pathlib.Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))][:2]
    return "\n".join(keep).encode()


def compilers() -> list[str]:
    """The C++ compilers to try, in order: ``$CXX`` (as ``make`` would take it),
    then ``g++`` (a ``$CXX`` without OpenMP's spec file has been seen)."""
    return list(dict.fromkeys(c for c in (os.environ.get("CXX"), "g++") if c))


def library_path(source: pathlib.Path = SOURCE, compiler: Optional[str] = None) -> pathlib.Path:
    """Where the library of ``source`` built by ``compiler`` (default: the first
    of ``compilers()``) lives, keyed by the source, the compiler, the flags
    and the host CPU."""
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join((compiler or compilers()[0], *CXX_FLAGS, *LD_FLAGS)).encode())
    digest.update(_host_cpu())
    return BUILD_DIR / f"libpn2native_{digest.hexdigest()[:16]}.so"


def build(source: pathlib.Path = SOURCE) -> Optional[pathlib.Path]:
    """The library of ``source`` from the first compiler of ``compilers()``
    that has built it or builds it now (each one's output kept as ``.log``
    beside its library), or None when none can."""
    for compiler in compilers():
        path = library_path(source, compiler)
        if path.exists():
            return path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        try:
            run = subprocess.run(
                [compiler, *CXX_FLAGS, str(source), *LD_FLAGS, "-o", str(tmp)],
                capture_output=True, text=True, timeout=300,
            )
        except (OSError, subprocess.TimeoutExpired) as e:
            path.with_suffix(".log").write_text(f"{compiler}: {e}\n")
            continue
        path.with_suffix(".log").write_text(run.stdout + run.stderr)
        if run.returncode == 0:
            os.replace(tmp, path)
            return path
        tmp.unlink(missing_ok=True)
    return None


def get_lib(source: pathlib.Path = SOURCE) -> Optional[ctypes.CDLL]:
    """The native library of ``source``, built on first use; None if it cannot be built or loaded."""
    key = library_path(source)  # changes with the source's contents
    if key in _libs:
        return _libs[key]
    built = build(source)
    lib = None
    if built is not None:
        try:
            lib = ctypes.CDLL(str(built))
        except OSError:
            lib = None
    if lib is not None:
        i64, i32, u8, f32, f64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_uint8, ctypes.c_float, ctypes.c_double
        P = ctypes.POINTER
        lib.densify_labels.argtypes = [P(f32), P(i32), i64, P(f32), i64, ctypes.c_int, f64, P(i32), P(u8)]
        lib.densify_labels.restype = ctypes.c_int
        lib.knn_search.argtypes = [P(f32), i64, P(f32), i64, ctypes.c_int, f64, P(i64), P(f64)]
        lib.knn_search.restype = ctypes.c_int
        lib.voxel_assign.argtypes = [P(f32), i64, f64, f64, f64, f64, i64, i64, P(i64)]
        lib.voxel_assign.restype = ctypes.c_int
    _libs[key] = lib
    return lib


def _as_c(arr: np.ndarray, dtype, ctype):
    arr = np.ascontiguousarray(arr, dtype=dtype)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctype))


def densify_labels_native(
    sparse_points: np.ndarray,
    sparse_labels: np.ndarray,
    dense_points: np.ndarray,
    knn: int = 3,
    cell: float = 0.0,
):
    """Native kNN majority-vote densification: (labels (N,) int32, colors
    (N, 3) uint8), or None without the library or for a ``knn`` it refuses
    (above 64)."""
    lib = get_lib()
    if lib is None:
        return None
    sp, sp_p = _as_c(sparse_points, np.float32, ctypes.c_float)
    sl, sl_p = _as_c(sparse_labels, np.int32, ctypes.c_int32)
    dp, dp_p = _as_c(dense_points, np.float32, ctypes.c_float)
    nd = len(dp)
    out_labels = np.empty(nd, np.int32)
    out_colors = np.empty((nd, 3), np.uint8)
    rc = lib.densify_labels(
        sp_p, sl_p, len(sp), dp_p, nd, int(knn), float(cell),
        out_labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_colors.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        return None
    return out_labels, out_colors


def knn_search_native(data_points: np.ndarray, query_points: np.ndarray, knn: int, cell: float = 0.0):
    """Native exact kNN: (idx (Q, k) int64, d2 (Q, k) float64), or None."""
    lib = get_lib()
    if lib is None:
        return None
    dp, dp_p = _as_c(data_points, np.float32, ctypes.c_float)
    qp, qp_p = _as_c(query_points, np.float32, ctypes.c_float)
    nq = len(qp)
    out_idx = np.empty((nq, knn), np.int64)
    out_d2 = np.empty((nq, knn), np.float64)
    rc = lib.knn_search(
        dp_p, len(dp), qp_p, nq, int(knn), float(cell),
        out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_d2.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        return None
    return out_idx, out_d2
