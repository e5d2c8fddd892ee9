"""The eleven kernels as operators of the ``pn2`` library: ``torch.ops.pn2.*``.

Each leaf wrapper of ``ops.cuda`` (one a Pallas kernel of the JAX package)
gets a schema in one ``torch.library.Library("pn2", "DEF")`` and three
implementations:

- CUDA: the ``ops.cuda`` wrapper on its planned route, which launches its
  kernel or raises (there is no fallback to the plain version);
- CPU: the plain version of ``ops.core``, which returns fresh tensors, none
  a view of an input, as an operator without an alias annotation must
  (``torch.library.opcheck`` holds each to it in the CPU tests);
- Fake: the outputs' shapes and dtypes from the inputs' shapes and the int
  and float arguments alone, so that ``torch.export`` traces the operator on
  tensors without data and an exported program holds it as one node.

``route=`` stays out of the schemas: forcing a route is for the raw wrappers.
The launch counts stay inside the wrappers, so a replay of an exported
program counts like an eager call. An exported program that holds these
operators needs this module imported before it is loaded
(``pointnet2_tpu_torch.export.load_exported`` does so).

``Library`` + ``impl`` is the cheaper of PyTorch's two ways to define an
operator from Python: the ``torch.library.custom_op`` decorator adds its own
Python layers to every call, and the predict path makes some 30 calls a
request. ``chip_smoke.py``'s export line times a call through ``pn2``
beside the raw wrapper (about 3 µs more a call on an H100).
"""

from __future__ import annotations

import importlib

import torch

from pointnet2_tpu_torch.ops import core
from pointnet2_tpu_torch.ops.cuda import ballquery, fps, interpolate, wingather

# The package attribute ``ops.cuda.knn`` is the wrapper function; the module is reached by name.
knn_module = importlib.import_module("pointnet2_tpu_torch.ops.cuda.knn")

LIB = torch.library.Library("pn2", "DEF")

# name -> the schema's arguments and results. The CUDA wrapper and the plain
# version of each (``CUDA``, ``CPU``) take the arguments in the schema's order.
SCHEMAS = {
    "fps_centroids": "(Tensor xyz, int npoint) -> (Tensor, Tensor)",
    "farthest_point_sample": "(Tensor xyz, int npoint) -> Tensor",
    "ball_query": "(Tensor xyz1, Tensor xyz2, float radius, int nsample) -> (Tensor, Tensor)",
    "ball_query_tiles": (
        "(Tensor xs, Tensor perm, Tensor qs, Tensor lo, float radius, int nsample, int w) -> (Tensor, Tensor)"
    ),
    "ball_query_window_tiles": (
        "(Tensor xyz1, Tensor xs, Tensor perm, Tensor qs, Tensor lo, Tensor hi, float radius, int nsample, "
        "int w) -> (Tensor, Tensor)"
    ),
    "ball_query_tiles_pos": (
        "(Tensor xs, Tensor perm, Tensor qs, Tensor lo, float radius, int nsample, int w) "
        "-> (Tensor, Tensor, Tensor)"
    ),
    "window_gather": "(Tensor zp_s, Tensor lo, Tensor pos) -> Tensor",
    "knn": "(Tensor xyz1, Tensor xyz2, int k) -> (Tensor, Tensor)",
    "knn_tiles": "(Tensor xs, Tensor perm, Tensor qs, Tensor lo, int k, int w) -> (Tensor, Tensor)",
    "three_interpolate": (
        "(Tensor points, Tensor idx, Tensor weight, Tensor? skip=None, str? precision=None) -> Tensor"
    ),
    "three_interpolate_grad": (
        "(Tensor g, Tensor idx, Tensor weight, int m, str? precision=None, ScalarType? dtype=None) -> Tensor"
    ),
}


def _cuda_three_interpolate(points, idx, weight, skip=None, precision=None):
    return interpolate.three_interpolate(points, idx, weight, skip, precision=precision)


def _cpu_three_interpolate(points, idx, weight, skip=None, precision=None):
    if skip is None:
        return core.three_interpolate(points, idx, weight, precision)
    return core.three_interpolate_concat(points, idx, weight, skip, precision)


CUDA = {
    "fps_centroids": fps.fps_centroids,
    "farthest_point_sample": fps.farthest_point_sample,
    "ball_query": ballquery.ball_query,
    "ball_query_tiles": ballquery.ball_query_tiles,
    "ball_query_window_tiles": ballquery.ball_query_window_tiles,
    "ball_query_tiles_pos": wingather.ball_query_tiles_pos,
    "window_gather": wingather.window_gather,
    "knn": knn_module.knn,
    "knn_tiles": knn_module.knn_tiles,
    "three_interpolate": _cuda_three_interpolate,
    "three_interpolate_grad": interpolate.three_interpolate_grad,
}

CPU = {
    "fps_centroids": core.fps_centroids,
    "farthest_point_sample": core.farthest_point_sample,
    "ball_query": core.ball_query,
    "ball_query_tiles": core.ball_query_tiles,
    "ball_query_window_tiles": core.ball_query_window_tiles,
    "ball_query_tiles_pos": core.ball_query_tiles_pos,
    "window_gather": core.window_gather,
    "knn": core.knn,
    "knn_tiles": core.knn_tiles,
    "three_interpolate": _cpu_three_interpolate,
    "three_interpolate_grad": core.three_interpolate_grad,
}


for _name, _schema in SCHEMAS.items():
    LIB.define(_name + _schema)
    LIB.impl(_name, CUDA[_name], "CUDA")
    LIB.impl(_name, CPU[_name], "CPU")


# -- fake implementations: shapes and dtypes only ---------------------------

I32 = torch.int32


@torch.library.register_fake("pn2::fps_centroids")
def _fps_centroids_fake(xyz, npoint):
    b = xyz.shape[0]
    return xyz.new_empty((b, npoint), dtype=I32), xyz.new_empty((b, npoint, 3))


@torch.library.register_fake("pn2::farthest_point_sample")
def _farthest_point_sample_fake(xyz, npoint):
    return xyz.new_empty((xyz.shape[0], npoint), dtype=I32)


def _idx_cnt(like, b, m, nsample):
    return like.new_empty((b, m, nsample), dtype=I32), like.new_empty((b, m), dtype=I32)


@torch.library.register_fake("pn2::ball_query")
def _ball_query_fake(xyz1, xyz2, radius, nsample):
    return _idx_cnt(xyz1, xyz1.shape[0], xyz2.shape[1], nsample)


@torch.library.register_fake("pn2::ball_query_tiles")
def _ball_query_tiles_fake(xs, perm, qs, lo, radius, nsample, w):
    return _idx_cnt(xs, xs.shape[0], qs.shape[1], nsample)


@torch.library.register_fake("pn2::ball_query_window_tiles")
def _ball_query_window_tiles_fake(xyz1, xs, perm, qs, lo, hi, radius, nsample, w):
    return _idx_cnt(xs, xs.shape[0], qs.shape[1], nsample)


@torch.library.register_fake("pn2::ball_query_tiles_pos")
def _ball_query_tiles_pos_fake(xs, perm, qs, lo, radius, nsample, w):
    b, m = xs.shape[0], qs.shape[1]
    idx, cnt = _idx_cnt(xs, b, m, nsample)
    return idx, xs.new_empty((b, m, nsample), dtype=I32), cnt


@torch.library.register_fake("pn2::window_gather")
def _window_gather_fake(zp_s, lo, pos):
    b, m, k = pos.shape
    return zp_s.new_empty((b, m, k, zp_s.shape[2]))


def _dist_idx(like, b, nq, k):
    return like.new_empty((b, nq, k), dtype=torch.float32), like.new_empty((b, nq, k), dtype=I32)


@torch.library.register_fake("pn2::knn")
def _knn_fake(xyz1, xyz2, k):
    return _dist_idx(xyz1, xyz1.shape[0], xyz2.shape[1], k)


@torch.library.register_fake("pn2::knn_tiles")
def _knn_tiles_fake(xs, perm, qs, lo, k, w):
    return _dist_idx(xs, xs.shape[0], qs.shape[1], k)


@torch.library.register_fake("pn2::three_interpolate")
def _three_interpolate_fake(points, idx, weight, skip=None, precision=None):
    b, n, _ = idx.shape
    c = points.shape[2]
    if skip is None:
        return points.new_empty((b, n, c))
    return points.new_empty((b, n, c + skip.shape[2]), dtype=interpolate.out_dtype(points, skip))


@torch.library.register_fake("pn2::three_interpolate_grad")
def _three_interpolate_grad_fake(g, idx, weight, m, precision=None, dtype=None):
    b, _, c = g.shape
    return g.new_empty((b, m, c), dtype=g.dtype if dtype is None else dtype)
