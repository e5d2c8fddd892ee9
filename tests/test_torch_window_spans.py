"""The x-range cut of the windowed ball query's tiles kernel, on the CPU.

The CUDA tiles kernel (``csrc/window_bq.cuh``, rows 7 and 8 of PERF.md's
kernel table) scans each query's window only over ``[first, last)``: the
columns whose rounded ``dx * dx`` alone stays below r2, a run of the
x-sorted window. ``ops.core.ball_query_tile_spans`` computes those spans as
the kernel does. These tests hold that the cut loses nothing: the plain
tiles functions restricted to the spans equal the unrestricted ones bit for
bit (indices, counts, window columns), on hypothesis-drawn clouds, on columns
exactly at ``|dx| = r``, on runs of equal x, with nsample 8, 32 and 64, and
through the whole calibrated ops against the JAX package's Pallas wrappers
in interpret mode, with windows that certify and windows that do not.
"""

import jax
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from jax.experimental.pallas import tpu as pltpu

from pointnet2_tpu.ops.pallas import ball_query_sliced as jax_ball_query_sliced
from pointnet2_tpu.ops.pallas.wingather import project_group_sliced as jax_project_group_sliced
from pointnet2_tpu_torch.ops import core

T = torch.from_numpy


def _restricted(with_pos):
    """``core.ball_query_tiles`` (``_pos`` with ``with_pos``) that looks only
    at each query's span: every other column counts as out of the ball."""

    def tiles(xs, perm, qs, lo, radius, nsample, w):
        keys, sentinel = core._bq_tile_keys(xs, perm, qs, lo, radius, w, with_pos)
        first, last = core.ball_query_tile_spans(xs, qs, lo, radius, w)
        col = torch.arange(w)
        inside = (col >= first[..., None]) & (col < last[..., None])
        sel, cnt = core._first_k(torch.where(inside, keys, sentinel), sentinel, nsample)
        if not with_pos:
            return sel.to(torch.int32), cnt.to(torch.int32)
        return (torch.div(sel, w, rounding_mode="floor").to(torch.int32), (sel % w).to(torch.int32),
                cnt.to(torch.int32))

    return tiles


def _cloud(seed, b, n, kind):
    rng = np.random.RandomState(seed)
    xyz = rng.rand(b, n, 3) * [8.0, 1.0, 1.0]
    if kind == "runs":  # runs of equal x: the stable sort keeps their order
        xyz[..., 0] = np.round(xyz[..., 0] * 8.0) / 8.0
    elif kind == "band":  # half the points in a 2 cm band of x
        xyz[:, : n // 2, 0] = 4.0 + rng.rand(b, n // 2) * 0.02
    return xyz.astype(np.float32)


def _check_spans(xyz, queries, radius, nsample, w):
    """Spans against the columns' own test, and the restricted tiles against
    the unrestricted ones, on the sorted inputs the calibrated op makes."""
    perm, xs, _, qs, lo, ok = core.ball_query_window_plan(T(xyz), T(queries), radius, w)
    first, last = core.ball_query_tile_spans(xs, qs, lo, radius, w)
    b, t = lo.shape
    m = qs.shape[1]
    win, _ = core._tile_windows(xs, perm, lo, w)
    q = qs.reshape(b, t, m // t, 1, 3)
    dx = q[..., 0] - win[:, :, None, :, 0]
    in_ball = (core._dist2(q, win[:, :, None]) < core.squared_radius(radius)).reshape(b, m, w)
    near = (dx * dx < core.squared_radius(radius)).reshape(b, m, w)
    col = torch.arange(w)
    inside = (col >= first[..., None]) & (col < last[..., None])
    assert torch.equal(inside, near)  # the span is exactly the columns that are not far
    assert not (in_ball & ~inside).any()
    for with_pos, plain in ((False, core.ball_query_tiles), (True, core.ball_query_tiles_pos)):
        got = _restricted(with_pos)(xs, perm, qs, lo, radius, nsample, w)
        want = plain(xs, perm, qs, lo, radius, nsample, w)
        assert all(torch.equal(g, h) for g, h in zip(got, want))
    return ok


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(
    seed=st.integers(0, 2**31 - 1),
    b=st.sampled_from([1, 2]),
    n=st.sampled_from([512, 1024]),
    m=st.sampled_from([128, 256]),
    radius=st.sampled_from([0.05, 0.3, 0.5, 1.5]),
    nsample=st.sampled_from([8, 32, 64]),
    window=st.sampled_from([128, 256, 384]),
    kind=st.sampled_from(["uniform", "runs", "band"]),
)
def test_spans_lose_no_hit(seed, b, n, m, radius, nsample, window, kind):
    xyz = _cloud(seed % 2**31, b, n, kind)
    queries = np.ascontiguousarray(xyz[:, :: n // m][:, :m])
    _check_spans(xyz, queries, radius, nsample, window)


@pytest.mark.parametrize("nsample", [8, 32, 64])
def test_columns_exactly_at_the_radius(nsample):
    """Columns at dx = +-r exactly (fl(dx * dx) == r2: far, and out of the
    ball even with dy = dz = 0) and one ulp inside (near, and in the ball)."""
    r = 0.5
    qx = np.float32(2.0)
    xs = [qx - np.float32(r), qx + np.float32(r),
          np.nextafter(qx - np.float32(r), qx), np.nextafter(qx + np.float32(r), qx)]
    rng = np.random.RandomState(nsample)
    cloud = rng.rand(1, 256, 3).astype(np.float32) * np.float32([4.0, 0.01, 0.01])
    cloud[0, :4, 0] = xs
    cloud[0, :4, 1:] = 0.0
    queries = np.zeros((1, 128, 3), np.float32)
    queries[0, :, 0] = qx
    queries[0, 1:, 0] += np.linspace(-0.3, 0.3, 127).astype(np.float32)
    _check_spans(cloud, queries, r, nsample, 256)  # the window is the whole cloud
    perm, xs_sorted, _, qs, lo, _ = core.ball_query_window_plan(T(cloud), T(queries), r, 256)
    first, last = core.ball_query_tile_spans(xs_sorted, qs, lo, r, 256)
    at = int(torch.nonzero(qs[0, :, 0] == float(qx))[0, 0])
    cols = torch.arange(first[0, at], last[0, at]) + lo[0, 0]
    inside = set(perm[0, cols].tolist())
    assert {2, 3} <= inside and not {0, 1} & inside


# (b, n, m, radius, nsample, window, ok): windows that certify and windows too small
OP_CASES = [
    (1, 1024, 512, 0.05, 8, 512, True),
    (2, 1024, 256, 0.3, 32, 256, False),
    (1, 4096, 512, 0.4, 64, 2048, True),
    (1, 1024, 128, 0.45, 40, 512, False),
]


@pytest.mark.parametrize("b,n,m,radius,nsample,window,ok", OP_CASES)
def test_cut_ball_query_sliced_matches_the_pallas_wrapper(b, n, m, radius, nsample, window, ok):
    x1 = _cloud(b * n + m, b, n, "uniform")
    x2 = np.ascontiguousarray(x1[:, :: n // m][:, :m])
    with pltpu.force_tpu_interpret_mode():
        want = jax_ball_query_sliced(x1, x2, radius, nsample, window)
    got = core.ball_query_sliced(T(x1), T(x2), radius, nsample, window, tiles=_restricted(False))
    assert bool(got[2]) == ok
    for g, h in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(h))
    assert all(torch.equal(g, h) for g, h in zip(got, core.ball_query_sliced(T(x1), T(x2), radius, nsample, window)))


@pytest.mark.parametrize("radius,window", [(0.05, 256), (0.3, 128)])
def test_cut_project_group_sliced_matches_the_pallas_wrapper(radius, window):
    rng = np.random.RandomState(2)
    xyz = _cloud(3, 1, 512, "runs")
    new_xyz = np.ascontiguousarray(xyz[:, np.argsort(xyz[0, :, 0], kind="stable")[:128]])
    inputs = np.concatenate([xyz, rng.rand(1, 512, 3).astype(np.float32)], -1)
    w0 = rng.randn(6, 8).astype(np.float32)
    b0 = rng.randn(8).astype(np.float32)
    with pltpu.force_tpu_interpret_mode(), jax.default_matmul_precision("highest"):
        want = jax_project_group_sliced(inputs, w0, b0, xyz, new_xyz, radius, 4, window)
    got = core.project_group_sliced(T(inputs), T(w0), T(b0), T(xyz), T(new_xyz), radius, 4, window,
                                    tiles=_restricted(True))
    plain = core.project_group_sliced(T(inputs), T(w0), T(b0), T(xyz), T(new_xyz), radius, 4, window)
    for i in (1, 2, 3, 4, 5):  # idx, cnt, qperm, inv_q, ok
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
        assert torch.equal(got[i], plain[i])
    assert torch.equal(got[0], plain[0])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
