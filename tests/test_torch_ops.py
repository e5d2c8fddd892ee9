"""The port's plain point-set operators against the JAX package.

Inputs are seeded numpy arrays fed to both sides. Tolerances:

- FPS indices and centroids, ball-query idx/cnt, kNN and 3-NN idx/dist2:
  equal bit for bit to the NumPy oracles of ``pointnet2_tpu/ops/reference.py``
  and to the Pallas kernels run in TPU interpret mode on the CPU. The one
  exception is the kNN distances of interpret mode, which contracts the
  distance sum into FMAs where NumPy does not: they are held within
  rtol=1e-5, atol=1e-6, as ``tests/test_ops_pallas.py`` holds them (their
  indices stay exact);
- three_interpolate: rtol=1e-6, atol=1e-6 against the Pallas kernel (a
  float32 matmul over a sparse weight block) and the XLA gather form, which
  sum the three products in another order;
- interpolation_weights: rtol=1e-6 against XLA and the oracle;
- three_interpolate_grad (the ``points`` cotangent) and the weight cotangent:
  rtol=1e-5, atol=1e-5 against the Pallas backward kernel in interpret mode
  (a float32 matmul over a dense W^T block) and against ``jax.vjp`` of the XLA
  gather form: a coarse row sums a few dozen addends, in another order on
  each side;
- project_group_leaf and the fps_centroids input gradient: rtol=1e-5,
  atol=1e-5 against ``jax.grad``; the leaf's input gradient is exactly zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pointnet2_tpu.ops import core as jcore
from pointnet2_tpu.ops import reference
from pointnet2_tpu import ops as jops
from pointnet2_tpu.ops.pallas import (
    ball_query_pallas,
    fps_centroids_pallas,
    knn_pallas,
    three_interpolate_pallas,
    three_nn_pallas,
)
from pointnet2_tpu.ops.pallas.interpolate import _ti_bwd
from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.ops import core

GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _cloud(rng, b, n, scale=2.0):
    return (rng.rand(b, n, 3) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# FPS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,n,m", [(2, 128, 16), (1, 200, 32), (3, 64, 64), (2, 300, 100), (1, 1, 1)])
def test_fps_centroids_match_oracle(rng, b, n, m):
    xyz = _cloud(rng, b, n)
    idx, cent = ops.fps_centroids(_t(xyz), m)
    want = reference.farthest_point_sample_np(xyz, m)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(cent.numpy(), reference.gather_points_np(xyz, want))


def test_fps_ties_go_to_the_lowest_index():
    """A cloud of repeated points: the running minima tie, argmax takes the first."""
    base = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    xyz = np.tile(base, (5, 1))[None]  # (1, 20, 3), every point four times
    idx, _ = ops.fps_centroids(_t(xyz), 8)
    np.testing.assert_array_equal(idx.numpy(), reference.farthest_point_sample_np(xyz, 8))


def test_fps_centroids_match_pallas_interpret(rng):
    xyz = _cloud(rng, 2, 256)
    with pltpu.force_tpu_interpret_mode():
        want_idx, want_xyz = fps_centroids_pallas(xyz, 64)
    idx, cent = ops.fps_centroids(_t(xyz), 64)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(cent.numpy(), np.asarray(want_xyz))


# ---------------------------------------------------------------------------
# Ball query
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "b,n,m,radius,nsample",
    [
        (2, 128, 128, 0.3, 8),
        (1, 300, 100, 0.5, 4),  # queries not a multiple of 128
        (2, 64, 37, 0.8, 16),
        (1, 16, 20, 1.5, 32),  # fewer points than slots
        (2, 256, 64, 0.5, 32),
    ],
)
def test_ball_query_matches_oracle(rng, b, n, m, radius, nsample):
    xyz1 = _cloud(rng, b, n, scale=1.0)
    xyz2 = _cloud(rng, b, m, scale=1.0)
    idx, cnt = ops.ball_query(_t(xyz1), _t(xyz2), radius, nsample)
    want_idx, want_cnt = reference.ball_query_np(xyz1, xyz2, radius, nsample)
    assert idx.dtype == torch.int32 and cnt.dtype == torch.int32
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)
    np.testing.assert_array_equal(idx.numpy(), want_idx)


def test_ball_query_empty_ball_pads_with_zero(rng):
    xyz1 = _cloud(rng, 1, 50)
    xyz2 = np.array([[[100.0, 100.0, 100.0], [0.5, 0.5, 0.5]]], np.float32)
    idx, cnt = ops.ball_query(_t(xyz1), _t(xyz2), 0.2, 8)
    want_idx, want_cnt = reference.ball_query_np(xyz1, xyz2, 0.2, 8)
    assert cnt[0, 0] == 0 and (idx[0, 0] == 0).all()
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)


def _boundary_cloud(rng, radius):
    """Dataset points exactly on, and 1-2 ulp inside and outside, each query's sphere."""
    q = (rng.randint(0, 256, size=(24, 3)) / 128.0).astype(np.float32)
    pts = []
    for i, c in enumerate(q):
        axis = i % 3
        on = c.copy()
        on[axis] = np.float32(c[axis] + np.float32(radius))  # exact: dyadic coordinates
        pts.append(on)
        for direction in (-np.inf, np.inf):
            p = on.copy()
            for _ in range(2):
                p = p.copy()
                p[axis] = np.nextafter(p[axis], np.float32(direction))
                pts.append(p)
        u = rng.randn(3)
        u /= np.linalg.norm(u)
        off = (c + radius * u).astype(np.float32)
        for k in range(-3, 4):
            p = off.copy()
            for _ in range(abs(k)):
                p[0] = np.nextafter(p[0], np.float32(np.sign(k) * np.inf))
            pts.append(p)
    data = np.stack(pts).astype(np.float32)
    data = data[rng.permutation(len(data))]
    return data[None], q[None]


@pytest.mark.parametrize("radius", [0.5, 1.0, 0.3])
def test_ball_query_boundary_ulps_match_oracle(rng, radius):
    xyz1, xyz2 = _boundary_cloud(rng, radius)
    r2 = np.float32(radius) ** 2
    d2 = np.sum((xyz2[0][:, None, :] - xyz1[0][None, :, :]) ** 2, axis=-1, dtype=np.float32)
    # The data really straddles the boundary at ulp scale.
    assert (d2 == r2).any()
    assert ((d2 < r2) & (d2 >= r2 * np.float32(1 - 1e-6))).any()
    assert ((d2 > r2) & (d2 <= r2 * np.float32(1 + 1e-6))).any()
    idx, cnt = ops.ball_query(_t(xyz1), _t(xyz2), radius, 64)
    want_idx, want_cnt = reference.ball_query_np(xyz1, xyz2, radius, 64)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)
    np.testing.assert_array_equal(idx.numpy(), want_idx)


def test_ball_query_matches_pallas_interpret(rng):
    xyz1 = _cloud(rng, 2, 256, scale=1.0)
    xyz2 = _cloud(rng, 2, 64, scale=1.0)
    with pltpu.force_tpu_interpret_mode():
        want_idx, want_cnt = ball_query_pallas(xyz1, xyz2, 0.3, 16)
    idx, cnt = ops.ball_query(_t(xyz1), _t(xyz2), 0.3, 16)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))


def test_ball_query_matches_xla(rng):
    xyz1 = _cloud(rng, 2, 200, scale=1.0)
    xyz2 = _cloud(rng, 2, 50, scale=1.0)
    want_idx, want_cnt = jcore.ball_query_xla(xyz1, xyz2, 0.4, 8)
    idx, cnt = ops.ball_query(_t(xyz1), _t(xyz2), 0.4, 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))


def test_group_points_matches_oracle(rng):
    pts = rng.randn(2, 40, 5).astype(np.float32)
    idx = rng.randint(0, 40, size=(2, 7, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        ops.group_points(_t(pts), _t(idx)).numpy(), reference.group_points_np(pts, idx)
    )
    np.testing.assert_array_equal(
        ops.gather_points(_t(pts), _t(idx[:, :, 0])).numpy(),
        reference.gather_points_np(pts, idx[:, :, 0]),
    )


# ---------------------------------------------------------------------------
# kNN / 3-NN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,m,nq,k", [(2, 64, 100, 3), (1, 16, 64, 1), (2, 130, 37, 5), (1, 20, 20, 16)])
def test_knn_matches_oracle(rng, b, m, nq, k):
    refs = _cloud(rng, b, m)
    queries = _cloud(rng, b, nq)
    dist, idx = ops.knn(_t(refs), _t(queries), k)
    want_dist, want_idx = reference.knn_np(refs, queries, k)
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(dist.numpy(), want_dist)


def test_knn_ties_go_to_the_lowest_index():
    """Reference points on a unit grid, repeated: many exactly equal distances."""
    g = np.stack(np.meshgrid(np.arange(3), np.arange(3), np.arange(2)), -1).reshape(-1, 3)
    refs = np.concatenate([g, g[::-1]]).astype(np.float32)[None]
    queries = (np.array([[0.5, 0.5, 0.5], [1, 1, 0], [2, 0, 1], [1.5, 1, 0.5]], np.float32))[None]
    dist, idx = ops.knn(_t(refs), _t(queries), 6)
    want_dist, want_idx = reference.knn_np(refs, queries, 6)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(dist.numpy(), want_dist)


def test_three_nn_matches_oracle_and_pallas_interpret(rng):
    dense = _cloud(rng, 2, 256)
    coarse = _cloud(rng, 2, 64)
    dist, idx = ops.three_nn(_t(dense), _t(coarse))
    want_dist, want_idx = reference.three_nn_np(dense, coarse)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(dist.numpy(), want_dist)
    with pltpu.force_tpu_interpret_mode():
        p_dist, p_idx = three_nn_pallas(dense, coarse)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(p_idx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(p_dist), rtol=1e-5, atol=1e-6)


def test_knn_matches_pallas_interpret(rng):
    refs = _cloud(rng, 2, 64)
    queries = _cloud(rng, 2, 200)
    with pltpu.force_tpu_interpret_mode():
        want_dist, want_idx = knn_pallas(refs, queries, 4)
    dist, idx = ops.knn(_t(refs), _t(queries), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(want_dist), rtol=1e-5, atol=1e-6)


def test_knn_rejects_k_above_the_dataset():
    with pytest.raises(ValueError):
        ops.knn(torch.zeros(1, 2, 3), torch.zeros(1, 4, 3), 3)


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------


def _interp_inputs(rng, b, m, n, c):
    points = rng.randn(b, m, c).astype(np.float32)
    dense = _cloud(rng, b, n)
    coarse = _cloud(rng, b, m)
    dist, idx = reference.three_nn_np(dense, coarse)
    weight = reference.interpolation_weights_np(dist).astype(np.float32)
    return points, idx, weight


@pytest.mark.parametrize("b,m,n,c", [(2, 64, 256, 32), (1, 16, 64, 130), (2, 100, 37, 7)])
def test_three_interpolate_matches_pallas_and_xla(rng, b, m, n, c):
    points, idx, weight = _interp_inputs(rng, b, m, n, c)
    got = ops.three_interpolate(_t(points), _t(idx), _t(weight)).numpy()
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(three_interpolate_pallas(points, idx, weight))
    xla = np.asarray(jcore.three_interpolate(jnp.asarray(points), idx, weight))
    assert got.shape == (b, n, c) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, xla, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        got, reference.three_interpolate_np(points, idx, weight), rtol=1e-6, atol=1e-6
    )


def test_interpolation_weights_match_xla_with_duplicate_points(rng):
    dense = _cloud(rng, 2, 64)
    coarse = np.concatenate([dense[:, :8], _cloud(rng, 2, 24)], axis=1)  # 8 exact duplicates
    dist, _ = reference.three_nn_np(dense, coarse)
    assert (dist == 0).any()
    got = ops.interpolation_weights(_t(dist)).numpy()
    np.testing.assert_allclose(got, np.asarray(jcore.interpolation_weights(dist)), rtol=1e-6)
    np.testing.assert_allclose(got, reference.interpolation_weights_np(dist), rtol=1e-6)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# Gradients: three_interpolate, project_group_leaf, fps_centroids
# ---------------------------------------------------------------------------


# Padding on every axis of the Pallas kernel: N, M and C off the multiples of 128.
GRAD_SHAPES = [(2, 37, 200, 70), (1, 130, 300, 7), (2, 16, 64, 129)]


@pytest.mark.parametrize("b,m,n,c", GRAD_SHAPES)
def test_three_interpolate_grad_matches_pallas_bwd_and_xla_vjp(rng, b, m, n, c):
    points, idx, weight = _interp_inputs(rng, b, m, n, c)
    g = rng.randn(b, n, c).astype(np.float32)
    got = core.three_interpolate_grad(_t(g), _t(idx), _t(weight), m).numpy()
    assert got.shape == (b, m, c) and got.dtype == np.float32
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(_ti_bwd(jnp.asarray(g), jnp.asarray(idx), jnp.asarray(weight), m, "highest", 128))
    _, vjp = jax.vjp(lambda p: jcore.three_interpolate(p, idx, weight), jnp.asarray(points))
    np.testing.assert_allclose(got, pallas, **GRAD_TOL)
    np.testing.assert_allclose(got, np.asarray(vjp(jnp.asarray(g))[0]), **GRAD_TOL)
    assert torch.equal(ops.three_interpolate_grad(_t(g), _t(idx), _t(weight), m), torch.from_numpy(got))


def test_three_interpolate_grad_with_duplicate_indices_and_zero_weights():
    """One query naming a row twice adds both weights; a zero weight adds nothing; unnamed rows stay 0."""
    g = torch.tensor([[[1.0, 2.0], [3.0, 4.0]]])
    idx = torch.tensor([[[1, 1, 2], [2, 0, 0]]], dtype=torch.int32)
    weight = torch.tensor([[[0.25, 0.5, 0.25], [1.0, 0.0, 0.0]]])
    got = core.three_interpolate_grad(g, idx, weight, 4)
    want = torch.tensor([[[0.0, 0.0], [0.75, 1.5], [3.25, 4.5], [0.0, 0.0]]])
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,m,n,c", GRAD_SHAPES[:2])
def test_three_interpolate_function_gradients_match_pallas_grad(rng, b, m, n, c):
    points, idx, weight = _interp_inputs(rng, b, m, n, c)
    cot = rng.randn(b, n, c).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want_p, want_w = jax.grad(
            lambda p, w: jnp.sum(three_interpolate_pallas(p, idx, w) * cot), argnums=(0, 1)
        )(jnp.asarray(points), jnp.asarray(weight))
    p, w = _t(points).requires_grad_(), _t(weight).requires_grad_()
    out = ops.three_interpolate(p, _t(idx), w)
    # The cotangent arrives as a slice of a wider tensor, as it does behind the skip concat.
    wide = torch.cat([_t(cot), torch.zeros(b, n, 5)], dim=-1)[..., :c]
    assert not wide.is_contiguous()
    got_p, got_w = torch.autograd.grad(out, (p, w), wide)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **GRAD_TOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-5, atol=1e-4)
    # Without a weight that asks for it, no weight cotangent is made.
    (only_p,) = torch.autograd.grad(ops.three_interpolate(p, _t(idx), _t(weight)), (p,), _t(cot))
    np.testing.assert_allclose(only_p.numpy(), got_p.numpy(), rtol=0, atol=0)


def test_three_interpolate_gradcheck_float64(rng):
    points, idx, weight = _interp_inputs(rng, 2, 9, 14, 3)
    p = _t(points).double().requires_grad_()
    w = _t(weight).double().requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: ops.three_interpolate(a, _t(idx), b), (p, w), eps=1e-6, atol=1e-6)
    assert torch.autograd.gradcheck(lambda a, b: core.three_interpolate(a, _t(idx), b), (p, w), eps=1e-6, atol=1e-6)


def _leaf_inputs(rng, b=2, n=100, m=20, k=8, cin=6, f0=16):
    inputs = rng.randn(b, n, cin).astype(np.float32)
    w = (rng.randn(cin, f0) * 0.3).astype(np.float32)
    bias = (rng.randn(f0) * 0.1).astype(np.float32)
    idx = rng.randint(0, n, (b, m, k)).astype(np.int32)
    cot = rng.randn(b, m, k, f0).astype(np.float32)
    return inputs, w, bias, idx, cot


def test_project_group_leaf_forward_and_gradients_match_jax(rng):
    inputs, w, bias, idx, cot = _leaf_inputs(rng)
    with jax.default_matmul_precision("highest"):
        want = jcore.project_group_leaf(inputs, w, bias, idx)
        want_w, want_b = jax.grad(
            lambda w_, b_: jnp.sum(jcore.project_group_leaf(jnp.asarray(inputs), w_, b_, idx) * cot),
            argnums=(0, 1),
        )(jnp.asarray(w), jnp.asarray(bias))
    x, wt, bt = _t(inputs).requires_grad_(), _t(w).requires_grad_(), _t(bias).requires_grad_()
    out = ops.project_group_leaf(x, wt, bt, _t(idx))
    assert torch.equal(out, core.group_points(x @ wt + bt, _t(idx)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **GRAD_TOL)
    gx, gw, gb = torch.autograd.grad(out, (x, wt, bt), _t(cot))
    assert gx.shape == x.shape and not gx.any()  # exactly zero, by construction
    np.testing.assert_allclose(gw.numpy(), np.asarray(want_w), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(want_b), rtol=1e-5, atol=1e-4)
    # The same parameter gradients as autograd through project-then-group.
    ref_w, ref_b = torch.autograd.grad(core.group_points(x @ wt + bt, _t(idx)), (wt, bt), _t(cot))
    np.testing.assert_allclose(gw.numpy(), ref_w.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gb.numpy(), ref_b.numpy(), rtol=1e-5, atol=1e-4)


def test_fps_centroids_input_gradient_matches_jax(rng):
    xyz = _cloud(rng, 2, 80)
    cot = rng.randn(2, 16, 3).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(jops.fps_centroids(x, 16, impl="xla")[1] * cot))(jnp.asarray(xyz))
    x = _t(xyz).requires_grad_()
    idx, cent = ops.fps_centroids(x, 16)
    assert not idx.requires_grad and cent.requires_grad
    (got,) = torch.autograd.grad(cent, (x,), _t(cot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=0)
    # A cloud that asks for no gradient takes the plain call: nothing is recorded.
    assert not ops.fps_centroids(_t(xyz), 16)[1].requires_grad


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def test_impl_torch_and_default_agree_on_cpu(rng):
    xyz = _t(_cloud(rng, 1, 64))
    a = ops.fps_centroids(xyz, 8)
    b = ops.fps_centroids(xyz, 8, impl="torch")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_unknown_impl_raises(rng):
    xyz = _t(_cloud(rng, 1, 64))
    with pytest.raises(ValueError, match="impl"):
        ops.ball_query(xyz, xyz, 0.5, 4, impl="pallas")


def test_core_squared_radius_is_the_f32_square():
    for r in (0.1, 0.3, 0.5, 1.0, 2.0, 4.0, 0.7):
        assert np.float32(core.squared_radius(r)) == np.float32(r) ** 2
