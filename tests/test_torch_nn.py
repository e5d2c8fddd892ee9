"""The port's nn modules in eval mode against the flax modules (ops_impl="xla").

Each flax module is initialised, every leaf of its variable tree is replaced
by seeded random values (moving statistics included, so BatchNorm does real
work), and the same tree goes to the port module through
``convert.state_dict_from_flax``. Geometry outputs (centroids, group
indices) must be equal; features agree within atol=1e-5, rtol=1e-5, the room
that two float32 matmuls summing in different orders need.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pointnet2_tpu.nn.layers import BatchNorm as JaxBatchNorm
from pointnet2_tpu.nn.layers import SharedMLP as JaxSharedMLP
from pointnet2_tpu.nn.pointnet import FeaturePropagation as JaxFP
from pointnet2_tpu.nn.pointnet import SetAbstraction as JaxSA
from pointnet2_tpu_torch.convert import state_dict_from_flax
from pointnet2_tpu_torch.nn.layers import BatchNorm, SharedMLP
from pointnet2_tpu_torch.nn.pointnet import FeaturePropagation, SetAbstraction

TOL = dict(atol=1e-5, rtol=1e-5)


def _randomize(variables, seed):
    """Same tree, seeded values: weights N(0, 0.3), biases/means N(0, 0.1),
    scales U(0.5, 1.5), variances U(0.5, 2)."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, leaf in flatten_dict(jax.tree_util.tree_map(np.asarray, variables)).items():
        name = path[-1]
        if name in ("kernel", "w0"):
            value = rng.normal(0, 0.3, leaf.shape)
        elif name == "scale":
            value = rng.uniform(0.5, 1.5, leaf.shape)
        elif name == "var":
            value = rng.uniform(0.5, 2.0, leaf.shape)
        else:
            value = rng.normal(0, 0.1, leaf.shape)
        out[path] = value.astype(np.float32)
    return unflatten_dict(out)


def _apply(module, variables, *args):
    with jax.default_matmul_precision("highest"):
        return module.apply(variables, *args, train=False, bn_momentum=0.9)


def _port(module, variables):
    module.load_state_dict(state_dict_from_flax(variables, module))
    return module.eval()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.mark.parametrize("shape", [(4, 16), (2, 3, 5, 32)])
def test_batchnorm_eval_matches_flax(shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32) * 3
    ref = JaxBatchNorm()
    variables = _randomize(ref.init(jax.random.PRNGKey(0), x, train=False, momentum=0.9), 1)
    with jax.default_matmul_precision("highest"):
        want = ref.apply(variables, x, train=False, momentum=0.9)
    got = _port(BatchNorm(shape[-1]), variables)(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_batchnorm_refuses_train_mode():
    with pytest.raises(NotImplementedError):
        BatchNorm(4)(torch.zeros(2, 4))


@pytest.mark.parametrize("features", [[32], [64, 64, 128]])
def test_shared_mlp_matches_flax(features):
    x = np.random.RandomState(2).randn(2, 10, 4, 19).astype(np.float32)
    ref = JaxSharedMLP(features)
    variables = _randomize(ref.init(jax.random.PRNGKey(0), x, train=False, bn_momentum=0.9), 3)
    want = _apply(ref, variables, x)
    got = _port(SharedMLP(19, features), variables)(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _box(rng, b, n, extent=(2.0, 2.0, 1.5)):
    return (rng.rand(b, n, 3) * extent).astype(np.float32)


@pytest.mark.parametrize("use_color", [True, False])
def test_sa1_leaf_level_matches_flax(use_color):
    """SA1: the raw cloud as a gradient leaf (flax takes project_group_leaf)."""
    rng = np.random.RandomState(4)
    xyz = _box(rng, 2, 256)
    color = rng.rand(2, 256, 3).astype(np.float32) if use_color else None
    ref = JaxSA(npoint=64, radius=0.5, nsample=8, mlp=[32, 32, 64], leaf_inputs=True, ops_impl="xla")
    variables = _randomize(ref.init(jax.random.PRNGKey(0), xyz, color, train=False, bn_momentum=0.9), 5)
    want_xyz, want_pts, want_idx = _apply(ref, variables, xyz, color)
    port = _port(SetAbstraction(64, 0.5, 8, [32, 32, 64], 3 if use_color else 0), variables)
    with torch.no_grad():
        got_xyz, got_pts, got_idx = port(_t(xyz), None if color is None else _t(color))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert got_pts.shape == (2, 64, 64)
    np.testing.assert_allclose(got_pts.numpy(), np.asarray(want_pts), **TOL)


def test_sa2_level_matches_flax():
    """SA2: features from the level below, the plain project-then-gather branch."""
    rng = np.random.RandomState(6)
    xyz = _box(rng, 2, 128, (4.0, 4.0, 3.0))
    feats = np.abs(rng.randn(2, 128, 64)).astype(np.float32)
    ref = JaxSA(npoint=32, radius=1.0, nsample=16, mlp=[64, 64, 128], ops_impl="xla")
    variables = _randomize(ref.init(jax.random.PRNGKey(0), xyz, feats, train=False, bn_momentum=0.9), 7)
    want_xyz, want_pts, want_idx = _apply(ref, variables, xyz, feats)
    port = _port(SetAbstraction(32, 1.0, 16, [64, 64, 128], 64), variables)
    with torch.no_grad():
        got_xyz, got_pts, got_idx = port(_t(xyz), _t(feats))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got_pts.numpy(), np.asarray(want_pts), **TOL)


@pytest.mark.parametrize("skip", [True, False])
def test_feature_propagation_matches_flax(skip):
    rng = np.random.RandomState(8)
    xyz1 = _box(rng, 2, 128)
    xyz2 = _box(rng, 2, 32)
    points1 = rng.randn(2, 128, 24).astype(np.float32) if skip else None
    points2 = rng.randn(2, 32, 40).astype(np.float32)
    ref = JaxFP(mlp=[64, 48], ops_impl="xla")
    variables = _randomize(
        ref.init(jax.random.PRNGKey(0), xyz1, xyz2, points1, points2, train=False, bn_momentum=0.9), 9
    )
    want = _apply(ref, variables, xyz1, xyz2, points1, points2)
    port = _port(FeaturePropagation(40 + (24 if skip else 0), [64, 48]), variables)
    with torch.no_grad():
        got = port(_t(xyz1), _t(xyz2), None if points1 is None else _t(points1), _t(points2))
    assert got.shape == (2, 128, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
