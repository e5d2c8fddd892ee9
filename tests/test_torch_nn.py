"""The port's nn modules, eval and train mode, against the flax modules (ops_impl="xla").

Each flax module is initialised, every leaf of its variable tree is replaced
by seeded random values (moving statistics included, so BatchNorm does real
work), and the same tree goes to the port module through
``convert.state_dict_from_flax``. Geometry outputs (centroids, group
indices) must be equal; features agree within atol=1e-5, rtol=1e-5, the room
that two float32 matmuls summing in different orders need.

Train mode: outputs within atol=5e-5, rtol=1e-5 (XLA's CPU BatchNorm with
batch statistics is itself about 1e-5 relative off a float64 run), updated
moving statistics within atol=1e-5, rtol=1e-5. BatchNorm's own gradients
within rtol=1e-4 of each one's max abs. Parameter gradients of the modules
with ReLUs (SetAbstraction, FeaturePropagation): relative L2 error <= 2e-2
for each parameter; an activation within the forward's noise of zero takes
the other side of the ReLU on the two sides and moves its channel's
gradient by far more than rounding would.
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
from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.convert import _flax_key, state_dict_from_flax
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
    """Train mode without the step's momentum: there is no default to fall back on."""
    with pytest.raises(ValueError, match="momentum"):
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


def test_feature_propagation_with_a_strided_skip_matches_flax():
    """The fused interpolation and concat with FP4's skip, the colour channels
    of the input cloud (a view of row stride 6), forward and the gradients of
    both feature inputs, against flax."""
    rng = np.random.RandomState(10)
    cloud = np.concatenate([_box(rng, 2, 128), rng.rand(2, 128, 3).astype(np.float32)], -1)
    xyz1, points1 = np.ascontiguousarray(cloud[..., :3]), np.ascontiguousarray(cloud[..., 3:])
    xyz2 = _box(rng, 2, 32)
    points2 = rng.randn(2, 32, 16).astype(np.float32)
    cot = rng.randn(2, 128, 24).astype(np.float32)
    ref = JaxFP(mlp=[32, 24], ops_impl="xla")
    variables = _randomize(
        ref.init(jax.random.PRNGKey(0), xyz1, xyz2, points1, points2, train=False, bn_momentum=0.9), 11
    )
    with jax.default_matmul_precision("highest"):
        want, (want_p1, want_p2) = jax.value_and_grad(
            lambda a, b: jnp.sum(ref.apply(variables, xyz1, xyz2, a, b, train=False, bn_momentum=0.9) * cot),
            argnums=(0, 1),
        )(jnp.asarray(points1), jnp.asarray(points2))
    port = _port(FeaturePropagation(16 + 3, [32, 24]), variables)
    full = _t(cloud).requires_grad_()
    p2 = _t(points2).requires_grad_()
    skip = full[..., 3:]
    assert not skip.is_contiguous()
    out = port(_t(xyz1), _t(xyz2), skip, p2)
    got = (out * _t(cot)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(full.grad[..., 3:].numpy(), np.asarray(want_p1), **TOL)
    assert not full.grad[..., :3].any()
    np.testing.assert_allclose(p2.grad.numpy(), np.asarray(want_p2), **TOL)


# ---------------------------------------------------------------------------
# Train mode
# ---------------------------------------------------------------------------

TRAIN_TOL = dict(atol=5e-5, rtol=1e-5)
STAT_TOL = dict(atol=1e-5, rtol=1e-5)


def _train_reference(ref, variables, args, cot, momentum):
    """flax outputs, updated batch_stats and parameter gradients for sum(out * cot)."""
    def f(params):
        out, mut = ref.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, *args,
            train=True, bn_momentum=momentum, mutable=["batch_stats"],
        )
        feats = out[1] if isinstance(out, tuple) else out
        return jnp.sum(feats * cot), (feats, mut["batch_stats"])

    with jax.default_matmul_precision("highest"):
        (_, (feats, stats)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, variables["params"])
        )
    return np.asarray(feats), flatten_dict(jax.tree_util.tree_map(np.asarray, stats)), flatten_dict(
        jax.tree_util.tree_map(np.asarray, grads)
    )


def _check_train(port, variables, feats, cot, want_feats, want_stats, want_grads, grad_rel_l2):
    np.testing.assert_allclose(feats.detach().numpy(), want_feats, **TRAIN_TOL)
    feats.backward(_t(cot))
    seen = set()
    noise = 1e-4 * max(np.abs(g).max() for g in want_grads.values())
    for key, tensor in port.state_dict().items():
        path, transposed = _flax_key(key)
        seen.add(path[1:])
        if path[0] == "batch_stats":
            np.testing.assert_allclose(tensor.numpy(), want_stats[path[1:]], err_msg=key, **STAT_TOL)
            continue
        grad = dict(port.named_parameters())[key].grad.numpy()
        ref = want_grads[path[1:]].T if transposed else want_grads[path[1:]]
        if np.abs(ref).max() < noise:  # a bias in front of a BatchNorm: zero but for rounding
            assert np.abs(grad).max() < noise, key
            continue
        err = np.linalg.norm(grad - ref) / np.linalg.norm(ref)
        assert err <= grad_rel_l2, (key, err)
    assert seen == set(want_stats) | set(want_grads)


@pytest.mark.parametrize("momentum", [0.5, "tensor:0.9"])
@pytest.mark.parametrize("shape", [(64, 16), (2, 8, 5, 32)])
def test_batchnorm_train_matches_flax(shape, momentum):
    """Output, both updated buffers, input and parameter gradients; the momentum as a float and as a 0-d tensor."""
    rng = np.random.RandomState(10)
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    cot = rng.randn(*shape).astype(np.float32)
    m = 0.9 if isinstance(momentum, str) else momentum
    ref = JaxBatchNorm()
    variables = _randomize(ref.init(jax.random.PRNGKey(0), x, train=False, momentum=0.9), 11)

    def f(params, x_):
        y, mut = ref.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x_,
            train=True, momentum=m, mutable=["batch_stats"],
        )
        return jnp.sum(y * cot), (y, mut["batch_stats"])

    (_, (want, stats)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]), jnp.asarray(x)
    )
    port = BatchNorm(shape[-1])
    port.load_state_dict(state_dict_from_flax(variables, port))
    xt = _t(x).requires_grad_()
    y = port(xt, torch.tensor(0.9) if isinstance(momentum, str) else momentum)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(port.mean.numpy(), np.asarray(stats["mean"]), **STAT_TOL)
    np.testing.assert_allclose(port.var.numpy(), np.asarray(stats["var"]), **STAT_TOL)
    y.backward(_t(cot))
    for got, ref_grad in ((xt.grad, gx), (port.scale.grad, gp["scale"]), (port.bias.grad, gp["bias"])):
        ref_grad = np.asarray(ref_grad)
        np.testing.assert_allclose(got.numpy(), ref_grad, atol=1e-4 * np.abs(ref_grad).max(), rtol=0)
    assert not port.mean.requires_grad and port.mean.grad_fn is None


def test_batchnorm_eval_leaves_the_buffers_alone():
    port = BatchNorm(4).eval()
    before = port.mean.clone(), port.var.clone()
    port(torch.randn(8, 4), 0.5)
    assert torch.equal(port.mean, before[0]) and torch.equal(port.var, before[1])


@pytest.mark.parametrize("leaf", [True, False])
def test_set_abstraction_train_matches_flax(leaf):
    """Leaf inputs gather the raw channels and project after; otherwise project, gather, subtract."""
    rng = np.random.RandomState(12)
    xyz = _box(rng, 2, 128)
    color = rng.rand(2, 128, 3).astype(np.float32)
    cot = rng.randn(2, 32, 32).astype(np.float32)
    ref = JaxSA(npoint=32, radius=0.6, nsample=8, mlp=[16, 16, 32], leaf_inputs=leaf, ops_impl="xla")
    variables = _randomize(ref.init(jax.random.PRNGKey(0), xyz, color, train=False, bn_momentum=0.9), 13)
    want = _train_reference(ref, variables, (xyz, color), cot, 0.7)
    port = SetAbstraction(32, 0.6, 8, [16, 16, 32], 3, leaf_inputs=leaf)
    port.load_state_dict(state_dict_from_flax(variables, port))
    _, feats, _ = port.train()(_t(xyz), _t(color), 0.7)
    _check_train(port, variables, feats, cot, *want, grad_rel_l2=2e-2)


def test_set_abstraction_takes_precomputed_geometry():
    rng = np.random.RandomState(14)
    xyz, color = _t(_box(rng, 2, 64)), _t(rng.rand(2, 64, 3).astype(np.float32))
    port = SetAbstraction(16, 0.8, 4, [8, 8], 3).eval()
    torch.nn.init.normal_(port.w0, std=0.3)
    with torch.no_grad():
        new_xyz, want, idx = port(xyz, color)
        got_xyz, got, got_idx = port(xyz, color, geometry={"new_xyz": new_xyz, "idx": idx})
        assert torch.equal(got, want) and got_xyz is new_xyz and got_idx is idx
        other = port(xyz, color, geometry={"new_xyz": new_xyz, "idx": idx.flip(1)})[1]
    assert not torch.equal(other, want)


def test_feature_propagation_train_matches_flax():
    rng = np.random.RandomState(15)
    xyz1, xyz2 = _box(rng, 2, 64), _box(rng, 2, 16)
    points1 = rng.randn(2, 64, 12).astype(np.float32)
    points2 = rng.randn(2, 16, 20).astype(np.float32)
    cot = rng.randn(2, 64, 24).astype(np.float32)
    ref = JaxFP(mlp=[32, 24], ops_impl="xla")
    variables = _randomize(
        ref.init(jax.random.PRNGKey(0), xyz1, xyz2, points1, points2, train=False, bn_momentum=0.9), 16
    )
    want = _train_reference(ref, variables, (xyz1, xyz2, points1, points2), cot, 0.6)
    port = FeaturePropagation(32, [32, 24])
    port.load_state_dict(state_dict_from_flax(variables, port))
    p2 = _t(points2).requires_grad_()
    feats = port.train()(_t(xyz1), _t(xyz2), _t(points1), p2, 0.6)
    _check_train(port, variables, feats, cot, *want, grad_rel_l2=2e-2)
    # The coarse features' gradient came through three_interpolate's own backward.
    with jax.default_matmul_precision("highest"):
        want_p2 = jax.jit(jax.grad(lambda p: jnp.sum(ref.apply(
            variables, xyz1, xyz2, points1, p, train=True, bn_momentum=0.6, mutable=["batch_stats"]
        )[0] * cot)))(jnp.asarray(points2))
    err = np.linalg.norm(p2.grad.numpy() - np.asarray(want_p2)) / np.linalg.norm(np.asarray(want_p2))
    assert err <= 2e-2, err


def test_feature_propagation_takes_precomputed_geometry_and_stops_the_distance_gradient():
    rng = np.random.RandomState(17)
    xyz1, xyz2 = _t(_box(rng, 1, 32)).requires_grad_(), _t(_box(rng, 1, 8)).requires_grad_()
    points2 = _t(rng.randn(1, 8, 6).astype(np.float32)).requires_grad_()
    port = FeaturePropagation(6, [8]).train()
    out = port(xyz1, xyz2, None, points2, 0.5)
    out.sum().backward()
    assert xyz1.grad is None and xyz2.grad is None and points2.grad is not None
    dist2, idx = ops.three_nn(xyz1.detach(), xyz2.detach())
    again = port(xyz1, xyz2, None, points2, 0.5, geometry={"dist2": dist2, "idx": idx})
    torch.testing.assert_close(again, out, atol=1e-6, rtol=1e-6)
