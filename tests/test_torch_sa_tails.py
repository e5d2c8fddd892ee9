"""The SA options of the port against the JAX package: the plain layout,
kNN grouping, the pooling modes, group_all, mlp2, use_xyz and use_bn, in
``SetAbstraction``, ``SetAbstractionMSG``, ``FeaturePropagation`` and
``PointNet2SemSeg(pre_project=False)``, with the weights carried across by
``convert``.

Each flax module is initialised, every leaf of its tree replaced by seeded
values (moving statistics included, so BatchNorm does real work) and handed
to the port through ``convert.state_dict_from_flax``; the inputs come from a
numpy seed. The JAX side runs ``ops_impl="xla"`` under
``jax.default_matmul_precision("highest")``. Tolerances: outputs within
rtol 2e-4, atol 2e-5 (as in ``tests/test_preproject.py``), eval and train;
parameter gradients of ``sum(out * cotangent)`` within 1e-3 of each one's max
abs; moving statistics after a train step within the same rtol and atol;
centroids and group indices bit for bit, also against the numpy oracles of
``ops/reference.py``; the model's logits within 1e-4.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pointnet2_tpu import convert as jax_convert
from pointnet2_tpu.config import Config as JaxConfig
from pointnet2_tpu.models.pointnet2_seg import PointNet2SemSeg as JaxSemSeg
from pointnet2_tpu.models.pointnet2_seg import weighted_ce_loss as jax_weighted_ce_loss
from pointnet2_tpu.nn.pointnet import FeaturePropagation as JaxFP
from pointnet2_tpu.nn.pointnet import SetAbstraction as JaxSA
from pointnet2_tpu.nn.pointnet import SetAbstractionMSG as JaxMSG
from pointnet2_tpu_torch import convert
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.convert import _flax_key, state_dict_from_flax
from pointnet2_tpu_torch.infer import Predictor
from pointnet2_tpu_torch.models.pointnet2_seg import PointNet2SemSeg, PointNet2SemSegMSG, weighted_ce_loss
from pointnet2_tpu_torch.nn.layers import SharedMLP
from pointnet2_tpu_torch.nn.pointnet import FeaturePropagation, SetAbstraction, SetAbstractionMSG, pool
from pointnet2_tpu_torch.ops.calibrate import calibrate_model_windows, required_bq_window
from pointnet2_tpu_torch.ops.reference import ball_query_np, farthest_point_sample_np, gather_points_np, knn_np
from pointnet2_tpu_torch.train import Trainer

TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = 1e-3  # of each gradient's max abs
MOMENTUM = 0.9
B, N, C, NPOINT, RADIUS, NSAMPLE = 2, 128, 5, 32, 0.4, 8
MLP = [16, 16, 32]

SMALL = dict(
    num_point=512,
    l1_npoint=128, l2_npoint=32, l3_npoint=16, l4_npoint=8,
    l1_nsample=8, l2_nsample=8, l3_nsample=8, l4_nsample=8,
)


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


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _inputs(seed, features=C, n=N):
    rng = np.random.RandomState(seed)
    xyz = rng.rand(B, n, 3).astype(np.float32)
    feats = rng.randn(B, n, features).astype(np.float32) if features else None
    return xyz, feats


def _pair(jax_module, port_module, xyz, feats, seed):
    variables = _randomize(
        jax_module.init(jax.random.PRNGKey(0), xyz, feats, train=False, bn_momentum=MOMENTUM), seed
    )
    port_module.load_state_dict(state_dict_from_flax(variables, port_module))
    return variables


def _jax_eval(module, variables, *args):
    with jax.default_matmul_precision("highest"):
        return jax.tree_util.tree_map(
            np.asarray, module.apply(variables, *args, train=False, bn_momentum=MOMENTUM)
        )


def _jax_train(module, variables, args, cotangent, pick=1):
    """Train-mode output ``pick``, the gradients of sum(out * cotangent) by
    flax path, and the updated moving statistics."""
    def loss(params):
        out, updates = module.apply(
            {"params": params, "batch_stats": variables.get("batch_stats", {})}, *args, train=True,
            bn_momentum=MOMENTUM, mutable=["batch_stats"],
        )
        return jnp.sum(out[pick] * cotangent), (out[pick], updates)

    with jax.default_matmul_precision("highest"):
        (_, (out, updates)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    grads = {("params", *k): np.asarray(v) for k, v in flatten_dict(grads).items()}
    stats = {("batch_stats", *k): np.asarray(v) for k, v in flatten_dict(updates.get("batch_stats", {})).items()}
    return np.asarray(out), grads, stats


def _port_train(module, args, cotangent, pick=1):
    module.train()
    out = module(*args, MOMENTUM)[pick]
    (out * _t(cotangent)).sum().backward()
    grads = {}
    for name, p in module.named_parameters():
        path, transposed = _flax_key(name)
        grads[path] = p.grad.numpy().T if transposed else p.grad.numpy()
    stats = {}
    for name, buf in module.named_buffers():
        stats[_flax_key(name)[0]] = buf.numpy()
    return out.detach().numpy(), grads, stats


def _kernel_before_batch_norm(path, paths):
    """The kernel of the layer whose bias is at ``path``, where a BatchNorm
    follows that layer (``dense_j``/``bn_j``, ``w0``/``b0``/``bn0``), else None."""
    *parent, layer, leaf = path
    if leaf == "b0" and (*parent, layer, "bn0", "scale") in paths:
        return (*parent, layer, "w0")
    if leaf == "bias" and layer.startswith("dense_") and (*parent, f"bn_{layer[6:]}", "scale") in paths:
        return (*parent, layer, "kernel")
    return None


def _assert_grads(got, want):
    """Each gradient within ``GRAD_TOL`` of its max abs. A bias that a
    train-mode BatchNorm follows has the gradient 0 in exact arithmetic (the
    batch mean takes it out again): both sides' rounding is all there is, so
    it is held within ``GRAD_TOL`` of its layer's kernel gradient instead."""
    assert set(got) == set(want)
    for path, ref in want.items():
        kernel = _kernel_before_batch_norm(path, want)
        scale = max(float(np.abs(want[kernel] if kernel else ref).max()), 1e-30)
        err = float(np.abs(got[path] - ref).max())
        assert err <= GRAD_TOL * scale, ("/".join(path), err, scale)


def _assert_train(jax_module, port_module, variables, args, seed, pick=1):
    out_shape = _jax_eval(jax_module, variables, *args)[pick].shape
    cotangent = np.random.RandomState(seed).randn(*out_shape).astype(np.float32)
    want, want_grads, want_stats = _jax_train(jax_module, variables, args, cotangent, pick)
    got, got_grads, got_stats = _port_train(port_module, [_t(a) for a in args], cotangent, pick)
    np.testing.assert_allclose(got, want, **TOL)
    _assert_grads(got_grads, want_grads)
    assert set(got_stats) == set(want_stats)
    for path, ref in want_stats.items():
        np.testing.assert_allclose(got_stats[path], ref, **TOL, err_msg="/".join(path))


def _oracle_indices(xyz, npoint, radius, nsample, use_knn):
    centroids = gather_points_np(xyz, farthest_point_sample_np(xyz, npoint))
    if use_knn:
        return centroids, knn_np(xyz, centroids, nsample)[1]
    return centroids, ball_query_np(xyz, centroids, radius, nsample)[0]


OPTIONS = list(itertools.product(["max", "avg", "weighted_avg", "max_and_avg"], [False, True], [True, False]))


def _sa(pooling, use_knn, use_xyz, pre_project, **kw):
    common = dict(pooling=pooling, use_knn=use_knn, use_xyz=use_xyz, pre_project=pre_project, **kw)
    leaf = common.pop("leaf_inputs", False)
    jax_module = JaxSA(npoint=NPOINT, radius=RADIUS, nsample=NSAMPLE, mlp=MLP, ops_impl="xla",
                       leaf_inputs=leaf, **common)
    port_module = SetAbstraction(NPOINT, RADIUS, NSAMPLE, MLP, C, leaf_inputs=leaf, **common)
    return jax_module, port_module


@pytest.mark.parametrize("pre_project", [True, False], ids=["pre_projected", "plain"])
@pytest.mark.parametrize("pooling,use_knn,use_xyz", OPTIONS)
def test_set_abstraction_eval_matches_jax(pooling, use_knn, use_xyz, pre_project):
    xyz, feats = _inputs(1)
    jax_module, port_module = _sa(pooling, use_knn, use_xyz, pre_project)
    variables = _pair(jax_module, port_module, xyz, feats, 2)
    want_xyz, want, want_idx = _jax_eval(jax_module, variables, xyz, feats)
    with torch.no_grad():
        got_xyz, got, got_idx = port_module.eval()(_t(xyz), _t(feats))
    centroids, oracle_idx = _oracle_indices(xyz, NPOINT, RADIUS, NSAMPLE, use_knn)
    np.testing.assert_array_equal(got_xyz.numpy(), want_xyz)
    np.testing.assert_array_equal(got_xyz.numpy(), centroids)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    np.testing.assert_array_equal(got_idx.numpy(), oracle_idx)
    assert got.shape == (B, NPOINT, port_module.out_features) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("layout", ["pre_projected_leaf", "pre_projected", "plain"])
@pytest.mark.parametrize("pooling,use_knn,use_xyz", OPTIONS)
def test_set_abstraction_train_matches_jax(pooling, use_knn, use_xyz, layout):
    """Train mode: batch statistics, the updated moving ones and the
    parameter gradients; the leaf path (raw channels grouped, then
    projected) applies with kNN groups too."""
    xyz, feats = _inputs(3)
    jax_module, port_module = _sa(
        pooling, use_knn, use_xyz, layout != "plain", leaf_inputs=layout == "pre_projected_leaf"
    )
    variables = _pair(jax_module, port_module, xyz, feats, 4)
    _assert_train(jax_module, port_module, variables, (xyz, feats), 5)


@pytest.mark.parametrize("pooling", ["max", "weighted_avg", "max_and_avg"])
@pytest.mark.parametrize("use_xyz", [True, False])
@pytest.mark.parametrize("features", [C, 0], ids=["features", "xyz_only"])
def test_group_all_matches_jax(pooling, use_xyz, features):
    """One group of every point around the origin, eval and train."""
    xyz, feats = _inputs(6, features)
    jax_module = JaxSA(npoint=1, radius=0.0, nsample=N, mlp=MLP, group_all=True, pooling=pooling,
                       use_xyz=use_xyz, ops_impl="xla")
    port_module = SetAbstraction(1, 0.0, N, MLP, features, group_all=True, pooling=pooling, use_xyz=use_xyz)
    variables = _pair(jax_module, port_module, xyz, feats, 7)
    want_xyz, want, want_idx = _jax_eval(jax_module, variables, xyz, feats)
    with torch.no_grad():
        got_xyz, got, got_idx = port_module.eval()(_t(xyz), _t(feats))
    np.testing.assert_array_equal(got_xyz.numpy(), np.zeros((B, 1, 3), np.float32))
    np.testing.assert_array_equal(got_xyz.numpy(), want_xyz)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    assert got.shape == want.shape == (B, 1, port_module.out_features)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    _assert_train(jax_module, port_module, variables, (xyz, feats), 8)


@pytest.mark.parametrize("pre_project", [True, False], ids=["pre_projected", "plain"])
@pytest.mark.parametrize("pooling", ["max", "max_and_avg"])
def test_mlp2_matches_jax(pooling, pre_project):
    xyz, feats = _inputs(9)
    jax_module, port_module = _sa(pooling, False, True, pre_project, mlp2=[24, 8])
    variables = _pair(jax_module, port_module, xyz, feats, 10)
    assert "mlp2" in variables["params"]
    want = _jax_eval(jax_module, variables, xyz, feats)[1]
    with torch.no_grad():
        got = port_module.eval()(_t(xyz), _t(feats))[1]
    assert got.shape == (B, NPOINT, 8) and port_module.out_features == 8
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    _assert_train(jax_module, port_module, variables, (xyz, feats), 11)


@pytest.mark.parametrize("layout", ["pre_projected_leaf", "pre_projected", "plain"])
@pytest.mark.parametrize("use_knn", [False, True])
def test_use_bn_false_matches_jax(layout, use_knn):
    """No BatchNorm anywhere: each dense layer keeps its bias into its ReLU."""
    xyz, feats = _inputs(12)
    jax_module, port_module = _sa(
        "max", use_knn, True, layout != "plain", leaf_inputs=layout == "pre_projected_leaf", use_bn=False,
        mlp2=[8],
    )
    variables = _pair(jax_module, port_module, xyz, feats, 13)
    assert "batch_stats" not in variables
    assert not list(port_module.buffers())
    want = _jax_eval(jax_module, variables, xyz, feats)[1]
    with torch.no_grad():
        got = port_module.eval()(_t(xyz), _t(feats))[1]
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    _assert_train(jax_module, port_module, variables, (xyz, feats), 14)


@pytest.mark.parametrize("use_xyz", [True, False])
def test_set_abstraction_without_features_matches_jax(use_xyz):
    """No features: the offsets are the rows (the pre-projected layout does
    not apply without use_xyz, as in JAX)."""
    xyz, _ = _inputs(15)
    jax_module = JaxSA(npoint=NPOINT, radius=RADIUS, nsample=NSAMPLE, mlp=MLP, use_xyz=use_xyz, ops_impl="xla")
    port_module = SetAbstraction(NPOINT, RADIUS, NSAMPLE, MLP, 0, use_xyz=use_xyz)
    assert port_module.pre_projected == use_xyz
    variables = _pair(jax_module, port_module, xyz, None, 16)
    want = _jax_eval(jax_module, variables, xyz, None)[1]
    with torch.no_grad():
        got = port_module.eval()(_t(xyz), None)[1]
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_layout_with_a_window_reports_its_certificate():
    """``pre_project=False`` with ``bq_window``: the calibrated ball query
    (the JAX XLA path ignores the window off the TPU). A window as wide as
    ``ops.calibrate`` asks for certifies, and the outputs are the exact ones;
    one narrower says so."""
    xyz, feats = _inputs(17, n=2048)
    jax_module = JaxSA(npoint=512, radius=0.1, nsample=NSAMPLE, mlp=MLP, pre_project=False, ops_impl="xla")
    variables = None
    centroids = gather_points_np(xyz, farthest_point_sample_np(xyz, 512))
    need = required_bq_window(xyz, centroids, 0.1)
    assert need < 1024
    for window, certified in ((1024, True), (128, False)):
        port_module = SetAbstraction(512, 0.1, NSAMPLE, MLP, C, pre_project=False, bq_window=window)
        if variables is None:
            variables = _pair(jax_module, port_module, xyz, feats, 18)
            want_xyz, want, want_idx = _jax_eval(jax_module, variables, xyz, feats)
        port_module.load_state_dict(state_dict_from_flax(variables, port_module))
        certificates = []
        with torch.no_grad():
            got_xyz, got, got_idx = port_module.eval()(_t(xyz), _t(feats), certificates=certificates)
        assert [name for name, _ in certificates] == ["bq_window_ok"]
        assert bool(certificates[0][1]) == certified
        if certified:
            np.testing.assert_array_equal(got_idx.numpy(), want_idx)
            np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_precomputed_geometry_is_refused_for_knn_and_group_all():
    xyz, feats = _inputs(19)
    geometry = {"new_xyz": _t(xyz[:, :NPOINT]), "idx": torch.zeros(B, NPOINT, NSAMPLE, dtype=torch.int32)}
    for module in (SetAbstraction(NPOINT, RADIUS, NSAMPLE, MLP, C, use_knn=True),
                   SetAbstraction(NPOINT, RADIUS, NSAMPLE, MLP, C, use_knn=True, pre_project=False),
                   SetAbstraction(1, 0.0, N, MLP, C, group_all=True)):
        with pytest.raises(ValueError, match="precomputed geometry"):
            module.eval()(_t(xyz), _t(feats), geometry=geometry)
    # Centroids alone are grouping-independent: kNN takes them (JAX: the same).
    out = SetAbstraction(NPOINT, RADIUS, NSAMPLE, MLP, C, use_knn=True).eval()
    torch.nn.init.normal_(out.w0)
    with torch.no_grad():
        new_xyz = out(_t(xyz), _t(feats), geometry={"new_xyz": geometry["new_xyz"]})[0]
    assert torch.equal(new_xyz, geometry["new_xyz"])
    with pytest.raises(ValueError, match="precomputed geometry"):
        SetAbstraction(1, 0.0, N, MLP, C, group_all=True)(_t(xyz), _t(feats), geometry={"new_xyz": new_xyz})


def test_unknown_pooling_raises():
    with pytest.raises(ValueError, match="unknown pooling"):
        SetAbstraction(NPOINT, RADIUS, NSAMPLE, MLP, C, pooling="median")
    with pytest.raises(ValueError, match="unknown pooling"):
        pool(torch.zeros(1, 2, 3, 4), None, "median")


@pytest.mark.parametrize("pre_project", [True, False], ids=["pre_projected", "literal"])
@pytest.mark.parametrize("use_xyz,use_bn", [(False, True), (True, False), (False, False)])
def test_msg_options_match_jax(use_xyz, use_bn, pre_project):
    """MSG with use_xyz=False or use_bn=False, both layouts. The literal
    layout's rows are ``[features, xyz offsets]``, the other way round from
    the SSG plain layout's: weights that tell the two apart check the order."""
    xyz, feats = _inputs(20)
    radii, nsamples, mlps = (0.2, 0.4), (4, 8), ([8, 16], [16, 32])
    jax_module = JaxMSG(npoint=NPOINT, radius_list=radii, nsample_list=nsamples, mlp_list=mlps,
                        use_xyz=use_xyz, use_bn=use_bn, pre_project=pre_project, ops_impl="xla")
    port_module = SetAbstractionMSG(NPOINT, radii, nsamples, mlps, C, pre_project=pre_project,
                                    use_xyz=use_xyz, use_bn=use_bn)
    variables = _pair(jax_module, port_module, xyz, feats, 21)
    want_xyz, want = _jax_eval(jax_module, variables, xyz, feats)
    with torch.no_grad():
        got_xyz, got = port_module.eval()(_t(xyz), _t(feats))
    np.testing.assert_array_equal(got_xyz.numpy(), want_xyz)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    _assert_train(jax_module, port_module, variables, (xyz, feats), 22)


def test_msg_literal_rows_put_the_features_first():
    """The literal MSG layout feeds ``[features, offsets]`` to ``mlp_0``: a
    first layer that reads only the last three rows sees the offsets."""
    xyz, feats = _inputs(23)
    module = SetAbstractionMSG(NPOINT, (0.4,), (NSAMPLE,), ([3],), C, pre_project=False, use_bn=False).eval()
    with torch.no_grad():
        dense = module.mlp_0.dense_0
        dense.weight.zero_()
        dense.bias.zero_()
        dense.weight[:, C:] = torch.eye(3)
        new_xyz, got = module(_t(xyz), _t(feats))
    idx = ball_query_np(xyz, new_xyz.numpy(), 0.4, NSAMPLE)[0]
    offsets = np.stack([xyz[b][idx[b]] for b in range(B)]) - new_xyz.numpy()[:, :, None, :]
    np.testing.assert_allclose(got.numpy(), np.maximum(offsets, 0).max(axis=2), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("skip", [True, False])
def test_feature_propagation_without_batch_norm_matches_jax(skip):
    rng = np.random.RandomState(24)
    xyz1 = rng.rand(B, 96, 3).astype(np.float32)
    xyz2 = rng.rand(B, 24, 3).astype(np.float32)
    points1 = rng.randn(B, 96, 6).astype(np.float32) if skip else None
    points2 = rng.randn(B, 24, 10).astype(np.float32)
    jax_module = JaxFP(mlp=[16, 8], use_bn=False, ops_impl="xla")
    port_module = FeaturePropagation(10 + (6 if skip else 0), [16, 8], use_bn=False)
    variables = _randomize(
        jax_module.init(jax.random.PRNGKey(0), xyz1, xyz2, points1, points2, train=False, bn_momentum=MOMENTUM), 25
    )
    assert "batch_stats" not in variables
    port_module.load_state_dict(state_dict_from_flax(variables, port_module))
    args = (xyz1, xyz2, points1, points2)
    want = _jax_eval(jax_module, variables, *args)
    with torch.no_grad():
        got = port_module.eval()(*[_t(a) for a in args])
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    cotangent = rng.randn(*want.shape).astype(np.float32)

    def loss(params):
        out = jax_module.apply({"params": params}, *args, train=True, bn_momentum=MOMENTUM)
        return jnp.sum(out * cotangent)

    with jax.default_matmul_precision("highest"):
        want_grads = {("params", *k): np.asarray(v)
                      for k, v in flatten_dict(jax.grad(loss)(variables["params"])).items()}
    port_module.train()
    (port_module(*[_t(a) for a in args], MOMENTUM) * _t(cotangent)).sum().backward()
    got_grads = {}
    for name, p in port_module.named_parameters():
        path, transposed = _flax_key(name)
        got_grads[path] = p.grad.numpy().T if transposed else p.grad.numpy()
    _assert_grads(got_grads, want_grads)


def test_shared_mlp_without_batch_norm_keeps_the_flax_names():
    mlp = SharedMLP(4, [8, 2], use_bn=False)
    assert sorted(mlp.state_dict()) == ["dense_0.bias", "dense_0.weight", "dense_1.bias", "dense_1.weight"]
    x = torch.randn(3, 4)
    with torch.no_grad():
        want = torch.relu(mlp.dense_1(torch.relu(mlp.dense_0(x))))
        np.testing.assert_array_equal(mlp(x).numpy(), want.numpy())


# -- the plain-layout model --------------------------------------------------


def _cloud(seed, b, n):
    rng = np.random.RandomState(seed)
    x = np.zeros((b, n, 6), np.float32)
    x[..., :3] = rng.rand(b, n, 3) * [8.0, 8.0, 4.9]
    x[..., 3:] = rng.rand(b, n, 3)
    return x


def _jax_model(**kw):
    return JaxSemSeg(num_classes=9, config=JaxConfig(**SMALL), ops_impl="xla", pre_project=False, **kw)


def _jax_logits(model, variables, x):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.jit(lambda v, p: model.apply(v, p, train=False, bn_momentum=MOMENTUM))(
            variables, jnp.asarray(x)
        ))


def test_plain_model_matches_jax_and_the_pre_projected_model():
    cfg = Config(**SMALL)
    variables = convert.init_variables(cfg, 9, seed=3, bn_stats="random", pre_project=False)
    x = _cloud(7, 2, cfg.num_point)
    want = _jax_logits(_jax_model(), variables, x)
    model = PointNet2SemSeg(cfg, pre_project=False).eval()
    model.load_state_dict(convert.from_flax_variables(variables))
    assert "sa1.mlp.dense_0.weight" in model.state_dict() and not hasattr(model.sa1, "w0")
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    # The same seed in the pre-projected layout computes the same function.
    pre = PointNet2SemSeg(cfg).eval()
    pre.load_state_dict(convert.from_flax_variables(convert.init_variables(cfg, 9, seed=3, bn_stats="random")))
    with torch.no_grad():
        np.testing.assert_allclose(pre(torch.from_numpy(x)).numpy(), got, atol=1e-4, rtol=1e-4)


def test_plain_model_with_windows_matches_jax_and_certifies():
    """Windows from ``ops.calibrate`` on the request itself: every windowed
    level reports a certificate (SA1..SA4, then FP1..FP4), all hold, and the
    logits are the exact model's."""
    wide = dict(SMALL, num_point=2048, l1_npoint=512)  # clouds wider than the windows at SA1 and FP4
    cfg = Config(**wide)
    variables = convert.init_variables(cfg, 9, seed=4, bn_stats="random", pre_project=False)
    x = _cloud(8, 2, cfg.num_point)
    model = JaxSemSeg(num_classes=9, config=JaxConfig(**wide), ops_impl="xla", pre_project=False)
    want = _jax_logits(model, variables, x)
    specs = [(spec.npoint, spec.radius) for spec in cfg.sa_layers]
    bq_window, fp_window = calibrate_model_windows(specs, cfg.num_point, lambda: x, 1, margin=1.0, device="cpu")
    assert bq_window < 2048 and fp_window < 512
    predictor = Predictor(cfg, convert.from_flax_variables(variables), device="cpu", bq_window=bq_window,
                          fp_window=fp_window, pre_project=False)
    certificates = []
    got = predictor.infer_logits(x, certificates).numpy()
    assert [name for name, _ in certificates] == ["bq_window_ok"] * 4 + ["fp_window_ok"] * 4
    assert all(bool(ok) for _, ok in certificates)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_plain_model_train_step_matches_jax(monkeypatch):
    """One train step's loss and gradients, dropout off on both sides."""
    import flax.linen

    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    cfg = Config(**SMALL).replace(num_point=256)
    variables = convert.init_variables(cfg, 9, seed=5, bn_stats="random", pre_project=False)
    x = _cloud(9, 4, 256)
    rng = np.random.RandomState(10)
    labels = rng.randint(0, 9, (4, 256))
    weights = rng.rand(4, 256).astype(np.float32)
    model = JaxSemSeg(num_classes=9, config=JaxConfig(**{**SMALL, "num_point": 256}), ops_impl="xla",
                      pre_project=False)

    def loss(params):
        logits, _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x), train=True,
            bn_momentum=0.5, rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"],
        )
        return jax_weighted_ce_loss(logits, jnp.asarray(labels), jnp.asarray(weights))

    with jax.default_matmul_precision("highest"):
        want_loss, want_grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
    want_grads = {("params", *k): np.asarray(v) for k, v in flatten_dict(want_grads).items()}

    port = PointNet2SemSeg(cfg, dropout_rate=0.0, pre_project=False).train()
    port.load_state_dict(convert.from_flax_variables(variables))
    got_loss = weighted_ce_loss(port(torch.from_numpy(x), bn_momentum=0.5), torch.from_numpy(labels),
                                torch.from_numpy(weights))
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), rtol=1e-5)
    got_grads = {}
    for name, p in port.named_parameters():
        path, transposed = _flax_key(name)
        got_grads[path] = p.grad.numpy().T if transposed else p.grad.numpy()
    assert set(got_grads) == set(want_grads)
    # Whole-model float32 gradients: relative L2 within 5e-2 (the batch
    # statistics' float32 rounding, tests/test_torch_model.py's note); a
    # bias that a train-mode BatchNorm follows, whose exact gradient is 0,
    # against its layer's kernel gradient (``_assert_grads``).
    paths = set(want_grads) | {("params", "fc1_bn", "scale")}
    for path, ref in want_grads.items():
        kernel = ("params", "fc1", "kernel") if path == ("params", "fc1", "bias") else (
            _kernel_before_batch_norm(path, paths))
        err = np.linalg.norm(got_grads[path] - ref) / max(np.linalg.norm(want_grads[kernel] if kernel else ref), 1e-30)
        assert err <= 5e-2, ("/".join(path), err)


def test_trainer_and_predictor_take_the_plain_layout():
    cfg = Config(**SMALL).replace(batch_size=2)
    trainer = Trainer(cfg, device="cpu", pre_project=False, dropout_rate=0.0)
    trainer.init_state(0, bn_stats="random")
    assert "sa2.mlp.dense_2.weight" in trainer.model.state_dict()
    rng = np.random.RandomState(11)
    batch = {"points": _cloud(12, 2, cfg.num_point), "labels": rng.randint(0, 9, (2, cfg.num_point)),
             "weights": np.ones((2, cfg.num_point), np.float32)}
    loss = float(trainer.train_step(batch)["loss"])
    assert np.isfinite(loss) and trainer.step == 1
    # The same seed in the pre-projected layout takes the same first step.
    pre = Trainer(cfg, device="cpu", dropout_rate=0.0)
    pre.init_state(0, bn_stats="random")
    np.testing.assert_allclose(float(pre.train_step(batch)["loss"]), loss, rtol=1e-5)
    predictor = Predictor(cfg, trainer.model.state_dict(), device="cpu", pre_project=False)
    labels = predictor.predict_step(batch["points"])
    assert labels.shape == (2, cfg.num_point)
    with pytest.raises(RuntimeError, match="state_dict"):
        Predictor(cfg, trainer.model.state_dict(), device="cpu")


def test_msg_model_has_no_plain_layout():
    with pytest.raises(ValueError, match="pre-projected layout only"):
        PointNet2SemSegMSG(Config(**SMALL), pre_project=False)
    with pytest.raises(ValueError, match="pre-projected layout only"):
        convert.init_variables(Config(**SMALL), arch="msg", pre_project=False)


# -- the weight mapping in both layouts --------------------------------------


@pytest.mark.parametrize("pre_project", [True, False], ids=["pre_projected", "plain"])
@pytest.mark.parametrize("use_color", [True, False])
def test_mapping_round_trips_the_jax_init_tree(pre_project, use_color):
    """The JAX model's own ``init`` tree, either layout: every leaf once into
    the port and back."""
    cfg_kw = dict(SMALL, use_color=int(use_color))
    model = JaxSemSeg(num_classes=5, use_color=use_color, config=JaxConfig(**cfg_kw), ops_impl="xla",
                      pre_project=pre_project)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k, p: model.init(k, p, train=False))(
        jax.random.PRNGKey(1), jnp.zeros((1, 512, 3 + 3 * use_color))
    ))
    sd = convert.from_flax_variables(ref)
    port = PointNet2SemSeg(Config(**cfg_kw), num_classes=5, use_color=use_color, pre_project=pre_project)
    port.load_state_dict(sd)  # strict: the same key set
    back = flatten_dict(convert.to_flax_variables(sd))
    flat = flatten_dict(ref)
    assert set(back) == set(flat)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)


def test_init_variables_plain_is_the_tf_carried_tree():
    """``init_variables(pre_project=False)`` is the pre-projected tree carried
    through the reference's TF names into the plain layout, by the JAX
    package's functions as by the port's."""
    cfg = Config(**SMALL)
    pre = convert.init_variables(cfg, 9, seed=6, bn_stats="random")
    plain = convert.init_variables(cfg, 9, seed=6, bn_stats="random", pre_project=False)
    want = flatten_dict(jax_convert.tf_vars_to_flax(jax_convert.flax_to_tf_vars(pre), pre_project=False))
    got = flatten_dict(plain)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], np.asarray(want[k])) for k in want)
    shapes = flatten_dict(jax.tree_util.tree_map(np.shape, jax.eval_shape(
        lambda: _jax_model().init(jax.random.PRNGKey(0), jnp.zeros((1, 512, 6)), train=False)
    )))
    assert {k: np.shape(v) for k, v in got.items()} == shapes


def test_state_dict_from_tf_in_the_plain_layout(tmp_path):
    """The TF ``.npz`` of a seeded tree, written by the JAX function as
    ``tests/test_torch_convert_tf.py``'s fixture is, into either layout: the
    JAX conversion's tree, the JAX plain model's logits, the same function."""
    cfg = Config(**SMALL)
    tree = convert.init_variables(cfg, 9, seed=7, bn_stats="random")
    path = tmp_path / "ref.npz"
    np.savez(path, **jax_convert.flax_to_tf_vars(tree))
    plain_sd = convert.state_dict_from_tf(str(path), pre_project=False)
    want = convert.from_flax_variables(jax_convert.convert_checkpoint(str(path), pre_project=False))
    assert plain_sd.keys() == want.keys()
    assert all(torch.equal(plain_sd[k], want[k]) for k in want)
    plain = PointNet2SemSeg(cfg, pre_project=False).eval()
    plain.load_state_dict(plain_sd)
    pre = PointNet2SemSeg(cfg).eval()
    pre.load_state_dict(convert.state_dict_from_tf(str(path)))
    x = _cloud(13, 2, cfg.num_point)
    want = _jax_logits(_jax_model(), jax_convert.convert_checkpoint(str(path), pre_project=False), x)
    with torch.no_grad():
        got = plain(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(pre(torch.from_numpy(x)).numpy(), got, atol=1e-4, rtol=1e-4)
