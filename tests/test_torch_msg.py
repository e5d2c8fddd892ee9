"""The port's MSG architecture against the JAX package's, on the CPU.

``SetAbstractionMSG``, ``PointNet2SemSegMSG``, ``precompute_geometry(arch="msg")``,
the weight bridge on the MSG tree, ``Trainer(arch="msg")``,
``Predictor(arch="msg")`` and the three CLIs' ``--arch msg``, at the small
configurations the JAX MSG tests use (``tests/test_model.py:261-264``, and
``FUSED`` of ``tests/test_wingather.py`` for the windows). Inputs are made
from seeds with numpy; the JAX side runs with ``ops_impl="xla"``.

Tolerances are those the SSG tests state for the same quantities:

- indices and centroids equal bit for bit;
- eval features and logits within atol 1e-5 / 1e-4 (``tests/test_torch_nn.py``,
  ``tests/test_torch_model.py``: two float32 matmul orders), argmax equal;
- train mode: a level's outputs within atol 5e-5, rtol 1e-5, moving statistics
  within 1e-5, parameter gradients within relative L2 2e-2; whole-model train
  logits within 1e-9 in float64 (``jax_float64``) and atol 2e-3 in float32;
  the input gradient within relative L2 1e-3;
- a float64 momentum-SGD Trainer step: loss rtol 1e-6, parameters atol 1e-8,
  statistics atol 1e-6 (``tests/test_torch_train.py``);
- the literal layout against the pre-projected one: rtol 2e-4, atol 2e-5,
  as ``tests/test_preproject.py:101`` holds them in JAX;
- bf16 logits within 8u of the float32 logits' scale of JAX's, and
  ``fold_batch_norm`` rtol 4e-7 (``tests/test_torch_precision.py``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pointnet2_tpu.config import Config as JaxConfig
from pointnet2_tpu.models.pointnet2_seg import PointNet2SemSegMSG as JaxMSG
from pointnet2_tpu.models.pointnet2_seg import precompute_geometry as jax_precompute_geometry
from pointnet2_tpu.nn.fold import fold_batch_norm as jax_fold_batch_norm
from pointnet2_tpu.nn.pointnet import SetAbstractionMSG as JaxSAMSG
from pointnet2_tpu_torch import convert
from pointnet2_tpu_torch.cli import kitti_predict as cli_kitti
from pointnet2_tpu_torch.cli import predict as cli_predict
from pointnet2_tpu_torch.cli import train as cli_train
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.convert import state_dict_from_flax
from pointnet2_tpu_torch.data.io import load_labels
from pointnet2_tpu_torch.data.semantic3d import SemanticDataset
from pointnet2_tpu_torch.infer import Predictor
from pointnet2_tpu_torch.models import (
    PointNet2SemSeg,
    PointNet2SemSegMSG,
    model_class,
    msg_scales,
    precompute_geometry,
)
from pointnet2_tpu_torch.nn.fold import fold_batch_norm
from pointnet2_tpu_torch.nn.pointnet import SetAbstractionMSG, ball_query
from pointnet2_tpu_torch.tools import scenes as scene_tools
from pointnet2_tpu_torch.train import Trainer, load_model_state, save_checkpoint
from test_torch_cli import _write_config, scenes  # noqa: F401  (scenes is a fixture)
from test_torch_model import jax_float64, to_float64
from test_torch_nn import TOL, _check_train, _randomize, _t, _train_reference
from test_torch_train import _assert_float64_step, _float64_run, _tree

torch.set_num_threads(2)
U = 2.0**-8  # bfloat16's unit roundoff
BF16 = torch.bfloat16
# tests/test_model.py's TestMSGModel._cfg.
MSG_SMALL = dict(
    num_point=256, batch_size=4, l1_npoint=64, l2_npoint=32, l3_npoint=16, l4_npoint=8,
    l1_nsample=8, l2_nsample=8, l3_nsample=8, l4_nsample=8,
)
# tests/test_wingather.py's FUSED: SA1's 256 centroids make two query tiles,
# so a window of 768 of the 1024 points engages and certifies.
FUSED = dict(
    num_point=1024, l1_npoint=256, l2_npoint=64, l3_npoint=32, l4_npoint=16,
    l1_radius=0.05, l2_radius=0.4, l3_radius=0.8, l4_radius=1.6,
    l1_nsample=8, l2_nsample=8, l3_nsample=8, l4_nsample=8,
)


def _cloud(seed, b, n, use_color=1, extent=(2.0, 2.0, 1.5)):
    """Clouds dense enough that SA1's half radius holds a few points a ball."""
    rng = np.random.RandomState(seed)
    x = np.zeros((b, n, 3 + 3 * use_color), np.float32)
    x[..., :3] = rng.rand(b, n, 3) * extent
    if use_color:
        x[..., 3:] = rng.rand(b, n, 3)
    return x


def _jax_msg(cfg_kw, use_color=1, **kw):
    return JaxMSG(
        num_classes=9, use_color=bool(use_color), config=JaxConfig(use_color=use_color, **cfg_kw),
        ops_impl="xla", **kw,
    )


def _jax_logits(model, variables, x):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax.jit(lambda v, p: model.apply(v, p, train=False, bn_momentum=0.9))(
            variables, jnp.asarray(x)
        ))


def _port_msg(cfg_kw, variables, use_color=1, **kw):
    model = PointNet2SemSegMSG(Config(use_color=use_color, **cfg_kw), 9, bool(use_color), **kw)
    model.load_state_dict(convert.from_flax_variables(variables))
    return model


# -- SetAbstractionMSG ---------------------------------------------------------

SA_KW = dict(npoint=32, radius_list=(0.25, 0.5), nsample_list=(4, 8), mlp_list=([8, 16], [16, 32]))


def _sa_inputs(seed):
    rng = np.random.RandomState(seed)
    return rng.rand(2, 128, 3).astype(np.float32), rng.rand(2, 128, 5).astype(np.float32)


def _sa_pair(pre_project, seed, leaf=False):
    xyz, feats = _sa_inputs(seed)
    ref = JaxSAMSG(**SA_KW, pre_project=pre_project, leaf_inputs=leaf, ops_impl="xla")
    variables = _randomize(ref.init(jax.random.PRNGKey(0), xyz, feats, train=False, bn_momentum=0.9), seed + 1)
    port = SetAbstractionMSG(
        SA_KW["npoint"], SA_KW["radius_list"], SA_KW["nsample_list"], SA_KW["mlp_list"], 5,
        pre_project=pre_project, leaf_inputs=leaf,
    )
    port.load_state_dict(state_dict_from_flax(variables, port))
    return ref, variables, port, xyz, feats


@pytest.mark.parametrize("pre_project", [True, False])
def test_set_abstraction_msg_eval_matches_flax(pre_project):
    ref, variables, port, xyz, feats = _sa_pair(pre_project, 20)
    with jax.default_matmul_precision("highest"):
        want_xyz, want = ref.apply(variables, xyz, feats, train=False, bn_momentum=0.9)
    with torch.no_grad():
        got_xyz, got = port.eval()(_t(xyz), _t(feats))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    assert got.shape == (2, 32, 16 + 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pre_project,leaf", [(True, True), (True, False), (False, False)])
def test_set_abstraction_msg_train_matches_flax(pre_project, leaf):
    """Batch statistics, the moving statistics and every parameter gradient;
    with ``leaf`` the scales gather the raw channels and project after."""
    ref, variables, port, xyz, feats = _sa_pair(pre_project, 22, leaf)
    cot = np.random.RandomState(23).randn(2, 32, 48).astype(np.float32)
    want = _train_reference(ref, variables, (xyz, feats), cot, 0.7)
    _, got = port.train()(_t(xyz), _t(feats), 0.7)
    _check_train(port, variables, got, cot, *want, grad_rel_l2=2e-2)


def _literal_to_pre_projected(state: dict, c: int) -> dict:
    """A literal-layout state_dict in the pre-projected layout: ``mlp_{s}.dense_0``
    (rows ``[features, xyz offsets]``) becomes ``scale{s}.w0`` (rows ``[xyz,
    features]``), ``bn_0`` becomes ``bn0``, and ``dense_i``/``bn_i`` move to
    ``mlp_rest.dense_{i-1}``/``bn_{i-1}``."""
    out = {}
    for key, value in state.items():
        mlp, layer, leaf = key.split(".")
        scale = f"scale{mlp[len('mlp_'):]}"
        kind, i = layer.split("_")
        if layer == "dense_0":
            if leaf == "weight":
                out[f"{scale}.w0"] = torch.cat([value.T[c:], value.T[:c]])
            else:
                out[f"{scale}.b0"] = value
        elif layer == "bn_0":
            out[f"{scale}.bn0.{leaf}"] = value
        else:
            out[f"{scale}.mlp_rest.{kind}_{int(i) - 1}.{leaf}"] = value
    return out


def test_msg_pre_projected_equals_the_literal_layout():
    """The port's two layouts with the same weights (remapped as
    ``tests/test_preproject.py:101`` remaps them), eval and train."""
    _, _, literal, xyz, feats = _sa_pair(False, 24)
    pre = SetAbstractionMSG(SA_KW["npoint"], SA_KW["radius_list"], SA_KW["nsample_list"], SA_KW["mlp_list"], 5)
    pre.load_state_dict(_literal_to_pre_projected(literal.state_dict(), 5))
    with torch.no_grad():
        for mode in ("eval", "train"):
            xyz_l, out_l = getattr(literal, mode)()(_t(xyz), _t(feats), 0.5)
            xyz_p, out_p = getattr(pre, mode)()(_t(xyz), _t(feats), 0.5)
            assert torch.equal(xyz_l, xyz_p)
            np.testing.assert_allclose(out_p.numpy(), out_l.numpy(), rtol=2e-4, atol=2e-5, err_msg=mode)


def test_msg_geometry_needs_one_index_set_a_scale():
    _, _, port, xyz, feats = _sa_pair(True, 26)
    with torch.no_grad():
        new_xyz, want = port.eval()(_t(xyz), _t(feats))
        idx = [ball_query(_t(xyz), new_xyz, r, k, None, None, None) for r, k in port.scales]
        got = port(_t(xyz), _t(feats), geometry={"new_xyz": new_xyz, "idx": tuple(idx)})[1]
        assert torch.equal(got, want)
        for wrong in ((idx[0],), idx[1]):
            with pytest.raises(ValueError, match="index sets for 2 grouping scales"):
                port(_t(xyz), _t(feats), geometry={"new_xyz": new_xyz, "idx": wrong})


# -- the model -------------------------------------------------------------------


@pytest.mark.parametrize("use_color", [1, 0])
def test_msg_eval_logits_match_jax_and_the_tree(use_color):
    cfg = Config(use_color=use_color, **MSG_SMALL)
    model = _jax_msg(MSG_SMALL, use_color)
    ref = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, cfg.num_point, cfg.point_dim)),
                                            train=False))
    variables = convert.init_variables(cfg, 9, seed=3, bn_stats="random", arch="msg")
    shapes = {k: v.shape for k, v in flatten_dict(ref).items()}
    assert {k: v.shape for k, v in flatten_dict(variables).items()} == shapes
    x = _cloud(7, 2, cfg.num_point, use_color)
    want = _jax_logits(model, variables, x)
    port = _port_msg(MSG_SMALL, variables, use_color).eval()
    assert [port.fp1.mlp.dense_0.in_features, port.fp2.mlp.dense_0.in_features,
            port.fp3.mlp.dense_0.in_features, port.fp4.mlp.dense_0.in_features] == [768, 448, 352, 128 + 3 * use_color]
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, cfg.num_point, 9)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_msg_converter_uses_every_leaf_and_round_trips():
    """Every leaf of the real flax MSG tree lands in the state_dict once, and
    ``to_flax_variables`` gives the tree back."""
    model = _jax_msg(MSG_SMALL)
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: model.init(key, jnp.zeros((1, 256, 6)), train=False)
    )(jax.random.PRNGKey(1)))
    sd = convert.from_flax_variables(ref)
    flat = flatten_dict(ref)
    assert len(sd) == len(flat)
    np.testing.assert_array_equal(sd["sa1.scale0.w0"].numpy(), flat[("params", "sa1", "scale0", "w0")])
    np.testing.assert_array_equal(
        sd["sa2.scale1.mlp_rest.bn_1.var"].numpy(), flat[("batch_stats", "sa2", "scale1", "mlp_rest", "bn_1", "var")]
    )
    PointNet2SemSegMSG(num_classes=9).load_state_dict(sd)  # strict: the same key set
    back = flatten_dict(convert.to_flax_variables(sd))
    assert set(back) == set(flat) and all(np.array_equal(back[k], v) for k, v in flat.items())
    with pytest.raises(RuntimeError, match="scale0"):
        PointNet2SemSeg(num_classes=9).load_state_dict(sd)


def test_msg_precompute_geometry_matches_jax_and_the_inline_forward():
    cfg = Config(**MSG_SMALL)
    x = _cloud(10, 3, cfg.num_point)
    want, ok = jax_precompute_geometry(jnp.asarray(x), config=JaxConfig(**MSG_SMALL), ops_impl="xla", arch="msg")
    got, got_ok = precompute_geometry(torch.from_numpy(x), cfg, arch="msg")
    assert bool(ok) and bool(got_ok)
    for i, (level, ref) in enumerate(zip(got["sa"], want["sa"])):
        np.testing.assert_array_equal(level["new_xyz"].numpy(), np.asarray(ref["new_xyz"]))
        if i < 2:
            assert isinstance(level["idx"], tuple) and len(level["idx"]) == 2
            assert level["idx"][0].shape[-1] == msg_scales(cfg.sa_layers[i])[0][1] == 4
        for g, w in zip(jax.tree_util.tree_leaves(level["idx"]), jax.tree_util.tree_leaves(ref["idx"])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for level, ref in zip(got["fp"], want["fp"]):
        np.testing.assert_array_equal(level["idx"].numpy(), np.asarray(ref["idx"]))
    model = PointNet2SemSegMSG(cfg).eval()
    model.load_state_dict(convert.from_flax_variables(convert.init_variables(cfg, 9, 0, "random", arch="msg")))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        assert torch.equal(model(xt, geometry=got), model(xt))
        ssg_geometry, _ = precompute_geometry(xt, cfg)
        with pytest.raises(ValueError, match="grouping scales"):
            model(xt, geometry=ssg_geometry)
    with pytest.raises(ValueError, match="unknown arch 'pointnet', expected 'ssg'/'msg'"):
        precompute_geometry(xt, cfg, arch="pointnet")


def test_msg_windowed_eval_logits_and_six_certificates():
    """``bq_window=768`` at FUSED: the fused windowed grouping (eval, no
    autograd) and the per-scale calibrated ball query (eval with autograd
    on) each append 2 + 2 certificates at the MSG levels and one at each SSG
    level; every one holds, and the logits equal the exact forward's and JAX's."""
    cfg = Config(**FUSED)
    variables = convert.init_variables(cfg, 9, seed=5, bn_stats="random", arch="msg")
    x = _cloud(11, 1, cfg.num_point, extent=(8.0, 1.0, 1.0))
    want = _jax_logits(_jax_msg(FUSED), variables, x)
    exact = _port_msg(FUSED, variables).eval()
    windowed = _port_msg(FUSED, variables, bq_window=768).eval()
    with torch.no_grad():
        exact_logits = exact(torch.from_numpy(x))
        fused_certs = []
        fused = windowed(torch.from_numpy(x), certificates=fused_certs)
    plain_certs = []
    plain = windowed(torch.from_numpy(x), certificates=plain_certs).detach()
    for certs in (fused_certs, plain_certs):
        assert [name for name, _ in certs] == ["bq_window_ok"] * 6 and all(bool(ok) for _, ok in certs)
    for got in (fused, plain):
        torch.testing.assert_close(got, exact_logits, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_msg_train_logits_match_jax(monkeypatch):
    """Train mode, dropout off: float32 within atol 2e-3, and in float64 on
    both sides with the hoisted float32 geometry within 1e-9."""
    import flax.linen

    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    cfg = Config(**MSG_SMALL)
    variables = convert.init_variables(cfg, 9, seed=3, bn_stats="random", arch="msg")
    x = _cloud(8, 4, cfg.num_point)
    model = _jax_msg(MSG_SMALL)

    def apply(v, p, g=None):
        return model.apply(v, p, train=True, bn_momentum=0.5, geometry=g,
                           rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])[0]

    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(apply)(variables, jnp.asarray(x)))
    port = _port_msg(MSG_SMALL, variables, dropout_rate=0.0).train()
    with torch.no_grad():
        got = port(torch.from_numpy(x), bn_momentum=0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=1e-4)

    geometry, _ = precompute_geometry(torch.from_numpy(x), cfg, arch="msg")
    as_float64 = jax.tree_util.tree_map(lambda t: t.double() if t.is_floating_point() else t, geometry)
    with jax_float64(), jax.default_matmul_precision("highest"):
        want64 = np.asarray(jax.jit(apply)(
            to_float64(variables), jnp.asarray(x, jnp.float64),
            to_float64(jax.tree_util.tree_map(lambda t: t.numpy(), geometry)),
        ))
    assert want64.dtype == np.float64
    port.load_state_dict(convert.from_flax_variables(variables))  # the forward above moved the statistics
    with torch.no_grad():
        got64 = port.double()(torch.from_numpy(x).double(), bn_momentum=0.5, geometry=as_float64)
    np.testing.assert_allclose(got64.numpy(), want64, atol=1e-9, rtol=0)


@pytest.mark.parametrize("input_is_leaf", [True, False])
def test_msg_input_gradient_matches_jax(input_is_leaf):
    """Eval mode; relative L2 <= 1e-3. As a leaf the cloud gets no gradient
    through SA1's scales."""
    cfg = Config(**MSG_SMALL)
    variables = convert.init_variables(cfg, 9, seed=4, bn_stats="random", arch="msg")
    x = _cloud(9, 2, cfg.num_point)
    cot = np.random.RandomState(1).randn(2, cfg.num_point, 9).astype(np.float32)
    port = _port_msg(MSG_SMALL, variables, input_is_leaf=input_is_leaf).eval()
    xt = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(port(xt), (xt,), torch.from_numpy(cot))
    model = _jax_msg(MSG_SMALL, input_is_leaf=input_is_leaf)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jax.grad(
            lambda p: jnp.sum(model.apply(variables, p, train=False, bn_momentum=0.9) * cot)
        ))(jnp.asarray(x)))
    err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert err <= 1e-3, err


# -- the Trainer and the Predictor ---------------------------------------------------


def test_msg_trainer_step_matches_jax_in_float64():
    """One free-running momentum-SGD step on both sides in float64: loss,
    parameters after, moving statistics."""
    port, (rec,) = _float64_run(1, seed=7, first_batch=50, arch="msg")
    assert isinstance(port.model, PointNet2SemSegMSG)
    _assert_float64_step(rec)
    assert ("params", "sa1", "scale0", "w0") in rec["after"]


def _msg_trainer(**kw):
    trainer = Trainer(Config(**MSG_SMALL), device="cpu", dropout_rate=0.0, arch="msg", **kw)
    trainer.init_state(6, bn_stats="random")
    return trainer


def test_msg_accum_hoisted_equals_not_hoisted():
    batch = {"points": _cloud(12, 4, 256), "labels": np.random.RandomState(12).randint(0, 9, (4, 256)),
             "weights": np.ones((4, 256), np.float32)}
    hoisted, inline = _msg_trainer(accum_steps=2), _msg_trainer(accum_steps=2, hoist_geometry=False)
    got, want = hoisted.train_step(batch), inline.train_step(batch)
    assert float(got["loss"]) == float(want["loss"]) and np.isfinite(float(got["loss"]))
    for key, value in _tree(inline).items():
        np.testing.assert_array_equal(_tree(hoisted)[key], value, err_msg=str(key))


def test_unknown_arch_raises_the_jax_trainers_error():
    state = convert.from_flax_variables(convert.init_variables(Config(**MSG_SMALL), 9, arch="msg"))
    for make in (lambda: Trainer(Config(**MSG_SMALL), device="cpu", arch="pointnet"),
                 lambda: Predictor(Config(**MSG_SMALL), state, device="cpu", arch="pointnet"),
                 lambda: model_class("pointnet")):
        with pytest.raises(ValueError, match="unknown arch 'pointnet', expected 'ssg'/'msg'"):
            make()


def test_msg_predictor_and_trainer_checks(tmp_path):
    """The Predictor on a checkpoint of an MSG Trainer equals the Trainer's
    own eval forward; the window check and the checkpoint work for MSG."""
    trainer = _msg_trainer(bq_window=768)
    x = _cloud(13, 2, 256)
    assert trainer.check_bq_window(x)  # 256 points: no level engages the window, each certifies
    save_checkpoint(tmp_path / "msg.pt", trainer)
    predictor = Predictor(Config(**MSG_SMALL), load_model_state(tmp_path / "msg.pt"), device="cpu", arch="msg")
    labels, ok = trainer.predict_step_checked(x)
    assert bool(ok) and torch.equal(predictor.predict_step(x), labels)
    with pytest.raises(RuntimeError, match="scale0"):
        Predictor(Config(**MSG_SMALL), load_model_state(tmp_path / "msg.pt"), device="cpu")


# -- the bf16 modes -----------------------------------------------------------------


def test_msg_bf16_modes_match_jax():
    """Uniform and selective (128) bfloat16 eval logits of the port and of JAX
    from the same weights; at 128 SA1 and SA2 (narrowest width 16 and 32 over
    both scales) stay float32."""
    cfg = Config(**MSG_SMALL)
    variables = convert.init_variables(cfg, 9, seed=3, bn_stats="random", arch="msg")
    x = _cloud(7, 2, cfg.num_point)
    model = _port_msg(MSG_SMALL, variables).eval()
    with torch.no_grad():
        f32 = model(torch.from_numpy(x)).numpy()
    want32 = _jax_logits(_jax_msg(MSG_SMALL), variables, x)
    scale = float(np.abs(want32).max())
    for width in (None, 128):
        port = model.with_precision(BF16, width).eval()
        stages = [getattr(port, f"sa{i}").compute_dtype for i in range(1, 5)]
        assert stages == ([None, None, BF16, BF16] if width else [BF16] * 4)
        assert port.sa1.scale0.mlp_rest.dtype == stages[0] and port.sa2.scale1.compute_dtype == stages[1]
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
        want = _jax_logits(_jax_msg(MSG_SMALL, compute_dtype=jnp.bfloat16, compute_dtype_min_width=width),
                           variables, x)
        assert float(np.abs(got - want).max()) <= 8 * U * scale
        assert float(np.abs(got - f32).max()) <= 2 * float(np.abs(want - want32).max()) + 1e-4
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.98


def test_msg_fold_batch_norm_matches_jax_and_the_unfolded_forward():
    cfg = Config(**MSG_SMALL)
    variables = convert.init_variables(cfg, 9, seed=4, bn_stats="random", arch="msg")
    state = convert.from_flax_variables(variables)
    got = fold_batch_norm(state)
    fp, fs = jax_fold_batch_norm(variables["params"], variables["batch_stats"])
    want = convert.from_flax_variables({"params": jax.tree_util.tree_map(np.asarray, dict(fp)),
                                        "batch_stats": jax.tree_util.tree_map(np.asarray, dict(fs))})
    assert set(got) == set(want) == set(state) and "sa1.scale0.bn0.mean" in got
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=4e-7, atol=1e-7, err_msg=key)
    x = torch.from_numpy(_cloud(3, 2, cfg.num_point))
    model = PointNet2SemSegMSG(cfg).eval()
    with torch.no_grad():
        model.load_state_dict(state)
        plain = model(x)
        model.load_state_dict(got)
        folded = model(x)
    np.testing.assert_allclose(folded.numpy(), plain.numpy(), atol=2e-3, rtol=1e-3)


def test_msg_bf16_trainer_and_predictor():
    """One mixed-precision step tracks the float32 step (loss within 5 %, JAX's
    bound); the bf16 Predictor's labels agree with float32's on most points."""
    batch = {"points": _cloud(14, 4, 256), "labels": np.random.RandomState(14).randint(0, 9, (4, 256)),
             "weights": np.ones((4, 256), np.float32)}
    f32, bf16 = _msg_trainer(), _msg_trainer(train_dtype="bfloat16", bf16_min_width=128)
    loss32, loss16 = float(f32.train_step(batch)["loss"]), float(bf16.train_step(batch)["loss"])
    assert loss16 == pytest.approx(loss32, rel=0.05)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in bf16.model.parameters())
    state = f32.model.state_dict()
    labels32 = Predictor(Config(**MSG_SMALL), state, device="cpu", arch="msg").predict_step(batch["points"])
    labels16 = Predictor(Config(**MSG_SMALL), state, device="cpu", arch="msg", dtype="bfloat16").predict_step(
        batch["points"])
    assert (labels16 == labels32).float().mean() > 0.8


# -- the CLIs -----------------------------------------------------------------------


def _spy(monkeypatch, module, name):
    seen = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        made = real(*args, **kwargs)
        seen.append((kwargs, made))
        return made

    monkeypatch.setattr(module, name, spy)
    return seen


@pytest.fixture(scope="module")
def msg_cli(scenes, tmp_path_factory):  # noqa: F811
    """``cli.train --arch msg`` for one epoch, then ``cli.predict --arch msg``
    on its ``model.pt``, each with its Trainer or Predictor spied on."""
    base = tmp_path_factory.mktemp("msg_cli")
    cfg_path = _write_config(base / "cfg.json", data_path=str(scenes), logdir=str(base / "log"))
    with pytest.MonkeyPatch.context() as mp:
        trainers = _spy(mp, cli_train, "Trainer")
        predictors = _spy(mp, cli_predict, "Predictor")
        summary = cli_train.main(["--config_file", cfg_path, "--seed", "0", "--device", "cpu", "--arch", "msg"])
        cli_predict.main(["--ckpt", str(base / "log" / "model.pt"), "--output_dir", str(base / "sparse"),
                          "--device", "cpu", "--set", "validation", "--config_file", cfg_path,
                          "--num_samples", "2", "--batch_size", "2", "--arch", "msg"])
    return base, cfg_path, summary, trainers, predictors


def _kitti_case(tmp_path, monkeypatch):
    cfg_kw = dict(num_point=512, use_color=0, box_size_x=60.0, box_size_y=20.0,
                  l1_npoint=128, l2_npoint=64, l3_npoint=16, l4_npoint=8)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg_kw))
    trainer = Trainer(Config(**cfg_kw), device="cpu", arch="msg")
    trainer.init_state(2, bn_stats="random")
    save_checkpoint(tmp_path / "msg.pt", trainer)
    root = scene_tools.write_drive(tmp_path / "drive", 11, frames=1, points=12_000)
    monkeypatch.chdir(tmp_path)
    predictors = _spy(monkeypatch, cli_kitti, "Predictor")
    summary = cli_kitti.main(["--ckpt", str(tmp_path / "msg.pt"), "--kitti_root", str(root), "--config_file",
                              str(cfg_path), "--device", "cpu", "--save", "--arch", "msg"])
    labels = load_labels("result/dense/0000.labels")
    assert len(labels) == summary["frames"][0]["dense_points"] and labels.min() >= 0 and labels.max() < 9
    return predictors


@pytest.mark.parametrize("cli", ["train", "predict", "kitti_predict"])
def test_arch_flag_reaches_the_model(cli, msg_cli, tmp_path, monkeypatch):
    if cli == "kitti_predict":
        made = _kitti_case(tmp_path, monkeypatch)
    else:
        made = msg_cli[3] if cli == "train" else msg_cli[4]
    (kwargs, obj), = made
    assert kwargs["arch"] == "msg"
    assert isinstance(obj.model, PointNet2SemSegMSG)


def test_cli_msg_train_then_predict(msg_cli):
    """The MSG checkpoints the train CLI wrote, and the predict CLI's labels
    against a ``Predictor(arch="msg")`` fed the samples the CLI drew."""
    base, cfg_path, summary, _, _ = msg_cli
    cfg = Config.from_json(cfg_path)
    text = (base / "log" / "log_train.txt").read_text()
    assert "mean loss" in text and "eval accuracy" in text and summary["step"] > 0
    state = load_model_state(base / "log" / "model.pt")
    assert "sa2.scale1.w0" in state
    predictor = Predictor(cfg, state, device="cpu", arch="msg")
    np.random.seed(0)
    dataset = SemanticDataset(cfg.num_point, "validation", True, cfg.box_size_x, cfg.box_size_y, cfg.data_path, seed=0)
    for fd in dataset.list_file_data:
        prefix = fd.file_path_without_ext.rsplit("/", 1)[-1]
        centered, _, _, colors = fd.sample_batch(2, cfg.num_point)
        want = predictor.predict_step(np.concatenate((centered, colors), -1).astype(np.float32)).numpy()
        np.testing.assert_array_equal(load_labels(base / "sparse" / f"{prefix}.labels"), want.reshape(-1))
    with pytest.raises(RuntimeError, match="scale0"):  # the checkpoint's arch, not the default
        cli_predict.main(["--ckpt", str(base / "log" / "model.pt"), "--output_dir", str(base / "ssg"),
                          "--device", "cpu", "--set", "validation", "--config_file", cfg_path])
