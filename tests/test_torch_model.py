"""The port's PointNet2SemSeg, converter and Predictor against the JAX package.

Both sides get the same seeded numpy inputs and the same weights: the flax
variables are made by ``convert.init_variables`` (flax layout) and handed to
the JAX model as they are and to the port through ``from_flax_variables``.

Tolerances: eval logits agree within atol=1e-4, rtol=1e-4 and their argmax
is equal. The geometry (FPS, ball query, 3-NN) is the same bit for bit on
both sides; the float32 matmuls of XLA's CPU backend and of PyTorch sum in
different orders, which leaves about 1e-6 relative after the 12 layers.
"""

import atexit
import contextlib
import os
import pathlib
import shutil
import tempfile

# Before JAX is imported, and for every process this one starts: the CLI
# tests run train.py and predict.py as subprocesses too, which inherit the
# environment but not a jax.config.update made here, and call
# setup_compilation_cache() (pointnet2_tpu/utils/runtime.py, which honours
# JAX_COMPILATION_CACHE_DIR). So the cache is switched off and, should
# anything still write one, pointed at a directory of this worker's own.
_CACHE_DIR = tempfile.mkdtemp(prefix="jax_cache_")
atexit.register(shutil.rmtree, _CACHE_DIR, ignore_errors=True)
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
os.environ["JAX_COMPILATION_CACHE_DIR"] = _CACHE_DIR

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pointnet2_tpu.config import Config as JaxConfig
from pointnet2_tpu.models.pointnet2_seg import PointNet2SemSeg as JaxSemSeg
from pointnet2_tpu.models.pointnet2_seg import precompute_geometry as jax_precompute_geometry
from pointnet2_tpu.models.pointnet2_seg import weighted_ce_loss as jax_weighted_ce_loss
from pointnet2_tpu.models.pointnet2_seg import weighted_ce_sum as jax_weighted_ce_sum
from pointnet2_tpu_torch import convert
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.infer import Predictor
from pointnet2_tpu_torch.models.pointnet2_seg import (
    PointNet2SemSeg,
    precompute_geometry,
    weighted_ce_loss,
    weighted_ce_sum,
)

# The JAX CLIs that the suite runs in-process turn on JAX's persistent
# compilation cache (pointnet2_tpu/utils/runtime.py), which lives under $HOME
# and outlives the run. With entries left by an earlier run, the Pallas
# interpret-mode model test of tests/test_wingather.py deadlocked in a worker
# that had run a CLI test before it (3 runs of 3 with a populated cache; with
# the cache empty or disabled, 2 runs of 2 passed). Every pytest-xdist worker
# imports this module while collecting, before anything is compiled, so this
# and the environment above keep the whole run off the shared on-disk cache.
jax.config.update("jax_enable_compilation_cache", False)

# Six workers share eight cores with the 8-device CPU meshes of the JAX-side
# tests, one of which (tests/test_multichip_cli.py, the production config on
# the mesh) has aborted its worker in a loaded run and passes alone. PyTorch
# would add eight intra-op threads a worker; the port's tests are small, so
# two do.
torch.set_num_threads(2)



@contextlib.contextmanager
def jax_float64():
    """Run the JAX package in float64 throughout, without editing it.

    ``jax.enable_x64`` alone does not: ``pointnet2_tpu.nn.layers.BatchNorm``
    takes its batch statistics from ``x.astype(jnp.float32)`` as
    ``mean(x²) − mean(x)²``, a difference of float32 sums that cancels. That
    rounding, which XLA's reductions and PyTorch's make in different orders,
    is where the two float32 train-mode forwards part: measured at 4 x 256
    points, 4e-5 at SA1's output and 6e-4 at the logits, whether the rest runs
    in float32 or float64, against 1e-12 at the logits once the statistics are
    float64 too. So for the span of this context the ``jnp`` that the layers
    module sees answers ``float64`` for ``float32``.
    """
    import pointnet2_tpu.nn.layers as jax_layers

    class _Float64Jnp:
        float32 = jnp.float64

        def __getattr__(self, name):
            return getattr(jnp, name)

    patch = pytest.MonkeyPatch()
    patch.setattr(jax_layers, "jnp", _Float64Jnp())
    try:
        with jax.enable_x64(True):
            yield
    finally:
        patch.undo()


def to_float64(tree):
    """A pytree of arrays as float64 jax arrays (integers stay as they are)."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64) if np.issubdtype(np.asarray(a).dtype, np.floating) else jnp.asarray(a),
        tree,
    )


SMALL = dict(
    num_point=512,
    l1_npoint=128, l2_npoint=32, l3_npoint=16, l4_npoint=8,
    l1_nsample=8, l2_nsample=8, l3_nsample=8, l4_nsample=8,
)


def _cloud(seed, b, n, use_color):
    rng = np.random.RandomState(seed)
    x = np.zeros((b, n, 3 + 3 * use_color), np.float32)
    x[..., :3] = rng.rand(b, n, 3) * [8.0, 8.0, 4.9]
    if use_color:
        x[..., 3:] = rng.rand(b, n, 3)
    return x


def _jax_logits(cfg_kw, use_color, variables, x):
    model = JaxSemSeg(
        num_classes=9, use_color=bool(use_color),
        config=JaxConfig(use_color=use_color, **cfg_kw), ops_impl="xla",
    )
    with jax.default_matmul_precision("highest"):
        out = model.apply(variables, jnp.asarray(x), train=False, bn_momentum=0.9)
    return np.asarray(out)


@pytest.mark.parametrize("use_color", [1, 0])
def test_eval_logits_match_jax(use_color):
    cfg = Config(use_color=use_color, **SMALL)
    variables = convert.init_variables(cfg, num_classes=9, seed=3)
    x = _cloud(7, 2, cfg.num_point, use_color)
    want = _jax_logits(SMALL, use_color, variables, x)

    model = PointNet2SemSeg(cfg, num_classes=9, use_color=bool(use_color)).eval()
    model.load_state_dict(convert.from_flax_variables(variables))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()

    assert got.shape == (2, cfg.num_point, 9)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("use_color", [1, 0])
def test_init_variables_has_the_flax_tree(use_color):
    cfg = Config(use_color=use_color, **SMALL)
    model = JaxSemSeg(
        num_classes=9, use_color=bool(use_color),
        config=JaxConfig(use_color=use_color, **SMALL), ops_impl="xla",
    )
    ref = model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.num_point, cfg.point_dim)), train=False
    )
    want = {k: v.shape for k, v in flatten_dict(jax.tree_util.tree_map(np.asarray, ref)).items()}
    got = {k: v.shape for k, v in flatten_dict(convert.init_variables(cfg, 9, 0)).items()}
    assert got == want


def test_init_variables_is_seeded_and_nontrivial():
    cfg = Config(**SMALL)
    a = flatten_dict(convert.init_variables(cfg, 9, 0))
    b = flatten_dict(convert.init_variables(cfg, 9, 0))
    c = flatten_dict(convert.init_variables(cfg, 9, 1))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a[("params", "sa1", "w0")], c[("params", "sa1", "w0")])
    mean = a[("batch_stats", "sa2", "bn0", "mean")]
    var = a[("batch_stats", "sa2", "bn0", "var")]
    assert np.abs(mean).max() > 0 and np.abs(var - 1).max() > 0
    assert all(v.dtype == np.float32 for v in a.values())


def test_converter_uses_every_leaf_of_model_init():
    """Every leaf of the real flax tree lands in the state_dict exactly once."""
    model = JaxSemSeg(
        num_classes=5, use_color=True, config=JaxConfig(**SMALL), ops_impl="xla"
    )
    ref = jax.tree_util.tree_map(
        np.asarray,
        model.init(jax.random.PRNGKey(1), jnp.zeros((1, 512, 6)), train=False),
    )
    sd = convert.from_flax_variables(ref)
    flat = flatten_dict(ref)
    assert len(sd) == len(flat)
    np.testing.assert_array_equal(sd["fc2.weight"].numpy(), flat[("params", "fc2", "kernel")].T)
    np.testing.assert_array_equal(sd["sa1.w0"].numpy(), flat[("params", "sa1", "w0")])
    np.testing.assert_array_equal(
        sd["fp4.mlp.bn_2.var"].numpy(), flat[("batch_stats", "fp4", "mlp", "bn_2", "var")]
    )
    PointNet2SemSeg(num_classes=5).load_state_dict(sd)  # strict: same key set


def test_converter_raises_on_a_leftover_leaf():
    variables = convert.init_variables(Config(**SMALL), 9, 0)
    variables["params"]["fc2"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unused"):
        convert.from_flax_variables(variables)


def test_converter_raises_on_a_missing_leaf():
    variables = convert.init_variables(Config(**SMALL), 9, 0)
    del variables["batch_stats"]["sa3"]["mlp_rest"]["bn_1"]["var"]
    with pytest.raises(KeyError, match="lack"):
        convert.from_flax_variables(variables)


def test_converter_raises_on_a_wrong_shape():
    variables = convert.init_variables(Config(**SMALL), 9, 0)
    variables["params"]["fp2"]["mlp"]["dense_1"]["bias"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert.from_flax_variables(variables)


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_predictor_chunking_gives_the_same_result(chunk):
    """Chunks of 1 and 2 split the batch of 4; 3 does not divide it and runs whole."""
    cfg = Config(**SMALL).replace(num_point=256)
    sd = convert.from_flax_variables(convert.init_variables(cfg, 9, 0))
    x = _cloud(11, 4, 256, 1)
    whole = Predictor(cfg, sd, infer_chunk=0, device="cpu")
    chunked = Predictor(cfg, sd, infer_chunk=chunk, device="cpu")
    want = whole.infer_logits(x)
    got = chunked.infer_logits(x)
    assert got.shape == (4, 256, 9)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    labels = chunked.predict_step(x)
    assert labels.dtype == torch.int32 and labels.shape == (4, 256)
    np.testing.assert_array_equal(labels.numpy(), want.argmax(-1).numpy())


def test_predictor_matches_the_jax_trainer_forward():
    """Predictor against Trainer._infer_logits (chunked) on the same weights."""
    from pointnet2_tpu.train.trainer import Trainer

    cfg = Config(**SMALL).replace(num_point=256)
    jcfg = JaxConfig(**{**SMALL, "num_point": 256})
    variables = convert.init_variables(cfg, 9, 5)
    x = _cloud(13, 4, 256, 1)
    trainer = Trainer(cfg=jcfg, ops_impl="xla", infer_chunk=2)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(trainer._infer_logits(
            _state(trainer, variables), jnp.asarray(x)
        ))
    got = Predictor(cfg, convert.from_flax_variables(variables), infer_chunk=2, device="cpu")
    np.testing.assert_allclose(got.infer_logits(x).numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got.predict_step(x).numpy(), want.argmax(-1))


def _state(trainer, variables):
    state = trainer.init_state(jax.random.PRNGKey(0))
    return state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
    )


def test_predictor_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(**SMALL)
    sd = convert.from_flax_variables(convert.init_variables(cfg, 9, 0))
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(cfg, sd)


def test_config_reads_the_repo_json_files():
    root = pathlib.Path(__file__).resolve().parents[1]
    for name, color in (("semantic.json", 1), ("semantic_no_color.json", 0)):
        cfg = Config.from_json(root / name)
        ref = JaxConfig.from_json(root / name)
        assert cfg.use_color == color
        assert cfg.sa_layers == tuple(
            type(cfg.sa_layers[0])(s.npoint, s.radius, s.nsample) for s in ref.sa_layers
        )
        assert cfg.point_dim == ref.point_dim and cfg.num_point == ref.num_point


# -- train-mode forward, geometry, loss ---------------------------------------


def test_the_suite_keeps_off_the_shared_compilation_cache():
    """What subprocess CLIs inherit, and what this process itself runs with."""
    assert os.environ["JAX_ENABLE_COMPILATION_CACHE"] == "false"
    assert os.environ["JAX_COMPILATION_CACHE_DIR"] == _CACHE_DIR and os.path.isdir(_CACHE_DIR)
    assert not jax.config.jax_enable_compilation_cache


def test_train_logits_match_jax(monkeypatch):
    """Train mode, dropout off: batch statistics and the leaf path of SA1.
    In float64 on both sides (``jax_float64``) the logits agree within 1e-9
    (measured 1e-12). In float32 they are held to atol 2e-3 only: the batch
    variance as a difference of float32 sums is about 1e-5 relative off per
    layer and the two sides round it differently, 6e-4 at the logits."""
    import flax.linen

    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    cfg = Config(**SMALL).replace(num_point=256)
    variables = convert.init_variables(cfg, num_classes=9, seed=3)
    x = _cloud(8, 4, 256, 1)
    model = JaxSemSeg(num_classes=9, config=JaxConfig(**{**SMALL, "num_point": 256}), ops_impl="xla")
    with jax.default_matmul_precision("highest"):
        want, _ = jax.jit(lambda v, p: model.apply(
            v, p, train=True, bn_momentum=0.5,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"],
        ))(variables, jnp.asarray(x))
    port = PointNet2SemSeg(cfg, dropout_rate=0.0).train()
    port.load_state_dict(convert.from_flax_variables(variables))
    with torch.no_grad():
        got = port(torch.from_numpy(x), bn_momentum=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=1e-4)
    with pytest.raises(ValueError, match="momentum"):
        port(torch.from_numpy(x))
    # Both sides get the float32 neighbour structure, as a float32 run computes
    # it (the JAX 3-NN keeps its distances in float32 whatever its input).
    geometry = precompute_geometry(torch.from_numpy(x), cfg)
    geometry64 = {
        part: tuple({k: v.double() if v.is_floating_point() else v for k, v in level.items()} for level in levels)
        for part, levels in geometry.items()
    }
    with jax_float64(), jax.default_matmul_precision("highest"):
        want64, _ = jax.jit(lambda v, p, g: model.apply(
            v, p, train=True, bn_momentum=0.5, geometry=g,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"],
        ))(
            to_float64(variables), jnp.asarray(x, jnp.float64),
            to_float64(jax.tree_util.tree_map(lambda t: t.numpy(), geometry)),
        )
        want64 = np.asarray(want64)
    assert want64.dtype == np.float64
    port.load_state_dict(convert.from_flax_variables(variables))  # the forward above moved the statistics
    with torch.no_grad():
        got64 = port.double()(torch.from_numpy(x).double(), bn_momentum=0.5, geometry=geometry64)
    np.testing.assert_allclose(got64.numpy(), want64, atol=1e-9, rtol=0)


@pytest.mark.parametrize("input_is_leaf", [True, False])
def test_input_gradient_matches_jax_with_and_without_the_leaf_path(input_is_leaf):
    """Eval mode (moving statistics, so little ReLU-mask noise). As a leaf the
    cloud gets no gradient through SA1 (what is left comes through the deeper
    levels' centroids and FP4's colour skip); otherwise it also goes through
    SA1's grouping scatter and the FPS centroids' scatter-add. Relative L2 <= 1e-3."""
    cfg = Config(**SMALL).replace(num_point=256)
    variables = convert.init_variables(cfg, num_classes=9, seed=4)
    x = _cloud(9, 2, 256, 1)
    cot = np.random.RandomState(1).randn(2, 256, 9).astype(np.float32)
    port = PointNet2SemSeg(cfg, input_is_leaf=input_is_leaf).eval()
    port.load_state_dict(convert.from_flax_variables(variables))
    xt = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(port(xt), (xt,), torch.from_numpy(cot))
    model = JaxSemSeg(
        num_classes=9, config=JaxConfig(**{**SMALL, "num_point": 256}), ops_impl="xla",
        input_is_leaf=input_is_leaf,
    )
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jax.grad(
            lambda p: jnp.sum(model.apply(variables, p, train=False, bn_momentum=0.9) * cot)
        ))(jnp.asarray(x)))
    err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert err <= 1e-3, err
    if not input_is_leaf:
        leaf = PointNet2SemSeg(cfg, input_is_leaf=True).eval()
        leaf.load_state_dict(convert.from_flax_variables(variables))
        (dropped,) = torch.autograd.grad(leaf(xt), (xt,), torch.from_numpy(cot))
        assert not torch.allclose(dropped, got, atol=1e-3)  # SA1's share of the gradient


def test_precompute_geometry_matches_jax_and_the_inline_forward():
    cfg = Config(**SMALL).replace(num_point=256)
    x = _cloud(10, 3, 256, 1)
    want, ok = jax_precompute_geometry(
        jnp.asarray(x), config=JaxConfig(**{**SMALL, "num_point": 256}), ops_impl="xla"
    )
    got = precompute_geometry(torch.from_numpy(x), cfg)
    assert bool(ok) and set(got) == {"sa", "fp"} and len(got["sa"]) == len(got["fp"]) == 4
    for level, ref in zip(got["sa"], want["sa"]):
        np.testing.assert_array_equal(level["new_xyz"].numpy(), np.asarray(ref["new_xyz"]))
        np.testing.assert_array_equal(level["idx"].numpy(), np.asarray(ref["idx"]))
    for level, ref in zip(got["fp"], want["fp"]):
        np.testing.assert_array_equal(level["idx"].numpy(), np.asarray(ref["idx"]))
        np.testing.assert_allclose(level["dist2"].numpy(), np.asarray(ref["dist2"]), rtol=1e-5, atol=1e-6)
    model = PointNet2SemSeg(cfg).eval()
    model.load_state_dict(convert.from_flax_variables(convert.init_variables(cfg, 9, 0)))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        assert torch.equal(model(xt, geometry=got), model(xt))


def _loss_inputs(seed, b=3, n=50, c=9, zero_weights=False):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, n, c) * 3).astype(np.float32)
    labels = rng.randint(0, c, (b, n)).astype(np.int32)
    weights = rng.rand(b, n).astype(np.float32)
    weights[rng.rand(b, n) < 0.3] = 0.0
    if zero_weights:
        weights[:] = 0.0
    return logits, labels, weights


@pytest.mark.parametrize("zero_weights", [False, True])
def test_weighted_ce_matches_jax(zero_weights):
    """Values rtol 1e-6; logit gradients atol 1e-7 (they are about 1/count).
    With all weights zero the loss and its gradient are zero, not NaN."""
    logits, labels, weights = _loss_inputs(0, zero_weights=zero_weights)
    want_sum, want_count = jax_weighted_ce_sum(logits, labels, weights)
    want_loss, want_grad = jax.value_and_grad(jax_weighted_ce_loss)(jnp.asarray(logits), labels, weights)
    lt = torch.from_numpy(logits).requires_grad_()
    total, count = weighted_ce_sum(lt, torch.from_numpy(labels), torch.from_numpy(weights))
    loss = weighted_ce_loss(lt, torch.from_numpy(labels), torch.from_numpy(weights))
    assert total.dtype == count.dtype == torch.float32 and count.dim() == 0
    np.testing.assert_allclose(float(total.detach()), float(want_sum), rtol=1e-6)
    assert float(count) == float(want_count) == np.count_nonzero(weights)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-6)
    loss.backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_grad), atol=1e-7, rtol=1e-5)
    assert np.isfinite(lt.grad.numpy()).all()
