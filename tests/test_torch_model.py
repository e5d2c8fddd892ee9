"""The port's PointNet2SemSeg, converter and Predictor against the JAX package.

Both sides get the same seeded numpy inputs and the same weights: the flax
variables are made by ``convert.init_variables`` (flax layout) and handed to
the JAX model as they are and to the port through ``from_flax_variables``.

Tolerances: eval logits agree within atol=1e-4, rtol=1e-4 and their argmax
is equal. The geometry (FPS, ball query, 3-NN) is the same bit for bit on
both sides; the float32 matmuls of XLA's CPU backend and of PyTorch sum in
different orders, which leaves about 1e-6 relative after the 12 layers.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pointnet2_tpu.config import Config as JaxConfig
from pointnet2_tpu.models.pointnet2_seg import PointNet2SemSeg as JaxSemSeg
from pointnet2_tpu_torch import convert
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.infer import Predictor
from pointnet2_tpu_torch.models.pointnet2_seg import PointNet2SemSeg

# The JAX CLIs that the suite runs in-process turn on JAX's persistent
# compilation cache (pointnet2_tpu/utils/runtime.py), which lives under $HOME
# and outlives the run. With entries left by an earlier run, the Pallas
# interpret-mode model test of tests/test_wingather.py deadlocked in a worker
# that had run a CLI test before it (3 runs of 3 with a populated cache; with
# the cache empty or disabled, 2 runs of 2 passed). Every pytest-xdist worker
# imports this module while collecting, before anything is compiled, so this
# keeps the whole run off the on-disk cache.
jax.config.update("jax_enable_compilation_cache", False)

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
