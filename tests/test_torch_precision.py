"""The bf16 precision modes of the port against the JAX package, on the CPU.

Every tolerance is a multiple of bfloat16's unit roundoff u = 2**-8 (8 bits
of significand: one rounding moves a value by at most u of itself):

- **three_interpolate in bfloat16.** The port widens the three rows to
  float32, multiplies by the float32 weights (rounded to bfloat16 first
  under ``"default"``), sums in float32 and rounds once. Against the Pallas
  kernel in interpret mode (a float32 product, rounded once; on the CPU its
  ``"default"`` does not round the weights) an element may differ by the
  two final roundings and the weights' rounding: 3u of ``S = sum_j w_j
  |p_j|``, held at 4u S. Against XLA's gather form, which under
  ``"default"`` multiplies and adds in bfloat16 (a rounding a product and a
  sum), 6u S.
- **Its backward** sums ``w * g`` over the pairs naming a row; ``S`` is the
  sum of ``|w g|`` there and ``k`` the pairs' count. Against the Pallas
  backward (float32, rounded once): 4u S. Against ``jax.vjp`` of the XLA
  form, which rounds each product to bfloat16 and scatter-adds in bfloat16:
  (2k + 3) u S.
- **fold_batch_norm**: the same float32 formula on both sides, rtol 4e-7 (a
  few float32 ulps, rsqrt's own included); the folded float32 eval forward
  equals the unfolded within JAX's own atol 2e-3, rtol 1e-3
  (``tests/test_model.py:350-380``).
- **The model** at a small config: bfloat16 logits of the port and of JAX
  are two evaluations of one float32 function, each with its own roundings
  (measured: each about 2.6u of the logits' scale from its float32 logits,
  and as far from each other). Held at 8u of the scale, and the port's own
  bfloat16 error to at most twice JAX's. JAX's invariants hold in the port
  exactly: a threshold above every width equals float32 bit for bit,
  threshold 0 equals uniform bfloat16 bit for bit, and 128 differs from both
  with an error at most 1.5 times uniform's (``tests/test_model.py:398-445``).
- **The Trainer**: a first bfloat16 step's loss within 5 % of the float32
  step's and its parameters within 5 % relative L2 (JAX's own bound,
  ``tests/test_train.py:150-172``), on both sides; the loss falls over 8
  steps with float32 master weights, statistics and Adam moments; bfloat16
  labels after 3 steps agree with float32 ones on more than 80 % of points
  (``tests/test_model.py:381-388``).
- **The flags**: each option and flag that once raised ``NotImplementedError``
  reaches the Trainer or the Predictor, and each invalid combination raises
  the JAX Trainer's ``ValueError``; the CLIs run on the CPU with the bf16
  flags.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.experimental.pallas import tpu as pltpu

from pointnet2_tpu.config import Config as JaxConfig
from pointnet2_tpu.models.pointnet2_seg import PointNet2SemSeg as JaxSemSeg
from pointnet2_tpu.nn.fold import fold_batch_norm as jax_fold_batch_norm
from pointnet2_tpu.ops import core as jcore
from pointnet2_tpu.ops import reference
from pointnet2_tpu.ops.pallas import three_interpolate_pallas
from pointnet2_tpu.train.trainer import Trainer as JaxTrainer
from pointnet2_tpu_torch import convert, ops
from pointnet2_tpu_torch.cli import predict as cli_predict
from pointnet2_tpu_torch.cli import train as cli_train
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.infer import Predictor, chunked_logits
from pointnet2_tpu_torch.models import PointNet2SemSeg
from pointnet2_tpu_torch.nn.fold import fold_batch_norm
from pointnet2_tpu_torch.ops import core
from pointnet2_tpu_torch.train import Trainer, load_model_state
from test_torch_cli import _write_config, scenes  # noqa: F401  (scenes is a fixture)
from test_torch_model import SMALL as MODEL_SMALL
from test_torch_model import _cloud
from test_torch_train import _jax_state, _jax_trainer, _jnp, _tree

U = 2.0**-8  # bfloat16's unit roundoff
BF16 = torch.bfloat16
TINY = dict(
    num_point=128, batch_size=8, l1_npoint=32, l2_npoint=16, l3_npoint=8, l4_npoint=4,
    l1_radius=0.3, l2_radius=0.6, l3_radius=1.2, l4_radius=2.4,
    l1_nsample=8, l2_nsample=8, l3_nsample=8, l4_nsample=8,
)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16_values(rng, *shape) -> np.ndarray:
    """float32 values that bfloat16 holds exactly: the same numbers on both sides."""
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(BF16).float().numpy()


def _interp_inputs(seed, b, m, n, c):
    rng = np.random.RandomState(seed)
    points = _bf16_values(rng, b, m, c)
    dense = (rng.rand(b, n, 3) * 2.0).astype(np.float32)
    coarse = (rng.rand(b, m, 3) * 2.0).astype(np.float32)
    dist, idx = reference.three_nn_np(dense, coarse)
    weight = reference.interpolation_weights_np(dist).astype(np.float32)
    return points, idx, weight


def _blend_scale(points, idx, weight):
    """``sum_j w_j |p_j|`` of every output element, in float64."""
    return core.three_interpolate(_t(np.abs(points)).double(), _t(idx), _t(weight).double()).numpy()


def _assert_within(got, want, bound, what):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    worst = float((err - bound).max())
    assert worst <= 0.0, f"{what}: an element off by {worst} more than its bound"


# ---------------------------------------------------------------------------
# three_interpolate, its concat and its backward in bfloat16
# ---------------------------------------------------------------------------


INTERP_SHAPES = [(2, 64, 256, 32), (1, 100, 37, 130)]


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("b,m,n,c", INTERP_SHAPES)
def test_three_interpolate_bf16_matches_jax(precision, b, m, n, c):
    points, idx, weight = _interp_inputs(5, b, m, n, c)
    got = ops.three_interpolate(_t(points).to(BF16), _t(idx), _t(weight), precision=precision)
    assert got.dtype == BF16 and got.shape == (b, n, c)
    got = got.float().numpy()
    jpoints = jnp.asarray(points).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        pallas = three_interpolate_pallas(jpoints, jnp.asarray(idx), jnp.asarray(weight), precision)
    xla = jcore.three_interpolate(jpoints, jnp.asarray(idx), jnp.asarray(weight), precision)
    assert pallas.dtype == xla.dtype == jnp.bfloat16
    scale = _blend_scale(points, idx, weight)
    _assert_within(got, np.asarray(pallas, np.float32), 4 * U * scale, "against Pallas")
    _assert_within(got, np.asarray(xla, np.float32), 6 * U * scale, "against XLA")
    # The arithmetic written out: float32 rows and weights, one rounding.
    w = _t(weight)
    if precision == "default":
        w = w.to(BF16).float()
    rows = core.group_points(_t(points), _t(idx))
    want = (rows[:, :, 0] * w[..., 0:1] + rows[:, :, 1] * w[..., 1:2] + rows[:, :, 2] * w[..., 2:3]).to(BF16)
    np.testing.assert_array_equal(got, want.float().numpy())


@pytest.mark.parametrize("skip_dtype", [torch.bfloat16, torch.float32])
def test_three_interpolate_concat_bf16_promotes_as_jax(skip_dtype):
    """A bfloat16 stage concatenates bfloat16 halves; a selective stage's
    float32 skip makes the row float32 (``jnp.concatenate`` promotes), the
    blend rounded to bfloat16 first and widened exactly."""
    b, m, n, c = 2, 32, 128, 16
    points, idx, weight = _interp_inputs(6, b, m, n, c)
    skip = _t(_bf16_values(np.random.RandomState(1), b, n, 5)).to(skip_dtype)
    for precision in ("highest", "default"):
        got = ops.three_interpolate(_t(points).to(BF16), _t(idx), _t(weight), precision=precision, skip=skip)
        blend = ops.three_interpolate(_t(points).to(BF16), _t(idx), _t(weight), precision=precision)
        assert got.dtype == skip_dtype and got.shape == (b, n, c + 5)
        assert torch.equal(got[..., :c], blend.to(skip_dtype)) and torch.equal(got[..., c:], skip)
        jpoints = jnp.asarray(points).astype(jnp.bfloat16)
        jskip = jnp.asarray(skip.float().numpy()).astype(jnp.bfloat16 if skip_dtype == BF16 else jnp.float32)
        jcat = jnp.concatenate([jcore.three_interpolate(jpoints, jnp.asarray(idx), jnp.asarray(weight), precision),
                                jskip], axis=-1)
        assert str(jcat.dtype) == str(skip_dtype).split(".")[-1]
        scale = np.concatenate([_blend_scale(points, idx, weight), np.zeros((b, n, 5))], -1)
        _assert_within(got.float().numpy(), np.asarray(jcat, np.float32), 6 * U * scale, "against XLA's concat")


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("g_dtype", [torch.bfloat16, torch.float32])
def test_three_interpolate_grad_bf16_matches_jax(precision, g_dtype):
    b, m, n, c = 2, 37, 200, 70
    points, idx, weight = _interp_inputs(7, b, m, n, c)
    g = _bf16_values(np.random.RandomState(2), b, n, c)
    got = core.three_interpolate_grad(_t(g).to(g_dtype), _t(idx), _t(weight), m, precision, BF16)
    assert got.dtype == BF16 and got.shape == (b, m, c)
    got = got.float().numpy()
    jpoints = jnp.asarray(points).astype(jnp.bfloat16)
    jg = jnp.asarray(g).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda p: three_interpolate_pallas(p, jnp.asarray(idx), jnp.asarray(weight), precision),
                         jpoints)
        pallas = vjp(jg)[0]
    _, vjp = jax.vjp(lambda p: jcore.three_interpolate(p, jnp.asarray(idx), jnp.asarray(weight), precision), jpoints)
    xla = vjp(jg)[0]
    assert pallas.dtype == xla.dtype == jnp.bfloat16
    abs_sum = core.three_interpolate_grad(_t(np.abs(g)).double(), _t(idx), _t(weight).double(), m).numpy()
    count = core.three_interpolate_grad(torch.ones(b, n, 1, dtype=torch.float64), _t(idx),
                                        torch.ones(b, n, 3, dtype=torch.float64), m).numpy()
    _assert_within(got, np.asarray(pallas, np.float32), 4 * U * abs_sum, "against the Pallas backward")
    _assert_within(got, np.asarray(xla, np.float32), (2 * count + 3) * U * abs_sum, "against jax.vjp of XLA")


def test_three_interpolate_function_bf16_gradients_keep_their_types():
    """Behind autograd: dpoints in the points' type (the plain backward at the
    forward's precision), dweight in the weights', the skip's slice in the skip's."""
    b, m, n, c = 2, 32, 96, 24
    points, idx, weight = _interp_inputs(8, b, m, n, c)
    p = _t(points).to(BF16).requires_grad_()
    w = _t(weight).requires_grad_()
    skip = torch.rand(b, n, 3).to(BF16).requires_grad_()
    out = ops.three_interpolate(p, _t(idx), w, precision="default", skip=skip)
    assert out.dtype == BF16
    cot = torch.randn(b, n, c + 3, generator=torch.Generator().manual_seed(0)).to(BF16)
    dp, dw, ds = torch.autograd.grad(out, (p, w, skip), cot)
    assert (dp.dtype, dw.dtype, ds.dtype) == (BF16, torch.float32, BF16)
    assert torch.equal(dp, core.three_interpolate_grad(cot[..., :c], _t(idx), _t(weight), m, "default", BF16))
    assert torch.equal(ds, cot[..., c:])


def test_three_interpolate_rejects_an_unknown_precision():
    points, idx, weight = _interp_inputs(9, 1, 8, 16, 4)
    with pytest.raises(ValueError, match="precision"):
        ops.three_interpolate(_t(points), _t(idx), _t(weight), precision="fast")


def test_op_bench_counts_two_bytes_a_bfloat16_feature():
    from pointnet2_tpu_torch.tools import op_bench

    b, n, m, c, c1 = 16, 8192, 1024, 128, 3
    f32, bf16 = op_bench.work_fp_interpolate(b, n, m, c, c1), op_bench.work_fp_interpolate(b, n, m, c, c1, elem=2)
    assert f32[0] - bf16[0] == 2 * (b * m * c + b * n * c1 + b * n * (c + c1)) and f32[1] == bf16[1]
    f32, bf16 = op_bench.work_three_interpolate_grad(b, n, m, c), op_bench.work_three_interpolate_grad(b, n, m, c, 2)
    assert f32[0] - bf16[0] == 2 * (b * n * c + b * m * c) and f32[1] == bf16[1]
    rows = op_bench.run(torch.device("cpu"), small=True, dtype="bfloat16")
    kernels = {r["kernel"] for r in rows if r["op"].startswith("three_interpolate")}
    assert kernels == {"three_interpolate_bf16", "three_interpolate_grad_bf16"}


# ---------------------------------------------------------------------------
# BatchNorm folding
# ---------------------------------------------------------------------------


def test_fold_batch_norm_matches_jax():
    cfg = Config(**MODEL_SMALL)
    variables = convert.init_variables(cfg, 9, seed=4, bn_stats="random")
    state = convert.from_flax_variables(variables)
    got = fold_batch_norm(state)
    fp, fs = jax_fold_batch_norm(variables["params"], variables["batch_stats"])
    want = convert.from_flax_variables({"params": jax.tree_util.tree_map(np.asarray, dict(fp)),
                                        "batch_stats": jax.tree_util.tree_map(np.asarray, dict(fs))})
    assert set(got) == set(want) == set(state)
    for key, value in want.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=4e-7, atol=1e-7, err_msg=key)
    # Every BatchNorm is an exact identity now; the input is untouched.
    for key in (k for k in got if k.endswith(".var")):
        assert torch.equal(got[key] + 1e-3, torch.ones_like(got[key]))
    assert not torch.equal(state["sa1.bn0.mean"], got["sa1.bn0.mean"])


def test_fold_batch_norm_raises_on_an_unmatched_batch_norm():
    state = convert.from_flax_variables(convert.init_variables(Config(**MODEL_SMALL), 9, seed=0))
    for part in ("scale", "bias", "mean", "var"):
        state[f"stray_bn.{part}"] = torch.ones(4)
    with pytest.raises(ValueError, match="stray_bn"):
        fold_batch_norm(state)


def test_folded_eval_forward_equals_the_unfolded_one():
    cfg = Config(**MODEL_SMALL)
    state = convert.from_flax_variables(convert.init_variables(cfg, 9, seed=5, bn_stats="random"))
    x = torch.from_numpy(_cloud(3, 2, cfg.num_point, 1))
    model = PointNet2SemSeg(cfg).eval()
    with torch.no_grad():
        model.load_state_dict(state)
        plain = model(x)
        model.load_state_dict(fold_batch_norm(state))
        folded = model(x)
    np.testing.assert_allclose(folded.numpy(), plain.numpy(), atol=2e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# The model's modes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_logits():
    """Eval logits of the port and of JAX at the small config, float32 and
    every mode, from the same weights (moving statistics that do real work)."""
    cfg = Config(**MODEL_SMALL)
    variables = convert.init_variables(cfg, 9, seed=3, bn_stats="random")
    x = _cloud(7, 2, cfg.num_point, 1)
    model = PointNet2SemSeg(cfg).eval()
    model.load_state_dict(convert.from_flax_variables(variables))

    def jax_logits(**kw):
        jm = JaxSemSeg(num_classes=9, config=JaxConfig(**MODEL_SMALL), ops_impl="xla", **kw)
        return np.asarray(jm.apply(variables, jnp.asarray(x), train=False, bn_momentum=0.9))

    out = {"f32": (model(torch.from_numpy(x)).detach().numpy(), jax_logits())}
    for width in (None, 0, 128, 10000):
        port = model.with_precision(BF16, width).eval()
        with torch.no_grad():
            got = port(torch.from_numpy(x))
        assert got.dtype == torch.float32
        out[width] = (got.numpy(), jax_logits(compute_dtype=jnp.bfloat16, compute_dtype_min_width=width))
    return out


@pytest.mark.parametrize("width", [None, 0, 128, 10000])
def test_model_modes_match_jax(model_logits, width):
    port, want = model_logits[width]
    port32, want32 = model_logits["f32"]
    scale = float(np.abs(want32).max())
    assert float(np.abs(port - want).max()) <= 8 * U * scale
    assert float(np.abs(port - port32).max()) <= 2 * float(np.abs(want - want32).max()) + 1e-4
    assert (port.argmax(-1) == want.argmax(-1)).mean() >= 0.98


def test_model_mode_invariants(model_logits):
    """JAX's own: above every width is float32, 0 is uniform bfloat16, 128 is between."""
    f32, uniform, selective = model_logits["f32"][0], model_logits[None][0], model_logits[128][0]
    np.testing.assert_array_equal(model_logits[10000][0], f32)
    np.testing.assert_array_equal(model_logits[0][0], uniform)
    assert not np.array_equal(selective, f32) and not np.array_equal(selective, uniform)
    assert np.abs(selective - f32).max() <= 1.5 * np.abs(uniform - f32).max()


def test_with_precision_shares_the_weights_and_sets_the_stages():
    model = PointNet2SemSeg(Config(**MODEL_SMALL))
    selective = model.with_precision(BF16, 128)
    assert selective.sa1.w0 is model.sa1.w0 and selective.fc1_bn.mean is model.fc1_bn.mean
    assert [getattr(selective, f"sa{i}").compute_dtype for i in range(1, 5)] == [None, None, BF16, BF16]
    assert [getattr(selective, f"fp{i}").compute_dtype for i in range(1, 5)] == [BF16] * 4
    assert selective.fc1_dtype == BF16 and selective.sa3.mlp_rest.dtype == BF16
    assert model.sa3.compute_dtype is None and model.fc1_dtype is None


# ---------------------------------------------------------------------------
# The Trainer in bfloat16, beside the JAX Trainer
# ---------------------------------------------------------------------------


def _toy_batch(seed, b=8, n=128):
    """JAX's separable toy task (``tests/test_train.py``): the class follows the height."""
    pts = np.random.RandomState(seed).rand(b, n, 6).astype(np.float32)
    return {"points": pts, "labels": 1 + (pts[:, :, 2] > 0.5).astype(np.int32),
            "weights": np.ones((b, n), np.float32)}


def _rel_l2(a: dict, b: dict) -> float:
    keys = [k for k in b if k[0] == "params"]
    diff = sum(float(np.sum((np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64)) ** 2)) for k in keys)
    norm = sum(float(np.sum(np.asarray(b[k], np.float64) ** 2)) for k in keys)
    return (diff / max(norm, 1e-30)) ** 0.5


@pytest.fixture(scope="module")
def first_steps():
    """One dropout-free Adam step from the same weights and batch: the port
    in float32 and bfloat16, the JAX trainer in bfloat16."""
    cfg = Config(**TINY)
    variables = convert.init_variables(cfg, 9, seed=0)
    batch = _toy_batch(0)
    out = {}
    for dtype in ("float32", "bfloat16"):
        port = Trainer(cfg, device="cpu", dropout_rate=0.0, train_dtype=dtype)
        port.load_variables(variables)
        before = _tree(port)
        out[dtype] = (float(port.train_step(batch)["loss"]), _tree(port))
    jt, patch = _jax_trainer(cfg=JaxConfig(**TINY), train_dtype="bfloat16")
    try:
        state, metrics = jt.train_step(_jax_state(jt, before), _jnp(batch), jax.random.PRNGKey(1))
    finally:
        patch.undo()
    out["jax"] = (float(metrics["loss"]), flatten_dict(jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats})))
    return out


@pytest.mark.parametrize("against", ["float32", "jax"])
def test_first_bf16_step_tracks(first_steps, against):
    loss, params = first_steps["bfloat16"]
    want_loss, want_params = first_steps[against]
    assert loss == pytest.approx(want_loss, rel=0.05)
    assert _rel_l2(params, want_params) < 0.05


def test_bf16_training_keeps_float32_state_and_learns():
    trainer = Trainer(Config(**TINY), device="cpu", train_dtype="bfloat16", bf16_min_width=128)
    trainer.init_state(0)
    batch = _toy_batch(1)
    losses = [float(trainer.train_step(batch, generator=torch.Generator().manual_seed(1))["loss"])
              for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in trainer.model.parameters())
    assert all(b.dtype == torch.float32 for b in trainer.model.buffers())
    for state in trainer.optimizer.state.values():
        assert all(v.dtype == torch.float32 for v in state.values() if torch.is_tensor(v) and v.is_floating_point())


@pytest.mark.parametrize("hoist", [True, False])
def test_bf16_accumulation_runs_and_learns(hoist):
    """JAX's ``test_accum_path_runs_bf16`` and ``test_hoist_loss_decreases_bf16``."""
    cfg = Config(**TINY)
    trainer = Trainer(cfg, device="cpu", train_dtype="bfloat16", accum_steps=4, hoist_geometry=hoist)
    trainer.init_state(0)
    batch = _toy_batch(2)
    first = trainer.train_step(batch)
    assert int(first["confusion"].sum()) == cfg.batch_size * cfg.num_point
    for _ in range(11):
        last = trainer.train_step(batch)
    assert np.isfinite(float(first["loss"])) and float(last["loss"]) < 0.9 * float(first["loss"])


def test_bf16_predict_after_training_agrees_with_float32_and_jax():
    cfg = Config(**TINY)
    trainer = Trainer(cfg, device="cpu", infer_dtype="bfloat16")
    trainer.init_state(0)
    batch = _toy_batch(3, b=4)
    for _ in range(3):
        trainer.train_step(batch)
    labels16, ok = trainer.predict_step_checked(batch["points"])
    assert bool(ok) and labels16.dtype == torch.int32
    labels32 = chunked_logits(trainer.model.eval(), torch.from_numpy(batch["points"]), 8).argmax(-1)
    assert (labels16 == labels32).float().mean() > 0.8
    # The Predictor folds once at construction; the Trainer folds each call: the same logits.
    predictor = Predictor(cfg, trainer.model.state_dict(), device="cpu", dtype="bfloat16")
    with torch.no_grad():
        logits = chunked_logits(trainer.infer_forward(), torch.from_numpy(batch["points"]), 8)
    assert torch.equal(predictor.infer_logits(batch["points"]), logits)
    jt = JaxTrainer(cfg=JaxConfig(**TINY), ops_impl="xla", infer_dtype="bfloat16")
    jax_labels = np.asarray(jt.predict_step(_jax_state(jt, _tree(trainer)), jnp.asarray(batch["points"])))
    assert (labels16.numpy() == jax_labels).mean() > 0.8


# ---------------------------------------------------------------------------
# The options and flags that once raised, and the combinations that must
# ---------------------------------------------------------------------------


def _stage_dtypes(model) -> list:
    return [getattr(model, f"{s}{i}").compute_dtype for s in ("sa", "fp") for i in range(1, 5)] + [model.fc1_dtype]


_SELECTIVE = [None, None, BF16, BF16] + [BF16] * 5


def _trainer_case(kw, infer, train):
    def check(tmp_path, scenes, monkeypatch):
        port = Trainer(Config(**TINY), device="cpu", **kw)
        jt = JaxTrainer(cfg=JaxConfig(**TINY), **kw)
        for model, stages, jmodel in ((port.infer_model, infer, jt.infer_model),
                                      (port.train_model, train, jt.train_model)):
            assert _stage_dtypes(model) == stages
            assert (jmodel is jt.model) == (model is port.model)
        assert all(p.dtype == torch.float32 for p in port.model.parameters())
    return check


def _raises(kw, match):
    def check(tmp_path, scenes, monkeypatch):
        for make in (lambda: Trainer(Config(**TINY), device="cpu", **kw), lambda: JaxTrainer(cfg=JaxConfig(**TINY), **kw)):
            with pytest.raises(ValueError, match=match):
                make()
    return check


def _spy(monkeypatch, module, name):
    seen = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        seen.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return seen


def _cli_train(flags, want):
    def check(tmp_path, scenes, monkeypatch):
        seen = _spy(monkeypatch, cli_train, "Trainer")
        cfg = _write_config(tmp_path / "cfg.json", data_path=str(scenes), logdir=str(tmp_path / "log"))
        summary = cli_train.main(["--config_file", cfg, "--seed", "0", "--device", "cpu", *flags])
        assert {k: seen[0][k] for k in want} == want
        state = load_model_state(tmp_path / "log" / "model.pt")
        assert summary["step"] > 0 and all(v.dtype == torch.float32 for v in state.values())
    return check


def _cli_predict(flags, want):
    def check(tmp_path, scenes, monkeypatch):
        cfg = _write_config(tmp_path / "cfg.json", data_path=str(scenes), logdir=str(tmp_path / "log"))
        trainer = Trainer(Config.from_json(cfg), device="cpu")
        trainer.init_state(0, bn_stats="random")
        from pointnet2_tpu_torch.train import save_checkpoint

        save_checkpoint(tmp_path / "model.pt", trainer)
        seen = _spy(monkeypatch, cli_predict, "Predictor")
        summary = cli_predict.main(["--ckpt", str(tmp_path / "model.pt"), "--config_file", cfg, "--device", "cpu",
                                    "--num_samples", "2", "--batch_size", "2",
                                    "--output_dir", str(tmp_path / "out"), *flags])
        assert {k: seen[0][k] for k in want} == want and summary["samples"] > 0
    return check


def _cli_raises(main, flags):
    def check(tmp_path, scenes, monkeypatch):
        cfg = _write_config(tmp_path / "cfg.json", data_path=str(scenes), logdir=str(tmp_path / "log"))
        argv = ["--config_file", cfg, "--device", "cpu", *flags]
        if main is cli_predict.main:
            argv += ["--ckpt", str(tmp_path / "unused.pt")]
        with pytest.raises(ValueError, match="bf16_min_width"):
            main(argv)
    return check


def _predictor_raises(kw, match):
    def check(tmp_path, scenes, monkeypatch):
        state = convert.from_flax_variables(convert.init_variables(Config(**TINY), 9, seed=0))
        with pytest.raises(ValueError, match=match):
            Predictor(Config(**TINY), state, device="cpu", **kw)
    return check


_F32 = [None] * 9
_BF16 = [BF16] * 9
PRECISION_CASES = {
    "infer_dtype": _trainer_case({"infer_dtype": "bfloat16"}, _BF16, _F32),
    "train_dtype": _trainer_case({"train_dtype": "bfloat16"}, _F32, _BF16),
    "bf16_min_width with train_dtype": _trainer_case({"train_dtype": "bfloat16", "bf16_min_width": 128}, _F32, _SELECTIVE),
    "bf16_min_width with infer_dtype": _trainer_case({"infer_dtype": "bfloat16", "bf16_min_width": 128}, _SELECTIVE, _F32),
    "infer_dtype with bq_window": _trainer_case({"bq_window": 3072, "infer_dtype": "bfloat16"}, _BF16, _F32),
    "train_dtype with fp_window": _trainer_case(
        {"fp_window": (None, None, None, 256), "train_dtype": "bfloat16"}, _F32, _BF16),
    "bf16_min_width alone": _raises({"bf16_min_width": 128}, "bf16_min_width"),
    "train_dtype float16": _raises({"train_dtype": "float16"}, "train_dtype"),
    "infer_dtype float16": _raises({"infer_dtype": "float16"}, "infer_dtype"),
    "cli.train --train_dtype --bf16_min_width": _cli_train(
        ["--train_dtype", "bfloat16", "--bf16_min_width", "128"], {"train_dtype": "bfloat16", "bf16_min_width": 128}),
    "cli.train --bf16_min_width alone": _cli_raises(cli_train.main, ["--bf16_min_width", "128"]),
    "cli.predict --dtype": _cli_predict(["--dtype", "bfloat16"], {"dtype": "bfloat16", "bf16_min_width": None}),
    "cli.predict --dtype --bf16_min_width": _cli_predict(
        ["--dtype", "bfloat16", "--bf16_min_width", "128"], {"dtype": "bfloat16", "bf16_min_width": 128}),
    "cli.predict --bf16_min_width alone": _cli_raises(cli_predict.main, ["--bf16_min_width", "128"]),
    "Predictor dtype float16": _predictor_raises({"dtype": "float16"}, "dtype"),
    "Predictor bf16_min_width alone": _predictor_raises({"bf16_min_width": 128}, "bf16_min_width"),
}


@pytest.mark.parametrize("case", list(PRECISION_CASES))
def test_precision_flags_reach_the_trainer(case, tmp_path, scenes, monkeypatch):  # noqa: F811
    PRECISION_CASES[case](tmp_path, scenes, monkeypatch)
