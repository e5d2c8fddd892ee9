"""The port's train step against the JAX trainer: the slice as a whole.

Both sides start from one flax variable tree (``convert.init_variables``) and
get the same seeded numpy batches; dropout is off on both (``dropout_rate=0``
in the port, ``flax.linen.Dropout.__call__`` patched to the identity before
the JAX step is traced). Each JAX step is traced once per configuration, in a
module-scoped fixture where several tests read it.

What is held to what, at 4 x 256 points:

- **In float64 on both sides** (``test_torch_model.jax_float64``; the port's
  model made ``double()``), momentum SGD, three steps that run free: every
  step's loss within rtol 1e-6 (the loss itself is float32 on both sides),
  the first step's gradient of every parameter within 1e-6 of its max abs
  (measured 2e-7), parameters after each step within atol 1e-8 (measured
  5e-10), moving statistics within atol 1e-6 (measured 3e-8). The same for
  one ``accum_steps=2`` step. This is the check of the backward: an error of
  a part in a million in any parameter's gradient fails it.
- **In float32**, a step from equal parameters: loss rtol 1e-5, moving
  statistics atol 1e-5 + rtol 1e-5, parameter gradients relative L2 <= 5e-2
  (measured 1-3e-2). No tighter, and the cause is measured, not guessed: the
  JAX BatchNorm takes the batch variance as ``mean(x²) − mean(x)²`` in
  float32, as the port does, and XLA's and PyTorch's reductions round that
  cancelling difference differently, about 1e-5 relative a layer. With the
  statistics alone in float64 the two forwards agree to 1e-12 at the logits;
  with them in float32 they are 4e-5 apart after SA1 and 6e-4 at the logits,
  whatever precision the rest runs in. A pre-activation that moves by 1e-4
  changes sides of the ReLU in a few of every 100 000 elements, and one such
  element moves its channel's gradient by about 1e-3 of its norm.
- Adam cannot be compared by letting both sides run free, not even in
  float64: the update ``m / (sqrt(v) + eps)`` of an element whose gradient
  is rounding noise (the weights behind a unit that is off for the whole
  batch) is ``+-lr`` by the noise's sign. Measured in float64: parameters 9e-6
  apart after one step, 1.6e-3 after two, the loss 1e-4 after three. So the
  three float32 Adam steps run in lockstep: before each step the JAX state
  gets the port's parameters and statistics, every step's loss must agree to
  rtol 1e-5, and the port's update is held to ``optax.adam`` applied to the
  port's own gradients, atol 1e-7 + rtol 1e-6.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pointnet2_tpu.config import Config as JaxConfig
import pointnet2_tpu.train.trainer as jax_trainer_module
from pointnet2_tpu.models import weighted_ce_loss as jax_weighted_ce_loss
from pointnet2_tpu.train.trainer import Trainer as JaxTrainer
from pointnet2_tpu.train.trainer import TrainState
from pointnet2_tpu.train.trainer import bn_momentum_schedule as jax_bn_momentum_schedule
from pointnet2_tpu.train.trainer import learning_rate_schedule as jax_learning_rate_schedule
from pointnet2_tpu.utils.metrics import confusion_matrix_jax
from pointnet2_tpu_torch import convert
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.models import PointNet2SemSeg, weighted_ce_sum
from pointnet2_tpu_torch.train import (
    Trainer,
    bn_momentum_schedule,
    learning_rate_schedule,
    restore_checkpoint,
    save_checkpoint,
)
from pointnet2_tpu_torch.utils.metrics import confusion_matrix
from test_torch_model import jax_float64, to_float64

SMALL = dict(
    num_point=256, batch_size=4,
    l1_npoint=128, l2_npoint=32, l3_npoint=16, l4_npoint=8,
    l1_nsample=8, l2_nsample=8, l3_nsample=8, l4_nsample=8,
)
STEPS = 3
GRAD_REL_L2 = 5e-2


def _batch(seed, b=4, n=256):
    """Clouds in 8 x 8 x 4.9 m with colours, labels in 0..8, weights with a quarter zeros."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((b, n, 6), np.float32)
    pts[..., :3] = rng.rand(b, n, 3) * [8.0, 8.0, 4.9]
    pts[..., 3:] = rng.rand(b, n, 3)
    weights = rng.rand(b, n).astype(np.float32)
    weights[rng.rand(b, n) < 0.25] = 0.0
    return {"points": pts, "labels": rng.randint(0, 9, (b, n)).astype(np.int32), "weights": weights}


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tree(trainer):
    """The port trainer's parameters and statistics as a flat flax tree of numpy arrays."""
    return flatten_dict(convert.to_flax_variables(trainer.model.state_dict()))


def _grads(trainer):
    named = {k: p.grad for k, p in trainer.model.named_parameters()}
    return flatten_dict(convert.to_flax_variables(named)["params"])


def _jax_state(jt, flat):
    tree = _jnp(unflatten_dict(flat))
    return TrainState(
        step=jnp.zeros((), jnp.int32), params=tree["params"],
        batch_stats=tree["batch_stats"], opt_state=jt.tx.init(tree["params"]),
    )


def _jax_trainer(**kw):
    """A JAX trainer whose steps are traced with dropout switched off."""
    patch = pytest.MonkeyPatch()
    patch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    return JaxTrainer(ops_impl="xla", **kw), patch


def _jax_step(jt, state, batch):
    with jax.default_matmul_precision("highest"):
        state, metrics = jt.train_step(state, _jnp(batch), jax.random.PRNGKey(1))
    return state, jax.tree_util.tree_map(np.asarray, metrics)


def _state_tree(state):
    """A JAX train state's parameters and statistics as a flat tree of numpy arrays."""
    return flatten_dict(jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats}
    ))


def _float64_run(steps, seed, first_batch, **trainer_kw):
    """``steps`` free-running momentum-SGD steps in float64 on both sides; a record per step."""
    cfg_kw = dict(SMALL, optimizer="momentum")
    port = Trainer(Config(**cfg_kw), device="cpu", dropout_rate=0.0, **trainer_kw)
    port.load_variables(convert.init_variables(port.cfg, 9, seed=seed, bn_stats="random", arch=port.arch))
    port.model.double()
    jt, patch = _jax_trainer(cfg=JaxConfig(**cfg_kw), **trainer_kw)
    # The accumulation scan carries an int32 confusion matrix; with 64-bit types
    # on, the count comes out int64 and the carry no longer closes.
    patch.setattr(
        jax_trainer_module, "confusion_matrix_jax",
        lambda *args: confusion_matrix_jax(*args).astype(jnp.int32),
    )
    records = []
    try:
        with jax_float64():
            state = _jax_state(jt, _tree(port))
            for i in range(steps):
                batch = _batch(first_batch + i)
                before = _state_tree(state)
                state, jax_metrics = _jax_step(jt, state, to_float64(batch))
                metrics = port.train_step(batch)
                records.append({
                    "metrics": metrics, "jax_metrics": jax_metrics, "grads": _grads(port),
                    "after": _tree(port), "jax_before": before, "jax_after": _state_tree(state),
                })
    finally:
        patch.undo()
    assert all(v.dtype == np.float64 for v in records[0]["jax_after"].values())
    return port, records


def _assert_float64_step(rec):
    """One free-running float64 step: loss rtol 1e-6, parameters atol 1e-8, statistics atol 1e-6."""
    np.testing.assert_allclose(float(rec["metrics"]["loss"]), rec["jax_metrics"]["loss"], rtol=1e-6)
    assert set(rec["after"]) == set(rec["jax_after"])
    for key, value in rec["jax_after"].items():
        atol = 1e-8 if key[0] == "params" else 1e-6
        np.testing.assert_allclose(rec["after"][key], value, atol=atol, rtol=0, err_msg=str(key))


def _assert_stats(got, want):
    for key, value in want.items():
        if key[0] == "batch_stats":
            np.testing.assert_allclose(got[key], np.asarray(value), atol=1e-5, rtol=1e-5, err_msg=str(key))


@pytest.fixture(scope="module")
def adam_run():
    """Three lockstep Adam steps; per step the port's and the JAX trainer's records."""
    cfg = Config(**SMALL)
    variables = convert.init_variables(cfg, 9, seed=3, bn_stats="random")
    port = Trainer(cfg, device="cpu", dropout_rate=0.0)
    port.load_variables(variables)
    jt, patch = _jax_trainer(cfg=JaxConfig(**SMALL))
    try:
        def loss_fn(params, stats, batch):
            logits, _ = jt.model.apply(
                {"params": params, "batch_stats": stats}, batch["points"], train=True,
                bn_momentum=jt.bn_schedule(0), rngs={"dropout": jax.random.PRNGKey(0)},
                mutable=["batch_stats"],
            )
            return jax_weighted_ce_loss(logits, batch["labels"], batch["weights"])

        state0 = _jax_state(jt, _tree(port))
        with jax.default_matmul_precision("highest"):
            jax_grads = jax.jit(jax.grad(loss_fn))(state0.params, state0.batch_stats, _jnp(_batch(10)))
        params = state0.params
        opt_state = jt.tx.init(params)

        @jax.jit
        def optax_step(grads, opt_state, params):
            updates, opt_state = jt.tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state

        steps = []
        for i in range(STEPS):
            batch = _batch(10 + i)
            before = _tree(port)
            state = _jax_state(jt, before).replace(step=jnp.asarray(i, jnp.int32))
            state, jax_metrics = _jax_step(jt, state, batch)
            metrics = port.train_step(batch)
            grads = _grads(port)
            params, opt_state = optax_step(_jnp(unflatten_dict(grads)), opt_state, params)
            steps.append({
                "metrics": metrics, "jax_metrics": jax_metrics, "grads": grads,
                "after": _tree(port),
                "jax_stats": flatten_dict({"batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}),
                "optax_params": flatten_dict({"params": jax.tree_util.tree_map(np.asarray, params)}),
            })
    finally:
        patch.undo()
    return {"steps": steps, "jax_grads": flatten_dict(jax.tree_util.tree_map(np.asarray, jax_grads))}


@pytest.mark.parametrize("step", range(STEPS))
def test_adam_step_metrics_and_statistics_match_jax(adam_run, step):
    rec = adam_run["steps"][step]
    got, want = rec["metrics"], rec["jax_metrics"]
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(got["accuracy"]), want["accuracy"], atol=2 / 1024)
    assert got["confusion"].shape == (9, 9) and int(got["confusion"].sum()) == 4 * 256
    # A logit tie broken the other way moves one count; rows (labels) never move.
    np.testing.assert_array_equal(got["confusion"].sum(1).numpy(), want["confusion"].sum(1))
    assert np.abs(got["confusion"].numpy() - want["confusion"]).sum() <= 4
    np.testing.assert_allclose(got["learning_rate"], want["learning_rate"], rtol=1e-6)
    np.testing.assert_allclose(got["bn_decay"], want["bn_decay"], rtol=1e-6)
    _assert_stats(rec["after"], rec["jax_stats"])


@pytest.fixture(scope="module")
def sgd_run_float64():
    return _float64_run(STEPS, seed=4, first_batch=20)


def test_first_step_gradients_match_jax(sgd_run_float64):
    """Float64 on both sides: every parameter's gradient within 1e-6 of its max abs.
    The JAX trainer's gradient is read off its first momentum-SGD step, whose
    update is ``-lr * g`` exactly. A bias in front of a BatchNorm has a zero
    gradient but for rounding, on both sides: 1e-12 absolute for those."""
    rec = sgd_run_float64[1][0]
    lr = float(rec["jax_metrics"]["learning_rate"])
    got = rec["grads"]
    checked = 0
    for key, after in rec["jax_after"].items():
        if key[0] != "params":
            continue
        want = (rec["jax_before"][key] - after) / lr
        np.testing.assert_allclose(
            got[key[1:]], want, atol=1e-6 * np.abs(want).max() + 1e-12, rtol=0, err_msg=str(key)
        )
        checked += np.abs(want).max() > 1e-6
    assert len(got) == sum(k[0] == "params" for k in rec["jax_after"]) and checked > 40


def test_first_step_gradients_match_jax_in_float32(adam_run):
    """Float32 against float32: relative L2 <= 5e-2 (the module docstring says why)."""
    got, want = adam_run["steps"][0]["grads"], adam_run["jax_grads"]
    assert set(got) == set(want)
    for key, ref in want.items():
        if np.abs(ref).max() < 1e-5:
            # A bias in front of a BatchNorm: its gradient is zero but for rounding.
            assert np.abs(got[key]).max() < 1e-5, key
            continue
        err = np.linalg.norm(got[key] - ref) / np.linalg.norm(ref)
        assert err <= GRAD_REL_L2, (key, err)


@pytest.mark.parametrize("step", range(STEPS))
def test_adam_update_matches_optax_on_the_same_gradients(adam_run, step):
    rec = adam_run["steps"][step]
    for key, want in rec["optax_params"].items():
        np.testing.assert_allclose(rec["after"][key], want, atol=1e-7, rtol=1e-6, err_msg=str(key))


def test_moving_statistics_moved(adam_run):
    first, last = adam_run["steps"][0]["after"], adam_run["steps"][-1]["after"]
    moved = [np.abs(first[k] - last[k]).max() for k in first if k[0] == "batch_stats"]
    assert min(moved) > 0


def test_momentum_sgd_step_matches_jax(sgd_run_float64):
    """Three free-running steps in float64; from the second on the momentum
    buffer is in use (``t = g + mu*t``)."""
    port, records = sgd_run_float64
    assert len(records) == STEPS and port.step == STEPS
    for rec in records:
        _assert_float64_step(rec)
    moved = [np.abs(records[0]["after"][k] - records[-1]["after"][k]).max() for k in records[0]["after"]]
    assert min(m for m, k in zip(moved, records[0]["after"]) if k[0] == "batch_stats") > 0
    buf = port.optimizer.state[port.model.fc2.weight]["momentum_buffer"]
    assert buf.dtype == torch.float64 and buf.abs().max() > 0


# -- schedules, confusion matrix ----------------------------------------------

# Across the first staircase edge (12500 * 16 = 200000), deep into the decay,
# and where the learning-rate floor and the BatchNorm clip hold.
SCHEDULE_STEPS = [0, 1, 12499, 12500, 12501, 24999, 25000, 100000, 162500, 10**6, 10**9]


@pytest.mark.parametrize("step", SCHEDULE_STEPS)
def test_schedules_match_jax(step):
    """rtol 1e-6: both compute in float32; the power may round in the last bit."""
    cfg_kw = dict(learning_rate=0.001, batch_size=16, decay_step=200000, learning_rate_decay_rate=0.7,
                  bn_init_decay=0.5, bn_decay_decay_rate=0.5, bn_decay_clip=0.99)
    lr = learning_rate_schedule(Config(**cfg_kw))(step)
    bn = bn_momentum_schedule(Config(**cfg_kw))(step)
    assert isinstance(lr, float) and isinstance(bn, float)
    np.testing.assert_allclose(lr, float(jax_learning_rate_schedule(JaxConfig(**cfg_kw))(jnp.int32(step))), rtol=1e-6)
    np.testing.assert_allclose(bn, float(jax_bn_momentum_schedule(JaxConfig(**cfg_kw))(step)), rtol=1e-6)


def test_schedules_hit_the_edge_the_floor_and_the_clip():
    cfg = Config(learning_rate=0.001, batch_size=16, decay_step=200000)
    lr, bn = learning_rate_schedule(cfg), bn_momentum_schedule(cfg)
    assert lr(12499) == pytest.approx(0.001) and lr(12500) == pytest.approx(0.0007, rel=1e-5)
    assert lr(10**9) == pytest.approx(1e-5)
    assert bn(0) == pytest.approx(0.5) and bn(12500) == pytest.approx(0.75) and bn(10**8) == pytest.approx(0.99)


def test_confusion_matrix_matches_jax():
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 9, (4, 300)).astype(np.int32)
    preds = rng.randint(0, 9, (4, 300)).astype(np.int64)
    got = confusion_matrix(torch.from_numpy(labels), torch.from_numpy(preds), 9)
    assert got.shape == (9, 9) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(confusion_matrix_jax(labels, preds, 9)))
    assert int(got[3, 5]) == int(((labels == 3) & (preds == 5)).sum())  # rows are labels


# -- gradient accumulation --------------------------------------------------


def test_accum_step_matches_the_jax_accum_step():
    """G=2 with ghost BN and hoisted geometry on both sides, momentum SGD, in float64."""
    _, (rec,) = _float64_run(1, seed=5, first_batch=30, accum_steps=2)
    _assert_float64_step(rec)
    got, want = rec["metrics"], rec["jax_metrics"]
    np.testing.assert_allclose(float(got["accuracy"]), want["accuracy"], atol=1e-6)
    np.testing.assert_array_equal(got["confusion"].numpy(), want["confusion"])


def _accum_trainer(g, seed=6, **kw):
    trainer = Trainer(Config(**SMALL), device="cpu", dropout_rate=0.0, accum_steps=g, **kw)
    trainer.load_variables(convert.init_variables(trainer.cfg, 9, seed=seed, bn_stats="random"))
    return trainer


@pytest.mark.parametrize("g", [2, 4])
def test_accum_of_equal_microbatches_equals_one_microbatch(g):
    """Each strided microbatch holds the same cloud, so ghost BN sees the
    whole-batch statistics in every one: the accumulated gradient and loss are
    those of a single microbatch, and with ``bn_accum_rescale`` the moving
    statistics advance as in one step. Gradients within 1e-4 of each one's
    max abs (plus 1e-5 for the biases whose gradient is zero but for
    rounding): the division by the count comes last instead of first, which
    rounds every intermediate of the backward differently."""
    one = _batch(40, b=4 // g)
    whole = {k: np.repeat(v, g, axis=0) for k, v in one.items()}  # sample i -> microbatch i % g
    single = _accum_trainer(1)
    want = single.train_step(one)
    accum = _accum_trainer(g, bn_accum_rescale=True)
    got = accum.train_step(whole)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-6)
    np.testing.assert_allclose(got["bn_decay"], want["bn_decay"] ** (1.0 / g), rtol=1e-6)
    np.testing.assert_array_equal(got["confusion"].numpy(), g * want["confusion"].numpy())
    for key, grad in _grads(single).items():
        np.testing.assert_allclose(
            _grads(accum)[key], grad, atol=1e-4 * np.abs(grad).max() + 1e-5, rtol=0, err_msg=str(key)
        )
    stats, ref = _tree(accum), _tree(single)
    for key in ref:
        if key[0] == "batch_stats":
            np.testing.assert_allclose(stats[key], ref[key], atol=1e-6, rtol=1e-5, err_msg=str(key))


def test_accum_hoisted_equals_unhoisted_and_the_loss_is_the_whole_batch_loss():
    batch = _batch(41)
    hoisted, inline = _accum_trainer(4), _accum_trainer(4, hoist_geometry=False)
    got, want = hoisted.train_step(batch), inline.train_step(batch)
    assert float(got["loss"]) == float(want["loss"])
    for key, value in _tree(inline).items():
        np.testing.assert_array_equal(_tree(hoisted)[key], value, err_msg=str(key))
    # The loss is sum(ce * w) over all microbatches / count of non-zero weights of the whole batch.
    ref = _accum_trainer(4)
    ref.model.train()
    total = 0.0
    with torch.no_grad():
        for j in range(4):
            x = torch.from_numpy(batch["points"][j::4])
            logits = ref.model(x, bn_momentum=ref.bn_schedule(0))
            ce, _ = weighted_ce_sum(
                logits, torch.from_numpy(batch["labels"][j::4]), torch.from_numpy(batch["weights"][j::4])
            )
            total += float(ce)
    np.testing.assert_allclose(float(got["loss"]), total / np.count_nonzero(batch["weights"]), rtol=1e-5)


def test_ghost_bn_advances_the_statistics_g_times():
    """Without the rescale, G equal microbatches move the statistics by 1 - m**G."""
    one = _batch(42, b=1)
    whole = {k: np.repeat(v, 4, axis=0) for k, v in one.items()}
    single, accum = _accum_trainer(1), _accum_trainer(4)
    before = _tree(single)
    single.train_step(one)
    accum.train_step(whole)
    m = single.bn_schedule(0)
    key = ("batch_stats", "sa1", "bn0", "mean")
    batch_mean = (_tree(single)[key] - before[key] * m) / (1 - m)
    want = before[key] * m**4 + batch_mean * (1 - m**4)
    np.testing.assert_allclose(_tree(accum)[key], want, atol=1e-5)


def test_accum_rejects_a_batch_it_does_not_divide():
    trainer = _accum_trainer(4)
    with pytest.raises(ValueError, match="divide"):
        trainer.train_step(_batch(43, b=6))
    with pytest.raises(ValueError, match="divide"):
        Trainer(Config(**SMALL), device="cpu", accum_steps=3)


def test_unported_options_at_their_off_value_and_unknown_ones():
    Trainer(Config(**SMALL), device="cpu", arch="ssg", bq_window=None, train_dtype="float32")
    Trainer(Config(**SMALL), device="cpu", bq_window=3072, fp_window=(None, None, None, 256))
    with pytest.raises(TypeError):
        Trainer(Config(**SMALL), device="cpu", window=3)
    with pytest.raises(ValueError, match="optimizer"):
        Trainer(Config(**dict(SMALL, optimizer="lamb")), device="cpu")


def test_trainer_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(Config(**SMALL))


# -- eval step, checkpoints ---------------------------------------------------


def test_eval_step_matches_jax():
    cfg = Config(**SMALL)
    variables = convert.init_variables(cfg, 9, seed=7, bn_stats="random")
    batch = _batch(50)
    jt = JaxTrainer(cfg=JaxConfig(**SMALL), ops_impl="xla", infer_chunk=2)
    unflat = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    state = _jax_state(jt, flatten_dict(unflat))
    with jax.default_matmul_precision("highest"):
        want = jax.tree_util.tree_map(np.asarray, jt.eval_step(state, _jnp(batch)))
    port = Trainer(cfg, device="cpu", infer_chunk=2)
    port.load_variables(variables)
    got = port.eval_step(batch)
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(got["accuracy"]), want["accuracy"], atol=1e-6)
    np.testing.assert_array_equal(got["preds"].numpy(), want["preds"])
    np.testing.assert_array_equal(got["confusion"].numpy(), want["confusion"])
    assert not port.model.training
    whole = Trainer(cfg, device="cpu", infer_chunk=0)
    whole.load_variables(variables)
    np.testing.assert_array_equal(whole.eval_step(batch)["preds"].numpy(), want["preds"])


def test_checkpoint_round_trip(tmp_path):
    """Step, parameters, statistics and Adam moments survive bit for bit; the
    next step is the same within atol 1e-6 (the restored tensors lie elsewhere
    in memory, and the CPU matmuls round by alignment). A bias in front of a
    BatchNorm has a gradient of rounding noise alone, which Adam scales to a
    full +-lr: those are held to 2.1 * lr."""
    a = Trainer(Config(**SMALL), device="cpu", dropout_rate=0.0)
    a.init_state(seed=8)
    a.train_step(_batch(60))
    a.train_step(_batch(61))
    save_checkpoint(tmp_path / "ckpt.pt", a)
    b = Trainer(Config(**SMALL), device="cpu", dropout_rate=0.0)
    b.init_state(seed=9)
    restore_checkpoint(tmp_path / "ckpt.pt", b)
    assert b.step == 2
    for key, value in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[key], value), key
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        for name in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a.optimizer.state[pa][name], b.optimizer.state[pb][name])
    want, got = a.train_step(_batch(62)), b.train_step(_batch(62))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-6)
    assert got["learning_rate"] == want["learning_rate"] and a.step == b.step == 3
    for key, value in a.model.state_dict().items():
        noise_only = key.endswith(".b0") or ("dense_" in key and key.endswith(".bias")) or key == "fc1.bias"
        atol = 2.1 * want["learning_rate"] if noise_only else 1e-6
        torch.testing.assert_close(b.model.state_dict()[key], value, atol=atol, rtol=0, msg=key)


def test_init_state_is_seeded():
    a, b, c = (Trainer(Config(**SMALL), device="cpu") for _ in range(3))
    a.init_state(seed=1), b.init_state(seed=1), c.init_state(seed=2)
    assert torch.equal(a.model.sa1.w0, b.model.sa1.w0) and not torch.equal(a.model.sa1.w0, c.model.sa1.w0)
    assert a.step == 0 and len(a.optimizer.state) == 0


def test_init_state_has_the_jax_init_states_moving_statistics():
    """A fresh state's BatchNorm starts where flax's does (mean 0, variance 1),
    exactly; ``bn_stats="random"`` keeps the kernels and draws other statistics."""
    port = Trainer(Config(**SMALL), device="cpu")
    port.init_state(seed=0)
    want = flatten_dict(jax.tree_util.tree_map(
        np.asarray, JaxTrainer(cfg=JaxConfig(**SMALL)).init_state(jax.random.PRNGKey(0)).batch_stats
    ))
    got = flatten_dict(convert.to_flax_variables(port.model.state_dict())["batch_stats"])
    assert set(got) == set(want) and len(got) > 20
    for key, value in want.items():
        assert value.dtype == got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], value, err_msg=str(key))
        np.testing.assert_array_equal(value, 0.0 if key[-1] == "mean" else 1.0)
    random = Trainer(Config(**SMALL), device="cpu")
    random.init_state(seed=0, bn_stats="random")
    for key, value in port.model.state_dict().items():
        assert torch.equal(random.model.state_dict()[key], value) != key.endswith((".mean", ".var")), key
    with pytest.raises(ValueError, match="bn_stats"):
        convert.init_variables(Config(**SMALL), bn_stats="identity")


def _head_masks(trainer, masks):
    """Record each step's dropout keep-mask: the draw the generator it is
    handed makes, taken from a copy of its state before the step draws it."""
    inner = trainer.model._dropout

    def recording(x, generator):
        copy = torch.Generator().set_state(generator.get_state())
        masks.append(torch.rand(x.shape, generator=copy) >= trainer.model.dropout_rate)
        return inner(x, generator)

    trainer.model._dropout = recording


def test_a_resumed_run_draws_the_unbroken_runs_dropout_masks(tmp_path):
    """Step s's head mask depends on the seed and s alone, as the reference's
    ``fold_in(dropout_rng, step)``: a run saved after step 0 and resumed in a
    new Trainer draws the unbroken run's step-1 mask, not its step-0 mask."""
    unbroken, masks = Trainer(Config(**SMALL), device="cpu", dropout_seed=1), []
    unbroken.init_state(seed=0)
    _head_masks(unbroken, masks)
    for step in range(2):
        unbroken.train_step(_batch(80 + step))
    first = Trainer(Config(**SMALL), device="cpu", dropout_seed=1)
    first.init_state(seed=0)
    first.train_step(_batch(80))
    save_checkpoint(tmp_path / "ckpt.pt", first)
    resumed, resumed_masks = Trainer(Config(**SMALL), device="cpu", dropout_seed=1), []
    resumed.init_state(seed=0)
    restore_checkpoint(tmp_path / "ckpt.pt", resumed)
    _head_masks(resumed, resumed_masks)
    resumed.train_step(_batch(81))
    (mask,) = resumed_masks
    assert mask.shape == masks[1].shape and 0.4 < mask.float().mean() < 0.6
    assert torch.equal(mask, masks[1]) and not torch.equal(mask, masks[0])
    other, other_masks = Trainer(Config(**SMALL), device="cpu", dropout_seed=2), []
    other.init_state(seed=0)
    _head_masks(other, other_masks)
    other.train_step(_batch(80))
    assert not torch.equal(other_masks[0], masks[0])


def test_to_flax_variables_inverts_from_flax_variables():
    variables = convert.init_variables(Config(**SMALL), 9, seed=2, bn_stats="random")
    back = convert.to_flax_variables(convert.from_flax_variables(variables))
    want, got = flatten_dict(variables), flatten_dict(back)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype
        np.testing.assert_array_equal(got[key], value, err_msg=str(key))


# -- the head's dropout -------------------------------------------------------


def test_dropout_is_seeded_halves_and_doubles():
    model = PointNet2SemSeg(Config(**SMALL)).train()
    x = torch.rand(4, 64, 128) + 0.5
    a = model._dropout(x, torch.Generator().manual_seed(5))
    b = model._dropout(x, torch.Generator().manual_seed(5))
    c = model._dropout(x, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    zeros = (a == 0).float().mean().item()
    assert 0.47 < zeros < 0.53
    kept = a != 0
    torch.testing.assert_close(a[kept], 2.0 * x[kept])
    # The model's own generator: seeded with 0, advancing from call to call.
    first, again = model._dropout(x, None), model._dropout(x, None)
    assert not torch.equal(first, again)
    fresh = PointNet2SemSeg(Config(**SMALL)).train()
    assert torch.equal(fresh._dropout(x, None), first)


def test_dropout_only_in_train_mode_and_off_at_rate_zero():
    cfg = Config(**SMALL)
    sd = convert.from_flax_variables(convert.init_variables(cfg, 9, seed=1, bn_stats="random"))
    x = torch.from_numpy(_batch(70, b=2)["points"])
    on, off = PointNet2SemSeg(cfg), PointNet2SemSeg(cfg, dropout_rate=0.0)
    on.load_state_dict(sd), off.load_state_dict(sd)
    with torch.no_grad():
        assert torch.equal(on.eval()(x), off.eval()(x))
        dropped = on.train()(x, bn_momentum=0.5, generator=torch.Generator().manual_seed(0))
        plain = off.train()(x, bn_momentum=0.5)
    assert not torch.allclose(dropped, plain)
    with pytest.raises(ValueError, match="dropout_rate"):
        PointNet2SemSeg(cfg, dropout_rate=1.0)
