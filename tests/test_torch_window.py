"""The port's calibrated-window path against the JAX package's, on the CPU.

The plain windowed operators of ``pointnet2_tpu_torch.ops.core`` are held
against the JAX package's Pallas wrappers run in interpret mode
(``pltpu.force_tpu_interpret_mode()``), the way ``tests/test_bq_window.py``,
``tests/test_wingather.py`` and ``tests/test_fp_window.py`` run them, on the
same numpy inputs, in the three regimes of each: a window that fits, one too
small (``ok`` False, and the windowed outputs still equal), and the static
fallback to the exact operator.

Tolerances: indices, counts, ``qperm``/``inv_q`` and ``ok`` equal bit for
bit. The fused grouping's ``grouped`` within 1e-6 (the projection is a matmul
summed in another order by XLA and PyTorch). kNN distances within 2 ulp: the
interpret-mode kernel lets XLA contract ``d2 + diff*diff`` into fused
multiply-adds (measured: 2 ulp at most, as ``tests/test_fp_window.py:40``
notes for the oracle), where the port rounds after every product and sum,
as the CUDA kernel does. Model logits within 1e-4 as in
``tests/test_torch_model.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pointnet2_tpu.config import Config as JaxConfig
from pointnet2_tpu.models.pointnet2_seg import PointNet2SemSeg as JaxSemSeg
from pointnet2_tpu.ops import calibrate as jax_calibrate
from pointnet2_tpu.ops.pallas import ball_query_sliced as jax_ball_query_sliced
from pointnet2_tpu.ops.pallas import knn_sliced as jax_knn_sliced
from pointnet2_tpu.ops.pallas.wingather import project_group_sliced as jax_project_group_sliced
from pointnet2_tpu_torch import convert, ops
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.infer import Predictor
from pointnet2_tpu_torch.models import PointNet2SemSeg
from pointnet2_tpu_torch.ops import calibrate, core
from pointnet2_tpu_torch.train import Trainer

T = torch.from_numpy


def _box(seed, b, n, scale=(8.0, 1.0, 1.0)):
    """Long in x, as the Semantic3D boxes the windows are calibrated on."""
    return (np.random.RandomState(seed).rand(b, n, 3) * scale).astype(np.float32)


def _fps_like(x, m):
    return np.ascontiguousarray(x[:, :: x.shape[1] // m][:, :m])


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


# (b, n, m, radius, nsample, window, regime)
BQ_CASES = [
    (1, 1024, 512, 0.05, 8, 512, "fits"),
    (2, 1024, 256, 0.3, 16, 256, "too small"),
    (2, 256, 128, 0.3, 8, 256, "fallback"),  # window >= n
    (1, 512, 200, 0.3, 8, 128, "fallback"),  # m not a multiple of the tile
    # nsample past one slot a lane: balls of up to 100+ points in a window that fits
    (1, 4096, 512, 0.4, 64, 2048, "fits"),
    (1, 1024, 128, 0.45, 40, 512, "too small"),
]


@pytest.mark.parametrize("b,n,m,radius,nsample,window,regime", BQ_CASES)
def test_ball_query_sliced_matches_the_pallas_wrapper(b, n, m, radius, nsample, window, regime):
    x1 = _box(1, b, n)
    x2 = _fps_like(x1, m)
    with pltpu.force_tpu_interpret_mode():
        want_idx, want_cnt, want_ok = jax_ball_query_sliced(x1, x2, radius, nsample, window)
    idx, cnt, ok = core.ball_query_sliced(T(x1), T(x2), radius, nsample, window)
    assert bool(ok) == bool(want_ok) == (regime != "too small")
    assert ok.dtype == torch.bool and ok.shape == ()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    exact_idx, exact_cnt = core.ball_query(T(x1), T(x2), radius, nsample)
    assert torch.equal(idx, exact_idx) == torch.equal(cnt, exact_cnt) == (regime != "too small")


# (b, n, m, radius, nsample, window, regime); the queries are the m leftmost
# points, one tile whose window starts at 0 (the interpret-mode gather is slow)
PG_CASES = [
    (1, 512, 128, 0.05, 4, 256, "fits"),
    (1, 512, 128, 0.3, 4, 128, "too small"),
    (1, 600, 128, 0.1, 4, 384, "fallback"),  # no 128-multiple >= 384 divides 600
]


@pytest.mark.parametrize("b,n,m,radius,nsample,window,regime", PG_CASES)
def test_project_group_sliced_matches_the_pallas_wrapper(b, n, m, radius, nsample, window, regime):
    rng = np.random.RandomState(2)
    xyz = _box(3, b, n)
    new_xyz = np.ascontiguousarray(xyz[:, np.argsort(xyz[0, :, 0], kind="stable")[:m]])
    inputs = np.concatenate([xyz, rng.rand(b, n, 3).astype(np.float32)], -1)
    w0 = rng.randn(6, 8).astype(np.float32)
    b0 = rng.randn(8).astype(np.float32)
    with pltpu.force_tpu_interpret_mode(), jax.default_matmul_precision("highest"):
        want = jax_project_group_sliced(inputs, w0, b0, xyz, new_xyz, radius, nsample, window)
    got = core.project_group_sliced(T(inputs), T(w0), T(b0), T(xyz), T(new_xyz), radius, nsample, window)
    grouped, idx, cnt, qperm, inv_q, ok = got
    assert bool(ok) == bool(want[5]) == (regime != "too small")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want[2]))
    if regime == "fallback":
        assert qperm is None and inv_q is None and want[3] is None and want[4] is None
    else:
        np.testing.assert_array_equal(qperm.numpy(), np.asarray(want[3]))
        np.testing.assert_array_equal(inv_q.numpy(), np.asarray(want[4]))
    np.testing.assert_allclose(grouped.numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
    if regime == "fits":  # in original query order, the exact chain's rows
        exact = core.group_points(T(inputs) @ T(w0) + T(b0), core.ball_query(T(xyz), T(new_xyz), radius, nsample)[0])
        torch.testing.assert_close(core.gather_points(grouped, inv_q), exact, rtol=1e-6, atol=1e-6)


# (b, m, nq, k, window, regime, variant)
KNN_CASES = [
    (2, 512, 1024, 3, 384, "fits", None),
    (1, 512, 1024, 4, 384, "fits", "duplicates"),  # repeated x and points: the stable sort, the tie rule
    (2, 512, 1000, 3, 256, "fits", None),  # 1000 queries: the last tile is padded
    (1, 512, 512, 3, 128, "too small", None),
    # Queries right of the whole dataset: their window holds 2 real columns
    # and 126 of padding, fewer than k, so three picks are +inf.
    (1, 130, 128, 5, 128, "too small", "far right"),
    (2, 256, 512, 3, 256, "fallback", None),  # window >= m
    (1, 512, 100, 3, 128, "fallback", None),  # fewer than one tile of queries
    # k past the kernel's register route
    (1, 512, 1024, 17, 384, "fits", "duplicates"),
    (1, 512, 512, 32, 128, "too small", None),
]


@pytest.mark.parametrize("b,m,nq,k,window,regime,variant", KNN_CASES)
def test_knn_sliced_matches_the_pallas_wrapper(b, m, nq, k, window, regime, variant):
    scale = (8.0, 1.0, 1.0) if regime != "too small" else (1.0, 1.0, 1.0)
    x1 = _box(4, b, m, scale)
    x2 = _box(5, b, nq, scale)
    if variant == "duplicates":
        x1[:, ::3, 0] = x1[:, 1:2, 0]  # a third of the dataset shares one x
        x1[:, 5::7] = x1[:, 4::7][:, : x1[:, 5::7].shape[1]]  # whole duplicate points: distance ties
    if variant == "far right":
        x2[..., 0] += 2.0
    with pltpu.force_tpu_interpret_mode():
        want_d, want_i, want_ok = jax_knn_sliced(x1, x2, k, window)
    dist, idx, ok = core.knn_sliced(T(x1), T(x2), k, window)
    want_d = np.asarray(want_d)
    assert bool(ok) == bool(want_ok) == (regime != "too small")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(np.isinf(dist.numpy()), np.isinf(want_d))
    if variant == "far right":
        assert np.isinf(want_d).any()
    finite = np.isfinite(want_d)
    assert _ulps(dist.numpy()[finite], want_d[finite]).max() <= 2
    if regime != "too small":  # certified: the exact operator's result, bit for bit
        exact_d, exact_i = core.knn(T(x1), T(x2), k)
        assert torch.equal(idx, exact_i) and torch.equal(dist, exact_d)


def test_three_nn_sliced_is_knn_sliced_in_three_nn_order():
    dense, coarse = T(_box(6, 1, 512)), T(_box(7, 1, 256))
    got = core.three_nn_sliced(dense, coarse, 128)
    want = core.knn_sliced(coarse, dense, 3, 128)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_calibrated_dispatch_runs_the_plain_windowed_versions_on_the_cpu():
    """Not JAX's XLA path, which ignores the window: the real certificate."""
    x1 = T(_box(8, 1, 1024, scale=(1.0, 1.0, 1.0)))
    x2 = x1[:, ::8].contiguous()
    assert not bool(ops.ball_query_calibrated(x1, x2, 0.3, 8, 128)[2])
    assert not bool(ops.knn_calibrated(x1, x1[:, :512].contiguous(), 3, 128)[2])
    assert not bool(ops.three_nn_calibrated(x1[:, :512].contiguous(), x1, 128, impl="torch")[2])
    inputs = torch.cat([x1, x1], -1)
    assert not bool(ops.project_group_calibrated(inputs, torch.ones(6, 4), torch.zeros(4), x1, x2, 0.3, 8, 128)[5])


# -- calibration --------------------------------------------------------------


@pytest.mark.parametrize("arg", ["auto", "3072", "3072,768,-,-", "512,none,,128"])
def test_parse_window_arg_matches_jax(arg):
    assert calibrate.parse_window_arg(arg) == jax_calibrate.parse_window_arg(arg)


def test_required_windows_and_choice_match_jax():
    cloud = _box(9, 2, 1024)
    queries = _fps_like(cloud, 256)
    for radius in (0.05, 0.2):
        assert calibrate.required_bq_window(cloud, queries, radius) == jax_calibrate.required_bq_window(
            cloud, queries, radius
        )
    assert calibrate.required_fp_window(queries, cloud) == jax_calibrate.required_fp_window(queries, cloud)
    for reqs, clouds in [([700, 300, 100, 40], [1024, 256, 64, 16]), ([9000, 200, 60, 15], [8192, 1024, 256, 64])]:
        assert calibrate.choose_window(reqs, clouds) == jax_calibrate.choose_window(reqs, clouds)


def test_calibrate_model_windows_matches_jax():
    specs = [(256, 0.05), (64, 0.4), (32, 0.8), (16, 1.6)]
    batches = [_box(20 + i, 2, 1024) for i in range(2)]

    def sampler():
        it = iter(batches)
        return lambda: next(it)

    got = calibrate.calibrate_model_windows(specs, 1024, sampler(), num_batches=2, device="cpu")
    want = jax_calibrate.calibrate_model_windows(specs, 1024, sampler(), num_batches=2)
    assert got == want


# -- the model, the Predictor and the Trainer ------------------------------------

# tests/test_wingather.py:130's FUSED config with 512 SA1 centroids in place
# of 256: a 768 window over SA1's 1024 points certifies, and so does a 256
# window over FP4's coarse cloud. With 256 centroids no FP window certifies:
# window starts fall on 128-multiples, so a 128 window over 256 columns has
# two places, and the tiles in the middle of the cloud fit neither
# (``calibrate.required_fp_window`` gives 256 there, i.e. none).
FUSED = dict(
    num_point=1024, l1_npoint=512, l2_npoint=64, l3_npoint=32, l4_npoint=16,
    l1_radius=0.05, l2_radius=0.4, l3_radius=0.8, l4_radius=1.6,
    l1_nsample=8, l2_nsample=8, l3_nsample=8, l4_nsample=8,
)
BQ_WINDOW, FP_WINDOW = 768, 256


def _scene(seed, b, n):
    rng = np.random.RandomState(seed)
    x = np.zeros((b, n, 6), np.float32)
    x[..., :3] = rng.rand(b, n, 3) * [8.0, 1.0, 1.0]
    x[..., 3:] = rng.rand(b, n, 3)
    return x


def test_windowed_eval_logits_and_certificates_match_the_pallas_model():
    """The JAX model on its Pallas path in interpret mode (windows engaged at
    SA1 and FP4; the other levels fall back statically), against the port's
    plain path: logits within 1e-4, the 8 certificates equal, and the port's
    logits equal to its own no-window forward, as the certificates promise."""
    cfg = Config(**FUSED)
    variables = convert.init_variables(cfg, num_classes=9, seed=5, bn_stats="random")
    x = _scene(11, 1, cfg.num_point)
    jax_model = JaxSemSeg(
        num_classes=9, config=JaxConfig(**FUSED), ops_impl="pallas", bq_window=BQ_WINDOW, fp_window=FP_WINDOW
    )
    with pltpu.force_tpu_interpret_mode(), jax.default_matmul_precision("highest"):
        # Under jit the interpret-mode kernels are traced once: 22 s in place of 38.
        want, diag = jax.jit(lambda v, p: jax_model.apply(
            v, p, train=False, bn_momentum=0.9, mutable=["diagnostics"]
        ))(variables, jnp.asarray(x))
    diag = diag["diagnostics"]
    want_flags = [("bq_window_ok", bool(diag[f"sa{i}"]["bq_window_ok"][0])) for i in range(1, 5)]
    want_flags += [("fp_window_ok", bool(diag[f"fp{i}"]["fp_window_ok"][0])) for i in range(1, 5)]

    model = PointNet2SemSeg(cfg, bq_window=BQ_WINDOW, fp_window=FP_WINDOW).eval()
    model.load_state_dict(convert.from_flax_variables(variables))
    certificates = []
    with torch.no_grad():
        got = model(T(x), certificates=certificates)
        exact = model.__class__(cfg).eval()
        exact.load_state_dict(model.state_dict())
        exact_logits = exact(T(x))
    assert [(name, bool(ok)) for name, ok in certificates] == want_flags
    assert all(ok for _, ok in want_flags)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got, exact_logits, rtol=1e-6, atol=1e-6)


def test_predictor_predict_step_checked():
    cfg = Config(**FUSED)
    sd = convert.from_flax_variables(convert.init_variables(cfg, num_classes=9, seed=6, bn_stats="random"))
    x = _scene(12, 2, cfg.num_point)
    plain = Predictor(cfg, sd, infer_chunk=1, device="cpu")
    windowed = Predictor(cfg, sd, infer_chunk=1, device="cpu", bq_window=BQ_WINDOW, fp_window=FP_WINDOW)
    labels, ok = windowed.predict_step_checked(x)
    assert ok is True and labels.dtype == torch.int32
    assert torch.equal(labels, plain.predict_step(x))
    assert plain.predict_step_checked(x)[1] is True  # no windows: nothing to certify
    too_small = Predictor(cfg, sd, infer_chunk=1, device="cpu", bq_window=256)
    assert too_small.predict_step_checked(x)[1] is False


SMALL_TRAIN = dict(FUSED, batch_size=2)


def _batch(seed, b=2):
    rng = np.random.RandomState(seed)
    return {
        "points": _scene(seed, b, FUSED["num_point"]),
        "labels": rng.randint(0, 9, (b, FUSED["num_point"])).astype(np.int32),
        "weights": rng.rand(b, FUSED["num_point"]).astype(np.float32),
    }


def _step(accum_steps=1, **windows):
    trainer = Trainer(
        Config(**SMALL_TRAIN), device="cpu", dropout_rate=0.0, accum_steps=accum_steps, **windows
    )
    trainer.init_state(seed=7, bn_stats="random")
    metrics = trainer.train_step(_batch(13))
    grads = {name: p.grad.clone() for name, p in trainer.model.named_parameters()}
    return trainer, metrics, grads


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_windowed_train_step_equals_the_exact_step(accum_steps):
    """Train mode: the windowed ball query and 3-NN (no fused grouping), with
    ``window_ok`` True, and the no-window step's neighbours. The loss is
    equal. The backward's scatter sums are not reproducible from run to run on
    the CPU (two no-window steps: 7.8e-7 relative L2 apart, measured), so
    the gradients are held to 1e-5 relative L2, and each parameter whose
    gradient is not rounding noise (max abs above 1e-4 of the model's
    largest; a bias in front of a BatchNorm has only noise) to 1e-4 of its
    max abs. With accum_steps=2 the
    geometry is hoisted and its certificate is the step's."""
    trainer, metrics, grads = _step(accum_steps, bq_window=BQ_WINDOW, fp_window=FP_WINDOW)
    _, exact_metrics, exact_grads = _step(accum_steps)
    assert metrics["window_ok"].dtype == torch.bool and bool(metrics["window_ok"])
    assert "window_ok" not in exact_metrics
    assert torch.equal(metrics["loss"], exact_metrics["loss"])
    got = torch.cat([g.flatten() for g in grads.values()])
    want = torch.cat([exact_grads[name].flatten() for name in grads])
    assert float((got - want).norm() / want.norm()) <= 1e-5
    largest = float(want.abs().max())
    for name, g in grads.items():
        scale = float(exact_grads[name].abs().max())
        if scale > 1e-4 * largest:
            assert float((g - exact_grads[name]).abs().max()) <= 1e-4 * scale, name
    evaluated = trainer.eval_step(_batch(14))
    assert bool(evaluated["window_ok"])
    labels, ok = trainer.predict_step_checked(_batch(14)["points"])
    assert torch.equal(labels, evaluated["preds"].to(torch.int32)) and bool(ok)
    assert trainer.check_bq_window(_batch(15)["points"]) is True


def test_trainer_window_certificates_fail_on_a_too_small_window():
    trainer, metrics, _ = _step(bq_window=(256, None, None, None))
    assert not bool(metrics["window_ok"])
    assert trainer.check_bq_window(_batch(15)["points"]) is False
    assert not bool(trainer.eval_step(_batch(14))["window_ok"])


@pytest.mark.parametrize("window", ["auto", 3.5, [512, "x"]])
def test_trainer_rejects_an_unresolved_window(window):
    with pytest.raises(TypeError, match="calibrate_model_windows"):
        Trainer(Config(**SMALL_TRAIN), device="cpu", bq_window=window)


def test_trainer_takes_per_level_windows_as_tuples():
    trainer = Trainer(Config(**SMALL_TRAIN), device="cpu", bq_window=[768, None, None, None], fp_window=128)
    assert trainer.bq_window == (768, None, None, None) and trainer.model.sa1.bq_window == 768
    assert trainer.model.sa2.bq_window is None and trainer.model.fp4.fp_window == 128
