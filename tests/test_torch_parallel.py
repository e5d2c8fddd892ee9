"""The port's ``parallel`` package on the CPU: sharded ops, rows, collectives
and the data-parallel train step, against the JAX package and the one-process port.

- The sharded kNN, 3-NN and densify over 1, 2, 3 and 8 CPU shards against
  ``pointnet2_tpu.parallel.sharded_ops`` on meshes of that many of the
  8 CPU devices ``tests/conftest.py`` forces: indices and labels bit for bit,
  distances within rtol 1e-5, atol 1e-6 (the port's kNN tests against the
  Pallas kernel state the same).
- ``local_rows``, ``shard_batch`` and ``pad_batch_to_devices`` against the
  JAX functions on NumPy batches: exact.
- The group's helpers in 2 and 3 gloo processes
  (``tests/torch_dist_worker.py``): the differentiable sum and its backward,
  the host all-gather, the train CLI's widest windows, the replica check.
- The train step in 2 gloo processes (``tools/dist_step.py``; each rank its
  half of every global batch of 4 x 256 points, ``test_torch_train.SMALL``)
  against ``run_case`` in this process on the whole batch, dropout on, SSG
  and MSG, ``accum_steps`` 1 and 2. In float32, one Adam step: loss rtol 1e-5,
  moving statistics atol 1e-5 + rtol 1e-5, gradients relative L2 <= 5e-2
  (measured 1e-5 to 1.9e-2). The two sides split BatchNorm's sums
  differently, and ``mean(x²) − mean(x)²`` in float32 turns that rounding
  into ReLU flips, as between XLA and PyTorch (``tests/test_torch_train.py``'s
  docstring). Adam's parameters are not compared: an element whose gradient
  is rounding noise moves by ``+-lr`` with the noise's sign (measured 2e-3).
  In float64, two momentum-SGD steps at ``_float64_run``'s tolerances: loss
  rtol 1e-6, the last step's gradients within 1e-6 of their max abs plus
  1e-12 (a bias in front of a BatchNorm has a gradient of rounding noise;
  measured 1e-13 relative), parameters atol 1e-8 and statistics atol 1e-6
  (measured 6e-15).
  Both ranks must hold the same state bit for bit. One float64 case, dropout
  off, is held to the JAX ``Trainer.train_step`` on the global batch. A
  group of one rank takes the plain step bit for bit. A control step, each
  rank's BatchNorm on its own rows (``tools.dist_step``'s
  ``rank_batch_norm``), must fail the float32 loss and gradient gates.

Every multi-process run bounds its own time (``run_ranks``: 240 s, a group
timeout of 60 s), and a rank that fails or hangs fails its test.
"""

import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import pointnet2_tpu.parallel as jax_parallel
from pointnet2_tpu.config import Config as JaxConfig
from pointnet2_tpu.parallel.multihost import local_rows as jax_local_rows
from pointnet2_tpu_torch import convert
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.ops import densify
from pointnet2_tpu_torch.parallel import (
    densify_labels_sharded,
    knn_sharded,
    local_rows,
    pad_batch_to_devices,
    shard_batch,
    three_nn_sharded,
)
from pointnet2_tpu_torch.parallel.launch import dist_flags, run_ranks
from pointnet2_tpu_torch.tools.dist_step import rank_argv, run_case
from pointnet2_tpu_torch.train_profile import train_batch
from test_torch_model import jax_float64, to_float64
from test_torch_train import SMALL, _jax_state, _jax_step, _jax_trainer, _state_tree

WORKER = str(pathlib.Path(__file__).with_name("torch_dist_worker.py"))
RANK_ENV = {"OMP_NUM_THREADS": "2"}
SHARDS = [1, 2, 3, 8]


def _ranks(argv_of, world):
    return run_ranks(argv_of, world, timeout=240, group_timeout=60, env=RANK_ENV)


# -- sharded ops ----------------------------------------------------------


def _cloud(seed, n, scale):
    return (np.random.RandomState(seed).rand(n, 3) * scale).astype(np.float32)


@pytest.mark.parametrize("shards", SHARDS)
def test_knn_sharded_equals_jax(shards):
    refs, queries = _cloud(1, 700, 5.0), _cloud(2, 2001, 5.0)  # 2001 queries: padded on every mesh
    d2, idx = knn_sharded(refs, queries, 4, ["cpu"] * shards)
    want_d2, want_idx = jax_parallel.knn_sharded(refs, queries, 4, jax_parallel.create_mesh(jax.devices()[:shards]))
    assert d2.dtype == torch.float32 and idx.dtype == torch.int32 and idx.shape == (2001, 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(want_d2), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shards", SHARDS)
def test_three_nn_sharded_equals_jax(shards):
    refs, targets = _cloud(3, 300, 1.0), _cloud(4, 999, 1.0)
    d2, idx = three_nn_sharded(targets, refs, ["cpu"] * shards)
    want_d2, want_idx = jax_parallel.three_nn_sharded(targets, refs, jax_parallel.create_mesh(jax.devices()[:shards]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(want_d2), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shards", SHARDS)
def test_densify_sharded_equals_jax_and_the_device_engine(shards):
    sparse, dense = _cloud(5, 500, 10.0), _cloud(6, 10_000, 10.0)  # 10 000: not a multiple of 8 x 128
    labels = np.random.RandomState(7).randint(0, 9, 500).astype(np.int32)
    got = densify_labels_sharded(sparse, labels, dense, 3, ["cpu"] * shards, chunk=1000)
    mesh = jax_parallel.create_mesh(jax.devices()[:shards])
    want = jax_parallel.densify_labels_sharded(sparse, labels, dense, 3, mesh)
    assert got.dtype == np.int32 and got.shape == (10_000,)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, densify.densify_labels_device(sparse, labels, dense, 3, "cpu")[0].numpy())


def test_sharded_ops_default_to_the_visible_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        knn_sharded(_cloud(1, 10, 1.0), _cloud(2, 10, 1.0), 3)


# -- rows and shards ------------------------------------------------------


def _numpy_batch(b):
    rng = np.random.RandomState(b)
    return {"points": rng.rand(b, 5, 6).astype(np.float32), "labels": rng.randint(0, 9, (b, 5))}


@pytest.mark.parametrize("nproc", [1, 2, 4])
def test_local_rows_equal_jax(nproc):
    batch = _numpy_batch(8)
    for pid in range(nproc):
        got = local_rows(batch, pid, nproc)
        want = jax_local_rows(batch, pid, nproc)
        for key in batch:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    with pytest.raises(ValueError, match="must divide by the process count 3"):
        local_rows(batch, 0, 3)
    with pytest.raises(ValueError, match="must divide by the process count 3"):
        jax_local_rows(batch, 0, 3)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_shard_batch_equals_jax(shards):
    batch = _numpy_batch(8)
    got = shard_batch(batch, ["cpu"] * shards)
    mesh = jax_parallel.create_mesh(jax.devices()[:shards])
    want = jax_parallel.shard_batch(batch, mesh)
    order = {d: i for i, d in enumerate(mesh.devices.flat)}
    for key in batch:
        jax_shards = sorted(want[key].addressable_shards, key=lambda s: order[s.device])
        assert len(got) == len(jax_shards) == shards
        for part, jax_shard in zip(got, jax_shards):
            assert part[key].device.type == "cpu"
            np.testing.assert_array_equal(part[key].numpy(), np.asarray(jax_shard.data))
    if shards > 1:
        with pytest.raises(ValueError, match="must divide by the mesh size"):
            shard_batch({"x": np.zeros((shards + 1, 2))}, ["cpu"] * shards)


@pytest.mark.parametrize("batch,devices", [(16, 1), (16, 3), (17, 8), (1, 8), (64, 6)])
def test_pad_batch_to_devices_equals_jax(batch, devices):
    assert pad_batch_to_devices(batch, devices) == jax_parallel.mesh.pad_batch_to_devices(batch, devices)


# -- the group's helpers ----------------------------------------------------


@pytest.mark.parametrize("world", [2, 3])
def test_collectives_in_a_group(tmp_path, world):
    out = str(tmp_path / "coll")
    _ranks(lambda r, c: [sys.executable, WORKER, "collectives", out, *dist_flags(r, world, c)], world)
    results = [json.loads(pathlib.Path(f"{out}.rank{r}.json").read_text()) for r in range(world)]
    weights = sum(r + 1 for r in range(world))
    for rank, res in enumerate(results):
        assert res["data_parallel"] == [rank, world] and res["backend"] == "gloo"
        assert res["allgather"] == [[r, 10 * r] for r in range(world)]
        assert res["windows"] == [3072, 512]  # the widest of (3072, None), (1024, 512), (None, None)
        assert res["sum"] == [float(sum((r + 1) ** 2 for r in range(world)))] * 3
        # d/dx_r of sum over ranks q of (q + 1) * sum(S): (r + 1) * sum over q of (q + 1).
        assert res["grad"] == [float((rank + 1) * weights)] * 3
        assert res["mismatch"] is not None and "different model states" in res["mismatch"]
        assert res["local_rows"] == np.arange(2 * world * 3).reshape(2 * world, 3)[2 * rank : 2 * rank + 2].tolist()


# -- the data-parallel train step -------------------------------------------

FLOAT32_CASES = [dict(arch=arch, accum_steps=g, batch_seed=20 + g) for arch in ("ssg", "msg") for g in (1, 2)]
FLOAT64_CASES = [dict(arch=arch, accum_steps=g, dtype="float64", optimizer="momentum", steps=2, batch_seed=30 + g)
                 for arch in ("ssg", "msg") for g in (1, 2)]
JAX_CASE = dict(dtype="float64", optimizer="momentum", dropout_rate=0.0, weights_seed=4, batch_seed=40)
CONTROL_CASES = [dict(arch=arch, control="rank_batch_norm", batch_seed=60) for arch in ("ssg", "msg")]
CASES = FLOAT32_CASES + FLOAT64_CASES + [JAX_CASE] + CONTROL_CASES


def _case_id(case):
    control = f"-{case['control']}" if case.get("control") else ""
    return f"{case.get('arch', 'ssg')}-accum{case.get('accum_steps', 1)}-{case.get('dtype', 'float32')}{control}"


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every case of ``CASES`` in one 2-process gloo group: each rank's records."""
    base = tmp_path_factory.mktemp("dist_step")
    (base / "spec.json").write_text(json.dumps({"config": SMALL, "device": "cpu", "cases": CASES}))
    _ranks(rank_argv(base / "spec.json", base / "out", 2), 2)
    return [torch.load(base / f"out.rank{r}.pt")["cases"] for r in range(2)]


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(((got[k].double() - v.double()) ** 2).sum()) for k, v in want.items())
    return (num / sum(float((v.double() ** 2).sum()) for v in want.values())) ** 0.5


def _stats(state: dict) -> dict:
    return {k: v for k, v in state.items() if k.endswith(".mean") or k.endswith(".var")}


def _check_ranks_agree(ranks, i):
    (a, b) = (ranks[0][i], ranks[1][i])
    assert a["world"] == b["world"] == 2 and a["backend"] == "gloo"
    assert a["losses"] == b["losses"] and torch.equal(a["confusion"], b["confusion"])
    for key, value in a["state"].items():
        assert torch.equal(value, b["state"][key]), key
    return a


@pytest.mark.parametrize("case", FLOAT32_CASES, ids=_case_id)
def test_two_process_step_float32_equals_the_one_process_step(two_ranks, case):
    got = _check_ranks_agree(two_ranks, CASES.index(case))
    want = run_case(Config(**SMALL), case, torch.device("cpu"))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert _rel_l2(got["grads"], want["grads"]) <= 5e-2
    for key, value in _stats(want["state"]).items():
        np.testing.assert_allclose(got["state"][key], value, atol=1e-5, rtol=1e-5, err_msg=key)
    # A logit tie broken the other way moves one count; rows (labels) never move.
    np.testing.assert_array_equal(got["confusion"].sum(1), want["confusion"].sum(1))
    assert int((got["confusion"] - want["confusion"]).abs().sum()) <= 4


@pytest.mark.parametrize("case", CONTROL_CASES, ids=_case_id)
def test_the_float32_gates_refuse_per_rank_batch_norm_statistics(two_ranks, case):
    """The control: each rank's BatchNorm takes its own rows' statistics (the
    gradients still summed, the loss over the global count). The float32
    test's loss and gradient gates must each refuse it."""
    got = two_ranks[0][CASES.index(case)]
    want = run_case(Config(**SMALL), case, torch.device("cpu"))
    assert abs(got["losses"][0] - want["losses"][0]) > 1e-5 * abs(want["losses"][0])
    assert _rel_l2(got["grads"], want["grads"]) > 5e-2


@pytest.mark.parametrize("case", FLOAT64_CASES, ids=_case_id)
def test_two_process_steps_float64_equal_the_one_process_steps(two_ranks, case):
    got = _check_ranks_agree(two_ranks, CASES.index(case))
    want = run_case(Config(**SMALL), case, torch.device("cpu"))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
    for key, value in want["grads"].items():
        assert float((got["grads"][key] - value).abs().max()) <= 1e-6 * float(value.abs().max()) + 1e-12, key
    for key, value in want["state"].items():
        atol = 1e-6 if key in _stats(want["state"]) else 1e-8
        np.testing.assert_allclose(got["state"][key], value, atol=atol, rtol=0, err_msg=key)


def test_two_process_step_float64_equals_the_jax_train_step(two_ranks):
    """The JAX step on the whole batch, from the same variables, dropout off on both sides."""
    got = _check_ranks_agree(two_ranks, CASES.index(JAX_CASE))
    cfg_kw = dict(SMALL, optimizer="momentum")
    variables = convert.init_variables(Config(**cfg_kw), 9, JAX_CASE["weights_seed"], bn_stats="random")
    flat = {k: np.asarray(v, np.float64) for k, v in flatten_dict(variables).items()}
    jt, patch = _jax_trainer(cfg=JaxConfig(**cfg_kw))
    try:
        with jax_float64():
            batch = train_batch(Config(**cfg_kw), SMALL["batch_size"], JAX_CASE["batch_seed"])
            state, jax_metrics = _jax_step(jt, _jax_state(jt, flat), to_float64(batch))
            after = _state_tree(state)
    finally:
        patch.undo()
    np.testing.assert_allclose(got["losses"][0], jax_metrics["loss"], rtol=1e-6)
    port = flatten_dict(convert.to_flax_variables(got["state"]))
    assert set(port) == set(after)
    for key, value in after.items():
        atol = 1e-8 if key[0] == "params" else 1e-6
        np.testing.assert_allclose(np.asarray(port[key]), value, atol=atol, rtol=0, err_msg=str(key))


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_a_group_of_one_takes_the_plain_step_bit_for_bit(tmp_path, accum_steps):
    """The distributed path (collectives of one rank) and then the plain
    ``Trainer`` step in the same process: loss, gradients, state and metrics equal."""
    case = dict(accum_steps=accum_steps, steps=2, batch_seed=50)
    (tmp_path / "spec.json").write_text(json.dumps(
        {"config": SMALL, "device": "cpu", "plain_after": True, "cases": [case]}
    ))
    _ranks(rank_argv(tmp_path / "spec.json", tmp_path / "out", 1), 1)
    out = torch.load(tmp_path / "out.rank0.pt")
    (dist_run,), (plain,) = out["cases"], out["plain"]
    assert dist_run["world"] == 1 and dist_run["backend"] == "gloo" and plain["backend"] is None
    assert dist_run["losses"] == plain["losses"] and torch.equal(dist_run["confusion"], plain["confusion"])
    np.testing.assert_allclose(dist_run["accuracies"], plain["accuracies"], rtol=1e-7)
    for part in ("grads", "state"):
        for key, value in plain[part].items():
            assert torch.equal(dist_run[part][key], value), (part, key)
