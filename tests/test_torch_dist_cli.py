"""The port's train and predict CLIs over 2 gloo processes on the CPU, ``--sharded``, ``--engine sharded``.

Fabricated Semantic3D scenes of 1200 points at ``test_torch_train.SMALL``'s
widths (4 x 256 points a batch: 10 train steps and 7 eval batches an
epoch). Each rank is a subprocess (``tools.dist_step``'s ``cli`` mode, which
runs the CLI's ``main`` and writes its summary) started by
``parallel.launch.run_ranks`` with its own deadline; the one-process runs
are made in this process.

- ``cli.train --dist_sampling replicated --seed 0`` on 2 processes against
  ``cli.train --seed 0`` (Adam at a learning rate of 1e-5): the same global
  batches, so the first step's loss within rtol 1e-5 and every step's within
  rtol 1e-4 (measured 1.6e-5). The float32 BatchNorm sums, split over two
  processes, round otherwise than in one, and training amplifies that: at
  semantic.json's 1e-3 the two runs part by about ten times a step on this
  tiny model (measured 7e-4 at step 3 and 1.9e-2 at step 7 with Adam, 2.3e-4
  and 2.5e-2 at step 6 with momentum SGD);
  one ``log_train.txt`` and one set of checkpoints, written by process 0;
  ``[proc 1]`` lines from process 1; ``--resume`` on 2 processes continues
  the step. ``--dist_sampling sharded``: each process's seed
  ``seed + 9973 * process`` and its batch of ``batch_size / 2``, and ``auto``
  windows agreed by every process.
- ``cli.predict`` on 2 processes: process p walks the scenes ``p::2`` on its
  own fresh ``seed=0`` stream, as process p of the root ``predict.py`` does.
  Its files are held to the root script run in this process as rank p of 2
  (``jax.process_index``/``process_count`` answering the script's own calls,
  ``multihost_utils.process_allgather`` standing in for the gather): each
  ``.pcd`` byte for byte, the ``.labels`` as ``tests/test_torch_cli.py``
  holds the one-process CLI's; and to the port's CLI run in this process as
  rank p (``multihost``'s index and count patched, no group): every file
  byte for byte, the gathered confusion matrix the sum of those runs'
  matrices. Process 1's first scene is drawn otherwise than in a one-process
  run, which draws it after scene 0's samples. ``--sharded`` over 2, 3 and
  4 CPU shards (``cli_mesh`` patched): the labels of the unsharded run, a
  short last batch (padded over 4 shards) included.
- ``cli.interpolate --engine sharded`` over two CPU shards: the device engine's files.
"""

import contextlib
import dataclasses
import io
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from pointnet2_tpu_torch import convert
from pointnet2_tpu_torch.cli import interpolate as cli_interpolate
from pointnet2_tpu_torch.cli import predict as cli_predict
from pointnet2_tpu_torch.cli import train as cli_train
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.data.io import load_labels, write_labels, write_pcd
from pointnet2_tpu_torch.data.semantic3d import train_file_prefixes, validation_file_prefixes
from pointnet2_tpu_torch.parallel import multihost
from pointnet2_tpu_torch.tools import scenes as fabricated
from pointnet2_tpu_torch.tools.dist_step import run_cli_ranks
from pointnet2_tpu_torch.train import Trainer, load_model_state, restore_checkpoint
from test_torch_train import SMALL

SCENE_POINTS = 1200
STEPS = 9 * SCENE_POINTS // (SMALL["batch_size"] * SMALL["num_point"])
# At semantic.json's 1e-3 this tiny model's two runs part by about ten times
# a step (measured with Adam: 5e-6 at step 2, 7e-4 at step 3, 1.9e-2 at step
# 7); at 1e-5 they stay within 2e-5 over the epoch.
LEARNING_RATE = 1e-5
LABEL_AGREEMENT = 0.9999  # the port's labels against the root predict.py's, as in tests/test_torch_cli.py

torch.set_num_threads(2)


def _write_config(path: pathlib.Path, **kw) -> str:
    cfg = Config(**{**SMALL, "max_epoch": 1, "learning_rate": LEARNING_RATE, **kw})
    path.write_text(json.dumps(dataclasses.asdict(cfg)))
    return str(path)


def _cli_ranks(module: str, out: pathlib.Path, argv: list, world: int = 2) -> tuple[list, list]:
    """``world`` ranks of the CLI ``module`` on the CPU: their summaries and outputs."""
    return run_cli_ranks(module, out, [*argv, "--device", "cpu"], world, timeout=300, group_timeout=60,
                         env={"OMP_NUM_THREADS": "2"})


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    data_dir = tmp_path_factory.mktemp("dist_scenes")
    rng = np.random.RandomState(0)
    for prefix in train_file_prefixes + validation_file_prefixes:
        pts = rng.rand(SCENE_POINTS, 3) * [20.0, 20.0, 4.0]
        write_pcd(data_dir / f"{prefix}.pcd", pts, rng.rand(SCENE_POINTS, 3))
        write_labels(data_dir / f"{prefix}.labels", np.where(pts[:, 2] < 2.0, 1, 5).astype(np.int32))
    return data_dir


@pytest.fixture(scope="module")
def one_process(scenes, tmp_path_factory):
    base = tmp_path_factory.mktemp("one_process")
    cfg_path = _write_config(base / "cfg.json", data_path=str(scenes), logdir=str(base / "log"))
    return base, cfg_path, cli_train.main(["--config_file", cfg_path, "--seed", "0", "--device", "cpu"])


@pytest.fixture(scope="module")
def two_processes(scenes, tmp_path_factory):
    base = tmp_path_factory.mktemp("two_processes")
    cfg_path = _write_config(base / "cfg.json", data_path=str(scenes), logdir=str(base / "log"))
    summaries, outputs = _cli_ranks(
        "train", base / "summary", ["--config_file", cfg_path, "--seed", "0", "--dist_sampling", "replicated"]
    )
    return base, cfg_path, summaries, outputs


def test_two_process_train_takes_the_one_process_steps(one_process, two_processes):
    _, _, want = one_process
    _, _, summaries, _ = two_processes
    want_losses = want["epochs"][0]["losses"]
    assert len(want_losses) == STEPS
    for summary in summaries:
        assert summary["processes"] == 2 and summary["backend"] == "gloo" and summary["step"] == STEPS
        got = summary["epochs"][0]["losses"]
        np.testing.assert_allclose(got[0], want_losses[0], rtol=1e-5)
        np.testing.assert_allclose(got, want_losses, rtol=1e-4)
    assert summaries[0]["epochs"][0]["losses"] == summaries[1]["epochs"][0]["losses"]


def test_two_process_train_writes_one_set_of_artifacts(two_processes):
    base, cfg_path, summaries, outputs = two_processes
    log = base / "log"
    text = (log / "log_train.txt").read_text()
    assert text.count("**** EPOCH 000") == 1 and "2 processes, backend gloo, sampling replicated" in text
    assert "[proc" not in text and "[proc 1] mean loss" in outputs[1] and "[proc 0]" not in outputs[0]
    assert len((log / "scalars.jsonl").read_text().splitlines()) == 2  # one train and one eval record
    assert summaries[1]["checkpoints"] == []
    names = sorted(pathlib.Path(p).name for p in summaries[0]["checkpoints"])
    assert names == sorted(p.name for p in log.glob("*.pt")) and "model_autosave.pt" in names
    trainer = Trainer(Config.from_json(cfg_path), device="cpu")
    restore_checkpoint(log / "model_autosave.pt", trainer)
    assert trainer.step == STEPS and trainer.optimizer.state


def test_two_process_train_resumes_on_every_process(two_processes, tmp_path):
    base, cfg_path, _, _ = two_processes
    cfg_path2 = _write_config(tmp_path / "cfg.json", data_path=Config.from_json(cfg_path).data_path,
                              logdir=str(tmp_path / "log"))
    summaries, outputs = _cli_ranks("train", tmp_path / "summary", [
        "--config_file", cfg_path2, "--seed", "1", "--dist_sampling", "replicated",
        "--resume", str(base / "log" / "model_autosave.pt"),
    ])
    assert [s["step"] for s in summaries] == [2 * STEPS, 2 * STEPS]
    assert f"at step {STEPS}" in (tmp_path / "log" / "log_train.txt").read_text()
    assert f"[proc 1] resumed from {base / 'log' / 'model_autosave.pt'} at step {STEPS}" in outputs[1]


def test_sharded_sampling_seeds_sizes_and_agreed_auto_windows(scenes, tmp_path):
    cfg_path = _write_config(tmp_path / "cfg.json", data_path=str(scenes), logdir=str(tmp_path / "log"))
    summaries, outputs = _cli_ranks("train", tmp_path / "summary", [
        "--config_file", cfg_path, "--seed", "3", "--bq_window", "auto", "--fp_window", "auto",
    ])
    for rank, output in enumerate(outputs):
        assert f"sampling sharded: seed {3 + 9973 * rank}, 2 clouds a draw, 2 rows a step" in output
    windows = [(s["bq_window"], s["fp_window"]) for s in summaries]
    assert windows[0] == windows[1]
    assert all(s["step"] == STEPS for s in summaries)


@pytest.mark.parametrize("argv,match", [
    (["--dist_sampling", "replicated", "--dist_num_processes", "2"], "replicated requires --seed"),
    (["--dist_num_processes", "3"], "must divide by the process count 3"),
    (["--dist_num_processes", "2", "--accum_steps", "4"], "--accum_steps 4 must divide"),
])
def test_train_refuses_a_batch_the_processes_cannot_split(scenes, tmp_path, capsys, argv, match):
    cfg_path = _write_config(tmp_path / "cfg.json", data_path=str(scenes), logdir=str(tmp_path / "log"))
    with pytest.raises(SystemExit):
        cli_train.main(["--config_file", cfg_path, "--device", "cpu", *argv])
    assert match in capsys.readouterr().err


@pytest.fixture(scope="module")
def one_process_predict(one_process, tmp_path_factory):
    base, cfg_path, _ = one_process
    out = tmp_path_factory.mktemp("predict_one")
    argv = ["--ckpt", str(base / "log" / "model.pt"), "--config_file", cfg_path, "--num_samples", "6",
            "--batch_size", "4", "--device", "cpu"]
    return argv, out, cli_predict.main(argv + ["--output_dir", str(out)])


@pytest.fixture(scope="module")
def two_process_predict(one_process_predict, tmp_path_factory):
    argv, _, _ = one_process_predict
    base = tmp_path_factory.mktemp("predict_two")
    argv = [a for a in argv if a != "--device" and a != "cpu"]
    summaries, outputs = _cli_ranks("predict", base / "summary", argv + ["--output_dir", str(base / "out")])
    return base / "out", summaries, outputs


def _root_predict_as_rank(rank: int, world: int, argv: list, out_dir: pathlib.Path, monkeypatch) -> np.ndarray:
    """The root ``predict.py`` in this process as rank ``rank`` of ``world``;
    returns the confusion matrix it hands to the gather. Only the script's
    own calls of ``jax.process_index``/``process_count`` see the rank: orbax's
    restore asks them too and wants a distributed client when the count is
    above 1."""
    import jax
    from jax.experimental import multihost_utils

    def for_the_script(value, real):
        return lambda: value if sys._getframe(1).f_globals.get("__name__") == "predict" else real()

    gathered = []

    def process_allgather(x):
        gathered.append(np.asarray(x))
        return np.asarray(x)[None]

    with monkeypatch.context() as mp:
        mp.setattr(jax, "process_index", for_the_script(rank, jax.process_index))
        mp.setattr(jax, "process_count", for_the_script(world, jax.process_count))
        mp.setattr(multihost_utils, "process_allgather", process_allgather)
        mp.setattr(sys, "argv", ["predict.py", *argv, "--output_dir", str(out_dir)])
        import predict

        with contextlib.redirect_stdout(io.StringIO()):
            predict.main()
    (matrix,) = gathered
    return matrix


def _port_predict_as_rank(rank: int, world: int, argv: list, out_dir: pathlib.Path, monkeypatch) -> dict:
    """The port's predict CLI in this process, with no group, as rank ``rank`` of ``world``."""
    with monkeypatch.context() as mp:
        mp.setattr(multihost, "process_index", lambda: rank)
        mp.setattr(multihost, "process_count", lambda: world)
        return cli_predict.main(argv + ["--output_dir", str(out_dir)])


@pytest.fixture(scope="module")
def orbax_checkpoint(one_process, tmp_path_factory):
    """The one-process run's ``model.pt`` as the JAX package's orbax checkpoint."""
    import jax

    from pointnet2_tpu.config import Config as JaxConfig
    from pointnet2_tpu.train.trainer import Trainer as JaxTrainer
    from pointnet2_tpu.train.trainer import save_checkpoint as jax_save_checkpoint

    base, cfg_path, _ = one_process
    variables = convert.to_flax_variables(load_model_state(base / "log" / "model.pt"))
    state = JaxTrainer(cfg=JaxConfig.from_json(cfg_path)).init_state(jax.random.PRNGKey(0))
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    path = tmp_path_factory.mktemp("orbax") / "model"
    jax_save_checkpoint(str(path), state)
    return path


def test_two_process_predict_splits_the_scenes_and_gathers_the_matrix(
        one_process_predict, two_process_predict, orbax_checkpoint, tmp_path, monkeypatch):
    argv, _, _ = one_process_predict
    out, summaries, outputs = two_process_predict
    port_argv = argv
    root_argv = [a for a in argv if a not in ("--device", "cpu")]
    root_argv[root_argv.index("--ckpt") + 1] = str(orbax_checkpoint)
    rank_matrices = []
    for rank, summary in enumerate(summaries):
        mine = validation_file_prefixes[rank::2]
        names = [pathlib.Path(p).stem for pair in summary["outputs"] for p in pair]
        assert names == [prefix for prefix in mine for _ in range(2)]
        alone = _port_predict_as_rank(rank, 2, port_argv, tmp_path / f"port{rank}", monkeypatch)
        rank_matrices.append(alone["confusion"])
        root_matrix = _root_predict_as_rank(rank, 2, root_argv, tmp_path / f"root{rank}", monkeypatch)
        got, want = [], []
        for prefix in mine:
            for suffix in (".pcd", ".labels"):
                assert (out / f"{prefix}{suffix}").read_bytes() == (tmp_path / f"port{rank}" / f"{prefix}{suffix}").read_bytes()
            assert (out / f"{prefix}.pcd").read_bytes() == (tmp_path / f"root{rank}" / f"{prefix}.pcd").read_bytes()
            got.append(load_labels(out / f"{prefix}.labels"))
            want.append(load_labels(tmp_path / f"root{rank}" / f"{prefix}.labels"))
        got, want = np.concatenate(got), np.concatenate(want)
        assert got.shape == want.shape == (len(mine) * 6 * SMALL["num_point"],)
        assert (got == want).mean() >= LABEL_AGREEMENT
        if np.array_equal(got, want):
            np.testing.assert_array_equal(alone["confusion"], root_matrix)
    for summary in summaries:
        np.testing.assert_array_equal(summary["confusion"], sum(rank_matrices))
    assert "Confusion matrix" in outputs[0] and "Confusion matrix" not in outputs[1]


def test_two_process_predict_draws_each_ranks_scenes_on_a_fresh_stream(one_process_predict, two_process_predict):
    """Process 1 starts its first scene on a fresh stream; a one-process run
    draws that scene after scene 0's samples, so the two differ."""
    _, want_dir, want = one_process_predict
    out, summaries, _ = two_process_predict
    first = validation_file_prefixes[1]
    assert (out / f"{first}.pcd").read_bytes() != (want_dir / f"{first}.pcd").read_bytes()
    assert [s["samples"] for s in summaries] == [6 * 3, 6 * 3] and want["samples"] == 6 * 6


@pytest.mark.parametrize("shards,batch", [(2, 4), (4, 4), (3, 3)])
def test_sharded_predict_gives_the_unsharded_labels(one_process_predict, tmp_path, monkeypatch, shards, batch):
    argv, want_dir, want = one_process_predict
    argv = [a if a != "4" else str(batch) for a in argv]
    unsharded = cli_predict.main(argv + ["--output_dir", str(tmp_path / "plain")]) if batch != 4 else want
    plain_dir = want_dir if batch == 4 else tmp_path / "plain"
    monkeypatch.setattr(cli_predict, "cli_mesh", lambda name: (torch.device(name),) * shards)
    got = cli_predict.main(argv + ["--output_dir", str(tmp_path / "sharded"), "--sharded"])
    assert got["samples"] == unsharded["samples"] == 6 * len(validation_file_prefixes)
    np.testing.assert_array_equal(got["confusion"], unsharded["confusion"])
    for prefix in validation_file_prefixes:
        for suffix in (".pcd", ".labels"):
            assert (tmp_path / "sharded" / f"{prefix}{suffix}").read_bytes() == \
                (plain_dir / f"{prefix}{suffix}").read_bytes()


def test_sharded_predict_needs_a_batch_the_devices_divide(one_process_predict, monkeypatch, capsys):
    argv, _, _ = one_process_predict
    monkeypatch.setattr(cli_predict, "cli_mesh", lambda name: (torch.device(name),) * 3)
    with pytest.raises(SystemExit):
        cli_predict.main(argv + ["--sharded"])
    assert "--sharded: batch_size 4 must divide by the device count 3" in capsys.readouterr().err


def test_interpolate_sharded_over_two_shards_writes_the_device_engines_files(tmp_path, monkeypatch):
    for name in ("gt", "sparse"):
        (tmp_path / name).mkdir()
    fabricated.fabricate_dense(tmp_path / "gt", tmp_path / "sparse", 0, "validation", (3000,) * 6, (400,) * 6)
    common = ["--set", "validation", "--sparse_dir", str(tmp_path / "sparse"), "--gt_dir", str(tmp_path / "gt"),
              "--device", "cpu"]
    cli_interpolate.main(common + ["--engine", "device", "--dense_dir", str(tmp_path / "device")])
    monkeypatch.setattr(cli_interpolate, "cli_mesh", lambda name: (torch.device(name),) * 2)
    summary = cli_interpolate.main(common + ["--engine", "sharded", "--dense_dir", str(tmp_path / "sharded")])
    assert summary["points"] == [3000] * 6
    for prefix in validation_file_prefixes:
        for suffix in (".labels", "_colored.pcd"):
            name = f"{prefix}{suffix}"
            assert (tmp_path / "sharded" / name).read_bytes() == (tmp_path / "device" / name).read_bytes()
