"""The port's train and predict CLIs on the CPU, and its predict CLI against the root ``predict.py``.

Fabricated Semantic3D scenes (as ``tests/test_train_cli.py`` makes them) at
the small widths of ``tests/test_predict_cli.py``: 512 points, batch 2, SA
128/64/16/8. The port runs with ``--device cpu`` (the plain operators).

- The train CLI: its log, scalars and checkpoints; ``--resume`` continuing
  the step; ``--bq_window auto``; the abort on a failed window certificate;
  CUDA as the default device (the multi-process and sharded modes are
  ``tests/test_torch_dist_cli.py``'s).
- The predict CLI against the root ``predict.py``, both run once on the same
  validation scenes from the same weights: the JAX side saves its
  ``init_state`` with orbax, the port gets the same variables through
  ``convert.from_flax_variables`` and its own ``save_checkpoint``. The
  ``.pcd`` files must be equal byte for byte (the same samples); the
  ``.labels`` equal on >= 99.99 % of points (the logits agree to about 1e-6
  relative, ``tests/test_torch_model.py``; an argmax could flip only on a
  near-tie), and so the printed confusion matrices.
"""

import contextlib
import dataclasses
import io as text_io
import json
import sys

import numpy as np
import pytest
import torch

from pointnet2_tpu_torch.cli import predict as cli_predict
from pointnet2_tpu_torch.cli import train as cli_train
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.data.io import load_labels, read_pcd, write_labels, write_pcd
from pointnet2_tpu_torch.data.semantic3d import train_file_prefixes, validation_file_prefixes
from pointnet2_tpu_torch.infer import Predictor
from pointnet2_tpu_torch.train import Trainer, load_model_state, restore_checkpoint, save_checkpoint

LABEL_AGREEMENT = 0.9999

# As tests/test_torch_model.py does for every worker of a whole run: the CLIs'
# plain operators are many small parallel regions, and PyTorch's default of a
# thread a core in each of several workers made one train CLI run 60 times
# slower (5 s alone, 320 s in 4 workers).
torch.set_num_threads(2)
SMALL = dict(num_point=512, batch_size=2, l1_npoint=128, l2_npoint=64, l3_npoint=16, l4_npoint=8)


def _write_config(path, **kw) -> str:
    path.write_text(json.dumps(dataclasses.asdict(Config(**{**SMALL, "max_epoch": 1, **kw}))))
    return str(path)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    data_dir = tmp_path_factory.mktemp("cli_scenes")
    rng = np.random.RandomState(0)
    for prefix in train_file_prefixes + validation_file_prefixes:
        pts = rng.rand(2000, 3) * [20.0, 20.0, 4.0]
        labels = np.where(pts[:, 2] < 2.0, 1, 5).astype(np.int32)
        write_pcd(data_dir / f"{prefix}.pcd", pts, rng.rand(2000, 3))
        write_labels(data_dir / f"{prefix}.labels", labels)
    return data_dir


@pytest.fixture(scope="module")
def trained(scenes, tmp_path_factory):
    base = tmp_path_factory.mktemp("cli_train")
    cfg_path = _write_config(base / "cfg.json", data_path=str(scenes), logdir=str(base / "log"))
    summary = cli_train.main(["--config_file", cfg_path, "--seed", "0", "--device", "cpu"])
    return base, cfg_path, summary


def test_train_cli_artifacts(trained):
    base, cfg_path, summary = trained
    log = base / "log"
    text = (log / "log_train.txt").read_text()
    for line in ("EPOCH 000", "mean loss", "Average IoU", "IoU of buildings", "eval accuracy",
                 "eval IoU of", "Autosaved state", "sampler threads: 1", "host ms a step"):
        assert line in text, line
    records = [json.loads(line) for line in (log / "scalars.jsonl").read_text().splitlines()]
    assert {r["tag"] for r in records} == {"train", "validation"}
    assert {"loss", "accuracy", "learning_rate", "bn_decay"} <= set(records[0])
    names = {p.name for p in log.iterdir()}
    assert {"model.pt", "model_autosave.pt", "best_model_epoch_000.pt"} <= names

    cfg = Config.from_json(cfg_path)
    steps = 9 * 2000 // (cfg.batch_size * cfg.num_point)
    assert summary["step"] == steps and len(summary["epochs"][0]["step_ms"]) == steps
    assert summary["epochs"][0]["val_batches"] == 6 * 2000 // (cfg.batch_size * cfg.num_point)
    states = []
    for name in ("model.pt", "model_autosave.pt", "best_model_epoch_000.pt"):
        trainer = Trainer(cfg, device="cpu")
        restore_checkpoint(log / name, trainer)
        assert trainer.step == steps and trainer.optimizer.state
        states.append(load_model_state(log / name))
    for state in states[1:]:
        assert all(torch.equal(state[k], v) for k, v in states[0].items())


def test_train_cli_resume_continues_the_step(trained, tmp_path):
    base, cfg_path, summary = trained
    cfg_path2 = _write_config(tmp_path / "cfg.json", data_path=Config.from_json(cfg_path).data_path,
                              logdir=str(tmp_path / "log"))
    resumed = cli_train.main(["--config_file", cfg_path2, "--seed", "1", "--device", "cpu",
                              "--resume", str(base / "log" / "model_autosave.pt")])
    assert resumed["step"] == 2 * summary["step"]
    assert f"at step {summary['step']}" in (tmp_path / "log" / "log_train.txt").read_text()


def test_train_cli_auto_windows(scenes, tmp_path):
    cfg_path = _write_config(tmp_path / "cfg.json", data_path=str(scenes), logdir=str(tmp_path / "log"))
    cli_train.main(["--config_file", cfg_path, "--seed", "0", "--device", "cpu",
                    "--bq_window", "auto", "--fp_window", "auto"])
    text = (tmp_path / "log" / "log_train.txt").read_text()
    assert "auto window calibration" in text and "mean loss" in text  # a whole epoch: no abort


@pytest.mark.parametrize("failing_step,match", [("train_step", "failed on a training batch"),
                                                ("eval_step", "failed on a validation batch")])
def test_train_cli_aborts_on_a_failed_certificate(scenes, tmp_path, monkeypatch, failing_step, match):
    """The certificates are set at the Trainer, False for the step under test
    and True for the other: at these widths SA1's 128 centroids are one tile,
    so no window that engages can certify, and the train steps would abort
    first."""
    for step in ("train_step", "eval_step"):
        original = getattr(Trainer, step)

        def forced(self, *args, _original=original, _ok=step != failing_step, **kwargs):
            metrics = _original(self, *args, **kwargs)
            metrics["window_ok"] = torch.tensor(_ok)
            return metrics

        monkeypatch.setattr(Trainer, step, forced)
    cfg_path = _write_config(tmp_path / "cfg.json", data_path=str(scenes), logdir=str(tmp_path / "log"))
    with pytest.raises(ValueError, match=match):
        cli_train.main(["--config_file", cfg_path, "--seed", "0", "--device", "cpu", "--bq_window", "256"])
    assert "Autosaved state" in (tmp_path / "log" / "log_train.txt").read_text()


_MAINS = {"train": cli_train.main, "predict": cli_predict.main}


@pytest.mark.parametrize("cli", ["train", "predict"])
def test_cli_runs_on_cuda_by_default_and_raises_without_it(cli, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _MAINS[cli](["--ckpt", "unused.pt"] if cli == "predict" else [])


@pytest.mark.parametrize("cli", ["train", "predict"])
def test_cli_says_it_cannot_read_an_orbax_directory(cli, scenes, tmp_path):
    cfg_path = _write_config(tmp_path / "cfg.json", data_path=str(scenes), logdir=str(tmp_path / "log"))
    orbax_dir = tmp_path / "model_autosave"
    orbax_dir.mkdir()
    flag = "--ckpt" if cli == "predict" else "--resume"
    with pytest.raises(ValueError, match="cannot read the JAX package's orbax checkpoint directories"):
        _MAINS[cli](["--config_file", cfg_path, "--device", "cpu", flag, str(orbax_dir)])


# -- the predict CLI against the root predict.py ------------------------------


@pytest.fixture(scope="module")
def both_predicts(scenes, tmp_path_factory):
    """Root ``predict.py`` and the port's CLI on the validation split, the same
    weights and flags: 3 samples a scene in batches of 2 (the JAX side pads
    the last batch; the port runs it short). Each run once."""
    import jax

    from pointnet2_tpu.config import Config as JaxConfig
    from pointnet2_tpu.train.trainer import Trainer as JaxTrainer
    from pointnet2_tpu.train.trainer import save_checkpoint as jax_save_checkpoint

    base = tmp_path_factory.mktemp("cli_predict")
    cfg_path = _write_config(base / "cfg.json", data_path=str(scenes), logdir=str(base / "log"))
    state = JaxTrainer(cfg=JaxConfig.from_json(cfg_path)).init_state(jax.random.PRNGKey(0))
    jax_save_checkpoint(str(base / "orbax"), state)
    variables = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    trainer = Trainer(Config.from_json(cfg_path), device="cpu")
    trainer.load_variables(variables)
    save_checkpoint(base / "port.pt", trainer)

    common = ["--set", "validation", "--config_file", cfg_path, "--num_samples", "3", "--batch_size", "2"]
    printed = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR", str(base / "jax_cache"))
        argv = ["predict.py", "--ckpt", str(base / "orbax"), "--output_dir", str(base / "jax")] + common
        mp.setattr(sys, "argv", argv)
        import predict

        with contextlib.redirect_stdout(text_io.StringIO()) as out:
            predict.main()
        printed["jax"] = out.getvalue()
    with contextlib.redirect_stdout(text_io.StringIO()) as out:
        summary = cli_predict.main(["--ckpt", str(base / "port.pt"), "--output_dir", str(base / "port"),
                                    "--device", "cpu"] + common)
    printed["port"] = out.getvalue()
    return base, printed, summary


def test_predict_cli_writes_the_root_predicts_points(both_predicts):
    base, _, summary = both_predicts
    assert summary["samples"] == 6 * 3 and len(summary["outputs"]) == 6
    for prefix in validation_file_prefixes:
        port, ref = base / "port" / f"{prefix}.pcd", base / "jax" / f"{prefix}.pcd"
        assert port.read_bytes() == ref.read_bytes()
        assert len(read_pcd(port)) == 3 * SMALL["num_point"]


def test_predict_cli_labels_agree_with_the_root_predict(both_predicts):
    base, printed, _ = both_predicts
    got = np.concatenate([load_labels(base / "port" / f"{p}.labels") for p in validation_file_prefixes])
    want = np.concatenate([load_labels(base / "jax" / f"{p}.labels") for p in validation_file_prefixes])
    assert got.shape == want.shape == (6 * 3 * SMALL["num_point"],)
    assert (got == want).mean() >= LABEL_AGREEMENT
    if np.array_equal(got, want):
        metrics = [text[text.index("Confusion matrix:"):] for text in (printed["port"], printed["jax"])]
        assert metrics[0] == metrics[1]


@pytest.fixture(scope="module")
def port_predict(scenes, tmp_path_factory):
    """The port's predict CLI alone, on seeded weights (no JAX)."""
    from pointnet2_tpu_torch import convert

    base = tmp_path_factory.mktemp("cli_port_predict")
    cfg_path = _write_config(base / "cfg.json", data_path=str(scenes), logdir=str(base / "log"))
    trainer = Trainer(Config.from_json(cfg_path), device="cpu")
    trainer.load_variables(convert.init_variables(trainer.cfg, 9, seed=4, bn_stats="random"))
    save_checkpoint(base / "port.pt", trainer)
    cli_predict.main(["--ckpt", str(base / "port.pt"), "--output_dir", str(base / "port"), "--device", "cpu",
                      "--set", "validation", "--config_file", cfg_path, "--num_samples", "3", "--batch_size", "2"])
    return base


def test_predict_cli_labels_are_the_predictors_on_its_samples(port_predict):
    """The CLI's files against a Predictor fed the samples drawn as the CLI
    draws them: a fresh SemanticDataset(seed=0) after np.random.seed(0)."""
    from pointnet2_tpu_torch.data.semantic3d import SemanticDataset

    base = port_predict
    cfg = Config.from_json(base / "cfg.json")
    predictor = Predictor(cfg, load_model_state(base / "port.pt"), device="cpu", impl="torch")
    np.random.seed(0)
    dataset = SemanticDataset(cfg.num_point, "validation", True, cfg.box_size_x, cfg.box_size_y, cfg.data_path, seed=0)
    for fd in dataset.list_file_data:
        prefix = fd.file_path_without_ext.rsplit("/", 1)[-1]
        raws, labels = [], []
        for current in (2, 1):
            centered, raw, _, colors = fd.sample_batch(current, cfg.num_point)
            raws.append(raw.reshape(-1, 3))
            labels.append(predictor.predict_step(np.concatenate((centered, colors), -1).astype(np.float32)).numpy())
        assert np.array_equal(read_pcd(base / "port" / f"{prefix}.pcd").points,
                              np.concatenate(raws).astype(np.float32).astype(np.float64))
        assert np.array_equal(load_labels(base / "port" / f"{prefix}.labels"), np.concatenate(labels).reshape(-1))


def test_predict_cli_auto_windows_and_certificate_abort(port_predict, monkeypatch, capsys):
    base = port_predict
    argv = ["--ckpt", str(base / "port.pt"), "--set", "validation", "--config_file", str(base / "cfg.json"),
            "--num_samples", "2", "--batch_size", "2", "--device", "cpu"]
    cli_predict.main(argv + ["--output_dir", str(base / "auto"), "--bq_window", "auto", "--fp_window", "auto"])
    assert "auto window calibration" in capsys.readouterr().out
    labels = load_labels(base / "auto" / f"{validation_file_prefixes[0]}.labels")
    assert len(labels) == 2 * SMALL["num_point"] and labels.min() >= 0 and labels.max() < 9

    def failing(self, points):
        return self.predict_step(points), False

    monkeypatch.setattr(Predictor, "predict_step_checked", failing)
    with pytest.raises(ValueError, match="exactness certificate failed on batch 0"):
        cli_predict.main(argv + ["--output_dir", str(base / "abort"), "--bq_window", "256"])


def test_fabricated_scenes_make_the_smoke_epoch(tmp_path):
    """``tools.scenes`` at ``semantic.json``'s widths, as ``chip_smoke.py``'s
    CLI phase uses them: 4 train batches and 2 validation batches of 16 x
    8192 an epoch, and every box thinned from more than 8192 points (no
    point repeated), which the calibrated windows' margin rests on."""
    from pointnet2_tpu_torch.data.semantic3d import SemanticDataset
    from pointnet2_tpu_torch.tools import scenes

    scenes.fabricate(tmp_path, 0)
    cfg = Config.from_json(scenes.ROOT / "semantic.json").replace(data_path=str(tmp_path))
    for split, batches in (("train", 4), ("validation", 2)):
        ds = SemanticDataset(cfg.num_point, split, True, cfg.box_size_x, cfg.box_size_y, cfg.data_path, seed=0)
        assert ds.get_num_batches(cfg.batch_size) == batches
        for fd in ds.list_file_data:
            xy = fd.points[:, :2]
            corners = [xy[np.argmin(xy @ d)] for d in ([1, 1], [-1, -1], [1, -1], [-1, 1])]
            # The smallest box: centred on the scene point nearest a corner.
            assert min(int(np.all(np.abs(xy - c) <= 5.0, axis=1).sum()) for c in corners) > cfg.num_point
        raw = ds.list_file_data[0].sample_batch(4, cfg.num_point)[1]
        assert all(len(np.unique(cloud, axis=0)) == cfg.num_point for cloud in raw)
