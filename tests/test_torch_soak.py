"""The port's training soaks on the CPU, against the JAX repo's tools and Trainer.

- ``tools.train_soak``: the JAX ``tools/train_soak.py`` run with its
  ``train`` module stood in (it copies the scenes and the config the tool
  made, and the port's run's log directory into its ``--out``), beside the
  port's tool run end to end with ``--device cpu`` at its smallest (8 000
  points a scene, one epoch: two steps of 16 x 2048 under ``--accum_steps
  4`` with ``auto`` windows and selective bf16, one evaluation):
  ``make_scene``'s 15 scenes equal byte for byte, the soak ``Config`` JSON
  equal byte for byte, the flags forwarded to the train CLI the same, the
  summary lines printed from the same ``scalars.jsonl`` equal line for line,
  and the port's checkpoints written and restored.
- ``tools.bf16_train_soak.presample``: the batches equal, byte for byte, the
  ones the JAX ``SemanticDataset`` draws from the same scenes in the JAX
  tool's order (seed 0 train, seed 1 validation).
- A 30-step drift test at ``tests/test_torch_cli.py``'s small widths (512
  points, batch 2, SA 128/64/16/8): the port's ``Trainer`` and the JAX
  ``Trainer`` (XLA path, flax's dropout patched out as in
  ``tests/test_torch_train.py``; the port's ``dropout_rate=0``) from one
  converted seed-0 init, Adam, each running free on the same 30 batches
  pre-sampled from the soak's scenes. After step 30, validation accuracy
  within 0.02 and mIoU within 0.04 on 8 validation batches (the JAX soak
  tool's convergence tolerances). The loss of each of the first 10 steps is
  held within 1e-3 relative of the JAX step's loss on the port's own
  parameters and statistics of that step (the JAX state rebuilt from them
  before each step), not of the free-running JAX run's: Adam's first update
  moves every element by the learning rate times the sign of its gradient,
  and an element whose gradient is rounding noise moves either way
  (``tests/test_torch_train.py`` measured this in float64), so two
  free-running runs part after step 1. Readings (torch 2.13 on the CPU):
  free-running, the losses 2.7e-6 relative apart at step 1, 9.0e-4 at step
  2, 3.5e-3 at 3 and up to 5.0e-2 by step 10; on the port's own parameters
  at most 1.05e-5; after step 30 accuracy 0.5382 against 0.5393 and mIoU
  0.2325 against 0.2324.
"""

import contextlib
import importlib.util
import io as text_io
import pathlib
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from pointnet2_tpu_torch import convert
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.data.semantic3d import train_file_prefixes, validation_file_prefixes
from pointnet2_tpu_torch.tools import bf16_train_soak, train_soak
from pointnet2_tpu_torch.train import Trainer, restore_checkpoint
from pointnet2_tpu_torch.utils.metrics import ConfusionMatrix

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCENE_POINTS = 8_000
SOAK_FLAGS = ["--accum_steps", "4", "--bq_window", "auto", "--fp_window", "auto", "--train_dtype", "bfloat16",
              "--bf16_min_width", "128"]
SMALL = dict(num_point=512, batch_size=2, l1_npoint=128, l2_npoint=64, l3_npoint=16, l4_npoint=8)
DRIFT_STEPS, DRIFT_EVAL_BATCHES = 30, 8
LOSS_RTOL = 1e-3  # each of the first 10 steps
ACC_TOL, MIOU_TOL = 0.02, 0.04

torch.set_num_threads(2)


def _load_root(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def soaks(tmp_path_factory):
    """The port's soak run once, then the JAX tool with its ``train`` stood in."""
    base = tmp_path_factory.mktemp("soak")
    port_out = base / "port_out"
    forwarded = {}
    real_train_main = train_soak.cli_train.main

    def port_train(argv):
        forwarded["port"] = list(argv)
        return real_train_main(argv)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_soak.cli_train, "main", port_train)

        def no_tensorboardx(*args, **kwargs):
            raise ImportError("tensorboardX")

        mp.setattr(train_soak, "export_tensorboard", no_tensorboardx)
        with contextlib.redirect_stdout(text_io.StringIO()) as out:
            port = train_soak.main(["--epochs", "1", "--points_per_scene", str(SCENE_POINTS), "--out", str(port_out),
                                    "--device", "cpu", *SOAK_FLAGS])
    port_printed = out.getvalue()

    jax_out = base / "jax_out"
    captured = base / "jax_scenes"

    def jax_train_main():
        # What the JAX tool made: its scenes and soak.json, and the flags it passes.
        argv = list(sys.argv)
        forwarded["jax"] = argv[1:]
        cfg_path = pathlib.Path(argv[argv.index("--config_file") + 1])
        shutil.copytree(cfg_path.parent, captured)
        shutil.rmtree(cfg_path.parent)  # the tool's mkdtemp directory, which it leaves behind
        # The run's log: the port's, so that both tools summarise the same records.
        shutil.copytree(port_out, jax_out, dirs_exist_ok=True)

    tool = _load_root("jax_train_soak", ROOT / "tools" / "train_soak.py")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "train", types.SimpleNamespace(main=jax_train_main))
        mp.setattr(sys, "argv", ["train_soak.py", "--epochs", "1", "--points_per_scene", str(SCENE_POINTS),
                                 "--out", str(jax_out), *SOAK_FLAGS])
        with contextlib.redirect_stdout(text_io.StringIO()) as out:
            tool.main()
    return {"port": port, "port_out": port_out, "port_printed": port_printed, "jax_printed": out.getvalue(),
            "captured": captured, "forwarded": forwarded, "base": base}


def test_make_scene_files_equal_the_jax_tools(soaks, tmp_path):
    train_soak.fabricate(str(tmp_path), SCENE_POINTS)
    prefixes = train_file_prefixes + validation_file_prefixes
    assert len(prefixes) == 15
    for prefix in prefixes:
        for ext in (".pcd", ".labels"):
            assert (tmp_path / f"{prefix}{ext}").read_bytes() == (soaks["captured"] / f"{prefix}{ext}").read_bytes()


def test_soak_config_json_equals_the_jax_tools(soaks, tmp_path):
    jax_json = (soaks["captured"] / "soak.json").read_bytes()
    jax_cfg = Config.from_json(soaks["captured"] / "soak.json")
    train_soak.soak_config(jax_cfg.data_path, 1, jax_cfg.logdir).to_json(tmp_path / "soak.json")
    assert (tmp_path / "soak.json").read_bytes() == jax_json
    assert (jax_cfg.num_point, jax_cfg.batch_size, jax_cfg.decay_step) == (2048, 16, 20000)
    assert [s.npoint for s in jax_cfg.sa_layers] == [512, 128, 32, 8]


def test_soak_forwards_the_jax_tools_flags(soaks):
    def pairs(argv):
        flags = dict(zip(argv[::2], argv[1::2]))
        flags.pop("--config_file")
        return flags

    port = pairs(soaks["forwarded"]["port"])
    assert port.pop("--device") == "cpu"
    assert port == pairs(soaks["forwarded"]["jax"])


def test_soak_prints_the_jax_tools_summary(soaks):
    def summary_lines(text):
        lines = text.splitlines()
        start = next(i for i, line in enumerate(lines) if line.startswith("epochs logged:"))
        return lines[start:]

    port, jax = summary_lines(soaks["port_printed"]), summary_lines(soaks["jax_printed"])
    assert port == jax
    assert port[0] == "epochs logged: 1  evals: 1"
    assert port[-1] == "checkpoints: ['best_model_epoch_000.pt', 'model.pt', 'model_autosave.pt']"
    assert "tensorboard export skipped: tensorboardX is not installed" in soaks["port_printed"]


def test_soak_checkpoints_restore(soaks):
    port = soaks["port"]
    assert port["checkpoints"] == ["best_model_epoch_000.pt", "model.pt", "model_autosave.pt"]
    summary = port["train_summary"]
    assert summary["step"] == summary["epochs"][0]["train_batches"] >= 1
    cfg = train_soak.soak_config("")
    trainer = Trainer(cfg, device="cpu", bq_window=summary["bq_window"], fp_window=summary["fp_window"])
    restore_checkpoint(soaks["port_out"] / "model_autosave.pt", trainer)
    assert trainer.step == summary["step"] and trainer.optimizer.state
    assert np.isfinite(port["train"][0]["loss"]) and 0.0 <= port["validation"][0]["accuracy"] <= 1.0


# -- the precision soak's batches ---------------------------------------------------


def test_precision_soak_batches_equal_the_jax_datasets(soaks):
    from pointnet2_tpu.data.semantic3d import SemanticDataset as JaxSemanticDataset

    cfg = train_soak.soak_config(str(soaks["captured"]))
    batches, val_batches = bf16_train_soak.presample(cfg, 3, 2)

    def jax_dataset(split, seed):
        return JaxSemanticDataset(
            num_points_per_sample=cfg.num_point, split=split, use_color=bool(cfg.use_color),
            box_size_x=cfg.box_size_x, box_size_y=cfg.box_size_y, path=cfg.data_path, seed=seed,
        )

    train_ds, val_ds = jax_dataset("train", 0), jax_dataset("validation", 1)
    want = [train_ds.sample_batch_in_all_files(cfg.batch_size, True) for _ in range(3)]
    want_val = [val_ds.sample_batch_in_all_files(cfg.batch_size, False) for _ in range(2)]
    for got, (data, labels, weights) in zip(batches + val_batches, want + want_val):
        for key, arr in zip(("points", "labels", "weights"), (data, labels, weights)):
            assert got[key].dtype == arr.dtype and got[key].tobytes() == arr.tobytes(), key


# -- 30 steps beside the JAX Trainer ------------------------------------------------


@pytest.fixture(scope="module")
def drift(soaks):
    import jax
    from flax.traverse_util import flatten_dict

    from pointnet2_tpu.config import Config as JaxConfig
    from test_torch_train import _jax_state, _jax_step, _jax_trainer, _tree

    cfg = Config(**SMALL, data_path=str(soaks["captured"]))
    batches, val_batches = bf16_train_soak.presample(cfg, DRIFT_STEPS, DRIFT_EVAL_BATCHES)
    tree = convert.init_variables(cfg, 9, seed=0)

    port = Trainer(cfg, device="cpu", dropout_rate=0.0)
    port.load_variables(tree)
    jt, patch = _jax_trainer(cfg=JaxConfig(**SMALL))
    state = _jax_state(jt, flatten_dict(tree))
    port_losses, jax_losses, lockstep = [], [], []
    try:
        for i, batch in enumerate(batches):
            if i < 10:  # the JAX step's loss on the port's parameters and statistics of this step
                lockstep.append(float(_jax_step(jt, _jax_state(jt, _tree(port)), batch)[1]["loss"]))
            port_losses.append(float(port.train_step(batch)["loss"]))
            state, metrics = _jax_step(jt, state, batch)
            jax_losses.append(float(metrics["loss"]))
        port_cm, jax_cm = ConfusionMatrix(9), ConfusionMatrix(9)
        for batch in val_batches:
            port_cm.increment_from_matrix(port.eval_step(batch)["confusion"])
            with jax.default_matmul_precision("highest"):
                jax_cm.increment_from_matrix(np.asarray(jt.eval_step(state, jax.tree.map(np.asarray, batch))["confusion"]))
    finally:
        patch.undo()
    return {"losses": (np.array(port_losses), np.array(jax_losses)), "lockstep": np.array(lockstep),
            "accuracy": (port_cm.get_accuracy(), jax_cm.get_accuracy()),
            "miou": (port_cm.get_mean_iou(), jax_cm.get_mean_iou())}


def test_drift_first_ten_losses(drift):
    port, jax = drift["losses"]
    rel = np.abs(port[:10] - drift["lockstep"]) / np.abs(drift["lockstep"])
    assert rel.max() <= LOSS_RTOL, rel
    assert abs(port[0] - jax[0]) <= LOSS_RTOL * abs(jax[0])  # the same first step, both runs free
    assert np.isfinite(port).all() and np.isfinite(jax).all() and port[-5:].mean() < port[:5].mean()


def test_drift_validation_after_thirty_steps(drift):
    (acc, jax_acc), (miou, jax_miou) = drift["accuracy"], drift["miou"]
    assert abs(acc - jax_acc) < ACC_TOL, (acc, jax_acc)
    assert abs(miou - jax_miou) < MIOU_TOL, (miou, jax_miou)
