"""The port's reference TF-checkpoint conversion against the JAX package's.

Seeded SSG trees (``convert.init_variables``, random moving statistics, with
colour and without): each of the five functions, ``read_tf_checkpoint``,
``tf_vars_to_flax``, ``to_preprojected``, ``flax_to_tf_vars`` and
``convert_checkpoint``, gives what ``pointnet2_tpu.convert``'s gives, bit
for bit, in the plain and the pre-projected layouts; an MSG tree raises
where JAX raises; a path that is not an ``.npz`` goes to ``tensorflow``,
which raises ``ImportError`` where it is absent and otherwise reads a TF1
checkpoint (optimizer slots left out) as the JAX function does. Then
``tools.convert_checkpoint`` on the CPU: its ``.pt`` holds the tree's
``state_dict`` at step 0, the port's eval logits on it agree with the JAX
model's on the JAX conversion of the same ``.npz`` within atol=1e-4,
rtol=1e-4 (``tests/test_torch_model.py``'s tolerance) with equal labels,
and ``cli.predict --ckpt`` and ``cli.train --resume`` take it.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import pointnet2_tpu.convert as jax_convert
from pointnet2_tpu_torch import convert
from pointnet2_tpu_torch.cli import predict as cli_predict
from pointnet2_tpu_torch.cli import train as cli_train
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.infer import Predictor
from pointnet2_tpu_torch.tools import convert_checkpoint as convert_cli
from pointnet2_tpu_torch.tools import scenes as fabricated
from pointnet2_tpu_torch.train import load_model_state
from test_torch_model import SMALL, _cloud, _jax_logits

CASES = [(1, 0), (0, 3)]  # (use_color, seed)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _tree(use_color: int, seed: int) -> dict:
    return convert.init_variables(Config(use_color=use_color, **SMALL), 9, seed, bn_stats="random")


def assert_same(got, want, path="") -> None:
    """Equal trees: the same keys, and arrays of the same dtype, shape and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for key in want:
            assert_same(got[key], want[key], f"{path}/{key}")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), path


@pytest.mark.parametrize("use_color,seed", CASES)
def test_flax_to_tf_vars_is_the_jax_functions(use_color, seed):
    tree = _tree(use_color, seed)
    tf_vars = convert.flax_to_tf_vars(tree)
    assert len(tf_vars) == 134
    assert_same(tf_vars, jax_convert.flax_to_tf_vars(tree))
    plain = jax_convert.tf_vars_to_flax(tf_vars, pre_project=False)
    assert_same(convert.flax_to_tf_vars(plain), jax_convert.flax_to_tf_vars(plain))


@pytest.mark.parametrize("pre_project", [True, False])
@pytest.mark.parametrize("use_color,seed", CASES)
def test_tf_vars_to_flax_is_the_jax_functions(use_color, seed, pre_project):
    tf_vars = jax_convert.flax_to_tf_vars(_tree(use_color, seed))
    got = convert.tf_vars_to_flax(tf_vars, pre_project=pre_project)
    assert_same(got, jax_convert.tf_vars_to_flax(tf_vars, pre_project=pre_project))
    if pre_project:
        assert_same(got, _tree(use_color, seed))  # the round trip gives the tree back


@pytest.mark.parametrize("use_color,seed", CASES)
def test_to_preprojected_is_the_jax_functions(use_color, seed):
    plain = jax_convert.tf_vars_to_flax(jax_convert.flax_to_tf_vars(_tree(use_color, seed)), pre_project=False)
    assert_same(convert.to_preprojected(plain), jax_convert.to_preprojected(plain))
    stat_less = {"params": plain["params"]}  # a gradient tree has no moving statistics
    assert_same(convert.to_preprojected(stat_less), jax_convert.to_preprojected(stat_less))


@pytest.mark.parametrize("pre_project", [True, False])
@pytest.mark.parametrize("use_color,seed", CASES)
def test_read_and_convert_the_npz_the_jax_function_wrote(tmp_path, use_color, seed, pre_project):
    path = tmp_path / "ref.npz"
    np.savez(path, **jax_convert.flax_to_tf_vars(_tree(use_color, seed)))
    assert_same(convert.read_tf_checkpoint(str(path)), jax_convert.read_tf_checkpoint(str(path)))
    assert_same(convert.convert_checkpoint(str(path), pre_project=pre_project),
                jax_convert.convert_checkpoint(str(path), pre_project=pre_project))


def test_state_dict_from_tf_is_from_flax_variables_of_the_tree(tmp_path):
    tree = _tree(1, 5)
    np.savez(tmp_path / "ref.npz", **convert.flax_to_tf_vars(tree))
    got = convert.state_dict_from_tf(str(tmp_path / "ref.npz"))
    want = convert.from_flax_variables(tree)
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], v) for k, v in want.items())


@pytest.mark.parametrize("fn", ["flax_to_tf_vars", "to_preprojected"])
def test_an_msg_tree_raises_where_jax_raises(fn):
    tree = convert.init_variables(Config(**SMALL), 9, 0, bn_stats="random", arch="msg")
    with pytest.raises(KeyError) as want:
        getattr(jax_convert, fn)(tree)
    with pytest.raises(KeyError) as got:
        getattr(convert, fn)(tree)
    assert str(got.value) == str(want.value) == "'mlp'"


def test_an_unknown_variable_raises_as_in_jax():
    tf_vars = {"layer1/conv0/kernel": np.zeros((1, 1, 6, 32), np.float32)}
    with pytest.raises(ValueError, match="unrecognized reference variable: layer1/conv0/kernel"):
        jax_convert.tf_vars_to_flax(tf_vars)
    with pytest.raises(ValueError, match="unrecognized reference variable: layer1/conv0/kernel"):
        convert.tf_vars_to_flax(tf_vars)


def test_a_tf_checkpoint_without_tensorflow_fails_on_its_import(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)  # as where it is not installed
    with pytest.raises(ImportError) as want:
        jax_convert.read_tf_checkpoint(str(tmp_path / "model.ckpt"))
    with pytest.raises(ImportError) as got:
        convert.read_tf_checkpoint(str(tmp_path / "model.ckpt"))
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)
    assert "tensorflow" in str(got.value)


def test_a_tf1_checkpoint_reads_as_in_jax(tmp_path):
    """A TF1 saver's checkpoint of the reference names, with an Adam slot and
    the global step, written and read in a process of its own (tensorflow
    takes some 15 s to import)."""
    pytest.importorskip("tensorflow")
    np.savez(tmp_path / "ref.npz", **convert.flax_to_tf_vars(_tree(1, 2)))
    script = textwrap.dedent(f"""
        import sys
        import numpy as np
        import tensorflow as tf
        import pointnet2_tpu.convert as jax_convert
        from pointnet2_tpu_torch import convert
        from test_torch_convert_tf import assert_same
        with np.load({str(tmp_path / "ref.npz")!r}) as z:
            tf_vars = {{k: z[k] for k in z.files}}
        with tf.Graph().as_default():
            for name, value in tf_vars.items():
                tf.compat.v1.Variable(value, name=name)
            tf.compat.v1.Variable(np.zeros(3, np.float32), name="layer1/conv0/weights/Adam")
            tf.compat.v1.Variable(0, name="global_step")
            saver = tf.compat.v1.train.Saver()
            with tf.compat.v1.Session() as sess:
                sess.run(tf.compat.v1.global_variables_initializer())
                prefix = saver.save(sess, {str(tmp_path / "model.ckpt")!r})
        got = convert.read_tf_checkpoint(prefix)
        assert_same(got, jax_convert.read_tf_checkpoint(prefix))
        assert_same(got, tf_vars)
        assert_same(convert.convert_checkpoint(prefix), jax_convert.convert_checkpoint(prefix))
        print("read", len(got))
    """)
    run = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path), env={**os.environ, "PYTHONPATH": f"{ROOT}:{ROOT / 'tests'}"})
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    assert "read 134" in run.stdout


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """``tools.convert_checkpoint`` on the CPU from an ``.npz`` of the JAX
    package's ``flax_to_tf_vars``, at ``test_torch_model.SMALL``'s widths."""
    base = tmp_path_factory.mktemp("convert_tf")
    cfg = Config(**SMALL, batch_size=2, max_epoch=1)
    tree = _tree(1, 7)
    np.savez(base / "ref.npz", **jax_convert.flax_to_tf_vars(tree))
    (base / "cfg.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    summary = convert_cli.main(["--tf_ckpt", str(base / "ref.npz"), "--out", str(base / "model.pt"),
                                "--config_file", str(base / "cfg.json"), "--device", "cpu"])
    return base, cfg, tree, summary


def test_the_converted_checkpoint_is_the_trees_state_at_step_0(converted):
    base, _, tree, summary = converted
    ckpt = torch.load(base / "model.pt", weights_only=True)
    want = convert.from_flax_variables(tree)
    assert ckpt["step"] == 0 and ckpt["optimizer"]["state"] == {} and summary["tensors"] == len(want)
    assert sorted(ckpt["model"]) == sorted(want) and all(torch.equal(ckpt["model"][k], v) for k, v in want.items())


def test_the_converted_checkpoint_gives_the_jax_models_logits(converted):
    base, cfg, _, _ = converted
    x = _cloud(11, 3, cfg.num_point, 1)
    want = _jax_logits(SMALL, 1, jax_convert.convert_checkpoint(str(base / "ref.npz")), x)
    with torch.no_grad():
        got = Predictor(cfg, load_model_state(base / "model.pt"), device="cpu").infer_logits(x).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_the_converted_checkpoint_loads_into_the_predict_and_train_clis(converted, tmp_path, monkeypatch):
    base, cfg, _, _ = converted
    monkeypatch.setattr(fabricated, "SCENE_POINTS", 2000)
    (tmp_path / "scenes").mkdir()
    fabricated.fabricate(tmp_path / "scenes", 0)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(dataclasses.asdict(cfg.replace(
        data_path=str(tmp_path / "scenes"), logdir=str(tmp_path / "log")))))
    summary = cli_predict.main(["--ckpt", str(base / "model.pt"), "--config_file", str(cfg_path), "--num_samples",
                                "2", "--output_dir", str(tmp_path / "out"), "--device", "cpu"])
    assert summary["samples"] == 2 * 6 and len(summary["outputs"]) == 6
    trained = cli_train.main(["--config_file", str(cfg_path), "--seed", "0", "--resume", str(base / "model.pt"),
                              "--device", "cpu"])
    steps = trained["epochs"][0]["train_batches"]
    assert steps > 0 and trained["step"] == steps
    assert f"resumed from {base / 'model.pt'} at step 0" in (tmp_path / "log" / "log_train.txt").read_text()


def test_the_converter_refuses_a_checkpoint_of_another_shape(converted, tmp_path):
    base, cfg, _, _ = converted
    (tmp_path / "cfg.json").write_text(json.dumps(dataclasses.asdict(cfg.replace(use_color=0))))
    with pytest.raises(RuntimeError, match="size mismatch"):  # load_state_dict, strict
        convert_cli.main(["--tf_ckpt", str(base / "ref.npz"), "--out", str(tmp_path / "model.pt"),
                          "--config_file", str(tmp_path / "cfg.json"), "--device", "cpu"])


def test_the_converter_defaults_to_the_card(converted, tmp_path, monkeypatch):
    base, _, _, _ = converted
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        convert_cli.main(["--tf_ckpt", str(base / "ref.npz"), "--out", str(tmp_path / "model.pt"),
                          "--config_file", str(base / "cfg.json")])
    assert not (tmp_path / "model.pt").exists()
