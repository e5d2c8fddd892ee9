"""The port's ``torch.export`` artifacts against the JAX package's StableHLO artifacts, on the CPU.

Counterpart of ``tests/test_export.py``. Both sides get the same weights
(the JAX ``Trainer.init_state`` at ``PRNGKey(0)``, handed to the port
through ``convert.from_flax_variables``) and the same seeded numpy clouds;
the JAX artifact comes from ``pointnet2_tpu.export`` and the port's from
``pointnet2_tpu_torch.export`` with ``device="cpu"``, where its graph holds
the ``pn2`` operators' CPU implementations (the plain versions).

Tolerances. Float32 artifacts: logits within atol=1e-4, rtol=1e-4
(``tests/test_torch_model.py``'s bound for the eval forward: the two
backends sum their float32 matmuls in different orders), labels equal where
the top-2 margin of the logits exceeds 1e-3. The bf16 modes round at other
places in the two frameworks: their logits are held at 8u of the logits'
scale (u = 2**-8, ``tests/test_torch_precision.py``'s bound for the model
in bfloat16) and their labels where the margin exceeds twice that. Every
artifact of the port also equals its own eager ``Predictor`` bit for bit:
the trace runs the same operators in the same order.

Not ported: ``test_symbolic_batch_with_pallas_rejected``. The JAX package
refuses a symbolic batch with its kernels because a Mosaic grid needs
concrete shapes; a ``pn2`` operator plans its launch from the tensors it
gets at run time, so the port exports a symbolic batch with its kernels.

The JAX package's windows are advisory on the CPU (its ``ok`` is always
True and its labels the exact path's); the port computes the windowed
function and its real certificate there, so its ``ok`` is held to its own
eager ``Predictor.predict_step_checked`` and its labels to JAX's only
where ``ok`` holds.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import test_torch_model  # noqa: F401  (keeps JAX off the shared compilation cache)
from pointnet2_tpu.config import Config as JaxConfig
from pointnet2_tpu.export import export_model as jax_export_model
from pointnet2_tpu.export import load_exported as jax_load_exported
from pointnet2_tpu.train.trainer import Trainer as JaxTrainer
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.export import export_model, load_exported
from pointnet2_tpu_torch.infer import Predictor
from pointnet2_tpu_torch.tools import export_model as export_tool
from pointnet2_tpu_torch.train import Trainer, save_checkpoint
from test_torch_cli import _write_config, scenes  # noqa: F401  (scenes is a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_point=256, batch_size=4, l1_npoint=64, l2_npoint=32, l3_npoint=16, l4_npoint=8)
# Windows that engage at SA1 (512 queries of 1024 points, four tiles) and FP4
# (1024 queries among 512 coarse points) and certify on clouds spread along
# x. At SMALL one tile holds every SA1 query and a window certifies only
# when it covers the cloud; SA2's one tile is left exact here for that reason.
WINDOWED = dict(num_point=1024, batch_size=4, l1_npoint=512, l2_npoint=128, l3_npoint=32, l4_npoint=8)
BQ_WINDOW, FP_WINDOW = (512, None, None, None), 256
U = 2.0**-8


def _points(seed, b, cfg_kw=SMALL):
    """``tests/test_export.py``'s clouds: standard normal, float32."""
    return np.random.RandomState(seed).randn(b, cfg_kw["num_point"], 6).astype(np.float32)


def _strip(seed, b, extent_x):
    """Clouds of ``WINDOWED`` size spread uniformly over ``extent_x`` x 1 x 1 m, colours in [0, 1)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(b, WINDOWED["num_point"], 6).astype(np.float32)
    x[..., 0] *= extent_x
    return x


def _pair(tmp_path, cfg_kw=SMALL, batch=None, output="labels", **mode):
    """A JAX artifact and the same weights in a port ``Trainer`` of the same mode:
    ``(jax_fn, jax_manifest, trainer)``."""
    jax_trainer = JaxTrainer(cfg=JaxConfig(**cfg_kw), **mode)
    state = jax_trainer.init_state(jax.random.PRNGKey(0))
    out = str(tmp_path / "jax")
    jax_export_model(jax_trainer, state, out, batch=batch, output=output)
    fn, manifest = jax_load_exported(out)
    trainer = Trainer(Config(**cfg_kw), device="cpu", **mode)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    trainer.load_variables(jax.tree_util.tree_map(np.asarray, variables))
    return fn, manifest, trainer


def _predictor(trainer, **kw):
    return Predictor(
        trainer.cfg, trainer.model.state_dict(), infer_chunk=trainer.infer_chunk, device="cpu", arch=trainer.arch,
        dtype=trainer.infer_dtype, bf16_min_width=trainer.bf16_min_width, bq_window=trainer.bq_window,
        fp_window=trainer.fp_window, **kw,
    )


def _sure(logits, margin):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] > margin


def _labels_agree(got, want, logits, margin=1e-3, share=0.9):
    """Labels equal wherever the top-2 margin of ``logits`` exceeds ``margin``,
    which at least ``share`` of the points do (the check is not empty)."""
    sure = _sure(logits, margin)
    assert sure.mean() > share
    np.testing.assert_array_equal(got[sure], want[sure])


def test_symbolic_batch_round_trip(tmp_path):
    """One artifact serves B = 1, 3 and 4 and equals the JAX artifact, and
    its manifest has the JAX keys; it loads in a process that has no model code."""
    jax_fn, jax_manifest, trainer = _pair(tmp_path)
    out = str(tmp_path / "port")
    manifest = export_model(trainer, out, batch=None, output="labels")
    assert manifest["input_shape"] == [None, 256, 6] and manifest["device"] == "cpu"
    assert set(manifest) == set(jax_manifest) - {"jax_version", "platforms"} | {"torch_version", "device"}
    assert {k: manifest[k] for k in manifest if k in jax_manifest and k != "artifact"} == {
        k: jax_manifest[k] for k in manifest if k in jax_manifest and k not in ("artifact", "artifact_bytes")
    } | {"artifact_bytes": manifest["artifact_bytes"]}
    assert manifest["window_certificate"] is False
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f) == manifest
    assert os.path.getsize(os.path.join(out, manifest["artifact"])) == manifest["artifact_bytes"]

    fn, loaded = load_exported(out)
    assert loaded == manifest
    predictor = _predictor(trainer)
    for b in (1, 3, 4):
        pts = _points(b, b)
        got = fn(torch.from_numpy(pts)).numpy()
        assert got.shape == (b, 256) and got.dtype == np.int32
        np.testing.assert_array_equal(got, predictor.predict_step(pts).numpy())
        _labels_agree(got, np.asarray(jax_fn(pts)), predictor.infer_logits(pts).numpy())

    code = (
        "import sys, numpy as np, torch\n"
        "from pointnet2_tpu_torch.export import load_exported\n"
        f"fn, m = load_exported({out!r})\n"
        f"pts = np.random.RandomState(3).randn(3, 256, 6).astype(np.float32)\n"
        "np.save(sys.argv[1], fn(torch.from_numpy(pts)).numpy())\n"
        "bad = [n for n in sys.modules if n.startswith(('pointnet2_tpu_torch.models', 'pointnet2_tpu_torch.nn'))]\n"
        "sys.exit(1 if bad else 0)\n"
    )
    saved = str(tmp_path / "labels.npy")
    run = subprocess.run([sys.executable, "-c", code, saved], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    np.testing.assert_array_equal(np.load(saved), predictor.predict_step(_points(3, 3)).numpy())


def test_fixed_batch_through_the_export_tool(tmp_path):
    """``tools.export_model`` on a checkpoint of the port: the fixed-batch
    float32 logits artifact within atol=rtol=1e-4 of the JAX one."""
    jax_fn, _, trainer = _pair(tmp_path, batch=4, output="logits")
    ckpt = str(tmp_path / "model.pt")
    save_checkpoint(ckpt, trainer)
    config = tmp_path / "small.json"
    config.write_text(json.dumps(SMALL))
    out = str(tmp_path / "port")
    manifest = export_tool.main([
        "--ckpt", ckpt, "--config_file", str(config), "--out", out, "--batch", "4", "--output", "logits",
        "--device", "cpu",
    ])
    assert manifest["input_shape"] == [4, 256, 6] and manifest["output"] == "logits"
    fn, _ = load_exported(out)
    pts = _points(7, 4)
    got = fn(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, _predictor(trainer).infer_logits(pts).numpy())
    want = np.asarray(jax_fn(pts))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    _labels_agree(got.argmax(-1), want.argmax(-1), want)


def test_logits_output_and_bf16_mode(tmp_path):
    jax_fn, _, trainer = _pair(tmp_path, batch=2, output="logits", infer_dtype="bfloat16")
    manifest = export_model(trainer, str(tmp_path / "port"), batch=2, output="logits")
    assert manifest["infer_dtype"] == "bfloat16" and manifest["output"] == "logits"
    fn, _ = load_exported(str(tmp_path / "port"))
    pts = _points(11, 2)
    got = fn(torch.from_numpy(pts)).numpy()
    assert got.shape == (2, 256, 9) and got.dtype == np.float32
    np.testing.assert_array_equal(got, _predictor(trainer).infer_logits(pts).numpy())
    want = np.asarray(jax_fn(pts), np.float32)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 8 * U * scale
    _labels_agree(got.argmax(-1), want.argmax(-1), want, margin=16 * U * scale, share=0.25)


def test_selective_bf16_msg_export(tmp_path):
    """The MSG model in selective bf16 (threshold 128): the manifest records
    both, and the artifact is the eager Predictor's forward and JAX's within the bf16 bounds."""
    jax_fn, _, trainer = _pair(
        tmp_path, batch=2, output="logits", arch="msg", infer_dtype="bfloat16", bf16_min_width=128
    )
    manifest = export_model(trainer, str(tmp_path / "port"), batch=2, output="logits")
    assert manifest["arch"] == "msg" and manifest["bf16_min_width"] == 128 and manifest["infer_dtype"] == "bfloat16"
    fn, loaded = load_exported(str(tmp_path / "port"))
    assert loaded["bf16_min_width"] == 128
    pts = _points(17, 2)
    got = fn(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, _predictor(trainer).infer_logits(pts).numpy())
    want = np.asarray(jax_fn(pts), np.float32)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 8 * U * scale
    _labels_agree(got.argmax(-1), want.argmax(-1), want, margin=16 * U * scale, share=0.25)


def test_windowed_export_carries_certificate(tmp_path):
    """With calibrated windows the artifact returns ``(labels, ok)`` and the
    manifest the widths. Clouds spread along x certify (labels JAX's); clouds
    within 1 cm of x do not, and the artifact says so as the eager Predictor does."""
    jax_fn, _, trainer = _pair(tmp_path, WINDOWED, batch=4, bq_window=BQ_WINDOW, fp_window=FP_WINDOW)
    trainer.infer_chunk = 2  # two chunks: both chunks' certificates in one ok
    manifest = export_model(trainer, str(tmp_path / "port"), batch=4, output="labels")
    assert manifest["window_certificate"] is True
    assert manifest["bq_window"] == BQ_WINDOW and manifest["fp_window"] == FP_WINDOW
    fn, loaded = load_exported(str(tmp_path / "port"))
    assert loaded["window_certificate"] is True and loaded["bq_window"] == list(BQ_WINDOW)
    predictor = _predictor(trainer)
    spread, narrow = _strip(19, 4, 16.0), _strip(23, 4, 0.01)
    for pts, want_ok in ((spread, True), (narrow, False)):
        labels, ok = fn(torch.from_numpy(pts))
        eager, eager_ok = predictor.predict_step_checked(pts)
        assert bool(ok) is eager_ok is want_ok
        np.testing.assert_array_equal(labels.numpy(), eager.numpy())
    jax_labels, jax_ok = jax_fn(spread)
    assert bool(jax_ok) is True
    _labels_agree(fn(torch.from_numpy(spread))[0].numpy(), np.asarray(jax_labels),
                  predictor.infer_logits(spread).numpy())


def test_export_tool_calibrates_auto_windows(scenes, tmp_path):
    """``--bq_window/--fp_window auto`` resolve from batches of the
    calibration split, as ``cli.predict`` resolves them; without the split's
    scenes the tool stops with a usage error."""
    ap = export_tool.build_parser()
    cfg_path = _write_config(tmp_path / "cfg.json", data_path=str(scenes))
    flags = ap.parse_args(["--ckpt", "unused.pt", "--config_file", cfg_path, "--bq_window", "auto",
                           "--fp_window", "auto", "--device", "cpu"])
    export_tool.calibrate(ap, flags, Config.from_json(cfg_path), torch.device("cpu"))
    for window in (flags.bq_window, flags.fp_window):
        assert window is None or isinstance(window, (int, tuple))
    empty = _write_config(tmp_path / "empty.json", data_path=str(tmp_path / "none"))
    flags = ap.parse_args(["--ckpt", "unused.pt", "--config_file", empty, "--bq_window", "auto"])
    with pytest.raises(SystemExit):
        export_tool.calibrate(ap, flags, Config.from_json(empty), torch.device("cpu"))


def test_load_refuses_a_cuda_artifact_without_cuda(tmp_path, monkeypatch):
    (tmp_path / "manifest.json").write_text(json.dumps({"artifact": "model.pt2", "device": "cuda"}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_exported(str(tmp_path))


def test_export_refuses_an_unknown_output():
    trainer = Trainer(Config(**SMALL), device="cpu")
    with pytest.raises(ValueError, match="unknown output"):
        export_model(trainer, "unused", batch=2, output="probabilities")
