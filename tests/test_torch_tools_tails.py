"""The port's calibration tool, visualizers and HTML viewer against the root
scripts and the JAX package, and ``--arch`` on the profiles, on the CPU.

- ``tools.bq_window_calibrate --device cpu`` prints, line for line, what the
  root ``tools/bq_window_calibrate.py`` prints (run as a subprocess with
  ``JAX_PLATFORMS=cpu``) on the scenes of ``tools.scenes`` at a small
  config: the FPS centroids are bit for bit the same on both sides, and the
  spans come from the same oracles.
- ``cli.colorize`` writes the root ``colorize.py``'s ``_colored.pcd`` files
  byte for byte and prints the same lines; ``write_html_viewer`` writes the
  JAX function's HTML byte for byte; ``cli.visualize --stats`` prints what
  ``visualize.py --stats`` prints.
- The visualize and ``kitti_visualize`` PNGs are written (matplotlib is
  installed here; the card's machine has none, so ``chip_smoke.py`` draws
  no PNG).
- ``predict_profile --arch`` and ``train_profile --arch`` reach the model,
  and a card is required.
"""

import contextlib
import dataclasses
import importlib
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from pointnet2_tpu.utils.html_viewer import write_html_viewer as jax_write_html_viewer
from pointnet2_tpu_torch import predict_profile, train_profile
from pointnet2_tpu_torch.cli import colorize as cli_colorize
from pointnet2_tpu_torch.cli import kitti_visualize as cli_kitti_visualize
from pointnet2_tpu_torch.cli import visualize as cli_visualize
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.data.io import write_labels, write_pcd
from pointnet2_tpu_torch.tools import bq_window_calibrate, scenes
from pointnet2_tpu_torch.utils.html_viewer import write_html_viewer

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(num_point=2048, batch_size=2, l1_npoint=512, l2_npoint=128, l3_npoint=32, l4_npoint=16)


def _root_main(name, argv, monkeypatch):
    """A root script's ``main`` in this process, its printed lines returned."""
    monkeypatch.syspath_prepend(str(ROOT))
    module = importlib.import_module(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main()
    return out.getvalue()


def _port_main(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return out.getvalue(), result


@pytest.fixture(scope="module")
def fabricated(tmp_path_factory):
    """``tools.scenes``' train and validation scenes, 8000 points each, and a
    config at the small widths of the CLI rehearsals."""
    base = tmp_path_factory.mktemp("calibrate")
    patch = pytest.MonkeyPatch()
    patch.setattr(scenes, "SCENE_POINTS", 8000)
    try:
        scenes.fabricate(base, 0)
    finally:
        patch.undo()
    cfg_path = base / "cfg.json"
    cfg_path.write_text(json.dumps(dataclasses.asdict(Config(**SMALL, data_path=str(base)))))
    return base, cfg_path


def test_calibration_table_matches_the_root_tool(fabricated):
    data_dir, cfg_path = fabricated
    flags = ["--data_path", str(data_dir), "--config_file", str(cfg_path), "--num_batches", "2", "--seed", "3"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    root = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "bq_window_calibrate.py"), *flags],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert root.returncode == 0, root.stderr[-3000:]
    printed, result = _port_main(bq_window_calibrate.main, [*flags, "--device", "cpu"])
    assert printed.splitlines() == root.stdout.splitlines()
    assert result["device"] == "cpu"
    assert f"--bq_window {result['bq_window']}" in printed or result["bq_window"] is None
    assert len(result["spans"][1]) == 2


def test_calibration_tool_needs_a_card_unless_asked(fabricated, monkeypatch):
    data_dir, cfg_path = fabricated
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bq_window_calibrate.main(["--data_path", str(data_dir), "--config_file", str(cfg_path)])


def _results(tmp_path, rng):
    """Two labelled clouds, one without labels and one already coloured."""
    src = tmp_path / "in"
    src.mkdir()
    for name in ("a", "b"):
        pts = rng.rand(500, 3) * 10
        write_pcd(src / f"{name}.pcd", pts)
        write_labels(src / f"{name}.labels", rng.randint(0, 9, 500))
    write_pcd(src / "nolabels.pcd", rng.rand(20, 3))
    write_pcd(src / "old_colored.pcd", rng.rand(20, 3), rng.rand(20, 3))
    return src


def test_colorize_writes_the_root_scripts_files(tmp_path, monkeypatch):
    src = _results(tmp_path, np.random.RandomState(0))
    root_out, port_out = tmp_path / "root", tmp_path / "port"
    want = _root_main("colorize", ["--input_dir", str(src), "--output_dir", str(root_out)], monkeypatch)
    got, written = _port_main(cli_colorize.main, ["--input_dir", str(src), "--output_dir", str(port_out)])
    assert got == want.replace(str(root_out), str(port_out))
    assert [pathlib.Path(p).name for p in written] == ["a_colored.pcd", "b_colored.pcd"]
    assert sorted(p.name for p in port_out.iterdir()) == sorted(p.name for p in root_out.iterdir())
    for path in root_out.iterdir():
        assert (port_out / path.name).read_bytes() == path.read_bytes()


@pytest.mark.parametrize("colors", [True, False])
@pytest.mark.parametrize("points", [300, 1200])
def test_html_viewer_writes_the_jax_functions_bytes(tmp_path, colors, points):
    rng = np.random.RandomState(points)
    pts = rng.randn(points, 3) * [5.0, 3.0, 1.0]
    cols = rng.rand(points, 3) if colors else None
    want = jax_write_html_viewer(pts, cols, tmp_path / "jax.html", title="scene", max_points=1000)
    got = write_html_viewer(pts, cols, tmp_path / "port.html", title="scene", max_points=1000)
    assert pathlib.Path(got).read_bytes() == pathlib.Path(want).read_bytes()


def test_visualize_stats_prints_what_the_root_script_prints(tmp_path, monkeypatch):
    src = _results(tmp_path, np.random.RandomState(1))
    argv = ["--pcd", str(src / "a.pcd"), "--labels", str(src / "a.labels"), "--stats"]
    want = _root_main("visualize", argv, monkeypatch)
    got, result = _port_main(cli_visualize.main, argv)
    assert got == want
    assert result == {"points": 500}
    assert list(tmp_path.rglob("*.png")) == []


def test_visualize_writes_the_png_and_the_root_scripts_html(tmp_path, monkeypatch):
    src = _results(tmp_path, np.random.RandomState(2))
    root_argv = ["--pcd", str(src / "a.pcd"), "--labels", str(src / "a.labels"),
                 "--out", str(tmp_path / "root.png"), "--html", str(tmp_path / "root.html")]
    port_argv = ["--pcd", str(src / "a.pcd"), "--labels", str(src / "a.labels"),
                 "--out", str(tmp_path / "port.png"), "--html", str(tmp_path / "port.html")]
    want = _root_main("visualize", root_argv, monkeypatch)
    got, result = _port_main(cli_visualize.main, port_argv)
    assert got == want.replace("root.", "port.")
    assert result["png"] == str(tmp_path / "port.png") and (tmp_path / "port.png").stat().st_size > 5_000
    assert (tmp_path / "port.html").read_bytes() == (tmp_path / "root.html").read_bytes()


def test_kitti_visualize_writes_the_frames(tmp_path, monkeypatch):
    root = scenes.write_drive(tmp_path / "kitti", 0, frames=3, points=2000)
    got, written = _port_main(
        cli_kitti_visualize.main,
        ["--kitti_root", str(root), "--out_dir", str(tmp_path / "port"), "--max_frames", "2"],
    )
    want = _root_main(
        "kitti_visualize",
        ["--kitti_root", str(root), "--out_dir", str(tmp_path / "root"), "--max_frames", "2"],
        monkeypatch,
    )
    assert got == want.replace(str(tmp_path / "root"), str(tmp_path / "port"))
    assert [pathlib.Path(p).name for p in written] == ["2011_09_26_0095_0000.png", "2011_09_26_0095_0001.png"]
    assert all(pathlib.Path(p).stat().st_size > 5_000 for p in written)


def test_new_modules_import_without_matplotlib():
    """On a machine without matplotlib (the card's) every new module imports,
    and ``--stats`` runs; drawing a frame raises the hint."""
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "import importlib\n"
        "for m in ('cli.visualize', 'cli.colorize', 'cli.kitti_visualize', 'utils.html_viewer',\n"
        "          'tools.bq_window_calibrate', 'nn.extras'):\n"
        "    importlib.import_module('pointnet2_tpu_torch.' + m)\n"
        "from pointnet2_tpu_torch.cli import kitti_visualize\n"
        "try:\n"
        "    kitti_visualize.main(['--kitti_root', '.'])\n"
        "except ImportError as e:\n"
        "    print('hint:', e)\n"
    )
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "needs matplotlib" in run.stdout


class _Reached(Exception):
    pass


@pytest.mark.parametrize("arch", ["ssg", "msg"])
def test_profiles_pass_the_arch_to_the_model(arch, monkeypatch):
    seen = {}

    def record(name):
        def build(*args, **kwargs):
            seen[name] = kwargs.get("arch")
            raise _Reached

        return build

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(predict_profile, "Predictor", record("predict"))
    monkeypatch.setattr(train_profile, "Trainer", record("train"))
    with pytest.raises(_Reached):
        predict_profile.main(["--arch", arch])
    with pytest.raises(_Reached):
        train_profile.main(["--arch", arch])
    assert seen == {"predict": arch, "train": arch}


def test_profiles_need_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert predict_profile.main(["--arch", "msg"]) == 1
    assert train_profile.main(["--arch", "msg"]) == 1
    assert "CUDA" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        predict_profile.main(["--arch", "pointnet"])
