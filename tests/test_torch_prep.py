"""The port's preprocess and downsample entry points against the root ``preprocess.py`` and ``downsample.py``.

Raw scenes of 3000 points from ``tools.scenes.fabricate_raw``: one with
colours and labels (a fiftieth of them 0), one without colours, one test
scene without ``.labels``, and a prefix with no ``.txt``. Both packages'
``all_file_prefixes`` are cut to these for each test. The root scripts run
in this process (``main()`` under a patched ``sys.argv``, as
``tests/test_cli.py`` runs them) on one copy of the scenes, the port's
``main(argv)`` on another: every file they write must be equal byte for
byte, and their printed lines equal once the directories are named alike.
Downsampling runs at the default 0.05 m, where these sparse scenes keep
about every point, and at 2 m, where voxels hold tens of points and the
majority vote decides.
"""

import contextlib
import importlib
import io
import os
import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pointnet2_tpu.data.semantic3d as jax_semantic3d
from pointnet2_tpu_torch.cli import downsample as cli_downsample
from pointnet2_tpu_torch.cli import preprocess as cli_preprocess
from pointnet2_tpu_torch.data import semantic3d
from pointnet2_tpu_torch.data.io import load_labels, read_pcd
from pointnet2_tpu_torch.tools import scenes

POINTS = 3000
COLOURED, PLAIN, TEST, MISSING = "scene_coloured", "scene_plain", "scene_test", "scene_missing"
REPO_ROOT = str(pathlib.Path(__file__).resolve().parents[1])


@pytest.fixture
def prefixes(monkeypatch):
    """Both packages' prefix tables cut to the fabricated scenes."""
    def cut(names):
        monkeypatch.setattr(jax_semantic3d, "all_file_prefixes", list(names))
        monkeypatch.setattr(semantic3d, "all_file_prefixes", list(names))
    cut([COLOURED, PLAIN, TEST, MISSING])
    return cut


def _raw(tmp_path, name: str) -> pathlib.Path:
    raw = tmp_path / name
    raw.mkdir()
    scenes.fabricate_raw(raw, 0, [COLOURED], POINTS)
    scenes.fabricate_raw(raw, 1, [PLAIN], POINTS, colors=False)
    scenes.fabricate_raw(raw, 2, [TEST], POINTS, with_labels=False)
    return raw


def _root(module: str, argv: list, monkeypatch) -> str:
    """The root script's ``main`` under ``argv``; what it printed."""
    mod = importlib.import_module(module)
    monkeypatch.setattr(sys, "argv", [module + ".py", *argv])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        mod.main()
    return out.getvalue()


def _port(main, argv: list) -> tuple[str, dict]:
    with contextlib.redirect_stdout(io.StringIO()) as out:
        summary = main(argv)
    return out.getvalue(), summary


def _same_files(a: pathlib.Path, b: pathlib.Path) -> list:
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    return names


def test_preprocess_writes_the_root_scripts_files(tmp_path, prefixes, monkeypatch):
    ref, port = _raw(tmp_path, "ref"), _raw(tmp_path, "port")
    printed = _root("preprocess", ["--raw_dir", str(ref)], monkeypatch)
    got, summary = _port(cli_preprocess.main, ["--raw_dir", str(port)])
    assert got == printed.replace(str(ref), str(port))
    assert f"txt {port / MISSING}.txt missing, skipped" in got
    assert summary["converted"] == [COLOURED, PLAIN, TEST] and summary["points"] == [POINTS] * 3
    assert summary["skipped"] == [MISSING]
    names = _same_files(ref, port)
    assert {f"{p}.pcd" for p in (COLOURED, PLAIN, TEST)} <= set(names)
    assert read_pcd(port / f"{COLOURED}.pcd").colors is not None and read_pcd(port / f"{PLAIN}.pcd").colors is None


def test_preprocess_skips_a_scene_it_converted(tmp_path, prefixes, monkeypatch):
    ref, port = _raw(tmp_path, "ref"), _raw(tmp_path, "port")
    _root("preprocess", ["--raw_dir", str(ref)], monkeypatch)
    _port(cli_preprocess.main, ["--raw_dir", str(port)])
    printed = _root("preprocess", ["--raw_dir", str(ref)], monkeypatch)
    got, summary = _port(cli_preprocess.main, ["--raw_dir", str(port)])
    assert got == printed.replace(str(ref), str(port))
    assert f"pcd {port / COLOURED}.pcd exists, skipped" in got
    assert summary["converted"] == [] and summary["skipped"] == [COLOURED, PLAIN, TEST, MISSING]
    _same_files(ref, port)


@pytest.mark.parametrize("voxel_size", [None, "2.0"])
def test_downsample_writes_the_root_scripts_files(tmp_path, prefixes, monkeypatch, voxel_size):
    ref, port = _raw(tmp_path, "ref"), _raw(tmp_path, "port")
    _root("preprocess", ["--raw_dir", str(ref)], monkeypatch)
    _port(cli_preprocess.main, ["--raw_dir", str(port)])
    prefixes([COLOURED, PLAIN, TEST])  # downsample needs every prefix's .pcd
    size = ["--voxel_size", voxel_size] if voxel_size else []
    printed = _root("downsample", ["--raw_dir", str(ref), "--downsampled_dir", str(tmp_path / "ref_ds"), *size],
                    monkeypatch)
    got, summary = _port(cli_downsample.main, ["--raw_dir", str(port), "--downsampled_dir",
                                              str(tmp_path / "port_ds"), *size])
    assert got == printed.replace(str(ref), str(port)).replace(str(tmp_path / "ref_ds"), str(tmp_path / "port_ds"))
    names = _same_files(tmp_path / "ref_ds", tmp_path / "port_ds")
    assert names == sorted([f"{COLOURED}.labels", f"{COLOURED}.pcd", f"{PLAIN}.labels", f"{PLAIN}.pcd",
                            f"{TEST}.pcd"])  # a test scene gets a .pcd only
    assert summary["downsampled"] == [COLOURED, PLAIN, TEST] and summary["points"] == [POINTS] * 3
    for prefix, sparse in zip((COLOURED, PLAIN), summary["sparse_points"]):
        dropped = int((load_labels(port / f"{prefix}.labels") == 0).sum())
        assert dropped > 0 and sparse <= POINTS - dropped  # the label-0 points are gone
        labels = load_labels(tmp_path / "port_ds" / f"{prefix}.labels")
        assert len(labels) == sparse and (labels != 0).all()
    if voxel_size:
        assert max(summary["sparse_points"]) < POINTS // 2  # voxels of several points: the vote decides


def test_downsample_skips_a_scene_it_finished(tmp_path, prefixes, monkeypatch):
    ref, port = _raw(tmp_path, "ref"), _raw(tmp_path, "port")
    prefixes([COLOURED, PLAIN, TEST])
    for raw in (ref, port):
        _port(cli_preprocess.main, ["--raw_dir", str(raw)])
    dirs = {raw: ["--raw_dir", str(raw), "--downsampled_dir", str(tmp_path / f"{raw.name}_ds")] for raw in (ref, port)}
    _root("downsample", dirs[ref], monkeypatch)
    _port(cli_downsample.main, dirs[port])
    # The rule: a .pcd, and a .labels where the raw scene has labels. Without
    # it the labelled scene is done again; the test scene is done already.
    for raw in (ref, port):
        (tmp_path / f"{raw.name}_ds" / f"{COLOURED}.labels").unlink()
    printed = _root("downsample", dirs[ref], monkeypatch)
    got, summary = _port(cli_downsample.main, dirs[port])
    assert got == printed.replace(str(ref), str(port))
    assert summary["downsampled"] == [COLOURED] and summary["skipped"] == [PLAIN, TEST]
    assert f"Skipped: {port / TEST}.pcd" in got
    _same_files(tmp_path / "ref_ds", tmp_path / "port_ds")
    _, again = _port(cli_downsample.main, dirs[port])
    assert again["skipped"] == [COLOURED, PLAIN, TEST]


def test_downsample_of_a_scene_without_its_pcd_raises_as_the_root_script(tmp_path, prefixes, monkeypatch):
    raw = _raw(tmp_path, "raw")  # no preprocess: no .pcd
    argv = ["--raw_dir", str(raw), "--downsampled_dir", str(tmp_path / "ds")]
    with pytest.raises(FileNotFoundError):
        _root("downsample", argv, monkeypatch)
    with pytest.raises(FileNotFoundError):
        _port(cli_downsample.main, argv)


@pytest.mark.parametrize("argv", [[], ["--voxel_size", "0.1", "--raw_dir", "in", "--downsampled_dir", "out"]])
def test_flags_and_defaults_match_the_root_scripts(monkeypatch, prefixes, argv):
    """Each script's per-scene function recorded instead of run: the same
    arguments from the same flags, the repo root's dataset directories by
    default (no directory is made)."""
    prefixes([COLOURED])
    monkeypatch.setattr(os, "makedirs", lambda *a, **k: None)
    calls = {}
    for name, module, func in (("root", importlib.import_module("downsample"), "down_sample"),
                               ("port", cli_downsample, "down_sample"),
                               ("root_pre", importlib.import_module("preprocess"), "point_cloud_txt_to_pcd"),
                               ("port_pre", cli_preprocess, "point_cloud_txt_to_pcd")):
        monkeypatch.setattr(module, func, lambda *a, _name=name: calls.setdefault(_name, a))
    _root("downsample", argv, monkeypatch)
    _port(cli_downsample.main, argv)
    pre_argv = argv[2:4]
    _root("preprocess", pre_argv, monkeypatch)
    _port(cli_preprocess.main, pre_argv)
    assert calls["port"] == calls["root"] and calls["port_pre"] == calls["root_pre"]
    if not argv:
        raw = os.path.join(REPO_ROOT, "dataset", "semantic_raw")
        assert calls["port_pre"] == (raw, COLOURED)
        assert calls["port"] == (os.path.join(raw, f"{COLOURED}.pcd"), os.path.join(raw, f"{COLOURED}.labels"),
                                 os.path.join(REPO_ROOT, "dataset", "semantic_downsampled", f"{COLOURED}.pcd"),
                                 os.path.join(REPO_ROOT, "dataset", "semantic_downsampled", f"{COLOURED}.labels"),
                                 0.05)
    else:
        assert calls["port"][-1] == 0.1 and calls["port_pre"] == ("in", COLOURED)


def test_the_raw_writer_writes_what_the_readers_parse(tmp_path):
    raw = _raw(tmp_path, "raw")
    rows = (raw / f"{COLOURED}.txt").read_text().splitlines()
    assert len(rows) == POINTS and len(rows[0].split()) == 7
    assert all(field.lstrip("-").isdigit() for field in rows[0].split()[3:])  # integer intensity and colour
    assert len((raw / f"{PLAIN}.txt").read_text().splitlines()[0].split()) == 4
    labels = load_labels(raw / f"{COLOURED}.labels")
    assert labels.shape == (POINTS,) and 0 < (labels == 0).mean() < 0.05 and labels.max() <= 8
    assert not (raw / f"{TEST}.labels").exists()
    np.testing.assert_array_equal(np.loadtxt(raw / f"{COLOURED}.txt")[:, :3].max(0) <= scenes.SCENE_M, True)
