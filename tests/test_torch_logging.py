"""The port's ``export_tensorboard`` and ``tools.scalars_to_tb`` against the JAX package's ``export_tensorboard``.

One ``scalars.jsonl`` written by the port's ``RunLogger`` (two tags, a
record with a step of 0, a blank line) goes through both functions: the run
directories are laid out alike, and each event file holds the same (tag,
step, value, wall time) records, read back with TensorBoard's
``event_accumulator`` as ``tests/test_logging.py`` reads them.
"""

import json
import sys

import pytest

from pointnet2_tpu.utils.logging import export_tensorboard as jax_export_tensorboard
from pointnet2_tpu_torch.tools import scalars_to_tb
from pointnet2_tpu_torch.utils.logging import RunLogger, export_tensorboard


def _records(run_dir) -> list:
    ea_mod = pytest.importorskip("tensorboard.backend.event_processing.event_accumulator")
    acc = ea_mod.EventAccumulator(str(run_dir))
    acc.Reload()
    return sorted((tag, e.step, e.value, e.wall_time) for tag in acc.Tags()["scalars"] for e in acc.Scalars(tag))


@pytest.fixture
def logdir(tmp_path):
    pytest.importorskip("tensorboardX")
    logger = RunLogger(tmp_path / "log")
    logger.scalars(0, "train", loss=2.25, accuracy=0.125)
    logger.scalars(10, "train", loss=1.5, accuracy=0.25, learning_rate=1e-3)
    logger.scalars(10, "validation", accuracy=0.4, miou=0.2, iou_cars=0.0)
    logger.scalars(20, "train", loss=1.0, accuracy=0.5)
    logger.close()
    with open(tmp_path / "log" / "scalars.jsonl", "a") as f:
        f.write("\n")
    return tmp_path / "log"


def test_export_tensorboard_writes_the_jax_functions_records(logdir, tmp_path):
    runs = export_tensorboard(logdir, tmp_path / "port")
    want = jax_export_tensorboard(logdir, tmp_path / "jax")
    assert [r.name for r in runs] == [r.name for r in want] == ["train", "validation"]
    for run in runs:
        assert run.parent == tmp_path / "port"
        assert len(list(run.glob("events.*"))) == 1
        got = _records(run)
        assert got == _records(tmp_path / "jax" / run.name) and got
    stamps = {json.loads(line)["time"] for line in (logdir / "scalars.jsonl").read_text().splitlines() if line}
    assert all(any(abs(r[3] - t) < 1e-3 for t in stamps) for r in _records(runs[0]))  # the records' own times
    assert ("loss", 0, 2.25) in [r[:3] for r in _records(runs[0])]


def test_export_tensorboard_defaults_to_the_logdirs_tb(logdir):
    runs = export_tensorboard(logdir)
    assert runs == [logdir / "tb" / "train", logdir / "tb" / "validation"]


def test_scalars_to_tb_writes_the_runs(logdir, tmp_path, capsys):
    runs = scalars_to_tb.main(["--logdir", str(logdir), "--out", str(tmp_path / "tb")])
    assert [r.name for r in runs] == ["train", "validation"]
    assert f"wrote {tmp_path / 'tb' / 'train'}" in capsys.readouterr().out
    assert _records(runs[1]) == _records(jax_export_tensorboard(logdir, tmp_path / "jax")[1])


def test_export_tensorboard_missing_file(tmp_path):
    pytest.importorskip("tensorboardX")
    with pytest.raises(FileNotFoundError):
        jax_export_tensorboard(tmp_path)
    with pytest.raises(FileNotFoundError):
        export_tensorboard(tmp_path)


def test_export_tensorboard_without_tensorboardx_says_what_it_needs(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # as on a machine without it
    with pytest.raises(ImportError, match="needs tensorboardX"):
        export_tensorboard(tmp_path)
