"""The port's benchmark and renamer entry points, its slope timer and per-op table, on the CPU.

- ``cli.renamer`` against the root ``renamer.py`` on two copies of one
  directory: the same files afterwards, the same printed lines (the
  directory's path aside).
- ``utils.bench.slope_time`` on a step of known cost (a 20 ms sleep): within 20 %
  of what a step took by the host's clock.
- ``cli.benchmark.data_stream`` against the arrays the root ``benchmark.py``
  hands its model (the script run with its model and timer stood in):
  equal byte for byte, randn and box regime, B = 64 then the sweep.
- ``cli.benchmark.main`` at ``tests/test_torch_cli.py``'s small widths on
  the JAX ``init_state`` weights (converted, through ``--ckpt``), with the
  sweep shortened through ``main``'s ``sweep`` argument and ``slope_time``
  stood in by one call (the timer is held above): its labels on the
  profiled batch of 64 equal the JAX ``Trainer.predict_step``'s (XLA path)
  on >= 99.99 % of points; the Chrome trace and ``gpu-profile.txt`` are
  written, the table from the CPU profile with its header and rows.
- ``utils.op_report`` formats a table with its share column and its header.
"""

import contextlib
import dataclasses
import importlib.util
import io as text_io
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from pointnet2_tpu_torch.cli import benchmark as cli_benchmark
from pointnet2_tpu_torch.cli import renamer as cli_renamer
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.train import Trainer, save_checkpoint
from pointnet2_tpu_torch.utils import op_report
from pointnet2_tpu_torch.utils.bench import slope_time

ROOT = pathlib.Path(__file__).resolve().parents[1]
LABEL_AGREEMENT = 0.9999
SMALL = dict(num_point=512, batch_size=2, l1_npoint=128, l2_npoint=64, l3_npoint=16, l4_npoint=8)

torch.set_num_threads(2)


def _write_config(path: pathlib.Path, **kw) -> str:
    path.write_text(json.dumps(dataclasses.asdict(Config(**{**SMALL, **kw}))))
    return str(path)


# -- renamer -------------------------------------------------------------------


def test_renamer_renames_as_the_root_script(tmp_path):
    src = tmp_path / "dense"
    src.mkdir()
    names = ["marketplacefeldkirch_station4_intensity_rgb.labels", "sg27_station3_intensity_rgb.labels",
             "birdfountain_station1_xyz_intensity_rgb.labels",
             # left in place: a validation scene's labels and a coloured cloud
             "bildstein_station1_xyz_intensity_rgb.labels", "sg27_station3_intensity_rgb_colored.pcd"]
    for name in names:
        (src / name).write_text(name)
    port_dir, root_dir = tmp_path / "port", tmp_path / "root"
    shutil.copytree(src, port_dir)
    shutil.copytree(src, root_dir)

    with contextlib.redirect_stdout(text_io.StringIO()) as out:
        summary = cli_renamer.main(["--dense_dir", str(port_dir)])
    root = subprocess.run([sys.executable, str(ROOT / "renamer.py"), "--dense_dir", str(root_dir)],
                          capture_output=True, text=True, check=True, timeout=60)

    files = {p.name: p.read_text() for p in port_dir.iterdir()}
    assert files == {p.name: p.read_text() for p in root_dir.iterdir()}
    assert files["marketsquarefeldkirch4.labels"] == names[0]
    assert {"sg27_3.labels", "birdfountain1.labels", names[3], names[4]} <= set(files)
    # The same lines, each path's directory aside; the order is the directory listing's.
    port_lines = sorted(out.getvalue().replace(str(port_dir), "DIR").splitlines())
    root_lines = sorted(root.stdout.replace(str(root_dir), "DIR").splitlines())
    assert port_lines == root_lines and len(port_lines) == 5
    assert len(summary["moved"]) == 3 and sorted(summary["unknown"]) == sorted(names[3:])


def test_renamer_table_is_the_root_scripts():
    spec = importlib.util.spec_from_file_location("root_renamer", ROOT / "renamer.py")
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    assert cli_renamer.conversion_dict == root.conversion_dict


# -- slope_time ----------------------------------------------------------------


def test_slope_time_measures_a_step_of_known_cost():
    """A step that sleeps 20 ms: the slope is within 20 % of what a step
    took (the chains' fixed costs cancel), by the host's clock around each
    call. That is 20 ms and a little on an idle host; on an oversubscribed
    one each wake from the sleep comes late, and another thread holding the
    GIL delays it further, so a miss names the threads the process ran at
    the start."""
    sleep = 0.02
    threads = [f"{t.name} (daemon={t.daemon})" for t in threading.enumerate()]
    took = []

    def step(c):
        t0 = time.perf_counter()
        time.sleep(sleep)
        out = c * 2.0
        took.append(time.perf_counter() - t0)
        return out

    t = slope_time(step, torch.ones(4), K0=2, K1=6, reps=3)
    cost = statistics.median(took)
    assert cost >= sleep and abs(t - cost) < 0.2 * cost, (
        f"slope {t * 1e3:.3f} ms, a step {cost * 1e3:.3f} ms; threads at the start: {threads}")


def test_slope_time_folds_each_output_into_the_next_carry():
    seen = []

    def step(c):
        seen.append(c.clone())
        return torch.full_like(c, 1e30)

    x = torch.ones(3)
    slope_time(step, x, K0=1, K1=2, reps=1)
    # The warm chains (1 + 2 calls), then one repetition on x + 1e-7. A call
    # after the first in a chain gets the carry plus 1e-38 times the last
    # output's sum (3e-8 here): a new tensor of the same float32 value.
    assert len(seen) == (1 + 2) * 2
    assert all(torch.equal(s, x) for s in seen[:3])
    assert all(torch.equal(s, x + 1e-7) for s in seen[3:]) and not torch.equal(x + 1e-7, x)


# -- the data stream -------------------------------------------------------------


def _root_benchmark_arrays(cfg_path: str, windowed: bool) -> list:
    """The arrays the root ``benchmark.py`` passes to its model, in order: its
    ``main`` run with the JAX ``Trainer``, ``slope_time``, the profiler and the
    per-op report stood in."""
    import jax

    import pointnet2_tpu.train.trainer as jax_trainer
    import pointnet2_tpu.utils.bench as jax_bench
    import pointnet2_tpu.utils.runtime as jax_runtime
    import pointnet2_tpu.utils.xplane as xplane

    seen = []

    class StubTrainer:
        def __init__(self, cfg, bq_window=None, fp_window=None):
            pass

        def init_state(self, key):
            return None

        def check_bq_window(self, state, x):
            return True

        def predict_step(self, state, x):
            return x

    def stub_slope_time(fn, x, K0=2, K1=10, reps=3):
        seen.append(np.asarray(x))
        return 1.0

    def no_report(*args, **kwargs):
        raise FileNotFoundError("stood in")

    spec = importlib.util.spec_from_file_location("root_benchmark", ROOT / "benchmark.py")
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    argv = ["benchmark.py", "--config_file", cfg_path, "--trace_dir", str(pathlib.Path(cfg_path).parent / "trace")]
    if windowed:
        argv += ["--bq_window", "256", "--fp_window", "128"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", argv)
        mp.setattr(jax_trainer, "Trainer", StubTrainer)
        mp.setattr(jax_bench, "slope_time", stub_slope_time)
        mp.setattr(jax_runtime, "setup_compilation_cache", lambda *a, **k: None)
        mp.setattr(jax.profiler, "trace", lambda *a, **k: contextlib.nullcontext())
        mp.setattr(xplane, "write_op_report", no_report)
        with contextlib.redirect_stdout(text_io.StringIO()):
            root.main()
    return seen


@pytest.mark.parametrize("windowed", [False, True], ids=["randn", "box"])
def test_data_stream_is_the_root_scripts_byte_for_byte(tmp_path, windowed):
    cfg_path = _write_config(tmp_path / "cfg.json")
    want = _root_benchmark_arrays(cfg_path, windowed)
    data = cli_benchmark.data_stream(Config.from_json(cfg_path), windowed)
    batches = [cli_benchmark.PROFILE_BATCH, *cli_benchmark.SWEEP]
    assert [a.shape[0] for a in want] == batches
    for batch, arr in zip(batches, want):
        got = data(batch)
        assert got.dtype == np.float32 and got.tobytes() == arr.astype(np.float32).tobytes()


# -- the benchmark against the JAX predict ----------------------------------------


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    """The port's benchmark on the JAX ``init_state`` weights, and the JAX
    ``predict_step`` on the profiled batch (the port's stream's first draw)."""
    import jax

    from pointnet2_tpu.config import Config as JaxConfig
    from pointnet2_tpu.train.trainer import Trainer as JaxTrainer

    base = tmp_path_factory.mktemp("bench")
    cfg_path = _write_config(base / "cfg.json")
    jt = JaxTrainer(cfg=JaxConfig.from_json(cfg_path), ops_impl="xla")
    state = jt.init_state(jax.random.PRNGKey(0))
    trainer = Trainer(Config.from_json(cfg_path), device="cpu")
    trainer.load_variables(jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))
    save_checkpoint(base / "model.pt", trainer)

    x = cli_benchmark.data_stream(Config.from_json(cfg_path), False)(cli_benchmark.PROFILE_BATCH)
    with jax.default_matmul_precision("highest"):
        jax_labels = np.asarray(jt.predict_step(state, x))

    with pytest.MonkeyPatch.context() as mp:
        # One call for the slope: the timer is held by its own tests above.
        mp.setattr(cli_benchmark, "slope_time", lambda fn, x, K0=2, K1=8: (fn(x), 0.25)[1])
        with contextlib.redirect_stdout(text_io.StringIO()) as out:
            summary = cli_benchmark.main(
                ["--ckpt", str(base / "model.pt"), "--config_file", cfg_path, "--trace_dir", str(base / "trace"),
                 "--device", "cpu"], sweep=(1, 2),
            )
    return summary, jax_labels, out.getvalue()


def test_benchmark_labels_equal_the_jax_predict_step(bench_run):
    summary, jax_labels, _ = bench_run
    assert summary["labels"].shape == jax_labels.shape == (cli_benchmark.PROFILE_BATCH, SMALL["num_point"])
    agreement = float((summary["labels"] == jax_labels).mean())
    assert agreement >= LABEL_AGREEMENT, agreement


def test_benchmark_writes_the_trace_and_the_per_op_table(bench_run):
    summary, _, printed = bench_run
    trace = json.loads(pathlib.Path(summary["trace"]).read_text())
    assert trace["traceEvents"]
    text = pathlib.Path(summary["report"]).read_text()
    lines = text.splitlines()
    assert lines[0].startswith("# per-op profile — operators, own host time")
    assert lines[2].split() == ["op", "line", "count", "total_ms", "avg_us", "share"]
    assert any(line.startswith("pn2::fps_centroids") for line in lines)
    assert "No memory column" in text
    shares = [float(line.split()[-1].rstrip("%")) for line in lines[3:] if line.endswith("%")]
    assert abs(sum(shares) - 100.0) < 0.5
    assert "Profiler trace written to" in printed and "# top ops" in printed


def test_benchmark_prints_the_root_scripts_lines(bench_run):
    summary, _, printed = bench_run
    lines = [line for line in printed.splitlines() if line.startswith("Batch size:")]
    assert lines[0].startswith("Batch size: 64, batch_time: 0.25, sample_time: ")
    assert [line.split(",")[0] for line in lines[1:]] == ["Batch size: 1", "Batch size: 2"]
    assert all("points_per_sec: " in line for line in lines[1:])
    assert [rec["batch"] for rec in summary["sweep"]] == [1, 2]
    assert summary["sweep"][1]["labels"].shape == (2, SMALL["num_point"])


def test_benchmark_refuses_uncertified_windows(tmp_path):
    """Box clouds of 512 points in 8 m: a 128-column window cannot hold SA1's
    neighbourhoods, so the script raises before it profiles."""
    cfg_path = _write_config(tmp_path / "cfg.json")
    with pytest.raises(RuntimeError, match="window certificate failed"):
        with contextlib.redirect_stdout(text_io.StringIO()):
            cli_benchmark.main(["--config_file", cfg_path, "--trace_dir", str(tmp_path / "trace"),
                                "--bq_window", "128", "--device", "cpu"], sweep=())
    assert not (tmp_path / "trace").exists()


# -- the per-op table ------------------------------------------------------------


def test_format_report_names_the_ports_kernels():
    rows = [op_report.OpRow("pn2_fps_centroids", "device", 4, 3000.0),
            op_report.OpRow("pn2_knn", "device", 4, 1000.0)]
    text = op_report.format_report(rows, top=1, title="t")
    assert "pn2_fps_centroids" in text and "75.00%" in text
    assert "... 1 more ops" in text and "25.00%" in text
    assert op_report.kernel_name("void pn2::fps_kernel<true, 4>(...)") == "pn2_fps_centroids"
    assert op_report.kernel_name("knn_tiles_kernel<3>") == "pn2_knn_tiles"
    assert op_report.kernel_name("ampere_sgemm") == "ampere_sgemm"


# -- the default device ------------------------------------------------------------


@pytest.mark.parametrize("entry", ["benchmark", "train_soak", "bf16_train_soak"])
def test_entry_points_run_on_cuda_by_default_and_raise_without_it(entry, monkeypatch, tmp_path):
    from pointnet2_tpu_torch.tools import bf16_train_soak, train_soak

    main = {"benchmark": cli_benchmark.main, "train_soak": train_soak.main, "bf16_train_soak": bf16_train_soak.main}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main[entry]([])
    assert list(tmp_path.iterdir()) == []
