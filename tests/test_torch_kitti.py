"""The port's KITTI data module and KITTI predict CLI against the JAX package's, on the CPU.

- ``data.kitti``: on ``tests/test_kitti.py``'s fabricated drive, the loaders,
  ``KittiRawDrive`` (scans, timestamps, OXTS packets and poses, calibration),
  each frame's crop and order, and the samples drawn from the same seed equal
  the JAX package's exactly; so does a drive from ``tools.scenes.write_drive``.
- ``cli.kitti_predict --device cpu`` against the root ``kitti_predict.py``,
  both run once on the same drive and weights at ``tests/test_kitti_predict.py``'s
  small config (512 points): the JAX side saves its ``init_state`` with
  orbax, the port gets the same variables through
  ``convert.from_flax_variables``. The JAX script samples each frame from an
  unseeded RandomState, the port from ``RandomState(0)``
  (``data.kitti.SAMPLE_SEED``); for the comparisons the JAX frames get
  ``RandomState(0)`` too. The dense ``.pcd`` must be equal
  byte for byte (the same crops and the same palette) and the dense
  ``.labels`` equal.
"""

import contextlib
import io as text_io
import sys

import numpy as np
import pytest
import torch

from pointnet2_tpu.data import kitti as jax_kitti
from pointnet2_tpu_torch.cli import kitti_predict as cli_kitti
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.data import kitti
from pointnet2_tpu_torch.data.io import load_labels, read_pcd
from pointnet2_tpu_torch.infer import Predictor
from pointnet2_tpu_torch.tools import scenes
from pointnet2_tpu_torch.train import Trainer, save_checkpoint
from pointnet2_tpu_torch.utils import render
from test_kitti import _write_drive

torch.set_num_threads(2)
SMALL = dict(num_point=512, use_color=0, box_size_x=60.0, box_size_y=20.0,
             l1_npoint=128, l2_npoint=64, l3_npoint=16, l4_npoint=8)
DRIVE = ("2011_09_26", "0095")


def _seeded_jax_frames(monkeypatch):
    """The JAX KittiFileData given RandomState(0) where it makes an unseeded one."""
    original = jax_kitti.KittiFileData.__init__

    def seeded(self, points, box_size_x, box_size_y, rng=None):
        original(self, points, box_size_x, box_size_y, rng=rng or np.random.RandomState(0))

    monkeypatch.setattr(jax_kitti.KittiFileData, "__init__", seeded)


def _frames_equal(port_ds, jax_ds, num_point):
    assert len(port_ds.list_file_data) == len(jax_ds.list_file_data) > 0
    for fd, ref in zip(port_ds.list_file_data, jax_ds.list_file_data):
        assert fd.file_path_without_ext == ref.file_path_without_ext
        for name in ("points", "labels", "colors"):
            got, want = getattr(fd, name), getattr(ref, name)
            assert got.dtype == want.dtype and np.array_equal(got, want), name
        for _ in range(2):
            for got, want in zip(fd.get_batch_of_one_z_box_from_origin(num_point),
                                 ref.get_batch_of_one_z_box_from_origin(num_point)):
                assert got.shape == (1, num_point, 3) and np.array_equal(got, want)
    assert port_ds.num_classes == jax_ds.num_classes and port_ds.labels_names == jax_ds.labels_names


def test_loaders_and_raw_drive_equal_the_jax_packages(tmp_path):
    root = _write_drive(tmp_path, np.random.RandomState(3), frames=3, n=3000)
    base = root / DRIVE[0] / f"{DRIVE[0]}_drive_{DRIVE[1]}_sync"
    scan = base / "velodyne_points" / "data" / "0000000001.bin"
    assert np.array_equal(kitti.load_velodyne_bin(str(scan)), jax_kitti.load_velodyne_bin(str(scan)))
    stamps = base / "velodyne_points" / "timestamps.txt"
    assert np.array_equal(kitti.load_timestamps(str(stamps)), jax_kitti.load_timestamps(str(stamps)))
    calib = root / DRIVE[0] / "calib_imu_to_velo.txt"
    got, want = kitti.load_calib(str(calib)), jax_kitti.load_calib(str(calib))
    assert set(got) == set(want) == {"calib_time", "R", "T"}
    for key, value in want.items():
        assert np.array_equal(got[key], value) if key != "calib_time" else got[key] == value

    port, ref = kitti.KittiRawDrive(str(root), *DRIVE), jax_kitti.KittiRawDrive(str(root), *DRIVE)
    assert len(port) == len(ref) == 3 and port.velo_files == ref.velo_files
    assert np.array_equal(port.get_velo(2), ref.get_velo(2))
    assert np.array_equal(port.velo_timestamps, ref.velo_timestamps)
    for got, want in zip(port.oxts, ref.oxts):
        assert np.array_equal(got, want)
    assert port.calib.keys() == ref.calib.keys()
    assert np.array_equal(port.calib["imu_to_velo/T"], ref.calib["imu_to_velo/T"])
    packets = np.random.RandomState(4).rand(5, 30)
    packets[:, :3] = packets[:, :3] * [1.0, 1.0, 100.0] + [48.0, 8.0, 0.0]  # lat, lon, alt
    assert np.array_equal(kitti.oxts_to_pose(packets), jax_kitti.oxts_to_pose(packets))
    pts = np.random.RandomState(5).randn(1000, 3) * 10
    bounds = ([-5, -5, -2], [5, 5, 5])
    assert np.array_equal(kitti.crop_box(pts, *bounds), jax_kitti.crop_box(pts, *bounds))
    with pytest.raises(FileNotFoundError):
        kitti.KittiDataset(512, str(tmp_path), ["2011_09_26"], ["0001"], 60, 20)


def test_frames_crops_and_samples_equal_the_jax_packages(tmp_path, monkeypatch):
    """Frames of tests/test_kitti.py's drive (fewer points than a sample after
    the crop: the sample repeats them) and of tools.scenes.write_drive (more:
    the sample thins them at random), both with RandomState(0) a frame."""
    _seeded_jax_frames(monkeypatch)
    for root, num_point in ((_write_drive(tmp_path / "a", np.random.RandomState(6), frames=2, n=3000), 4096),
                            (scenes.write_drive(tmp_path / "b", 7, frames=2, points=20_000), 1024)):
        args = (num_point, str(root), [DRIVE[0]], [DRIVE[1]], 60.0, 20.0)
        with contextlib.redirect_stdout(text_io.StringIO()):
            port, ref = kitti.KittiDataset(*args), jax_kitti.KittiDataset(*args)
        _frames_equal(port, ref, num_point)
    fd = kitti.KittiFileData(np.random.RandomState(8).randn(5000, 3) * [20, 10, 2], 60, 20,
                             rng=np.random.RandomState(1))
    ref = jax_kitti.KittiFileData(np.random.RandomState(8).randn(5000, 3) * [20, 10, 2], 60, 20,
                                  rng=np.random.RandomState(1))
    for got, want in zip(fd.get_batch_of_one_z_box_from_origin(512), ref.get_batch_of_one_z_box_from_origin(512)):
        assert np.array_equal(got, want)


def test_a_dataset_draws_the_same_samples_every_time(tmp_path):
    """Each frame samples from RandomState(SAMPLE_SEED): two datasets of one
    drive draw the same samples, and a frame's next draw is another."""
    root = scenes.write_drive(tmp_path, 9, frames=1, points=20_000)
    with contextlib.redirect_stdout(text_io.StringIO()):
        frames = [kitti.KittiDataset(1024, str(root), [DRIVE[0]], [DRIVE[1]], 60.0, 20.0).list_file_data[0]
                  for _ in range(2)]
    first = [fd.get_batch_of_one_z_box_from_origin(1024)[1] for fd in frames]
    assert kitti.SAMPLE_SEED == 0 and np.array_equal(*first)
    assert not np.array_equal(first[0], frames[0].get_batch_of_one_z_box_from_origin(1024)[1])


# -- the KITTI predict CLI against the root kitti_predict.py -------------------


@pytest.fixture(scope="module")
def both_kitti_predicts(tmp_path_factory):
    """Root ``kitti_predict.py`` and the port's CLI, ``--save --render``, on
    the same drive of 2 frames and the same weights. Each run once."""
    import jax

    from pointnet2_tpu.config import Config as JaxConfig
    from pointnet2_tpu.train.trainer import Trainer as JaxTrainer
    from pointnet2_tpu.train.trainer import save_checkpoint as jax_save_checkpoint

    base = tmp_path_factory.mktemp("kitti_predict")
    root = _write_drive(base, np.random.RandomState(10), frames=2, n=8000)
    cfg_path = base / "config.json"
    JaxConfig(**SMALL).to_json(cfg_path)
    state = JaxTrainer(cfg=JaxConfig(**SMALL)).init_state(jax.random.PRNGKey(0))
    jax_save_checkpoint(str(base / "orbax"), state)
    trainer = Trainer(Config.from_json(cfg_path), device="cpu")
    trainer.load_variables(jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))
    save_checkpoint(base / "port.pt", trainer)

    common = ["--kitti_root", str(root), "--config_file", str(cfg_path), "--save", "--render"]
    for side in ("jax", "port"):
        (base / side).mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR", str(base / "jax_cache"))
        _seeded_jax_frames(mp)
        mp.chdir(base / "jax")
        mp.setattr(sys, "argv", ["kitti_predict.py", "--ckpt", str(base / "orbax")] + common)
        import kitti_predict

        with contextlib.redirect_stdout(text_io.StringIO()):
            kitti_predict.main()
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(base / "port")
        with contextlib.redirect_stdout(text_io.StringIO()) as out:
            summary = cli_kitti.main(["--ckpt", str(base / "port.pt"), "--device", "cpu"] + common)
    return base, summary, out.getvalue()


def test_kitti_predict_writes_the_root_scripts_files(both_kitti_predicts):
    base, summary, printed = both_kitti_predicts
    assert [f["name"] for f in summary["frames"]] == ["2011_09_26/0095/0000", "2011_09_26/0095/0001"]
    for frame in ("0000", "0001"):
        port, ref = base / "port" / "result" / "dense", base / "jax" / "result" / "dense"
        assert (port / f"{frame}.pcd").read_bytes() == (ref / f"{frame}.pcd").read_bytes()
        got, want = load_labels(port / f"{frame}.labels"), load_labels(ref / f"{frame}.labels")
        assert len(got) == len(read_pcd(port / f"{frame}.pcd")) > SMALL["num_point"]
        np.testing.assert_array_equal(got, want)
    pngs = sorted((base / "port" / "result" / "frames").glob("*.png"))
    assert [p.name for p in pngs] == ["2011_09_26_0095_0000.png", "2011_09_26_0095_0001.png"]
    assert pngs[0].stat().st_size > 10_000
    lines = printed.splitlines()
    stages = [i for i, line in enumerate(lines) if "FPS]" in line]
    assert len(stages) == 2 and "load_data: " in lines[stages[0]] and "predict_interpolate: " in lines[stages[0]]
    assert lines[stages[0] + 1].startswith("predict: ") and ", densify: " in lines[stages[0] + 1]
    for frame in summary["frames"]:
        timer = frame["timer"]
        assert timer["predict"] + timer["densify"] == pytest.approx(timer["predict_interpolate"])


def test_kitti_predict_labels_are_the_predictor_and_densify_on_its_samples(both_kitti_predicts):
    """The dense labels of each frame: the sample the summary returns through a
    plain Predictor, then the densify engines on the host."""
    from pointnet2_tpu_torch.ops.densify import densify_labels
    from pointnet2_tpu_torch.train import load_model_state

    base, summary, _ = both_kitti_predicts
    cfg = Config.from_json(base / "config.json")
    predictor = Predictor(cfg, load_model_state(base / "port.pt"), device="cpu", impl="torch")
    with contextlib.redirect_stdout(text_io.StringIO()):
        dataset = kitti.KittiDataset(cfg.num_point, str(base), [DRIVE[0]], [DRIVE[1]], 60.0, 20.0)
    for frame, fd in zip(summary["frames"], dataset.list_file_data):
        centered, raw = fd.get_batch_of_one_z_box_from_origin(cfg.num_point)
        assert np.array_equal(frame["centered"], centered[0]) and np.array_equal(frame["raw"], raw[0])
        sparse = predictor.predict_step(centered.astype(np.float32)).numpy().reshape(-1)
        written = load_labels(base / "port" / "result" / "dense" / f"{frame['name'][-4:]}.labels")
        for engine in ("scipy", "native"):
            want, _ = densify_labels(raw[0].astype(np.float32), sparse, fd.points.astype(np.float32), 3, engine)
            np.testing.assert_array_equal(written, want)


@pytest.fixture
def port_ckpt(tmp_path, monkeypatch):
    from pointnet2_tpu_torch import convert

    cfg = Config(**SMALL)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(__import__("json").dumps(__import__("dataclasses").asdict(cfg)))
    trainer = Trainer(cfg, device="cpu")
    trainer.load_variables(convert.init_variables(cfg, 9, seed=2, bn_stats="random"))
    save_checkpoint(tmp_path / "port.pt", trainer)
    root = scenes.write_drive(tmp_path / "drive", 11, frames=1, points=12_000)
    monkeypatch.chdir(tmp_path)
    return ["--ckpt", str(tmp_path / "port.pt"), "--kitti_root", str(root), "--config_file", str(cfg_path),
            "--device", "cpu"]


def test_kitti_predict_auto_windows_and_the_certificate_abort(port_ckpt, monkeypatch, capsys):
    summary = cli_kitti.main(port_ckpt + ["--save", "--bq_window", "auto", "--fp_window", "auto"])
    assert "auto window calibration" in capsys.readouterr().out
    assert all(w is None or isinstance(w, int) for w in (summary["bq_window"], summary["fp_window"]))
    labels = load_labels("result/dense/0000.labels")
    assert len(labels) == summary["frames"][0]["dense_points"] and labels.min() >= 0 and labels.max() < 9

    monkeypatch.setattr(Predictor, "predict_step_checked", lambda self, points: (self.predict_step(points), False))
    with pytest.raises(ValueError, match="certificate failed on frame 2011_09_26/0095/0000"):
        cli_kitti.main(port_ckpt + ["--bq_window", "512"])


def test_kitti_predict_refusals(port_ckpt, tmp_path, monkeypatch):
    orbax_dir = tmp_path / "orbax"
    orbax_dir.mkdir()
    with pytest.raises(ValueError, match="cannot read the JAX package's orbax checkpoint directories"):
        cli_kitti.main(port_ckpt + ["--ckpt", str(orbax_dir)])
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # as on a machine without it
    with pytest.raises(ImportError, match="--render.*needs matplotlib"):
        cli_kitti.main(port_ckpt + ["--render"])
    with pytest.raises(ImportError, match="needs matplotlib"):
        render.render_cloud_png(np.zeros((4, 3)), None, str(tmp_path / "x.png"))
    assert not (tmp_path / "result" / "frames").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_kitti.main([a for a in port_ckpt if a not in ("--device", "cpu")])
