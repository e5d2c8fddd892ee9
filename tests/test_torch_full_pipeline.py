"""The port's full pipeline, end to end through its entry points, on the CPU:

    raw .txt -> cli.preprocess -> cli.downsample -> cli.train -> cli.predict
             -> cli.interpolate -> cli.renamer

The counterpart of ``tests/test_full_pipeline.py``, on the same synthetic
raw scenes (its ``_write_raw_txt``, the same seed and split tables, the
test scene a real test prefix so the renamer's submission name applies)
and with the same configuration and flags; every CLI of the port runs with
``--device cpu`` where it takes one. The same assertions: the test scene's
dense labels carry their submission name, one label a raw point, and the
dense validation accuracy is above 0.6 (two balanced classes: chance is
0.5).
"""

from __future__ import annotations

import contextlib
import io as text_io

import numpy as np
import pytest
import torch

import pointnet2_tpu_torch.data.semantic3d as s3d
from pointnet2_tpu_torch.cli import downsample, interpolate, predict, preprocess, renamer, train
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.data.io import load_labels
from test_full_pipeline import ALL_SCENES, TEST_SCENES, TRAIN_SCENES, VAL_SCENES, _write_raw_txt

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    rng = np.random.RandomState(7)
    base = tmp_path_factory.mktemp("pipeline")
    raw = base / "raw"
    down = base / "downsampled"
    raw.mkdir()

    # The split tables for the whole chain: every CLI resolves its prefixes
    # through pointnet2_tpu_torch.data.semantic3d.
    saved = {k: list(v) for k, v in s3d.map_name_to_file_prefixes.items()}
    saved_all = list(s3d.all_file_prefixes)
    s3d.map_name_to_file_prefixes["train"] = TRAIN_SCENES
    s3d.map_name_to_file_prefixes["validation"] = VAL_SCENES
    s3d.map_name_to_file_prefixes["test"] = TEST_SCENES
    s3d.map_name_to_file_prefixes["train_full"] = TRAIN_SCENES + VAL_SCENES
    s3d.map_name_to_file_prefixes["all"] = ALL_SCENES
    s3d.all_file_prefixes[:] = ALL_SCENES

    try:
        for name in ALL_SCENES:
            _write_raw_txt(str(raw / name), rng, with_labels=name not in TEST_SCENES)

        with contextlib.redirect_stdout(text_io.StringIO()):
            preprocess.main(["--raw_dir", str(raw)])
            downsample.main(["--raw_dir", str(raw), "--downsampled_dir", str(down), "--voxel_size", "0.4"])

            cfg = Config(
                num_point=128, batch_size=8, max_epoch=3, data_path=str(down), logdir=str(base / "log"),
                box_size_x=10, box_size_y=10,
                l1_npoint=32, l2_npoint=16, l3_npoint=8, l4_npoint=4,
                l1_radius=0.5, l2_radius=1.0, l3_radius=2.0, l4_radius=4.0,
                l1_nsample=8, l2_nsample=8, l3_nsample=4, l4_nsample=4,
            )
            cfg_path = base / "pipeline.json"
            cfg.to_json(cfg_path)

            train.main(["--config_file", str(cfg_path), "--seed", "0", "--device", "cpu"])
            ckpt = base / "log" / "model_autosave.pt"
            assert ckpt.exists()

            sparse = base / "sparse"
            for split in ("validation", "test"):
                predict.main(["--ckpt", str(ckpt), "--set", split, "--config_file", str(cfg_path),
                              "--num_samples", "4", "--batch_size", "4", "--output_dir", str(sparse),
                              "--device", "cpu"])

            dense = base / "dense"
            for split in ("validation", "test"):
                interpolate.main(["--set", split, "--sparse_dir", str(sparse), "--dense_dir", str(dense),
                                  "--gt_dir", str(raw), "--engine", "scipy"])

            renamer.main(["--dense_dir", str(dense)])
        yield {"base": base, "raw": raw, "dense": dense, "cfg": cfg}
    finally:
        for k, v in saved.items():
            s3d.map_name_to_file_prefixes[k] = v
        s3d.all_file_prefixes[:] = saved_all


def test_submission_named_dense_labels(pipeline):
    dense = pipeline["dense"]
    assert (dense / "marketsquarefeldkirch4.labels").exists()
    assert not (dense / (TEST_SCENES[0] + ".labels")).exists()
    labels = np.loadtxt(dense / "marketsquarefeldkirch4.labels", dtype=np.int64)
    raw_pts = np.loadtxt(pipeline["raw"] / (TEST_SCENES[0] + ".txt"), usecols=(0, 1, 2))
    assert len(labels) == len(raw_pts)  # one label per raw dense point


def test_dense_validation_accuracy_above_chance(pipeline):
    got = load_labels(pipeline["dense"] / (VAL_SCENES[0] + ".labels"))
    want = load_labels(pipeline["raw"] / (VAL_SCENES[0] + ".labels"))
    assert len(got) == len(want)
    mask = want != 0
    acc = float((got[mask] == want[mask]).mean())
    assert acc > 0.6, f"dense validation accuracy {acc:.3f} not above chance"


def test_train_artifacts_from_the_cli(pipeline):
    text = (pipeline["base"] / "log" / "log_train.txt").read_text()
    assert "EPOCH 002" in text
    assert "eval accuracy" in text
