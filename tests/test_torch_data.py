"""The port's data modules, run logger and host confusion matrix against the JAX package's.

Both sides get the same seeded NumPy inputs. Tolerance: none. Both run the
same NumPy arithmetic, so every comparison is bit for bit: arrays with
``np.array_equal``, files byte for byte, log text and metric reports as
equal strings.
"""

import ast
import dataclasses
import json
import pathlib
import threading

import numpy as np
import pytest
import torch

from pointnet2_tpu.data import augment as jax_augment
from pointnet2_tpu.data import io as jax_io
from pointnet2_tpu.data import rng as jax_rng
from pointnet2_tpu.data import semantic3d as jax_s3d
from pointnet2_tpu.data import voxel as jax_voxel
from pointnet2_tpu.utils import logging as jax_logging
from pointnet2_tpu.utils.metrics import ConfusionMatrix as JaxConfusionMatrix
from pointnet2_tpu_torch.data import augment, io, semantic3d, voxel
from pointnet2_tpu_torch.data import rng as port_rng
from pointnet2_tpu_torch.utils import logging as port_logging
from pointnet2_tpu_torch.utils.metrics import ConfusionMatrix

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _equal_clouds(a, b) -> bool:
    return all(
        (x is None and y is None) or (x is not None and y is not None and np.array_equal(x, y) and x.dtype == y.dtype)
        for x, y in ((a.points, b.points), (a.colors, b.colors), (a.intensity, b.intensity))
    )


# -- file I/O ---------------------------------------------------------------


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
@pytest.mark.parametrize("with_colors", [True, False], ids=["rgb", "xyz"])
def test_pcd_written_by_one_side_reads_the_same_on_the_other(tmp_path, binary, with_colors):
    rng = np.random.RandomState(1)
    points = rng.rand(257, 3) * [30.0, 20.0, 5.0] - 7.0
    colors = rng.rand(257, 3) if with_colors else None
    io.write_pcd(tmp_path / "port.pcd", points, colors, binary=binary)
    jax_io.write_pcd(tmp_path / "jax.pcd", points, colors, binary=binary)
    assert (tmp_path / "port.pcd").read_bytes() == (tmp_path / "jax.pcd").read_bytes()
    got = io.read_pcd(tmp_path / "jax.pcd")
    want = jax_io.read_pcd(tmp_path / "port.pcd")
    assert _equal_clouds(got, want)
    assert np.array_equal(got.points, points.astype(np.float32).astype(np.float64))
    assert (got.colors is None) == (colors is None)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_pcd_with_split_rgb_and_intensity_fields(tmp_path, binary):
    """PCL's other layout: r, g, b in 0..255 and an intensity field."""
    rng = np.random.RandomState(2)
    n = 64
    rec = np.empty(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("intensity", "<f4"),
                             ("r", "u1"), ("g", "u1"), ("b", "u1")])
    for name in ("x", "y", "z", "intensity"):
        rec[name] = rng.rand(n) * 10
    for name in ("r", "g", "b"):
        rec[name] = rng.randint(0, 256, n)
    header = (
        "VERSION 0.7\nFIELDS x y z intensity r g b\nSIZE 4 4 4 4 1 1 1\nTYPE F F F F U U U\n"
        f"COUNT 1 1 1 1 1 1 1\nWIDTH {n}\nHEIGHT 1\nPOINTS {n}\nDATA {'binary' if binary else 'ascii'}\n"
    )
    path = tmp_path / "split.pcd"
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(rec.tobytes())
        else:
            for row in rec:
                f.write((" ".join(repr(v.item()) for v in row) + "\n").encode("ascii"))
    got, want = io.read_pcd(path), jax_io.read_pcd(path)
    assert _equal_clouds(got, want)
    assert got.intensity is not None and got.colors is not None


def test_labels_written_and_read_the_same(tmp_path):
    labels = np.random.RandomState(3).randint(0, 9, 1000)
    io.write_labels(tmp_path / "port.labels", labels)
    jax_io.write_labels(tmp_path / "jax.labels", labels)
    assert (tmp_path / "port.labels").read_bytes() == (tmp_path / "jax.labels").read_bytes()
    got, want = io.load_labels(tmp_path / "jax.labels"), jax_io.load_labels(tmp_path / "port.labels")
    assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want) and np.array_equal(got, labels)


def test_pts_and_semantic3d_txt_read_and_written_the_same(tmp_path):
    rng = np.random.RandomState(4)
    cloud = io.PointCloud(points=rng.rand(50, 3) * 100, colors=rng.rand(50, 3),
                          intensity=rng.randint(-2000, 2000, 50).astype(np.float32))
    io.write_pts(tmp_path / "port.pts", cloud)
    jax_io.write_pts(tmp_path / "jax.pts", jax_io.PointCloud(cloud.points, cloud.colors, cloud.intensity))
    assert (tmp_path / "port.pts").read_text() == (tmp_path / "jax.pts").read_text()
    assert _equal_clouds(io.read_pts(tmp_path / "jax.pts"), jax_io.read_pts(tmp_path / "port.pts"))
    raw = np.column_stack([rng.rand(40, 3) * 50, rng.randint(-500, 500, 40), rng.randint(0, 256, (40, 3))])
    np.savetxt(tmp_path / "scene.txt", raw, fmt="%.6f")
    assert _equal_clouds(io.read_semantic3d_txt(tmp_path / "scene.txt"),
                         jax_io.read_semantic3d_txt(tmp_path / "scene.txt"))


# -- augmentation -------------------------------------------------------------

# (name, the batch's last dimension, the arguments after it, whether it takes
# an ``rng``): those that do get a RandomState, the others draw from the
# global NumPy stream, seeded alike on both sides.
AUGMENTATIONS = [
    ("rotate_point_cloud", 3, (), True),
    ("rotate_feature_point_cloud", 6, (3,), True),
    ("jitter_point_cloud", 6, (), False),
    ("shift_point_cloud", 3, (), False),
    ("random_scale_point_cloud", 6, (), False),
    ("random_point_dropout", 6, (), False),
    ("shuffle_points", 6, (), False),
    ("rotate_point_cloud_with_normal", 6, (), False),
    ("rotate_point_cloud_by_angle", 6, (0.7,), False),
    ("rotate_perturbation_point_cloud", 3, (), False),
    ("rotate_perturbation_point_cloud_with_normal", 6, (), False),
]


def _augment(module, name, args, takes_rng, batch, seed):
    fn = getattr(module, name)
    if takes_rng:
        return fn(batch.copy(), *args, rng=np.random.RandomState(seed))
    np.random.seed(seed)
    return fn(batch.copy(), *args)


@pytest.mark.parametrize("name,width,args,takes_rng", AUGMENTATIONS, ids=[a[0] for a in AUGMENTATIONS])
def test_augmentation_bit_for_bit(name, width, args, takes_rng):
    batch = np.random.RandomState(5).rand(3, 128, width).astype(np.float32)
    got = _augment(augment, name, args, takes_rng, batch, seed=11)
    want = _augment(jax_augment, name, args, takes_rng, batch, seed=11)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert not np.array_equal(got, batch)  # it did something


def test_shuffle_data_and_file_lists(tmp_path):
    data = np.random.RandomState(6).rand(10, 4, 3)
    labels = np.arange(10)
    np.random.seed(12)
    got = augment.shuffle_data(data, labels)
    np.random.seed(12)
    want = jax_augment.shuffle_data(data, labels)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    (tmp_path / "files.txt").write_text("a.h5\nb.h5\n")
    assert augment.get_data_files(tmp_path / "files.txt") == jax_augment.get_data_files(tmp_path / "files.txt")


def test_augment_module_imports_h5py_only_inside_load_h5():
    tree = ast.parse((ROOT / "pointnet2_tpu_torch/data/augment.py").read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = {a.name for n in top for a in n.names} | {n.module for n in top if isinstance(n, ast.ImportFrom)}
    assert "h5py" not in names


# -- voxels -----------------------------------------------------------------


@pytest.mark.parametrize("with_colors,min_bound", [(True, None), (False, None), (True, (-1.0, -2.0, -0.5))])
def test_voxel_downsample_and_majority_vote_bit_for_bit(with_colors, min_bound):
    rng = np.random.RandomState(7)
    points = rng.rand(5000, 3) * [12.0, 9.0, 3.0]
    colors = rng.rand(5000, 3) if with_colors else None
    bound = None if min_bound is None else np.array(min_bound)
    got = voxel.voxel_downsample_with_trace(points, 0.4, colors, bound)
    want = jax_voxel.voxel_downsample_with_trace(points, 0.4, colors, bound)
    for g, w in zip(got, want):
        assert (g is None and w is None) or (g.dtype == w.dtype and np.array_equal(g, w))
    labels = rng.randint(0, 9, 5000)
    nv = len(got[0])
    vote = voxel.majority_vote_labels(got[2], labels, nv)
    assert vote.dtype == np.int32 and np.array_equal(vote, jax_voxel.majority_vote_labels(want[2], labels, nv))
    low = points.min(0)
    assert np.array_equal(voxel.voxel_keys(points, 0.4, low), jax_voxel.voxel_keys(points, 0.4, low))


# -- the thread-local sampling streams ---------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_thread_local_rng_streams(seed):
    """Children are spawned in first-call order: the caller's first, then each
    thread's, run one after another so the order is fixed."""
    port, ref = port_rng.ThreadLocalRNG(seed), jax_rng.ThreadLocalRNG(seed)
    draws = {"port": [], "jax": []}

    def draw(side, source):
        r = source.get()
        assert source.get() is r  # one RandomState a thread
        draws[side].append((r.randint(0, 2**31, 8), r.uniform(size=4), r.permutation(16)))

    for side, source in (("port", port), ("jax", ref)):
        draw(side, source)
        for _ in range(3):
            t = threading.Thread(target=draw, args=(side, source))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    for got, want in zip(draws["port"], draws["jax"], strict=True):
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    firsts = {tuple(d[0]) for d in draws["port"]}
    assert len(firsts) == 4  # each thread its own stream
    state = np.random.RandomState(3)
    assert port_rng.resolve_rng(state) is state and port_rng.resolve_rng(port) is port.get()


# -- the Semantic3D dataset -------------------------------------------------


def _fabricate(data_dir, rng, prefixes, n):
    """Scenes of 20 x 20 x 4 m (larger than the 10 x 10 m box), labels by height and x."""
    for prefix in prefixes:
        pts = rng.rand(n, 3) * [20.0, 20.0, 4.0]
        labels = (np.where(pts[:, 2] < 2.0, 1, 5) + (pts[:, 0] > 15.0)).astype(np.int32)
        jax_io.write_pcd(str(data_dir / f"{prefix}.pcd"), pts, rng.rand(n, 3))
        jax_io.write_labels(str(data_dir / f"{prefix}.labels"), labels)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    data_dir = tmp_path_factory.mktemp("s3d")
    rng = np.random.RandomState(0)
    _fabricate(data_dir, rng, jax_s3d.train_file_prefixes + jax_s3d.validation_file_prefixes, 3000)
    _fabricate(data_dir, rng, jax_s3d.test_file_prefixes, 1500)
    return str(data_dir)


def _datasets(path, split, num_point=256, use_color=True, seed=3):
    kw = dict(num_points_per_sample=num_point, split=split, use_color=use_color, box_size_x=10.0,
              box_size_y=10.0, path=path, seed=seed)
    return semantic3d.SemanticDataset(**kw), jax_s3d.SemanticDataset(**kw)


def test_split_tables_are_the_same():
    assert semantic3d.map_name_to_file_prefixes == jax_s3d.map_name_to_file_prefixes
    assert semantic3d.LABEL_NAMES == jax_s3d.LABEL_NAMES and semantic3d.NUM_CLASSES == jax_s3d.NUM_CLASSES


@pytest.mark.parametrize("split", ["train", "validation", "train_full", "test"])
def test_dataset_label_weights_and_batch_counts(scenes, split):
    port, ref = _datasets(scenes, split)
    assert port.label_weights.dtype == np.float32 and np.array_equal(port.label_weights, ref.label_weights)
    if split in ("train", "train_full"):
        assert (port.label_weights > 0).all()
    else:
        assert not port.label_weights.any()  # the reference's quirk: all-zero weights off the train splits
    assert np.array_equal(port.scene_probas, ref.scene_probas)
    assert port.get_total_num_points() == ref.get_total_num_points()
    for bs in (1, 2, 8):
        assert port.get_num_batches(bs) == ref.get_num_batches(bs)
    assert port.get_file_paths_without_ext() == ref.get_file_paths_without_ext()
    assert port.labels_names == ref.labels_names and port.num_classes == ref.num_classes


@pytest.mark.parametrize("augmented", [True, False], ids=["augment", "plain"])
@pytest.mark.parametrize("split,num_point,use_color", [
    ("train", 256, True), ("validation", 256, True), ("train", 4096, True), ("train", 256, False),
])
def test_dataset_batches_bit_for_bit(scenes, split, num_point, use_color, augmented):
    """Several batches from the same seed; 4096 points is more than a box
    holds, so the fixed-size mask repeats points."""
    port, ref = _datasets(scenes, split, num_point, use_color)
    for _ in range(3):
        got = port.sample_batch_in_all_files(4, augment=augmented)
        want = ref.sample_batch_in_all_files(4, augment=augmented)
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[0].shape == (4, num_point, 6 if use_color else 3)


def test_file_data_samples_bit_for_bit(scenes):
    prefix = jax_s3d.validation_file_prefixes[1]
    kw = dict(file_path_without_ext=f"{scenes}/{prefix}", has_label=True, use_color=True,
              box_size_x=10.0, box_size_y=10.0)
    port = semantic3d.SemanticFileData(**kw, rng=np.random.RandomState(9))
    ref = jax_s3d.SemanticFileData(**kw, rng=np.random.RandomState(9))
    for _ in range(2):
        for g, w in zip(port.sample_batch(3, 512), ref.sample_batch(3, 512), strict=True):
            assert np.array_equal(g, w)
    assert np.array_equal(port.points, ref.points) and np.array_equal(port.labels, ref.labels)


# -- the host confusion matrix ----------------------------------------------


def test_confusion_matrix_metrics_against_the_jax_class(capsys):
    rng = np.random.RandomState(10)
    port, ref = ConfusionMatrix(9), JaxConfusionMatrix(9)
    for _ in range(3):
        gt, pd = rng.randint(0, 9, 500), rng.randint(0, 9, 500)
        port.increment_from_list(gt, pd)
        ref.increment_from_list(gt, pd)
    extra = rng.randint(0, 50, (9, 9))
    port.increment_from_matrix(torch.from_numpy(extra))  # a tensor, as the device's matrix arrives
    ref.increment_from_matrix(extra)
    port.increment(3, 4)
    ref.increment(3, 4)
    assert np.array_equal(port.confusion_matrix, ref.confusion_matrix)
    assert port.get_per_class_ious() == ref.get_per_class_ious()
    assert port.get_mean_iou() == ref.get_mean_iou() and port.get_accuracy() == ref.get_accuracy()
    names = list(semantic3d.LABEL_NAMES)
    assert port.format_metrics(names) == ref.format_metrics(names)
    capsys.readouterr()
    port.print_metrics()
    got = capsys.readouterr().out
    ref.print_metrics()
    assert got == capsys.readouterr().out
    for bad in ((9, 0), (0, -1)):
        with pytest.raises(ValueError):
            port.increment(*bad)
        with pytest.raises(ValueError):
            port.increment_from_list([bad[0]], [bad[1]])
    assert ConfusionMatrix(9).get_accuracy() == JaxConfusionMatrix(9).get_accuracy() == 0.0


# -- the run logger -----------------------------------------------------------


def test_run_logger_writes_what_the_jax_logger_writes(tmp_path, capsys):
    port, ref = port_logging.RunLogger(tmp_path / "port"), jax_logging.RunLogger(tmp_path / "jax")
    for logger in (port, ref):
        logger.log("**** EPOCH 000 ****")
        logger.scalars(17, "train", loss=np.float32(0.25), accuracy=0.5)
        logger.scalars(17, "validation", miou=1)
        logger.close()
    assert (tmp_path / "port/log_train.txt").read_text() == (tmp_path / "jax/log_train.txt").read_text()

    def records(side):
        out = [json.loads(line) for line in (tmp_path / side / "scalars.jsonl").read_text().splitlines()]
        assert all(isinstance(r.pop("time"), float) for r in out)
        return out

    assert records("port") == records("jax")
    capsys.readouterr()
    for value in (0, 0.5, 1.5, "x", -1):
        port_logging.update_progress(value)
        got = capsys.readouterr().out
        jax_logging.update_progress(value)
        assert got == capsys.readouterr().out
    port_logging.NullLogger(3).log("hello")
    got = capsys.readouterr().out
    jax_logging.NullLogger(3).log("hello")
    assert got == capsys.readouterr().out == "[proc 3] hello\n"


def test_config_written_by_the_port_loads_on_both_sides(tmp_path):
    from pointnet2_tpu.config import Config as JaxConfig
    from pointnet2_tpu_torch.config import Config

    cfg = Config(num_point=512, batch_size=2, l1_npoint=128)
    (tmp_path / "cfg.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    assert dataclasses.asdict(JaxConfig.from_json(tmp_path / "cfg.json")) == dataclasses.asdict(cfg)
