"""The port's densification against the JAX package's and the NumPy oracle, on the CPU.

Every engine the CPU has (``scipy``, ``native``, ``device`` on the plain
path, ``auto``, ``sharded`` over CPU shards) must give ``pointnet2_tpu.ops.densify.densify_labels``'s
labels and ``reference.densify_labels_np``'s, exactly: labels are integers
and the inputs hold no distance ties, so any difference is a fault. The
JAX side runs its ``scipy`` and ``device`` engines only: its ``native``
engine loads ``native/libpn2native.so``, which ``tests/test_densify.py``
rebuilds in place while other workers run. The port builds its own library.
"""

import contextlib
import io as text_io
import sys

import numpy as np
import pytest
import torch

from pointnet2_tpu.ops import reference
from pointnet2_tpu.ops.densify import densify_labels as jax_densify_labels
from pointnet2_tpu.utils import colors as jax_colors
from pointnet2_tpu_torch import native
from pointnet2_tpu_torch.ops import densify
from pointnet2_tpu_torch.ops.densify import densify_labels, densify_labels_device
from pointnet2_tpu_torch.utils import colors

ENGINES = ["scipy", "native", "device", "auto", "sharded"]
SHARDS = ("cpu",) * 3  # the sharded engine's mesh: three shards, the dense cloud padded to 384 a shard


def _problem(seed, ns=300, nd=1000):
    rng = np.random.RandomState(seed)
    sparse = (rng.rand(ns, 3) * 5).astype(np.float32)
    labels = rng.randint(0, 9, ns).astype(np.int32)
    dense = (rng.rand(nd, 3) * 5).astype(np.float32)
    return sparse, labels, dense


def _port(engine, sparse, labels, dense, knn):
    return densify_labels(sparse, labels, dense, knn=knn, engine=engine, device="cpu",
                          mesh=SHARDS if engine == "sharded" else None)


@pytest.mark.parametrize("knn", [1, 3, 5])
@pytest.mark.parametrize("engine", ENGINES)
def test_every_engine_equals_the_jax_function_and_the_oracle(engine, knn):
    sparse, labels, dense = _problem(knn, ns=300, nd=600)
    got, got_colors = _port(engine, sparse, labels, dense, knn)
    want = reference.densify_labels_np(sparse, labels, dense, k=knn)
    assert got.dtype == np.int32 and got_colors.dtype == np.uint8 and got_colors.shape == (600, 3)
    np.testing.assert_array_equal(got, want)
    for jax_engine in ("scipy", "device"):
        jax_got, jax_got_colors = jax_densify_labels(sparse, labels, dense, knn=knn, engine=jax_engine)
        np.testing.assert_array_equal(got, np.asarray(jax_got))
        np.testing.assert_array_equal(got_colors, np.asarray(jax_got_colors))


@pytest.mark.parametrize("engine", ENGINES)
def test_k_larger_than_the_sparse_set_is_clamped(engine):
    sparse, labels, dense = _problem(11, ns=2, nd=50)
    got, _ = _port(engine, sparse, labels, dense, 5)
    np.testing.assert_array_equal(got, reference.densify_labels_np(sparse, labels, dense, k=2))
    np.testing.assert_array_equal(got, jax_densify_labels(sparse, labels, dense, knn=5, engine="scipy")[0])


@pytest.mark.parametrize("engine", ENGINES)
def test_a_sparse_set_of_seven_points(engine):
    rng = np.random.RandomState(12)
    sparse = rng.rand(7, 3).astype(np.float32)
    labels = np.arange(1, 8, dtype=np.int32)
    dense = rng.rand(300, 3).astype(np.float32)
    got, _ = _port(engine, sparse, labels, dense, 3)
    np.testing.assert_array_equal(got, reference.densify_labels_np(sparse, labels, dense, k=3))
    np.testing.assert_array_equal(got, np.asarray(jax_densify_labels(sparse, labels, dense, knn=3, engine="device")[0]))


# Labels of a dense point's neighbours in ascending distance, and the label
# the vote must give: the first label to reach the largest count wins.
TIES = [
    ([1, 2, 2, 1, 1], 4, 2),  # 2 reaches two first
    ([1, 2, 1, 2, 2], 4, 1),  # 1 reaches two first
    ([3, 1, 2, 4, 5], 4, 3),  # all once: the nearest
    ([5, 5, 6, 6, 6], 4, 5),
    ([7, 8, 8, 8, 7], 4, 8),
    ([1, 2, 2, 1, 1], 5, 1),  # 2 reaches two first, 1 three later
    ([6, 4, 4, 6, 0], 5, 4),
    ([2, 3, 4, 2, 3], 3, 2),
]


@pytest.mark.parametrize("engine", ENGINES)
def test_vote_ties_go_to_the_first_label_to_reach_the_count(engine):
    """One far-apart cluster a case: a dense point at its centre and five sparse
    points at distances 1.0-1.4 in five directions, labelled in that order."""
    directions = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    for knn in (3, 4, 5):
        cases = [(order, want) for order, k, want in TIES if k == knn]
        centres = np.array([[100.0 * i, 0.0, 0.0] for i in range(len(cases))], np.float32)
        sparse = np.concatenate([c + directions * (1.0 + 0.1 * np.arange(5))[:, None] for c in centres])
        labels = np.concatenate([np.array(order, np.int32) for order, _ in cases])
        got, got_colors = _port(engine, sparse.astype(np.float32), labels, centres, knn)
        want = np.array([w for _, w in cases], np.int32)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, reference.densify_labels_np(sparse, labels, centres, k=knn))
        np.testing.assert_array_equal(got_colors, jax_colors.LABEL_COLORS_UINT8[want])


def test_colors_equal_the_jax_table():
    np.testing.assert_array_equal(colors.LABEL_COLORS_UINT8, jax_colors.LABEL_COLORS_UINT8)
    labels = np.array([0, 5, 8, 3, 3])
    np.testing.assert_array_equal(colors.label_to_colors(labels), jax_colors.label_to_colors(labels))
    pts = np.zeros((5, 3))
    np.testing.assert_array_equal(colors.colorize_point_cloud(pts, labels),
                                  jax_colors.colorize_point_cloud(pts, labels))
    with pytest.raises(ValueError):
        colors.label_to_colors(np.array([9]))
    with pytest.raises(ValueError):
        colors.colorize_point_cloud(pts, labels[:2])


def test_sharded_engine_names_its_item_and_unknown_engines_raise(monkeypatch):
    """The sharded engine answers with the device engine's labels, over any
    mesh; its default mesh is every visible card, and raises without one."""
    sparse, labels, dense = _problem(3, ns=20, nd=20)
    want = densify_labels(sparse, labels, dense, engine="device", device="cpu")
    for mesh in (("cpu",), ("cpu",) * 2, ("cpu",) * 8):
        got = densify_labels(sparse, labels, dense, engine="sharded", mesh=mesh)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        densify_labels(sparse, labels, dense, engine="sharded")
    with pytest.raises(ValueError, match="unknown densify engine"):
        densify_labels(sparse, labels, dense, engine="gpu")


def test_device_engine_is_chunked_and_stays_on_its_device(monkeypatch):
    """The plain version in chunks of a few queries gives the labels of one
    chunk, and the labels and colors stay on the device as tensors."""
    sparse, labels, dense = _problem(4, ns=200, nd=700)
    whole, whole_colors = densify_labels_device(sparse, labels, dense, 3, device="cpu")
    monkeypatch.setattr(densify, "PLAIN_PAIRS", 200 * 64)
    calls = []
    knn = densify.ops.knn
    monkeypatch.setattr(densify.ops, "knn", lambda *a, **kw: calls.append(a[1].shape) or knn(*a, **kw))
    got, got_colors = densify_labels_device(torch.from_numpy(sparse), torch.from_numpy(labels),
                                            torch.from_numpy(dense), 3, device="cpu")
    assert [shape[1] for shape in calls] == [64] * 10 + [60]
    assert got.dtype == torch.int32 and got_colors.dtype == torch.uint8 and got_colors.shape == (700, 3)
    assert torch.equal(got, whole) and torch.equal(got_colors, whole_colors)
    np.testing.assert_array_equal(got.numpy(), reference.densify_labels_np(sparse, labels, dense, k=3))
    np.testing.assert_array_equal(got_colors.numpy(), colors.LABEL_COLORS_UINT8[got.numpy()])


def test_device_engine_on_the_kernel_path_has_no_plain_fallback():
    """With ``impl="cuda"`` the engine calls the kernel, which refuses CPU tensors."""
    sparse, labels, dense = _problem(3, ns=20, nd=20)
    with pytest.raises(ValueError, match="CUDA"):
        densify_labels_device(sparse, labels, dense, 3, device="cpu", impl="cuda")


def test_device_chunk_keeps_the_kernels_int32_outputs():
    assert densify.device_chunk(3, 250_000, kernel=True) == densify.MAX_DEVICE_CHUNK
    assert densify.device_chunk(29056, 250_000, kernel=True) * 29056 < 2**31
    assert densify.device_chunk(3, 250_000, kernel=False) == densify.PLAIN_PAIRS // 250_000


def test_majority_vote_on_the_device_equals_the_numpy_vote():
    rng = np.random.RandomState(5)
    for k in (1, 2, 3, 6):
        nl = rng.randint(0, 4, (500, k)).astype(np.int32)
        np.testing.assert_array_equal(
            densify.majority_vote(torch.from_numpy(nl)).numpy(), densify._majority_in_distance_order(nl)
        )


def test_device_engine_runs_on_cuda_by_default_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sparse, labels, dense = _problem(3, ns=20, nd=20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        densify_labels(sparse, labels, dense, engine="device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        densify_labels_device(sparse, labels, dense)


def test_native_loader_builds_its_own_library_and_never_a_stale_one(tmp_path, monkeypatch):
    """The port's library lives in its build directory, named by a hash of the
    source: an edited source gets a new library, built fresh, never the old one."""
    assert native.library_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "build" and native.BUILD_DIR.parent.name == "pointnet2_tpu_torch"
    assert native.SOURCE == native.PACKAGE_DIR.parent / "native" / "densify.cpp"
    if native.get_lib() is None:
        pytest.skip("no C++ compiler with OpenMP")
    assert native.library_path().exists()

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    edited = tmp_path / "densify.cpp"
    edited.write_text(native.SOURCE.read_text())
    first = native.library_path(edited)
    assert first.parent == tmp_path / "build" and not first.exists()
    assert native.get_lib(edited) is not None and first.exists()
    edited.write_text(native.SOURCE.read_text() + "\n// edited\n")
    second = native.library_path(edited)
    assert second != first and not second.exists()
    lib = native.get_lib(edited)
    assert lib is not None and second.exists() and second.stat().st_mtime >= edited.stat().st_mtime
    assert lib._name == str(second)


def test_native_build_tries_cxx_then_gpp(tmp_path, monkeypatch):
    """A ``$CXX`` that cannot build the library (one without OpenMP's spec
    file has been seen) is logged and the next compiler, ``g++``, builds it."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert native.compilers() == [str(tmp_path / "no-such-compiler"), "g++"]
    if native.get_lib() is None:
        pytest.skip("no C++ compiler with OpenMP")
    failed = native.library_path(native.SOURCE, native.compilers()[0])
    assert "no-such-compiler" in failed.with_suffix(".log").read_text() and not failed.exists()
    assert native.library_path(native.SOURCE, "g++").exists()
    monkeypatch.delenv("CXX")
    assert native.compilers() == ["g++"]


def test_native_knn_is_exact():
    if native.get_lib() is None:
        pytest.skip("no C++ compiler with OpenMP")
    rng = np.random.RandomState(6)
    data = (rng.rand(500, 3) * 3).astype(np.float32)
    queries = (rng.rand(100, 3) * 3).astype(np.float32)
    idx, d2 = native.knn_search_native(data, queries, 5)
    want_d2, want_idx = reference.knn_np(data[None], queries[None], 5)
    np.testing.assert_array_equal(idx, want_idx[0])
    np.testing.assert_allclose(d2, want_d2[0], rtol=1e-5, atol=1e-7)


# -- the interpolate CLI against the root interpolate.py ----------------------


@pytest.fixture(scope="module")
def both_interpolates(tmp_path_factory):
    """Root ``interpolate.py`` (``--engine scipy``: its ``native`` engine loads
    the library another worker may be rebuilding) and the port's CLI with every
    engine the CPU has, on the 6 validation scenes from
    ``tools.scenes.fabricate_dense`` (the last without ground truth)."""
    from pointnet2_tpu_torch.cli import interpolate as cli_interpolate
    from pointnet2_tpu_torch.data.semantic3d import validation_file_prefixes
    from pointnet2_tpu_torch.tools import scenes

    base = tmp_path_factory.mktemp("interpolate")
    for name in ("gt", "sparse"):
        (base / name).mkdir()
    scenes.fabricate_dense(base / "gt", base / "sparse", 0, "validation", (3000,) * 6, (400,) * 6)
    (base / "gt" / f"{validation_file_prefixes[-1]}.labels").unlink()
    common = ["--set", "validation", "--sparse_dir", str(base / "sparse"), "--gt_dir", str(base / "gt")]
    printed, summaries = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["interpolate.py", "--dense_dir", str(base / "root"), "--engine", "scipy"] + common)
        import interpolate

        with contextlib.redirect_stdout(text_io.StringIO()) as out:
            interpolate.main()
        printed["root"] = out.getvalue()
    for engine in ENGINES:
        with contextlib.redirect_stdout(text_io.StringIO()) as out:
            summaries[engine] = cli_interpolate.main(
                ["--dense_dir", str(base / engine), "--engine", engine, "--device", "cpu"] + common
            )
        printed[engine] = out.getvalue()
    return base, printed, summaries


def _metrics(text: str, base) -> list[str]:
    """The printed lines but the timings, with the output directory made neutral."""
    lines = [line for line in text.splitlines() if not line.startswith("KNN interpolation time")]
    return [line.replace(str(base), "").split("/", 2)[-1] for line in lines]


@pytest.mark.parametrize("engine", ENGINES)
def test_interpolate_cli_writes_the_root_scripts_files_and_metrics(both_interpolates, engine):
    from pointnet2_tpu_torch.data.semantic3d import validation_file_prefixes

    base, printed, summaries = both_interpolates
    summary = summaries[engine]
    assert summary["scenes"] == validation_file_prefixes and summary["points"] == [3000] * 6
    for prefix in validation_file_prefixes:
        for suffix in (".labels", "_colored.pcd"):
            name = f"{prefix}{suffix}"
            assert (base / engine / name).read_bytes() == (base / "root" / name).read_bytes()
    assert _metrics(printed[engine], base) == _metrics(printed["root"], base)
    assert printed[engine].count("Confusion matrix") == 6 and "treat as test set" in printed[engine]
    assert 0.5 < float(printed[engine].split("Global results")[1].split("accuracy:")[1].split()[0]) <= 1.0


def test_interpolate_cli_refuses_sharded_and_needs_cuda_for_the_device_engine(monkeypatch):
    from pointnet2_tpu_torch.cli import interpolate as cli_interpolate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # --engine sharded answers over every visible card, and there is none here.
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        cli_interpolate.main(["--engine", "sharded"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_interpolate.main(["--engine", "device"])
