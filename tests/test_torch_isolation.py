"""The port stands alone: no JAX and nothing of pointnet2_tpu, and no silent CPU path.

These tests import neither JAX nor the JAX package themselves.
"""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

from pointnet2_tpu_torch import ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "pointnet2_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_importing_the_port_loads_no_jax():
    mods = _port_modules() + ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pointnet2_tpu'))\n"
        "print(len(bad), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    run = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert run.returncode == 0, run.stdout + run.stderr
    assert len(mods) >= 23
    assert {"pointnet2_tpu_torch.train.trainer", "pointnet2_tpu_torch.utils.metrics",
            "pointnet2_tpu_torch.ops.autograd", "pointnet2_tpu_torch.train_profile",
            "pointnet2_tpu_torch.ops.calibrate", "pointnet2_tpu_torch.ops.cuda.wingather",
            "pointnet2_tpu_torch.ops.reference", "pointnet2_tpu_torch.utils.bench",
            "pointnet2_tpu_torch.tools.parity", "pointnet2_tpu_torch.tools.op_bench",
            "pointnet2_tpu_torch.tools.stage_bench", "pointnet2_tpu_torch.ops.densify",
            "pointnet2_tpu_torch.native", "pointnet2_tpu_torch.data.kitti", "pointnet2_tpu_torch.utils.colors",
            "pointnet2_tpu_torch.utils.render", "pointnet2_tpu_torch.cli.interpolate",
            "pointnet2_tpu_torch.cli.kitti_predict", "pointnet2_tpu_torch.ops.library",
            "pointnet2_tpu_torch.export", "pointnet2_tpu_torch.serving", "pointnet2_tpu_torch.cli.serve",
            "pointnet2_tpu_torch.tools.export_model", "pointnet2_tpu_torch.cli.preprocess",
            "pointnet2_tpu_torch.cli.downsample", "pointnet2_tpu_torch.tools.convert_checkpoint",
            "pointnet2_tpu_torch.tools.scalars_to_tb", "pointnet2_tpu_torch.nn.extras",
            "pointnet2_tpu_torch.utils.html_viewer", "pointnet2_tpu_torch.cli.visualize",
            "pointnet2_tpu_torch.cli.colorize", "pointnet2_tpu_torch.cli.kitti_visualize",
            "pointnet2_tpu_torch.tools.bq_window_calibrate", "pointnet2_tpu_torch.cli.benchmark",
            "pointnet2_tpu_torch.cli.renamer", "pointnet2_tpu_torch.utils.op_report",
            "pointnet2_tpu_torch.tools.train_soak", "pointnet2_tpu_torch.tools.bf16_train_soak",
            "pointnet2_tpu_torch.ops.cuda.probes", "pointnet2_tpu_torch.tools.fps_mask_probe",
            "pointnet2_tpu_torch.tools.fps_packed_probe", "pointnet2_tpu_torch.tools.knn_variant_probe",
            "pointnet2_tpu_torch.ops.cuda.bq_probes", "pointnet2_tpu_torch.tools.bq_i16_probe",
            "pointnet2_tpu_torch.tools.bq_fat_probe", "pointnet2_tpu_torch.tools.bq_cond_probe",
            "pointnet2_tpu_torch.tools.bq_sliced_decomp_probe", "pointnet2_tpu_torch.ops.cuda.gather_probes",
            "pointnet2_tpu_torch.tools.gather_probe", "pointnet2_tpu_torch.tools.sp_gather_probe",
            "pointnet2_tpu_torch.tools.fused_gather_probe",
            "pointnet2_tpu_torch.tools.wingather_out4d_probe"} <= set(mods)


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|pointnet2_tpu)(?:\.|\s|$)", re.MULTILINE
)


@pytest.mark.parametrize(
    "path",
    sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")) + ["chip_smoke.py"],
)
def test_source_has_no_jax_or_reference_import(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(text), path


def test_the_scan_catches_forbidden_imports():
    for line in ("import jax", "from jax import numpy", "import pointnet2_tpu.ops",
                 "from pointnet2_tpu import ops", "  import flax.linen"):
        assert _FORBIDDEN.search(line), line
    for line in ("import pointnet2_tpu_torch", "from pointnet2_tpu_torch.ops import core"):
        assert not _FORBIDDEN.search(line), line


@pytest.mark.parametrize(
    "op", ["fps_centroids", "ball_query", "knn", "three_nn", "three_interpolate", "three_interpolate_grad",
           "ball_query_calibrated", "project_group_calibrated", "knn_calibrated", "three_nn_calibrated",
           "farthest_point_sample"]
)
def test_impl_cuda_on_a_cpu_tensor_raises(op):
    xyz = torch.rand(1, 32, 3)
    big = torch.rand(1, 512, 3)
    args = {
        "ball_query_calibrated": (big, big[:, :128].contiguous(), 0.1, 4, 128),
        "project_group_calibrated": (
            torch.rand(1, 512, 6), torch.rand(6, 4), torch.rand(4), big, big[:, :128].contiguous(), 0.1, 4, 128,
        ),
        "knn_calibrated": (big, big, 3, 128),
        "three_nn_calibrated": (big, big, 128),
        "fps_centroids": (xyz, 8),
        "farthest_point_sample": (xyz, 8),
        "ball_query": (xyz, xyz[:, :8].contiguous(), 0.5, 4),
        "knn": (xyz, xyz, 3),
        "three_nn": (xyz, xyz),
        "three_interpolate": (torch.rand(1, 8, 4), torch.zeros(1, 32, 3, dtype=torch.int32), torch.rand(1, 32, 3)),
        "three_interpolate_grad": (
            torch.rand(1, 32, 4), torch.zeros(1, 32, 3, dtype=torch.int32), torch.rand(1, 32, 3), 8,
        ),
    }[op]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(ops, op)(*args, impl="cuda")


@pytest.mark.parametrize(
    "name", ["fps_centroids", "ball_query", "knn", "three_interpolate", "three_interpolate_grad",
             "ball_query_tiles", "ball_query_tiles_pos", "window_gather", "knn_tiles",
             "farthest_point_sample", "ball_query_window_tiles", "fps_remask", "fps_packed", "knn_argmin",
             "knn_tracked", "bq_keys", "bq_fat", "bq_precut_cond", "bq_precut_decomp"]
)
def test_kernel_wrappers_refuse_cpu_tensors(name):
    """Called directly, a wrapper never runs a plain version in the kernel's place."""
    from pointnet2_tpu_torch.ops import cuda

    xyz = torch.rand(1, 32, 3)
    big = torch.rand(1, 512, 3)
    perm = torch.arange(512, dtype=torch.int32)[None]
    lo = torch.zeros(1, 1, dtype=torch.int32)
    args = {
        "ball_query_tiles": (big, perm, big[:, :128].contiguous(), lo, 0.1, 4, 128),
        "ball_query_tiles_pos": (big, perm, big[:, :128].contiguous(), lo, 0.1, 4, 128),
        "window_gather": (torch.rand(1, 512, 8), lo, torch.zeros(1, 128, 4, dtype=torch.int32)),
        "knn_tiles": (big, perm, big[:, :128].contiguous(), lo, 3, 128),
        "fps_centroids": (xyz, 8),
        "farthest_point_sample": (xyz, 8),
        "ball_query_window_tiles": (big, big, perm, big[:, :128].contiguous(), lo, lo, 0.1, 4, 128),
        "ball_query": (xyz, xyz, 0.5, 4),
        "knn": (xyz, xyz, 3),
        "three_interpolate": (torch.rand(1, 8, 4), torch.zeros(1, 32, 3, dtype=torch.int32), torch.rand(1, 32, 3)),
        "three_interpolate_grad": (
            torch.rand(1, 32, 4), torch.zeros(1, 32, 3, dtype=torch.int32), torch.rand(1, 32, 3), 8,
        ),
        "fps_remask": (xyz, 8, True),
        "fps_packed": (xyz, 8, 2),
        "knn_argmin": (xyz, xyz, 3),
        "knn_tracked": (xyz, xyz, 3),
        "bq_keys": (xyz, xyz, 0.5, 4, True),
        "bq_fat": (xyz, xyz, 0.5, 4, 128),
        "bq_precut_cond": (torch.rand(1, 1, 3, 128), torch.zeros(1, 1, 1, 128, dtype=torch.int32),
                           torch.rand(1, 1, 128, 3), 512, 0.1, 4, torch.ones((), dtype=torch.int32)),
        "bq_precut_decomp": (torch.rand(1, 1, 3, 128), torch.zeros(1, 1, 1, 128, dtype=torch.int32),
                             torch.rand(1, 1, 128, 3), 512, 0.1, 4),
    }[name]
    before = dict(cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(cuda, name)(*args)
    assert dict(cuda.LAUNCHES) == before


def test_trainer_without_cuda_raises_unless_given_the_cpu(monkeypatch):
    from pointnet2_tpu_torch.config import Config
    from pointnet2_tpu_torch.train import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = Config(num_point=64, batch_size=2, l1_npoint=16, l2_npoint=8, l3_npoint=4, l4_npoint=2,
                   l1_nsample=4, l2_nsample=4, l3_nsample=4, l4_nsample=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(small)
    assert Trainer(small, device="cpu").device.type == "cpu"


def test_the_three_interpolate_backward_on_the_kernel_path_has_no_plain_fallback(monkeypatch):
    """With use_kernel the Function calls the ``pn2`` operators, forward and
    backward; their CUDA implementations are the wrappers, which refuse a CPU
    tensor. (On a CPU tensor the operators' dispatcher runs the plain
    versions, so here each operator is given its CUDA implementation.)"""
    from pointnet2_tpu_torch.ops import library
    from pointnet2_tpu_torch.ops.autograd import ThreeInterpolate
    from pointnet2_tpu_torch.ops.cuda import interpolate

    assert library.CUDA["three_interpolate_grad"] is interpolate.three_interpolate_grad
    for name in ("three_interpolate", "three_interpolate_grad"):
        monkeypatch.setattr(torch.ops.pn2, name, library.CUDA[name])
    args = (torch.rand(1, 8, 4, requires_grad=True), torch.zeros(1, 32, 3, dtype=torch.int32), torch.rand(1, 32, 3))
    with pytest.raises(ValueError, match="CUDA"):
        ThreeInterpolate.apply(*args, True)
    out = ThreeInterpolate.apply(*args, False)
    out.grad_fn.use_kernel = True  # the backward alone on the kernel path
    with pytest.raises(ValueError, match="CUDA"):
        out.sum().backward()


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert run.returncode != 0
    assert '"ok"' not in run.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory with chip_smoke.py and nothing else of the repo, it cannot run."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    run = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)},
    )
    assert run.returncode != 0
    assert '"ok"' not in run.stdout


def test_build_names_its_flags_and_library_by_source_hash():
    from pointnet2_tpu_torch.ops.cuda import build

    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS and "-fmad=false" in build.NVCC_FLAGS
    assert {"fps", "ballquery", "knn", "interpolate", "wingather", "fps_probes", "knn_probes",
            "bq_probes", "gather_probes"} <= set(build.SOURCES)
    paths = {name: build.library_path(name) for name in build.SOURCES}
    assert len(set(paths.values())) == len(build.SOURCES)
    for name, path in paths.items():
        assert (build.CSRC_DIR / f"{name}.cu").exists()
        assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert build.BUILD_DIR == PORT / "build"
