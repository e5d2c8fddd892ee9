"""The port's op surface against the JAX package's, on the CPU.

The index-only FPS, the round-1 windowed ball query and the tail ops
(``prob_sample``, ``selection_sort``, ``select_top_k``) of
``pointnet2_tpu_torch.ops`` on their plain versions, held against the JAX
package's functions (the Pallas wrappers in interpret mode, under
``pltpu.force_tpu_interpret_mode()`` as ``tests/test_ops_pallas.py`` runs
them) and against the NumPy oracles, on the same numpy inputs; the port's
copy of the oracles against the JAX package's; and the three tools in their
CPU mode.

Tolerances: every output here is an index, a count or a value moved without
arithmetic, so all are held equal bit for bit; ``interpolation_weights_np``
and ``three_interpolate_np`` of the two oracle modules too (the same numpy
code on the same inputs).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import pointnet2_tpu.ops as jax_ops
from pointnet2_tpu.ops import core as jax_core
from pointnet2_tpu.ops import reference as jax_reference
from pointnet2_tpu.ops.pallas import ball_query_windowed as jax_ball_query_windowed
from pointnet2_tpu.ops.pallas import farthest_point_sample_pallas
from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.ops import core, reference
from pointnet2_tpu_torch.tools import op_bench, parity, stage_bench

T = torch.from_numpy


def _cloud(rng, b, n, scale=2.0):
    return (rng.rand(b, n, 3) * scale).astype(np.float32)


def _box(seed, b, n, scale=(8.0, 1.0, 1.0)):
    """Long in x, so that tiles of x-sorted queries fit their windows."""
    return (np.random.RandomState(seed).rand(b, n, 3) * scale).astype(np.float32)


# -- index-only FPS ---------------------------------------------------------------


@pytest.mark.parametrize("b,n,m", [(2, 256, 64), (1, 100, 30), (3, 64, 64)])
def test_farthest_point_sample_matches_pallas_and_oracle(rng, b, n, m):
    xyz = _cloud(rng, b, n)
    got = ops.farthest_point_sample(T(xyz), m, impl="torch")
    assert got.dtype == torch.int32 and got.shape == (b, m)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(farthest_point_sample_pallas(xyz, m))
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), reference.farthest_point_sample_np(xyz, m))
    # impl=None on a CPU tensor is the plain version; the fused op gives the same indices.
    assert torch.equal(ops.farthest_point_sample(T(xyz), m), got)
    assert torch.equal(ops.fps_centroids(T(xyz), m)[0], got)


# -- the round-1 windowed ball query ----------------------------------------------


# (b, n, m, radius, nsample, window, cloud); cloud "unit" is tests/test_ops_pallas.py's.
WINDOWED_CASES = [
    (2, 1024, 128, 0.1, 8, 256, "unit"),  # test_ops_pallas.py:105-130: windows fit
    (1, 512, 128, 0.9, 4, 128, "unit"),  # tight window, may or may not fit
    (2, 512, 256, 0.05, 16, 128, "unit"),  # tiny balls
    (1, 512, 128, 0.3, 8, 128, "flat"),  # every x equal: the too-dense fallback
    (2, 4096, 1024, 0.1, 8, None, "box"),  # the default window, 1024 columns: tiles fit
    (1, 512, 64, 0.2, 8, None, "box"),  # M < 128: one tile of 64 queries, window 128
    (2, 1000, 256, 0.05, 8, 256, "box"),  # N off the 128-multiples
    (1, 100, 37, 0.5, 4, None, "box"),  # static fallback: M off the tile, window covers N
    (2, 2048, 512, 0.2, 40, 512, "band"),  # nsample past 32, some tiles fit, some do not
]


def _windowed_inputs(seed, b, n, m, cloud):
    rng = np.random.RandomState(seed)
    if cloud == "unit":
        return _cloud(rng, b, n, scale=1.0), _cloud(rng, b, m, scale=1.0)
    xyz1 = _box(seed, b, n)
    if cloud == "flat":
        xyz1 = _cloud(rng, b, n, scale=1.0)
        xyz1[:, :, 0] = 0.5
        return xyz1, np.ascontiguousarray(xyz1[:, :m])
    if cloud == "band":
        xyz1[:, : n // 2, 0] = 4.0 + 0.01 * xyz1[:, : n // 2, 0]
    return xyz1, np.ascontiguousarray(xyz1[:, rng.choice(n, m, replace=False)])


@pytest.mark.parametrize("b,n,m,radius,nsample,window,cloud", WINDOWED_CASES)
def test_ball_query_windowed_matches_pallas_and_oracle(b, n, m, radius, nsample, window, cloud):
    xyz1, xyz2 = _windowed_inputs(40, b, n, m, cloud)
    got_idx, got_cnt = core.ball_query_windowed(T(xyz1), T(xyz2), radius, nsample, window)
    with pltpu.force_tpu_interpret_mode():
        want_idx, want_cnt = jax_ball_query_windowed(xyz1, xyz2, radius, nsample, window)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    ref_idx, ref_cnt = reference.ball_query_np(xyz1, xyz2, radius, nsample)
    np.testing.assert_array_equal(got_idx.numpy(), ref_idx)
    np.testing.assert_array_equal(got_cnt.numpy(), ref_cnt)
    if window is None:  # the public op takes the default window
        idx, cnt = ops.ball_query(T(xyz1), T(xyz2), radius, nsample, impl="windowed")
        assert torch.equal(idx, got_idx) and torch.equal(cnt, got_cnt)


def test_windowed_tiles_fall_back_one_by_one():
    """In one call some tiles fit their window and some do not; each of the
    plain kernel's two branches gives the exact ball query on its own."""
    xyz1, xyz2 = _windowed_inputs(41, 2, 2048, 512, "band")
    x1, x2 = T(xyz1), T(xyz2)
    w = 512
    perm, xs, qperm, qs, lo, hi = core.ball_query_window_bounds(x1, x2, 0.2, w)
    fits = (hi - lo) <= w
    assert bool(fits.any()) and not bool(fits.all())
    idx_s, cnt_s = core.ball_query_window_tiles(x1, xs, perm, qs, lo, hi, 0.2, 8, w)
    want_idx, want_cnt = core.ball_query(x1, qs, 0.2, 8)
    assert torch.equal(idx_s, want_idx) and torch.equal(cnt_s, want_cnt)
    # The fitting tiles' window alone already holds the exact answer.
    win_idx, _ = core.ball_query_tiles(xs, perm, qs, lo, 0.2, 8, w)
    q_fits = fits[:, :, None].expand(-1, -1, 128).reshape(2, 512)
    assert torch.equal(win_idx[q_fits], want_idx[q_fits])
    assert not torch.equal(win_idx[~q_fits], want_idx[~q_fits])


def test_ball_query_impl_values_and_errors():
    xyz = T(_box(42, 1, 512))
    q = xyz[:, :128].contiguous()
    want = ops.ball_query(xyz, q, 0.2, 8, impl="torch")
    for impl in (None, "windowed"):
        got = ops.ball_query(xyz, q, 0.2, 8, impl=impl)
        assert all(torch.equal(g, h) for g, h in zip(got, want))
    with pytest.raises(ValueError, match="unknown impl"):
        ops.ball_query(xyz, q, 0.2, 8, impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        ops.ball_query(xyz, q, 0.2, 8, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.farthest_point_sample(xyz, 8, impl="cuda")


# -- tail ops ---------------------------------------------------------------------


@pytest.mark.parametrize("b,n,m", [(2, 50, 17), (1, 8, 64)])
def test_prob_sample_matches_jax_and_oracle(rng, b, n, m):
    weights = rng.rand(b, n).astype(np.float32)
    weights[:, ::5] = 0.0  # empty bins: runs of equal cdf values
    cdf = np.cumsum(weights, axis=-1).astype(np.float32)
    uniforms = rng.rand(b, m).astype(np.float32)
    uniforms[:, 0] = 0.0
    uniforms[:, 1] = np.float32(1.0) - np.finfo(np.float32).eps  # the last bin, at the clamp
    got = ops.prob_sample(T(cdf), T(uniforms))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_core.prob_sample(cdf, uniforms)))
    np.testing.assert_array_equal(got.numpy(), reference.prob_sample_np(cdf, uniforms))


@pytest.mark.parametrize("k", [1, 3, 7, 12, 20])
@pytest.mark.parametrize("ties", [False, True])
def test_selection_sort_full_rows_match_jax_and_oracle(rng, k, ties):
    """All N positions: the sorted prefix and the swap-order tail; ties keep
    the first occurrence (values drawn from 0..3 make many)."""
    shape = (2, 3, 12)
    dist = (rng.randint(0, 4, shape) if ties else rng.rand(*shape)).astype(np.float32)
    got_idx, got_dist = ops.selection_sort(T(dist), k)
    assert got_idx.dtype == torch.int32 and got_idx.shape == shape
    jax_idx, jax_dist = jax_core.selection_sort(jnp.asarray(dist), k)
    want_idx, want_dist = reference.selection_sort_np(dist, k)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(jax_idx))
    np.testing.assert_array_equal(got_dist.numpy(), np.asarray(jax_dist))
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    np.testing.assert_array_equal(got_dist.numpy(), want_dist)
    top_idx, top_dist = ops.select_top_k(k, T(dist))
    jax_top_idx, jax_top_dist = jax_core.select_top_k(k, jnp.asarray(dist))
    np.testing.assert_array_equal(top_idx.numpy(), np.asarray(jax_top_idx))
    np.testing.assert_array_equal(top_dist.numpy(), np.asarray(jax_top_dist))


def test_the_op_surface_covers_the_jax_package():
    assert set(jax_ops.__all__) <= set(ops.__all__)
    for name in ops.__all__:
        assert callable(getattr(ops, name)), name


# -- the oracle copy --------------------------------------------------------------


def _oracle_args(name, rng):
    xyz1 = _cloud(rng, 2, 40)
    xyz2 = _cloud(rng, 2, 12)
    idx2 = rng.randint(0, 40, (2, 12)).astype(np.int32)
    return {
        "farthest_point_sample_np": (xyz1, 10),
        "gather_points_np": (rng.rand(2, 40, 5).astype(np.float32), idx2),
        "prob_sample_np": (np.cumsum(rng.rand(2, 40), axis=-1).astype(np.float32), rng.rand(2, 9)),
        "ball_query_np": (xyz1, xyz2, 0.6, 5),
        "group_points_np": (rng.rand(2, 40, 5).astype(np.float32), rng.randint(0, 40, (2, 12, 4))),
        "knn_np": (xyz1, xyz2, 4),
        "selection_sort_np": (rng.randint(0, 3, (2, 3, 9)).astype(np.float32), 4),
        "three_nn_np": (xyz2, xyz1),
        "three_interpolate_np": (
            rng.rand(2, 40, 5).astype(np.float32), rng.randint(0, 40, (2, 12, 3)),
            rng.rand(2, 12, 3).astype(np.float32),
        ),
        "interpolation_weights_np": (rng.rand(2, 12, 3).astype(np.float32) * 1e-9,),
        "densify_labels_np": (xyz1[0], rng.randint(0, 9, 40), xyz2[0], 3),
    }[name]


ORACLES = sorted(name for name in dir(jax_reference) if name.endswith("_np"))


@pytest.mark.parametrize("name", ORACLES)
def test_the_oracle_copy_gives_the_jax_oracles_outputs(name):
    args = _oracle_args(name, np.random.RandomState(43))
    got = getattr(reference, name)(*args)
    want = getattr(jax_reference, name)(*args)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_the_oracle_copy_has_every_oracle():
    assert ORACLES == sorted(name for name in dir(reference) if name.endswith("_np"))
    assert len(ORACLES) == 11


# -- the tools --------------------------------------------------------------------


def test_parity_sweep_passes_on_the_cpu(capsys):
    assert parity.main(["--device", "cpu", "--small"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    assert summary["failures"] == [] and summary["checks"] == len(lines) - 1 == 35
    names = [line.split(None, 1)[1] for line in lines[:-1]]
    assert all(line.startswith("PASS") for line in lines[:-1])
    for prefix in ("fps n=", "fps_centroids n=", "ball_query n=", "ball_query_windowed n=",
                   "ball_query_sliced n=", "project_group_sliced n=", "three_nn n", "three_nn_sliced n",
                   "knn k=8", "three_interpolate n=", "three_interpolate_bwd n=", "ball_query nonmultiple",
                   "knn nonmultiple", "ball_query_windowed clustered", "ball_query_windowed nsample=64",
                   "knn k=32", "three_interpolate skip=3"):
        assert any(name.startswith(prefix) for name in names), prefix


def test_parity_sweep_counts_a_failure(monkeypatch, capsys):
    """A kernel that disagrees with its oracle fails its check and the exit code."""
    real = ops.farthest_point_sample
    monkeypatch.setattr(ops, "farthest_point_sample", lambda xyz, m, impl=None: real(xyz, m).flip(-1))
    assert parity.main(["--device", "cpu", "--small"]) == 1
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["failures"] == ["fps n=1024 m=256", "fps n=256 m=64", "fps n=100 m=30"]


@pytest.mark.parametrize("tool", [parity, op_bench, stage_bench])
def test_tools_refuse_to_run_without_cuda_unless_given_the_cpu(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main([])


def test_op_bench_on_the_cpu_measures_nothing(capsys):
    assert op_bench.main(["--device", "cpu", "--small"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert {row["op"] for row in rows} == {
        "farthest_point_sample", "fps_centroids", "ball_query", "ball_query_sliced", "ball_query_sliced_pos",
        "window_gather", "ball_query_windowed", "three_nn", "knn_sliced", "knn", "three_interpolate_concat",
        "three_interpolate_grad",
    }
    for row in rows:
        assert row["kernel_ms"] is None and row["plain_ms"] is None and row["library_ms"] is None
        assert row["bound_by"] in ("bytes", "operations") and row["bound_ms"] > 0


def test_kernel_probe_refuses_to_run_without_a_card(monkeypatch):
    from pointnet2_tpu_torch.tools import kernel_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        kernel_probe.main(["tree"])
    # Its per-kernel lines name kernels as the profiler prints them.
    for key, name in (
        ("(anonymous namespace)::three_interpolate_grad_zero_kernel(int*, int)", "three_interpolate_grad_zero_kernel"),
        ("void (anonymous namespace)::three_interpolate_grad_sum_kernel<true>(float const*, long long)",
         "three_interpolate_grad_sum_kernel"),
        ("void pn2_window::ball_query_tiles_kernel<false, true>(float const*, int const*)", "ball_query_tiles_kernel"),
    ):
        assert kernel_probe.kernel_name(key) == name


def test_stage_bench_on_the_cpu_measures_nothing(capsys):
    assert stage_bench.main(["--device", "cpu", "--small"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [row["stage"] for row in rows] == ["sa_sample_group"] * 4 + ["group"] + ["fp_interpolate"] * 2
    assert all(row["ms"] is None for row in rows)


def test_stage_bench_composites_match_the_reference(rng):
    """The SA composite through the index-only FPS, with either ball query,
    equals the oracles' composition."""
    x = rng.rand(2, 256, 3 + 4).astype(np.float32)
    xyz = np.ascontiguousarray(x[..., :3])
    for impl in (None, "windowed"):
        g_xyz, g_feat = stage_bench.sample_and_group(T(x), 64, 0.3, 8, impl)
        fps = reference.farthest_point_sample_np(xyz, 64)
        new_xyz = reference.gather_points_np(xyz, fps)
        idx, _ = reference.ball_query_np(xyz, new_xyz, 0.3, 8)
        np.testing.assert_array_equal(g_feat.numpy(), reference.group_points_np(x[..., 3:], idx))
        np.testing.assert_array_equal(
            g_xyz.numpy(), reference.group_points_np(xyz, idx) - new_xyz[:, :, None, :]
        )
