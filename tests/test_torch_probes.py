"""The port's FPS and kNN probe tools against the JAX repo's TPU design probes.

The root ``tools/fps_mask_probe.py``, ``tools/fps_packed_probe.py`` and
``tools/knn_variant_probe.py`` are loaded by file path and their Pallas
kernels run in TPU interpret mode on the CPU, beside the port's plain
versions (``pointnet2_tpu_torch.tools.*_probe``) on the same numpy-seeded
inputs. Tolerances: FPS indices bit for bit with the interpreted kernels and
with ``pointnet2_tpu.ops.reference.farthest_point_sample_np``; kNN indices
bit for bit with the interpreted kernels and ``knn_np``, distances bit for
bit with ``knn_np`` and within atol=1e-6 of the interpreted kernels, whose
CPU lowering rounds the distance sum differently (up to 9.5e-7 on these
clouds; equal on integer clouds). The kernels themselves run on the card
only (``chip_smoke.py``'s probes phase); here their wrappers' arguments are
held against the C signatures they call, and the launch plans checked.
"""

import importlib.util
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pointnet2_tpu.ops import reference
from pointnet2_tpu_torch.ops.cuda import build, probes
from pointnet2_tpu_torch.ops.cuda import fps as cuda_fps
from pointnet2_tpu_torch.tools import fps_mask_probe, fps_packed_probe, knn_variant_probe

ROOT = pathlib.Path(__file__).resolve().parents[1]
DIST_ATOL = 1e-6  # the interpreted kernels' distances against the oracle's


def _load_root(name: str):
    spec = importlib.util.spec_from_file_location(f"root_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def root_tools():
    return {name: _load_root(name) for name in ("fps_mask_probe", "fps_packed_probe", "knn_variant_probe")}


def _cloud(seed: int, b: int, n: int, integer: bool) -> np.ndarray:
    x = np.random.RandomState(seed).rand(b, n, 3) * (4.0 if integer else 10.0)
    return (np.round(x) if integer else x).astype(np.float32)


@pytest.mark.parametrize("integer", [False, True], ids=["random", "integer"])
@pytest.mark.parametrize("remask", [True, False])
def test_fps_remask_matches_the_interpreted_probe_and_the_oracle(root_tools, remask, integer):
    xyz = _cloud(1, 12, 200, integer)
    with pltpu.force_tpu_interpret_mode():
        jax_idx = np.asarray(root_tools["fps_mask_probe"].fps(jnp.asarray(xyz), 40, remask))
    got = fps_mask_probe.fps_remask(torch.from_numpy(xyz), 40, remask)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jax_idx)
    np.testing.assert_array_equal(got.numpy(), reference.farthest_point_sample_np(xyz, 40))


@pytest.mark.parametrize("integer", [False, True], ids=["random", "integer"])
@pytest.mark.parametrize("g", [2, 4])
def test_fps_packed_matches_the_interpreted_probe_and_the_oracle(root_tools, g, integer):
    """B = 12 is not a multiple of G (nor of the TPU's 8 G): the padded clouds write nothing."""
    xyz = _cloud(2, 12, 200, integer)
    with pltpu.force_tpu_interpret_mode():
        jax_idx = np.asarray(root_tools["fps_packed_probe"].fps_packed(jnp.asarray(xyz), 40, g))
    got = fps_packed_probe.fps_packed(torch.from_numpy(xyz), 40, g)
    assert got.shape == (12, 40) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jax_idx)
    np.testing.assert_array_equal(got.numpy(), reference.farthest_point_sample_np(xyz, 40))


@pytest.mark.parametrize("integer", [False, True], ids=["random", "integer"])
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("variant", ["v1", "v3"])
def test_knn_variants_match_the_interpreted_probe_and_the_oracle(root_tools, variant, k, integer):
    refs, queries = _cloud(3, 2, 300, integer), _cloud(4, 2, 260, integer)
    jax_fn = getattr(root_tools["knn_variant_probe"], f"knn_pallas_{variant}")
    with pltpu.force_tpu_interpret_mode():
        jax_dist, jax_idx = (np.asarray(a) for a in jax_fn(jnp.asarray(refs), jnp.asarray(queries), k))
    port = knn_variant_probe.knn_argmin if variant == "v1" else knn_variant_probe.knn_tracked
    dist, idx = port(torch.from_numpy(refs), torch.from_numpy(queries), k)
    want_dist, want_idx = reference.knn_np(refs, queries, k)
    assert dist.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(idx.numpy(), jax_idx)
    np.testing.assert_array_equal(dist.numpy(), want_dist)
    np.testing.assert_allclose(dist.numpy(), jax_dist, rtol=0, atol=DIST_ATOL)


def test_the_knn_plain_versions_run_their_rows_in_parts(monkeypatch):
    """Past ``PLAIN_ROW_BYTES`` the rows go a run of clouds at a time, with the same result."""
    refs, queries = _cloud(5, 5, 70, True), _cloud(6, 5, 90, False)
    whole = [fn(torch.from_numpy(refs), torch.from_numpy(queries), 7)
             for fn in (knn_variant_probe.knn_argmin_plain, knn_variant_probe.knn_tracked_plain)]
    monkeypatch.setattr(knn_variant_probe, "PLAIN_ROW_BYTES", 2 * 90 * 70 * 4)  # two clouds a run
    for fn, (dist, idx) in zip((knn_variant_probe.knn_argmin_plain, knn_variant_probe.knn_tracked_plain), whole):
        d, i = fn(torch.from_numpy(refs), torch.from_numpy(queries), 7)
        assert torch.equal(d, dist) and torch.equal(i, idx)
    want_dist, want_idx = reference.knn_np(refs, queries, 7)
    np.testing.assert_array_equal(whole[0][1].numpy(), want_idx)
    np.testing.assert_array_equal(whole[0][0].numpy(), want_dist)


SMALL = {
    "fps_mask_probe": dict(b=12, n=200, npoint=40, oracle_clouds=12, rounds=3),
    "fps_packed_probe": dict(b=12, n=200, npoint=40, groups=(2, 4, 8), oracle_clouds=12, sweep=(5, 20)),
    "knn_variant_probe": dict(b=3, nq=260, m=300, k=3, oracle_clouds=3),
}
EXACT_LINES = {
    "fps_mask_probe": ["remask=True exact=True", "remask=False exact=True", "masked vs unmasked agree=True"],
    "fps_packed_probe": ["G=2: exact=True", "G=4: exact=True", "G=8: exact=True", "B=5: exact=True",
                         "B=20: exact=True"],
    "knn_variant_probe": ["legacy-v1 index-exact vs oracle: True; distances bit for bit: True",
                          "v3 index-exact vs oracle: True; distances bit for bit: True"],
}
TOOLS = {"fps_mask_probe": fps_mask_probe, "fps_packed_probe": fps_packed_probe,
         "knn_variant_probe": knn_variant_probe}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_probe_tool_runs_small_on_the_cpu(name, capsys):
    summary = TOOLS[name].main(["--device", "cpu"], shapes=SMALL[name])
    lines = capsys.readouterr().out.splitlines()
    for want in EXACT_LINES[name]:
        assert any(line.startswith(want) for line in lines), (want, lines)
    assert lines[-1] == "times: taken on the card only"
    assert "card" not in summary


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_probe_tools_refuse_to_run_without_cuda_unless_given_the_cpu(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TOOLS[name].main([], shapes=SMALL[name])


def test_probe_tool_fails_when_a_variant_misses_the_oracle(monkeypatch):
    real = knn_variant_probe.knn_tracked_plain
    monkeypatch.setattr(knn_variant_probe, "knn_tracked_plain", lambda a, b, k: tuple(t.flip(-1) for t in real(a, b, k)))
    with pytest.raises(AssertionError, match="misses the oracle"):
        knn_variant_probe.main(["--device", "cpu"], shapes=SMALL["knn_variant_probe"])


# --- The wrappers against the C entry points they call ----------------------------------------

C_ENTRY = re.compile(r"^int (pn2_\w+)\(([^)]*)\)", re.MULTILINE)


def _c_params(source: str) -> dict:
    text = (build.CSRC_DIR / f"{source}.cu").read_text()
    return {name: len([p for p in params.split(",") if p.strip()]) for name, params in C_ENTRY.findall(text)}


@pytest.mark.parametrize("call", ["fps_remask", "fps_packed", "knn_argmin", "knn_tracked"])
def test_wrappers_pass_every_argument_of_their_c_entry(monkeypatch, call):
    """The checks pass on a CPU stand-in; what would reach ctypes is caught
    and counted against the C signature (a mismatch shows only on the card)."""
    seen = []
    monkeypatch.setattr(probes, "require", lambda *a, **k: None)
    monkeypatch.setattr(probes, "stream_of", lambda t: (0, 0))
    monkeypatch.setattr(probes, "launch", lambda *a: seen.append(a))
    monkeypatch.setattr(cuda_fps, "_route", lambda xyz, m, rows, what, route: (*xyz.shape[:2], 8, 128, 8))
    monkeypatch.setattr(probes, "packed_device_plan", lambda device, b, n, g: (8, 128, 8))
    xyz = torch.rand(3, 8192, 3)
    args = {"fps_remask": (xyz, 64, True), "fps_packed": (xyz, 64, 2),
            "knn_argmin": (xyz[:, :1024], xyz, 3), "knn_tracked": (xyz[:, :1024], xyz, 32)}[call]
    getattr(probes, call)(*args)
    (kernel, source, symbol, argtypes, *passed), = seen
    assert kernel == call and source in build.SOURCES
    assert len(argtypes) == len(passed) == _c_params(source)[symbol]
    assert f"{symbol}_error_string" in (build.CSRC_DIR / f"{source}.cu").read_text()
    if call == "fps_packed":  # the C entry takes a group's threads: the plan's, not the block's
        assert passed[5:9] == [2, 8, 128, 8]


def test_probe_chain_passes_every_argument_of_its_c_entry(monkeypatch):
    """``probe_chain`` calls ``pn2_fps_probe_chain`` itself (it counts no
    launch): its arguments against the C signature, a group's threads."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    lib = type("Lib", (), {})()
    lib.pn2_fps_probe_chain = entry
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: type("Stream", (), {"cuda_stream": 0})())
    probes.probe_chain(4, 1024, 2, (8, 256, 8))
    probes.probe_chain(3, 1000, 8, (1, 512, 16), device=1)
    assert len(calls[0]) == len(entry.argtypes) == _c_params("fps_probes")["pn2_fps_probe_chain"]
    assert calls[0][:6] == (4, 1024, 2, 8, 128, 0) and calls[1][:6] == (3, 1000, 8, 1, 64, 1)


def test_packed_plan_is_row_6s_plan_over_groups():
    """G = 1 is row 6's candidates, and row 6's own answers stay as they
    were; G clouds a cluster place ceil(B / G) clusters by the fewest waves,
    then the smaller block, then the smaller cluster (row 6: the larger)."""
    for n in (64, 1000, 1024, 4096, 8192, 16384, 65536):
        assert probes.packed_candidates(n, 1) == cuda_fps.candidates(n)
    assert cuda_fps.candidates(8192) == {8: (128, 8), 4: (256, 8), 2: (512, 8), 1: (512, 16)}
    assert cuda_fps.candidates(1000) == {1: (128, 8)}
    assert cuda_fps.plan(64, 8192, {8: 64, 4: 33, 2: 66, 1: 132}) == (8, 128, 8)
    assert cuda_fps.plan(64, 8192, {8: 16, 4: 64, 2: 66, 1: 132}) == (4, 256, 8)  # 64 clusters of 4 in one wave
    # A block keeps >= 1024 points of its cloud, as row 6's; G groups of threads fit one block.
    assert probes.packed_candidates(8192, 8) == {8: (64, 16)}
    assert probes.packed_candidates(8192, 4) == {8: (128, 8), 4: (128, 16)}
    assert probes.packed_candidates(8192, 2) == {8: (128, 8), 4: (256, 8), 2: (256, 16)}
    assert probes.packed_plan(64, 8192, 2, {8: 40, 4: 40, 2: 40}) == (8, 128, 8)  # all fit: blocks of 256
    assert probes.packed_plan(64, 8192, 2, {8: 31, 4: 32, 2: 32}) == (2, 256, 16)  # one wave; then the smaller cluster
    assert probes.packed_plan(64, 8192, 4, {8: 30, 4: 30}) == (4, 128, 16)
    assert probes.packed_plan(12, 1000, 8, {1: 1}) == (1, 64, 16)  # two clusters of one block, two waves
    # Eight 64-thread groups of 16 points hold 1024 points a cloud: at N = 8191 a block of 8 would
    # keep fewer than 1024 points of its cloud, and the slice of 4 does not fit.
    assert probes.packed_candidates(8191, 8) == {} and probes.packed_candidates(8191, 4) == {4: (128, 16)}
    with pytest.raises(ValueError, match="no FPS route"):
        probes.packed_plan(12, 8191, 8, {})
    with pytest.raises(ValueError, match="no FPS route"):
        probes.packed_plan(64, 8192, 8, {8: 0})


@pytest.mark.parametrize("n", [1000, 8192, 16384])
@pytest.mark.parametrize("g", probes.GROUPS)
def test_packed_plan_holds_one_clouds_points_a_thread(g, n):
    """Every route of G clouds at N: threads a group a multiple of 32, G of
    them within row 6's block limit for PPT (at most 1024), PPT <= 16 points
    of one cloud a thread, the group's threads holding the block's slice,
    and >= 1024 points a block past C = 1; the route chosen at B = 64 and at
    B = 12 for given residency answers (all in one wave: the smallest
    block, then the smaller cluster; else the one route in one wave)."""
    shapes = probes.packed_candidates(n, g)
    assert shapes and (n > 1000 or list(shapes) == [1])
    for c, (threads, ppt) in shapes.items():
        assert c in cuda_fps.CLUSTERS and ppt in cuda_fps.PPTS and ppt <= 16
        assert threads % 32 == 0 and 32 <= threads and g * threads <= cuda_fps.max_threads(ppt) <= 1024
        assert threads * ppt >= cuda_fps.slice_points(n, c)
        assert c == 1 or n >= c * cuda_fps.MIN_BLOCK_POINTS
    largest = max(shapes)
    for b in (64, 12):
        clusters = -(-b // g)
        best = min(shapes, key=lambda c: (shapes[c][0], c))
        assert probes.packed_plan(b, n, g, {c: clusters for c in shapes}) == (best, *shapes[best])
        one_wave = {c: clusters - 1 for c in shapes} | {largest: clusters}  # the rest take two
        assert probes.packed_plan(b, n, g, one_wave)[0] == largest


def test_routes_line_times_every_route_and_puts_the_plan_back(monkeypatch):
    """``fps_packed_probe.routes_line`` at N = 8192, G = 2: each route of
    ``packed_candidates`` launched with the plan answering it (a stub
    launch records the route and gives row 6's indices, a stub device time
    grows with the cluster), and ``probes.packed_device_plan`` put back."""
    from pointnet2_tpu_torch.ops import cuda

    planned = lambda device, b, n, g: (8, 128, 8)
    monkeypatch.setattr(probes, "packed_device_plan", planned)
    monkeypatch.setattr(probes, "require", lambda *a, **k: None)
    xyz, base, seen = torch.rand(4, 8192, 3), torch.zeros(4, 16, dtype=torch.int32), []

    def fps_packed(x, npoint, g):
        seen.append(probes.packed_route(x, npoint, g))
        return base

    monkeypatch.setattr(cuda, "fps_packed", fps_packed)
    monkeypatch.setattr(fps_packed_probe, "device_ms", lambda run, kernel: run() is base and seen[-1][0] / 10)
    got = fps_packed_probe.routes_line(xyz, 16, 2, base, "card")
    assert probes.packed_device_plan is planned
    assert got == {"(8, 256, 8)": 0.8, "(4, 512, 8)": 0.4, "(2, 512, 16)": 0.2}
    assert seen == [(8, 256, 8)] * 2 + [(4, 512, 8)] * 2 + [(2, 512, 16)] * 2
    monkeypatch.setattr(cuda, "fps_packed", lambda x, npoint, g: base + 1)
    with pytest.raises(AssertionError, match="misses row 6"):
        fps_packed_probe.routes_line(xyz, 16, 2, base, "card")
    assert probes.packed_device_plan is planned


# (B, M, Nq, k, chunk slots, warps): FP4's 3-NN, SA kNN grouping, the last
# M that leaves room for three blocks an SM and the first that does not, the
# old row's limit of 14528 references and one past it, a cloud staged whole
# to the last of 18 chunks, the ring past that (4 slots, any M), M = k = 16.
KNN_PLAN_CASES = ((64, 1024, 8192, 3, 1, 8), (16, 8192, 1024, 32, 8, 16), (1, 6144, 8, 3, 6, 8),
                  (1, 6145, 8, 3, 7, 16), (1, 14528, 8, 32, 15, 16), (1, 14529, 8, 32, 15, 16),
                  (2, 18432, 8, 32, 18, 16), (4, 20000, 1024, 32, 4, 8), (1, 10**7, 8, 32, 4, 8),
                  (1, 16, 700, 16, 1, 8))


@pytest.mark.parametrize("b, m, nq, k, slots, warps", KNN_PLAN_CASES)
def test_knn_probe_limits(monkeypatch, b, m, nq, k, slots, warps):
    """The plan takes any M (the cloud staged whole up to 18 chunks of 1024
    references, else through a ring of 4), its shared bytes within a block's
    232448, and 16 warps a block where at most two blocks fit an SM, else 8;
    it raises on k > 32, k > M, B > 65535 or an empty input, and so does the
    wrapper before any launch."""
    assert probes.knn_plan(b, m, nq, k) == (warps, slots * (12 * 1024 + 8))
    assert slots * (12 * 1024 + 8) <= 232448
    for bad in ((b, m, nq, 33), (b, k - 1, nq, k), (65536, m, nq, k), (0, m, nq, k), (b, m, 0, k), (b, m, nq, 0)):
        with pytest.raises(ValueError, match="kNN probe kernels need"):
            probes.knn_plan(*bad)
    monkeypatch.setattr(probes, "require", lambda *a, **k: None)
    monkeypatch.setattr(probes, "launch", lambda *a: pytest.fail("launched"))
    for call in (probes.knn_argmin, probes.knn_tracked):
        with pytest.raises(ValueError, match="k <= min"):
            call(torch.rand(1, 64, 3), torch.rand(1, 8, 3), 33)
        with pytest.raises(ValueError, match="k <= min"):
            call(torch.rand(1, 16, 3), torch.rand(1, 8, 3), 17)


@pytest.mark.parametrize("g", [1, 3, 16])
def test_fps_packed_takes_only_its_instantiated_groups(monkeypatch, g):
    """The packed kernel is built for G = 2, 4, 8; one cloud a cluster is the
    re-masking kernel's no-remask case. Another G raises before any launch."""
    monkeypatch.setattr(probes, "require", lambda *a, **k: None)
    monkeypatch.setattr(probes, "launch", lambda *a: pytest.fail("launched"))
    assert probes.GROUPS == (2, 4, 8)
    with pytest.raises(ValueError, match=r"takes \(2, 4, 8\) clouds a cluster"):
        probes.fps_packed(torch.rand(3, 1024, 3), 64, g)
