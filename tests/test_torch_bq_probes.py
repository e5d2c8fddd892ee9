"""The port's ball-query probe tools against the JAX repo's TPU design probes.

The root ``tools/bq_i16_probe.py``, ``tools/bq_fat_probe.py``,
``tools/bq_cond_probe.py`` and ``tools/bq_sliced_decomp_probe.py`` are loaded
by file path and their Pallas kernels run in TPU interpret mode on the CPU,
beside the port's plain versions (``pointnet2_tpu_torch.tools.bq_*_probe``)
on the same numpy-seeded inputs. ``bq_sliced_decomp_probe``'s kernel call is
local to its ``main``, so the test builds the same ``pallas_call`` from
``ballquery._ball_query_sliced_kernel`` with its BlockSpecs. Tolerance: bit
for bit everywhere (indices and counts are integers), with the interpreted
kernels, with ``pointnet2_tpu.ops.reference.ball_query_np`` where the
function is row 2's (the exact ball query: every ``bq_keys`` and ``bq_fat``
case, and the pre-cut pipelines where their windows fit), and, where the
windows do not fit, with the interpreted probe alone. The kernels themselves run on the card only
(``chip_smoke.py``'s probes phase and ``tests/test_torch_cuda.py``); here
their wrappers' arguments are held against the C signatures they call, and
their limits checked.
"""

import functools
import importlib.util
import os
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pointnet2_tpu.ops import reference
from pointnet2_tpu.ops.pallas import ballquery as jax_bq
from pointnet2_tpu_torch.ops.cuda import bq_probes, build
from pointnet2_tpu_torch.tools import bq_cond_probe, bq_fat_probe, bq_i16_probe, bq_sliced_decomp_probe

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = ("bq_i16_probe", "bq_fat_probe", "bq_cond_probe", "bq_sliced_decomp_probe")


@pytest.fixture(scope="module")
def root_tools():
    """The four root tools, loaded by path. ``bq_fat_probe`` appends a flag to
    ``LIBTPU_INIT_ARGS`` when it is imported: the variable is put back as it was."""
    out = {}
    before = os.environ.get("LIBTPU_INIT_ARGS")
    try:
        for name in NAMES:
            spec = importlib.util.spec_from_file_location(f"root_{name}", ROOT / "tools" / f"{name}.py")
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            out[name] = module
    finally:
        if before is None:
            os.environ.pop("LIBTPU_INIT_ARGS", None)
        else:
            os.environ["LIBTPU_INIT_ARGS"] = before
    return out


def test_loading_the_root_tools_leaves_libtpu_init_args_as_it_was(root_tools):
    assert "xla_tpu_scoped_vmem_limit_kib" not in os.environ.get("LIBTPU_INIT_ARGS", "")


def _clouds(seed: int, b: int, n: int, m: int, integer: bool) -> tuple[np.ndarray, np.ndarray]:
    """A cloud and queries: uniform in the unit cube, or integers 0..4 (ties
    in x and balls whose edge falls on lattice points)."""
    rng = np.random.RandomState(seed)
    if integer:
        return (np.round(rng.rand(b, n, 3) * 4).astype(np.float32),
                np.round(rng.rand(b, m, 3) * 4).astype(np.float32))
    return rng.rand(b, n, 3).astype(np.float32), rng.rand(b, m, 3).astype(np.float32)


RADIUS = {False: 0.2, True: 1.0}  # r = 1 on the lattice: the points at distance 1 are out (strict <)


def _np(pair) -> tuple:
    return tuple(np.asarray(a) for a in pair)


def _assert_pairs(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


# --- bq_i16_probe: int16 / int32 keys -------------------------------------------------------------


@pytest.mark.parametrize("integer", [False, True], ids=["random", "integer"])
@pytest.mark.parametrize("use_i16", [False, True], ids=["i32", "i16"])
@pytest.mark.parametrize("n, m, ns", [(500, 256, 16), (300, 200, 8)])
def test_bq_keys_matches_the_interpreted_probe_and_the_oracle(root_tools, use_i16, integer, n, m, ns):
    """N = 300 / 500: the padded lanes past N; M = 200: a partial query tile."""
    xyz1, xyz2 = _clouds(10 + n, 2, n, m, integer)
    r = RADIUS[integer]
    with pltpu.force_tpu_interpret_mode():
        want_jax = _np(root_tools["bq_i16_probe"].bq(jnp.asarray(xyz1), jnp.asarray(xyz2), r, ns, use_i16))
    got = bq_i16_probe.bq_keys(torch.from_numpy(xyz1), torch.from_numpy(xyz2), r, ns, use_i16)
    _assert_pairs(got, want_jax)
    _assert_pairs(got, reference.ball_query_np(xyz1, xyz2, r, ns))


# --- bq_fat_probe: query tiles of 128 / 256 sharing chunk-built keys ------------------------------


@pytest.mark.parametrize("integer", [False, True], ids=["random", "integer"])
@pytest.mark.parametrize("tm", [128, 256])
@pytest.mark.parametrize("n, m, ns", [(500, 256, 16), (300, 200, 8)])
def test_bq_fat_matches_the_interpreted_probe_and_the_oracle(root_tools, tm, integer, n, m, ns):
    xyz1, xyz2 = _clouds(20 + n, 2, n, m, integer)
    r = RADIUS[integer]
    with pltpu.force_tpu_interpret_mode():
        want_jax = _np(root_tools["bq_fat_probe"].bq_fat(jnp.asarray(xyz1), jnp.asarray(xyz2), r, ns, tm))
    got = bq_fat_probe.bq_fat(torch.from_numpy(xyz1), torch.from_numpy(xyz2), r, ns, tm)
    _assert_pairs(got, want_jax)
    _assert_pairs(got, reference.ball_query_np(xyz1, xyz2, r, ns))


# --- bq_cond_probe: row 7 on cut windows, with and without the guard ------------------------------

# (label, N, M, window, radius): "fits" holds every tile's candidates in its
# window (at the limit, max(hi - lo) = W, as the probe's own shape does);
# "partly" half the tiles', "does not fit" none (the guarded outputs are
# zeros where not all fit).
SLICED_CASES = [("fits", 1024, 512, 512, 0.05), ("partly", 1024, 512, 384, 0.05), ("does not fit", 600, 256, 256, 0.1)]


def _sliced_clouds(n: int, m: int, integer: bool, seed: int = 0):
    """The JAX tools' queries: every (N // M)-th point of the cloud, in tiles of 128."""
    xyz1 = np.random.RandomState(seed).rand(2, n, 3).astype(np.float32)
    if integer:
        xyz1 = np.round(xyz1 * 16).astype(np.float32) / 16  # ties in x, exact in float32
    return xyz1, np.ascontiguousarray(xyz1[:, :: n // m][:, :m])


@pytest.mark.parametrize("integer", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("label, n, m, w, r", SLICED_CASES, ids=[c[0] for c in SLICED_CASES])
def test_precut_pipelines_match_the_interpreted_probe(root_tools, label, n, m, w, r, integer):
    xyz1, xyz2 = _sliced_clouds(n, m, integer)
    ns = 8
    a, b = torch.from_numpy(xyz1), torch.from_numpy(xyz2)
    fits = bool(bq_cond_probe.fits_of(bq_cond_probe.precut_plan(a, b, r, w), w))
    assert fits == (label == "fits")
    probe = root_tools["bq_cond_probe"]
    with pltpu.force_tpu_interpret_mode():
        nocond = _np(probe.make_nocond()(jnp.asarray(xyz1), jnp.asarray(xyz2), r, ns, w))
        dummy = _np(probe.make_dummycond()(jnp.asarray(xyz1), jnp.asarray(xyz2), r, ns, w))
    got_nocond = bq_cond_probe.nocond(a, b, r, ns, w)
    got_dummy = bq_cond_probe.dummycond(a, b, r, ns, w)
    _assert_pairs(got_nocond, nocond)
    _assert_pairs(got_dummy, dummy)
    if fits:
        want = reference.ball_query_np(xyz1, xyz2, r, ns)
        _assert_pairs(got_nocond, want)
        _assert_pairs(got_dummy, want)
    else:
        assert not any(bool(x.any()) for x in got_dummy)
        # The windows miss candidates: the outputs are not the exact ball query.
        assert not np.array_equal(got_nocond[1].numpy(), reference.ball_query_np(xyz1, xyz2, r, ns)[1])


# --- bq_sliced_decomp_probe: the same kernel, timed apart; its pallas_call built here -------------


def _decomp_kernel(win, permw, q_tiles, n: int, r: float, ns: int):
    """``bq_sliced_decomp_probe.py``'s ``kernel_only`` (:67-89), with its BlockSpecs."""
    b, t, _, w = win.shape
    tm = q_tiles.shape[2]
    kernel = functools.partial(jax_bq._ball_query_sliced_kernel, n=n, radius=float(r), nsample=ns)
    return pl.pallas_call(
        kernel,
        grid=(b, t),
        in_specs=[
            pl.BlockSpec((1, 1, 3, w), lambda i, j: (i, j, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1, 1, w), lambda i, j: (i, j, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1, tm, 3), lambda i, j: (i, j, 0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=(
            pl.BlockSpec((1, 1, tm, ns), lambda i, j: (i, j, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1, 1, tm), lambda i, j: (i, j, 0, 0), memory_space=pltpu.VMEM),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((b, t, tm, ns), jnp.int32),
            jax.ShapeDtypeStruct((b, t, 1, tm), jnp.int32),
        ),
        scratch_shapes=[pltpu.VMEM((tm, 128), jnp.int32)],
    )(win, permw, q_tiles)


def _decomp_pipeline(xyz1, xyz2, r: float, w: int, tm: int = 128):
    """``bq_sliced_decomp_probe.py:41-58``: the window starts and the cut windows, in JAX."""
    b, n, _ = xyz1.shape
    t = xyz2.shape[1] // tm
    perm = jnp.argsort(xyz1[..., 0], axis=1)
    xs = jnp.take_along_axis(xyz1, perm[..., None], axis=1)
    qperm = jnp.argsort(xyz2[..., 0], axis=1)
    q_tiles = jnp.take_along_axis(xyz2, qperm[..., None], axis=1).reshape(b, t, tm, 3)
    lo = jax.vmap(jnp.searchsorted)(xs[..., 0], q_tiles[..., 0].min(axis=-1) - r).astype(jnp.int32)
    lo_aligned = (jnp.clip(lo, 0, n - w) // 128) * 128
    cut = jax.vmap(jax.vmap(lambda arr, s: jax.lax.dynamic_slice(arr, (0, s), (arr.shape[0], w)),
                            in_axes=(None, 0)), in_axes=(0, 0))
    xs_t = jnp.transpose(xs, (0, 2, 1))
    return lo_aligned, cut(xs_t, lo_aligned), cut(perm.astype(jnp.int32)[:, None, :], lo_aligned), q_tiles


@pytest.mark.parametrize("integer", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("label, n, m, w, r", SLICED_CASES, ids=[c[0] for c in SLICED_CASES])
def test_precut_kernel_matches_the_decomp_probes_kernel_and_row_7(label, n, m, w, r, integer):
    """The port's pipeline (sorts, window starts, cut) equals the JAX tool's,
    and the plain kernel on its windows equals the interpreted one and row 7
    in place at the same starts, whether the windows fit or not."""
    xyz1, xyz2 = _sliced_clouds(n, m, integer, seed=1)
    ns = 8
    plan = bq_cond_probe.precut_plan(torch.from_numpy(xyz1), torch.from_numpy(xyz2), r, w)
    lo, win, permw, q_tiles = _decomp_pipeline(jnp.asarray(xyz1), jnp.asarray(xyz2), r, w)
    np.testing.assert_array_equal(plan["lo"].numpy(), np.asarray(lo))
    np.testing.assert_array_equal(plan["win"].numpy(), np.asarray(win))
    np.testing.assert_array_equal(plan["permw"].numpy(), np.asarray(permw))
    np.testing.assert_array_equal(plan["q_tiles"].numpy(), np.asarray(q_tiles))
    with pltpu.force_tpu_interpret_mode():
        want = _np(_decomp_kernel(win, permw, q_tiles, n, r, ns))
    got = bq_sliced_decomp_probe.kernel_only(plan, n, r, ns)
    _assert_pairs(got, want)
    row7 = bq_sliced_decomp_probe.in_place(plan, r, ns, w)
    _assert_pairs((got[0].reshape(2, m, ns), got[1].reshape(2, m)), tuple(x.numpy() for x in row7))


def test_precut_plain_drops_columns_whose_index_is_not_below_n():
    """The TPU kernel's ``keys_orig < n``: such a column is never in the ball."""
    xyz1, xyz2 = _sliced_clouds(600, 256, False)
    plan = bq_cond_probe.precut_plan(torch.from_numpy(xyz1), torch.from_numpy(xyz2), 0.1, 384)
    idx, cnt = bq_cond_probe.precut_plain(plan["win"], plan["permw"], plan["q_tiles"], 600, 0.1, 16)
    assert int(cnt.sum()) > 0
    none, zero = bq_cond_probe.precut_plain(plan["win"], plan["permw"], plan["q_tiles"], 0, 0.1, 16)
    assert not bool(zero.any()) and not bool(none.any())


def test_precut_plan_refuses_a_window_past_the_cloud_or_partial_tiles():
    a, b = torch.rand(1, 300, 3), torch.rand(1, 256, 3)
    with pytest.raises(ValueError, match="window"):
        bq_cond_probe.precut_plan(a, b, 0.1, 301)
    with pytest.raises(ValueError, match="tiles of 128"):
        bq_cond_probe.precut_plan(a, b[:, :200], 0.1, 256)


# --- The tools ------------------------------------------------------------------------------------

SMALL = {
    "bq_i16_probe": dict(b=3, n=500, m=256, nsample=16, radius=0.15, oracle_clouds=3, rounds=1),
    "bq_fat_probe": dict(b=3, n=500, m=256, nsample=16, radius=0.15, oracle_clouds=3, rounds=1),
    "bq_cond_probe": dict(b=2, n=1024, m=512, nsample=16, radius=0.05, window=512, oracle_clouds=2, rounds=1),
    "bq_sliced_decomp_probe": dict(b=2, n=1024, m=256, nsample=16, radius=0.1, window=256, rounds=1),
}
EXACT_LINES = {
    "bq_i16_probe": ["i32: exact vs row 2=True; vs the oracle on 3 clouds=True",
                     "i16: exact vs row 2=True; vs the oracle on 3 clouds=True", "i16 vs i32 agree=True"],
    "bq_fat_probe": ["tm=128: exact vs row 2=True; vs the oracle on 3 clouds=True",
                     "tm=256: exact vs row 2=True; vs the oracle on 3 clouds=True"],
    "bq_cond_probe": ["W=512: the windows fit (max(hi - lo) <= W)=True",
                      "no-cond: exact vs row 2=True; vs the oracle on 2 clouds=True",
                      "dummy-cond: exact vs row 2=True; vs the oracle on 2 clouds=True",
                      "with-cond: exact vs row 2=True; vs the oracle on 2 clouds=True"],
    "bq_sliced_decomp_probe": ["W=256: the windows fit=False",
                               "kernel on cut windows vs row 7 in place at the same starts: equal=True"],
}
TOOLS = {"bq_i16_probe": bq_i16_probe, "bq_fat_probe": bq_fat_probe, "bq_cond_probe": bq_cond_probe,
         "bq_sliced_decomp_probe": bq_sliced_decomp_probe}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_bq_probe_tool_runs_small_on_the_cpu(name, capsys):
    summary = TOOLS[name].main(["--device", "cpu"], shapes=SMALL[name])
    lines = capsys.readouterr().out.splitlines()
    for want in EXACT_LINES[name]:
        assert any(line.startswith(want) for line in lines), (want, lines)
    assert lines[-1] == "times: taken on the card only"
    assert "card" not in summary


def test_bq_cond_probe_takes_the_dummy_branch_where_the_windows_do_not_fit(capsys):
    shapes = {**SMALL["bq_cond_probe"], "window": 384}
    summary = bq_cond_probe.main(["--device", "cpu"], shapes=shapes)
    assert summary["fits"] is False and summary["exact"]["dummy-cond"] == {"zeros": True}
    assert "dummy-cond: the other branch's zeros=True" in capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_bq_probe_tools_refuse_to_run_without_cuda_unless_given_the_cpu(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TOOLS[name].main([], shapes=SMALL[name])


@pytest.mark.parametrize("name, attr", [("bq_i16_probe", "bq_keys_plain"), ("bq_fat_probe", "bq_fat_plain"),
                                        ("bq_cond_probe", "precut_plain"),
                                        ("bq_sliced_decomp_probe", "precut_plain")])
def test_bq_probe_tool_fails_when_a_variant_misses_its_reference(monkeypatch, name, attr):
    """A plain version whose picks come out one slot late makes the tool raise."""
    module = TOOLS[name]
    real = getattr(module, attr)
    monkeypatch.setattr(module, attr, lambda *a, **k: (real(*a, **k)[0].roll(1, -1), real(*a, **k)[1]))
    with pytest.raises(AssertionError, match="misses its reference"):
        TOOLS[name].main(["--device", "cpu"], shapes=SMALL[name])


# --- The wrappers against the C entry points they call --------------------------------------------

C_ENTRY = re.compile(r"^int (pn2_\w+)\(([^)]*)\)", re.MULTILINE)


def _c_params(source: str) -> dict:
    text = (build.CSRC_DIR / f"{source}.cu").read_text()
    return {name: len([p for p in params.split(",") if p.strip()]) for name, params in C_ENTRY.findall(text)}


def _stub_launch(monkeypatch) -> list:
    seen = []
    monkeypatch.setattr(bq_probes, "require", lambda *a, **k: None)
    monkeypatch.setattr(bq_probes, "stream_of", lambda t: (0, 0))
    monkeypatch.setattr(bq_probes, "launch", lambda *a: seen.append(a))
    monkeypatch.setattr(bq_probes, "num_sms", lambda device: 132)
    return seen


@pytest.mark.parametrize("call", ["bq_keys_i32", "bq_keys_i16", "bq_fat", "bq_precut_cond", "bq_precut_decomp"])
def test_bq_wrappers_pass_every_argument_of_their_c_entry(monkeypatch, call):
    """The checks pass on a CPU stand-in; what would reach ctypes is caught
    and counted against the C signature (a mismatch shows only on the card)."""
    seen = _stub_launch(monkeypatch)
    xyz = torch.rand(2, 8192, 3)
    win, permw, q = torch.rand(2, 8, 3, 3072), torch.zeros(2, 8, 1, 3072, dtype=torch.int32), torch.rand(2, 8, 128, 3)
    fits = torch.ones((), dtype=torch.int32)
    {
        "bq_keys_i32": lambda: bq_probes.bq_keys(xyz, xyz[:, :1024], 0.1, 32, False),
        "bq_keys_i16": lambda: bq_probes.bq_keys(xyz, xyz[:, :1024], 0.1, 32, True),
        "bq_fat": lambda: bq_probes.bq_fat(xyz, xyz[:, :1024], 0.1, 32, 256),
        "bq_precut_cond": lambda: bq_probes.bq_precut_cond(win, permw, q, 8192, 0.1, 32, fits),
        "bq_precut_decomp": lambda: bq_probes.bq_precut_decomp(win, permw, q, 8192, 0.1, 32),
    }[call]()
    (kernel, source, symbol, argtypes, *passed), = seen
    assert kernel == call.removesuffix("_i32").removesuffix("_i16") and source == "bq_probes" in build.SOURCES
    assert len(argtypes) == len(passed) == _c_params(source)[symbol]
    assert f"{symbol}_error_string" in (build.CSRC_DIR / f"{source}.cu").read_text()
    if call.startswith("bq_keys"):
        assert passed[7] == int(call.endswith("i16")) and passed[8] == (14 if call.endswith("i16") else 7)
    if call.startswith("bq_precut"):
        assert passed[3] == (fits.data_ptr() if call.endswith("cond") else None)
        assert tuple(passed[11:13]) == bq_probes.precut_route(2, 8, 128, 3072, 0)


def test_bq_key_rows_fit_a_block_and_int16_keys_hold_n():
    """A row a warp in 227 KB: 7 warps of int32 keys and 14 of int16 at N =
    8192 (the probe's shape); int16 keys stop at N = 32767, int32 rows at one
    warp's 58112 columns."""
    assert bq_probes.key_warps(8192, False) == 7 and bq_probes.key_warps(8192, True) == 14
    assert bq_probes.key_warps(1000, False) == bq_probes.key_warps(1000, True) == 16
    assert bq_probes.key_warps(32767, True) == 3 and bq_probes.key_warps(bq_probes.MAX_N_I32, False) == 1
    with pytest.raises(ValueError, match="N <= 32767 with int16"):
        bq_probes.key_warps(32768, True)
    with pytest.raises(ValueError, match="N <= 58112 with int32"):
        bq_probes.key_warps(58113, False)


@pytest.mark.parametrize("case", ["nsample 0", "int16 N", "tile 64", "fits dtype", "window 0"])
def test_bq_wrappers_refuse_what_their_kernels_do_not_take(monkeypatch, case):
    monkeypatch.setattr(bq_probes, "launch", lambda *a: pytest.fail("launched"))
    monkeypatch.setattr(bq_probes, "stream_of", lambda t: (0, 0))
    monkeypatch.setattr(bq_probes, "num_sms", lambda device: 132)

    def on_cpu(t, what, dtype, shape, contiguous=True):
        """``require``'s checks past the device: a CPU tensor stands in for a card's."""
        if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
            raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
        if t.dim() != len(shape) or any(w is not None and g != w for g, w in zip(t.shape, shape)):
            raise ValueError(f"{what} must have shape {shape}, got {tuple(t.shape)}")

    monkeypatch.setattr(bq_probes, "require", on_cpu)
    xyz = torch.rand(1, 40000, 3)
    win, permw, q = torch.rand(1, 2, 3, 256), torch.zeros(1, 2, 1, 256, dtype=torch.int32), torch.rand(1, 2, 128, 3)
    call, match = {
        "nsample 0": (lambda: bq_probes.bq_keys(xyz[:, :1000], xyz[:, :64], 0.1, 0, False), "nsample > 0"),
        "int16 N": (lambda: bq_probes.bq_keys(xyz, xyz[:, :64], 0.1, 16, True), "N <= 32767"),
        "tile 64": (lambda: bq_probes.bq_fat(xyz[:, :1000], xyz[:, :64], 0.1, 16, 64), r"tiles of \(128, 256\)"),
        "fits dtype": (lambda: bq_probes.bq_precut_cond(win, permw, q, 600, 0.1, 16, torch.ones(())), "fits must be"),
        "window 0": (lambda: bq_probes.bq_precut_decomp(win[..., :0], permw[..., :0], q, 600, 0.1, 16), "a window"),
    }[case]
    with pytest.raises(ValueError, match=match):
        call()

