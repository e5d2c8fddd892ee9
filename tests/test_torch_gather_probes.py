"""The port's gather probe tools against the JAX repo's TPU design probes.

The root ``tools/gather_probe.py``, ``tools/sp_gather_probe.py`` and
``tools/fused_gather_probe.py`` are loaded by file path and their Pallas
kernels run in TPU interpret mode on the CPU, beside the port's plain
versions (``pointnet2_tpu_torch.tools.*gather_probe``) on the same
numpy-seeded inputs. ``gather_probe.py`` imports ``slope_time`` from
``tools.train_bench``, which defines it only inside its ``main``: the module
is loaded with a stand-in ``tools.train_bench`` whose ``slope_time`` is
``pointnet2_tpu.utils.bench.slope_time``, and ``sys.modules`` is put back
afterwards. Tolerance: bit for bit everywhere (a row copy does no
arithmetic), with the interpreted kernels and with ``np.take_along_axis``.
Each probe is held only where its TPU grid covers every row: ``sp_row_gather``
tiles 4096 rows, so its case has R = 4096 (below that its grid is empty).
The kernels themselves run on the card only (``chip_smoke.py``'s probes phase
and ``tests/test_torch_cuda.py``); here their wrappers' arguments are held
against the C signatures they call, and their limits checked.
"""

import importlib.util
import pathlib
import re
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pointnet2_tpu.utils.bench import slope_time
from pointnet2_tpu_torch.ops.cuda import build, gather_probes
from pointnet2_tpu_torch.tools import fused_gather_probe, gather_probe, sp_gather_probe

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = ("gather_probe", "sp_gather_probe", "fused_gather_probe")


@pytest.fixture(scope="module")
def root_tools():
    """The three root tools, loaded by path; ``gather_probe.py``'s broken
    import is met by a stand-in ``tools.train_bench`` for the load only."""
    saved = {name: sys.modules.get(name) for name in ("tools", "tools.train_bench")}
    stand_in = types.ModuleType("tools.train_bench")
    stand_in.slope_time = slope_time
    sys.modules["tools.train_bench"] = stand_in
    out = {}
    try:
        for name in NAMES:
            spec = importlib.util.spec_from_file_location(f"root_{name}", ROOT / "tools" / f"{name}.py")
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            out[name] = module
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module
    return out


def test_loading_the_root_tools_puts_sys_modules_back(root_tools):
    assert root_tools["gather_probe"].slope_time is slope_time
    assert getattr(sys.modules.get("tools.train_bench"), "slope_time", None) is not slope_time


def _rows_inputs(seed: int, b: int, n: int, c: int, r: int):
    rng = np.random.RandomState(seed)
    return rng.rand(b, n, c).astype(np.float32), rng.randint(0, n, (b, r)).astype(np.int32)


def _take(pts: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return np.take_along_axis(pts, idx[..., None].astype(np.int64), axis=1)


# --- gather_probe: indices read from memory, tiles of min(2048, R) ---------------------------------


@pytest.mark.parametrize("b, n, c, r", [(2, 512, 8, 256), (3, 300, 3, 256)], ids=["C8", "C3"])
def test_gather_rows_matches_the_interpreted_probe(root_tools, b, n, c, r):
    pts, idx = _rows_inputs(30 + c, b, n, c, r)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(root_tools["gather_probe"].gather_pallas(jnp.asarray(pts), jnp.asarray(idx)))
    got = gather_probe.gather_rows(torch.from_numpy(pts), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _take(pts, idx))


# --- sp_gather_probe: sp_row, the indices staged, tiles of 4096 ------------------------------------


def test_sp_row_matches_the_interpreted_probe(root_tools):
    """R = 4096, one cloud: one tile, the smallest R its grid covers."""
    pts, idx = _rows_inputs(40, 1, 512, 8, 4096)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(root_tools["sp_gather_probe"].sp_row_gather(jnp.asarray(pts), jnp.asarray(idx)))
    got = sp_gather_probe.sp_row(torch.from_numpy(pts), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _take(pts, idx))


# --- sp_gather_probe: sp_win, the window staged, rows by relative index ----------------------------

# N = 1024, W = 256, tm = 128, K = 8, a span of 192: with M = 256 (two tiles)
# kblk is [0, 3], the last tile's second block clamped to block 3 (interpreted,
# the case takes some 9 s); with M = 512 (the tools' test) [0, 1, 2, 3].
WINDOW = dict(n=1024, k=8, span=192, w=256, tm=128, rounds=1)


def test_sp_win_matches_the_interpreted_probe_with_the_clamped_block(root_tools):
    shapes = {**WINDOW, "m": 256}
    pts, idx, kblk = sp_gather_probe.regime_inputs(2, 8, shapes)
    assert kblk[0, -1] == shapes["n"] // shapes["w"] - 1  # the last tile's second block is clamped
    sp_gather_probe.check_window(idx, kblk, shapes["w"], shapes["tm"])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(root_tools["sp_gather_probe"].sp_win_gather(
            jnp.asarray(pts), jnp.asarray(idx), jnp.asarray(kblk), shapes["w"], shapes["tm"], 4))
    got = sp_gather_probe.sp_win(torch.from_numpy(pts), torch.from_numpy(idx), torch.from_numpy(kblk),
                                 shapes["w"], shapes["tm"], 4).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _take(pts, idx.reshape(2, -1)))


def test_sp_win_plain_reads_the_scratch_not_the_cloud():
    """A relative index past the window's rows would read the cloud's next
    block in a flat gather; the plain version builds the clamped scratch, so
    at the last tile the rows at W..2W are block nblk - 1 again."""
    n, w, tm = 512, 128, 128
    pts = torch.arange(n, dtype=torch.float32)[None, :, None].expand(1, n, 2).contiguous()
    kblk = torch.tensor([[n // w - 1]], dtype=torch.int32)
    idx = torch.full((1, tm, 1), (n // w - 1) * w + w + 5, dtype=torch.int32)  # rel = w + 5
    got = sp_gather_probe.sp_win_plain(pts, idx, kblk, w, tm)
    assert torch.equal(got, torch.full((1, tm, 2), float((n // w - 1) * w + 5)))


def test_regime_inputs_keep_every_index_in_its_window():
    """The JAX tool's regimes: every relative index in [0, 2W) (checked on
    the host before anything is timed) and the bases' blocks as the JAX tool
    computes them."""
    shapes = sp_gather_probe.SHAPES
    pts, idx, kblk = sp_gather_probe.regime_inputs(2, 4, shapes)
    sp_gather_probe.check_window(idx, kblk, shapes["w"], shapes["tm"])
    assert pts.shape == (2, 8192, 4) and idx.shape == (2, 1024, 32) and kblk.tolist() == [[0, 0, 0, 0, 0, 0, 1, 1]] * 2
    assert (np.diff(pts[..., 0], axis=1) > -1e-3).all()  # sorted by x up to the noise
    with pytest.raises(AssertionError, match="leaves"):
        sp_gather_probe.check_window(idx, kblk + 1, shapes["w"], shapes["tm"])


# --- fused_gather_probe: indices written on chip, emitted and read back ----------------------------


def test_fused_idx_matches_the_interpreted_probe(root_tools):
    rng = np.random.RandomState(50)
    pts = rng.randn(2, 512, 8).astype(np.float32)
    idx = rng.randint(0, 512, size=(2, 256)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        rows, emitted = root_tools["fused_gather_probe"].vmem_idx_gather(jnp.asarray(pts), jnp.asarray(idx))
    got_rows, got_idx = fused_gather_probe.fused_idx_gather(torch.from_numpy(pts), torch.from_numpy(idx))
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(rows))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(emitted))
    np.testing.assert_array_equal(got_rows.numpy(), _take(pts, idx))
    assert got_idx.dtype == torch.int32 and got_idx.shape == (2, 1, 256)


# --- The tools ------------------------------------------------------------------------------------

SMALL = {
    "gather_probe": dict(b=3, n=512, c=8, m=64, k=8, rounds=1),
    "sp_gather_probe": {**WINDOW, "m": 512, "regimes": {"small": dict(label="small", b=2, c=5),
                                                        "narrow": dict(label="narrow", b=3, c=8)}},
    "fused_gather_probe": dict(b=2, n=512, c=3, r=8192, rounds=1),
}
EXACT_LINES = {
    "gather_probe": ["gather_rows: exact vs group_points=True; vs row 9=True"],
    "sp_gather_probe": ["sp_row: exact vs group_points=True; vs row 9=True"]
    + [f"sp_win/u{u}: exact vs group_points=True; vs row 9=True" for u in (4, 8, 16)],
    "fused_gather_probe": ["fused-index gather (indices written on chip, emitted, read back) runs; exact vs "
                           "group_points=True; emitted indices equal the input=True; vs row 9=True"],
}
TOOLS = {"gather_probe": gather_probe, "sp_gather_probe": sp_gather_probe, "fused_gather_probe": fused_gather_probe}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_gather_probe_tool_runs_small_on_the_cpu(name, capsys):
    summary = TOOLS[name].main(["--device", "cpu"], shapes=SMALL[name])
    lines = capsys.readouterr().out.splitlines()
    for want in EXACT_LINES[name]:
        assert any(line.startswith(want) for line in lines), (want, lines)
    assert lines[-1] == "times: taken on the card only"
    assert "card" not in summary


def test_sp_gather_probe_runs_the_regimes_asked_for(capsys):
    out = sp_gather_probe.main(["narrow", "--device", "cpu"], shapes=SMALL["sp_gather_probe"])
    assert list(out) == ["narrow"] and "== narrow" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        sp_gather_probe.main(["wide", "--device", "cpu"], shapes=SMALL["sp_gather_probe"])


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_gather_probe_tools_refuse_to_run_without_cuda_unless_given_the_cpu(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TOOLS[name].main([], shapes=SMALL[name])


@pytest.mark.parametrize("name, attr", [("gather_probe", "gather_rows_plain"), ("sp_gather_probe", "sp_row_plain"),
                                        ("sp_gather_probe", "sp_win_plain"),
                                        ("fused_gather_probe", "fused_idx_plain")])
def test_gather_probe_tool_fails_when_a_variant_misses_its_reference(monkeypatch, name, attr):
    """A plain version whose rows come out one place late makes the tool
    raise; for the fused probe also indices emitted one place late."""
    module = TOOLS[name]
    real = getattr(module, attr)

    def late(*a, **k):
        out = real(*a, **k)
        return tuple(x.roll(1, 1) for x in out) if isinstance(out, tuple) else out.roll(1, 1)

    monkeypatch.setattr(module, attr, late)
    with pytest.raises(AssertionError, match="misses its reference"):
        module.main(["--device", "cpu"], shapes=SMALL[name])


def test_fused_probe_fails_when_only_the_emitted_indices_are_wrong(monkeypatch):
    real = fused_gather_probe.fused_idx_plain
    monkeypatch.setattr(fused_gather_probe, "fused_idx_plain", lambda p, i: (real(p, i)[0], real(p, i)[1] + 1))
    with pytest.raises(AssertionError, match="misses its reference"):
        fused_gather_probe.main(["--device", "cpu"], shapes=SMALL["fused_gather_probe"])


# --- The wrappers against the C entry points they call --------------------------------------------

C_ENTRY = re.compile(r"^int (pn2_\w+)\(([^)]*)\)", re.MULTILINE)


def _c_params(source: str) -> dict:
    text = (build.CSRC_DIR / f"{source}.cu").read_text()
    return {name: len([p for p in params.split(",") if p.strip()]) for name, params in C_ENTRY.findall(text)}


def _on_cpu(t, what, dtype, shape, contiguous=True):
    """``require``'s checks past the device: a CPU tensor stands in for a card's."""
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(w is not None and g != w for g, w in zip(t.shape, shape)):
        raise ValueError(f"{what} must have shape {shape}, got {tuple(t.shape)}")


def _stub_launch(monkeypatch) -> list:
    seen = []
    monkeypatch.setattr(gather_probes, "require", _on_cpu)
    monkeypatch.setattr(gather_probes, "stream_of", lambda t: (0, 0))
    monkeypatch.setattr(gather_probes, "launch", lambda *a: seen.append(a))
    return seen


CALLS = {
    "gather_rows": lambda p, i, i3, kb: gather_probes.gather_rows(p, i),
    "gather_rows_staged": lambda p, i, i3, kb: gather_probes.gather_rows_staged(p, i),
    "gather_fused_idx": lambda p, i, i3, kb: gather_probes.gather_fused_idx(p, i),
    "gather_window_staged": lambda p, i, i3, kb: gather_probes.gather_window_staged(p, i3, kb, 4096, 128, 8),
}


@pytest.mark.parametrize("c, vec, lanes", [(64, 1, 16), (32, 1, 8), (3, 0, 4)])
@pytest.mark.parametrize("call", sorted(CALLS))
def test_gather_wrappers_pass_every_argument_of_their_c_entry(monkeypatch, call, c, vec, lanes):
    """The checks pass on a CPU stand-in; what would reach ctypes is caught
    and counted against the C signature (a mismatch shows only on the card).
    The route is row 9's plan: 16-byte vectors where C % 4 == 0, the lanes
    covering a row."""
    seen = _stub_launch(monkeypatch)
    pts = torch.rand(5, 8192, c)
    idx3 = torch.randint(0, 3072, (5, 1024, 32), dtype=torch.int32)
    kblk = torch.zeros((5, 8), dtype=torch.int32)
    out = CALLS[call](pts, idx3.view(5, -1), idx3, kblk)
    (kernel, source, symbol, argtypes, *passed), = seen
    assert kernel == call and source == "gather_probes" in build.SOURCES and symbol == f"pn2_{call}"
    assert len(argtypes) == len(passed) == _c_params(source)[symbol]
    assert f"{symbol}_error_string" in (build.CSRC_DIR / f"{source}.cu").read_text()
    if call == "gather_window_staged":
        assert tuple(passed[3:11]) == (5, 8192, c, 8, 128 * 32, 4096, vec, 8)
        assert out.shape == (5, 1024 * 32, c)
    else:
        tr = {"gather_rows": 2048, "gather_rows_staged": 4096, "gather_fused_idx": 4096}[call]
        assert tuple(passed[2:9]) == (5, 8192, 32768, tr, c, vec, lanes)
        rows = out[0] if call == "gather_fused_idx" else out
        assert rows.shape == (5, 32768, c)
        if call == "gather_fused_idx":
            assert out[1].shape == (5, 1, 32768) and out[1].dtype == torch.int32


def test_window_wrapper_passes_the_relative_indices():
    idx = torch.tensor([[[4100, 4096], [8191, 5000]]], dtype=torch.int32)
    rel = gather_probes.relative_indices(idx, torch.tensor([[1]], dtype=torch.int32), 4096, 2)
    assert rel.tolist() == [[[4, 0, 4095, 904]]] and rel.dtype == torch.int32


@pytest.mark.parametrize("case", ["rows 1000", "staged R 2048", "fused R 6000", "window M % tm", "window N % w",
                                  "window slice", "window unroll", "window kblk", "B 0", "idx dtype"])
def test_gather_wrappers_refuse_what_their_kernels_do_not_take(monkeypatch, case):
    monkeypatch.setattr(gather_probes, "launch", lambda *a: pytest.fail("launched"))
    monkeypatch.setattr(gather_probes, "stream_of", lambda t: (0, 0))
    monkeypatch.setattr(gather_probes, "require", _on_cpu)
    pts = torch.rand(2, 8192, 8)
    idx = lambda r: torch.zeros((2, r), dtype=torch.int32)
    idx3 = torch.zeros((2, 1024, 32), dtype=torch.int32)
    kblk = torch.zeros((2, 8), dtype=torch.int32)
    call, match = {
        # min(2048, 3000) = 2048 rows a tile: 3000 is not a whole number of them.
        "rows 1000": (lambda: gather_probes.gather_rows(pts, idx(3000)), "tiles of 2048"),
        # sp_row_gather's grid (b, R // 4096) is empty below 4096 rows.
        "staged R 2048": (lambda: gather_probes.gather_rows_staged(pts, idx(2048)), "tiles of 4096"),
        "fused R 6000": (lambda: gather_probes.gather_fused_idx(pts, idx(6000)), "tiles of 4096"),
        "window M % tm": (lambda: gather_probes.gather_window_staged(pts, idx3[:, :1000], kblk, 4096, 128, 4),
                          "M a multiple of tm"),
        "window N % w": (lambda: gather_probes.gather_window_staged(pts[:, :8000], idx3, kblk, 4096, 128, 4),
                         "N of w"),
        # 2W x 16 bytes + tm * K * 4: 8192 rows take 256 KB alone.
        "window slice": (lambda: gather_probes.gather_window_staged(torch.rand(2, 16384, 8), idx3, kblk, 8192, 128, 4),
                         "past a block's 232448"),
        "window unroll": (lambda: gather_probes.gather_window_staged(pts, idx3, kblk, 4096, 128, 2), "unroll in"),
        "window kblk": (lambda: gather_probes.gather_window_staged(pts, idx3, kblk[:, :4], 4096, 128, 4),
                        "kblk must have shape"),
        "B 0": (lambda: gather_probes.gather_rows(pts[:0], idx(2048)[:0]), "1 <= B"),
        "idx dtype": (lambda: gather_probes.gather_rows(pts, idx(2048).long()), "idx must be"),
    }[case]
    with pytest.raises(ValueError, match=match):
        call()


def test_window_shared_memory_fits_the_probe_and_stops_past_the_block():
    """At the probe's W = 4096 and 128 x 32 rows a tile: 128 KB of window
    slice and 16 KB of relative indices; the largest W that fits is 6752."""
    assert gather_probes.window_shared_bytes(4096, 4096) == 147456
    assert gather_probes.window_shared_bytes(6752, 4096) <= 232448 < gather_probes.window_shared_bytes(6753, 4096)


def test_plain_versions_refuse_partial_tiles_as_the_wrappers_do():
    pts = torch.rand(1, 64, 4)
    with pytest.raises(ValueError, match="tiles of 4096"):
        sp_gather_probe.sp_row_plain(pts, torch.zeros((1, 2048), dtype=torch.int32))
    with pytest.raises(ValueError, match="tiles of 2048"):
        gather_probe.gather_rows_plain(pts, torch.zeros((1, 3000), dtype=torch.int32))
    with pytest.raises(ValueError, match="unroll in"):
        sp_gather_probe.sp_win(pts, torch.zeros((1, 128, 1), dtype=torch.int32), torch.zeros((1, 1), dtype=torch.int32),
                               64, 128, 5)
