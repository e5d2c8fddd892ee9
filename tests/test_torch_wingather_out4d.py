"""The port's 4-D window grouping against the JAX repo's TPU design probe.

The root ``tools/wingather_out4d_probe.py`` defines its gather kernel
(``_window_gather_kernel_4d``) and its function (``project_group_sliced_4d``)
inside ``main``, which runs at full size; the test takes the two out of
``main`` with ``ast`` and runs them in a namespace holding what ``main``
imports, under ``pltpu.force_tpu_interpret_mode()`` on the CPU, beside the
port's plain versions (``pointnet2_tpu_torch.tools.wingather_out4d_probe``)
on the same numpy-seeded inputs. Row 8's kernel
(``pointnet2_tpu.ops.pallas.wingather._bq_sliced_pos_kernel``) is called
directly with the probe's BlockSpecs (``:121-152``), and the gather kernel
with its scalar-prefetch grid (``:157-190``). Tolerance: bit for bit
everywhere (indices, counts and copied rows). The projection ``inputs @ w0
+ b0`` is a float32 product that XLA and PyTorch sum in different orders
(1 ulp apart at the probe's ``randn * 0.1`` weights), so where the test
holds the JAX function's ``grouped`` against the port's, ``w0`` gives each
output channel one input channel times a signed power of two: every product
is exact, the sums add zeros, and the rows are equal bit for bit whatever
the order. The kernels themselves
run on the card only (``chip_smoke.py``'s probes phase and
``tests/test_torch_cuda.py``); here their wrappers' arguments are held
against the C signatures they call, and their limits checked.
"""

import ast
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pointnet2_tpu.ops.pallas import wingather as wg
from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.ops import core
from pointnet2_tpu_torch.ops.cuda import bq_probes, build, gather_probes
from pointnet2_tpu_torch.tools import wingather_out4d_probe as probe
from test_torch_gather_probes import _c_params, _on_cpu

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROBE_DEFS = ("_window_gather_kernel_4d", "project_group_sliced_4d")


def _root_defs() -> dict:
    """The probe's two definitions out of its ``main``, executed in a
    namespace of ``main``'s imports; returns the namespace."""
    tree = ast.parse((ROOT / "tools" / "wingather_out4d_probe.py").read_text())
    main = next(node for node in tree.body if isinstance(node, ast.FunctionDef) and node.name == "main")
    defs = [node for node in main.body if isinstance(node, ast.FunctionDef) and node.name in PROBE_DEFS]
    assert [d.name for d in defs] == list(PROBE_DEFS)
    namespace = {"functools": functools, "jax": jax, "jnp": jnp, "lax": lax, "pl": pl, "pltpu": pltpu, "wg": wg,
                 "_LANES": 128}
    exec(compile(ast.Module(body=defs, type_ignores=[]), "tools/wingather_out4d_probe.py", "exec"), namespace)
    return namespace


ROOT_DEFS = _root_defs()

# The pipeline's case: one cloud of 2048 points in the probe's boxes, 1024
# FPS centroids in 8 tiles, K = 8, C = 8, W = 512 (wblk 512, 4 blocks): the
# certificate holds, no ball is empty, and the last tile's window starts in
# the last block, so its second block is clamped (interpreted, about 20 s).
PIPELINE = dict(b=1, n=2048, m=1024, k=8, c_in=6, f0=8, window=512, radius=0.3)


def exact_projection(seed: int, c_in: int, f0: int) -> torch.Tensor:
    """(C_IN, F0) float32: output channel j is input channel ``j % C_IN``
    times a signed power of two (2^-3 .. 2^2), every other weight 0."""
    rng = np.random.RandomState(seed)
    w0 = np.zeros((c_in, f0), np.float32)
    w0[np.arange(f0) % c_in, np.arange(f0)] = rng.choice([-1.0, 1.0], f0) * 2.0 ** rng.randint(-3, 3, f0)
    return torch.from_numpy(w0)


@pytest.fixture(scope="module")
def pipeline():
    """The seeded inputs (the probe's, with ``exact_projection`` for
    ``w0``), the port's plain 4-D function, and the probe's function run
    once in interpret mode, all as numpy."""
    s = PIPELINE
    inputs, _, b0, xyz = probe.probe_inputs(s, torch.device("cpu"))
    w0 = exact_projection(5, s["c_in"], s["f0"])
    new_xyz = ops.fps_centroids(xyz, s["m"])[1]
    args = (inputs, w0, b0, xyz, new_xyz)
    port = probe.project_group_sliced_4d(*args, s["radius"], s["k"], s["window"])
    with pltpu.force_tpu_interpret_mode():
        root = ROOT_DEFS["project_group_sliced_4d"](*(jnp.asarray(a.numpy()) for a in args), s["radius"], s["k"],
                                                    s["window"])
        root = [np.asarray(x) for x in root]
    plan = probe.window_plan(inputs, xyz, new_xyz, s["radius"], s["window"])
    return {"args": args, "port": [x.numpy() for x in port], "root": root, "plan": plan}


def test_the_4d_function_matches_the_interpreted_probe(pipeline):
    """``grouped``, ``idx``, ``cnt``, ``qperm``, ``inv_q`` and ``ok`` bit for
    bit, on a case with every ball filled and the last block clamped; also
    equal to the port's shipped grouping (rows 8 and 9)."""
    port, root, plan = pipeline["port"], pipeline["root"], pipeline["plan"]
    for name, got, want in zip(("grouped", "idx", "cnt", "qperm", "inv_q", "ok"), port, root):
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=name)
    assert bool(port[5]) and (port[2] > 0).all()  # the certificate holds; no ball is empty
    n, wblk = PIPELINE["n"], plan["wblk"]
    assert wblk == 512 and int((plan["lo"] // wblk).max()) == n // wblk - 1  # the clamp is reached
    shipped = ops.project_group_calibrated(*pipeline["args"], PIPELINE["radius"], PIPELINE["k"], PIPELINE["window"])
    for got, want in zip(port[:3], shipped[:3]):
        np.testing.assert_array_equal(got, want.numpy())


# --- P13: row 8's kernel on cut windows ----------------------------------------------------------


def _bq_pos(win, permw, q_tiles, n: int, r: float, ns: int):
    """The probe's row-8 ``pallas_call`` (``:121-152``), with its BlockSpecs."""
    b, t, _, w = win.shape
    tm = q_tiles.shape[2]
    kernel = functools.partial(wg._bq_sliced_pos_kernel, n=n, radius=float(r), nsample=ns)
    spec = lambda shape: pl.BlockSpec(shape, lambda i, j: (i, j, 0, 0), memory_space=pltpu.VMEM)
    return pl.pallas_call(
        kernel,
        grid=(b, t),
        in_specs=[spec((1, 1, 3, w)), spec((1, 1, 1, w)), spec((1, 1, tm, 3))],
        out_specs=(spec((1, 1, tm, ns)), spec((1, 1, tm, ns)), spec((1, 1, 1, tm))),
        out_shape=(
            jax.ShapeDtypeStruct((b, t, tm, ns), jnp.int32),
            jax.ShapeDtypeStruct((b, t, tm, ns), jnp.int32),
            jax.ShapeDtypeStruct((b, t, 1, tm), jnp.int32),
        ),
        scratch_shapes=[pltpu.VMEM((tm, wg._round_up(ns, 128)), jnp.int32)],
    )(win, permw, q_tiles)


def _uniform_queries(seed: int, b: int, n: int, m: int):
    """Points in the probe's boxes and queries drawn apart from them in the
    same boxes: at r = 0.3 about half the balls are empty and most of the
    others hold fewer than K points (the padding rules)."""
    rng = np.random.RandomState(seed)
    box = np.array(probe.BOX, np.float32)
    xyz = (rng.rand(b, n, 3) * box).astype(np.float32)
    inputs = np.concatenate([xyz, rng.rand(b, n, 3).astype(np.float32)], axis=-1)
    queries = (rng.rand(b, m, 3) * box).astype(np.float32)
    return torch.from_numpy(inputs), torch.from_numpy(xyz), torch.from_numpy(queries)


@pytest.mark.parametrize("ns", [8, 40])
def test_precut_pos_plain_matches_row_8s_interpreted_kernel_with_empty_balls(ns):
    """The port's plain P13 on its own cut windows against the interpreted
    kernel on the same windows, and against the port's row 8 reading the
    windows in place: idx, pos and cnt bit for bit, with empty balls."""
    inputs, xyz, new_xyz = _uniform_queries(60 + ns, 2, 1024, 256)
    plan = probe.window_plan(inputs, xyz, new_xyz, 0.3, 256)
    win_args = (plan["win"], plan["permw"], plan["q_tiles"])
    got = probe.precut_pos_plain(*win_args, 1024, 0.3, ns)
    with pltpu.force_tpu_interpret_mode():
        want = _bq_pos(*(jnp.asarray(a.numpy()) for a in win_args), 1024, 0.3, ns)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    cnt = got[2]
    assert int((cnt == 0).sum()) > 0 and int(((cnt > 0) & (cnt < ns)).sum()) > 0
    empty = (cnt[:, :, 0, :] == 0)[..., None].expand_as(got[0])
    assert not bool(got[0][empty].any()) and not bool(got[1][empty].any())  # index 0, column 0
    idx8, pos8, cnt8 = core.ball_query_tiles_pos(plan["xs"], plan["perm"], plan["qs"], plan["lo"], 0.3, ns, 256)
    b, m = cnt8.shape
    assert torch.equal(got[0].reshape(b, m, ns), idx8) and torch.equal(got[1].reshape(b, m, ns), pos8)
    assert torch.equal(got[2].reshape(b, m), cnt8)


def test_precut_pos_plain_pads_by_the_first_pick_and_reads_columns():
    """A hand-made window: query 0 sees columns 2 and 5 (original indices 9
    and 4), query 1 nothing: idx [4, 9, 4], pos [5, 2, 5]; idx and pos 0 for
    the empty ball; the counts 2 and 0."""
    w = 8
    win = torch.full((1, 1, 3, w), 50.0)
    win[0, 0, :, 2] = 0.1
    win[0, 0, :, 5] = 0.2
    permw = torch.tensor([[[[0, 1, 9, 3, 5, 4, 6, 7]]]], dtype=torch.int32)
    q = torch.tensor([[[[0.0, 0.0, 0.0], [9.0, 9.0, 9.0]]]])
    idx, pos, cnt = probe.precut_pos_plain(win, permw, q, 10, 1.0, 3)
    assert idx.tolist() == [[[[4, 9, 4], [0, 0, 0]]]] and pos.tolist() == [[[[5, 2, 5], [0, 0, 0]]]]
    assert cnt.tolist() == [[[[2, 0]]]]


# --- P14: the window gather writing (B, M, K, C) ---------------------------------------------------


def _gather_4d(kblk, rel, zp_s, tm: int, k: int, wblk: int):
    """The probe's gather ``pallas_call`` (``:157-190``) over its extracted kernel."""
    b, n, c = zp_s.shape
    t = kblk.shape[1]
    nblk = n // wblk
    kernel = functools.partial(ROOT_DEFS["_window_gather_kernel_4d"], tm=tm, k=k, wblk=wblk, unroll=4)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(b, t),
        in_specs=[
            pl.BlockSpec((1, 1, 1, tm * k), lambda bb, tt, kr: (bb, tt, 0, 0), memory_space=pltpu.SMEM),
            pl.BlockSpec((1, wblk, c), lambda bb, tt, kr: (bb, kr[bb, tt], 0)),
            pl.BlockSpec((1, wblk, c), lambda bb, tt, kr: (bb, jnp.minimum(kr[bb, tt] + 1, nblk - 1), 0)),
        ],
        out_specs=pl.BlockSpec((1, tm, k, c), lambda bb, tt, kr: (bb, tt, 0, 0)),
        scratch_shapes=[pltpu.VMEM((2 * wblk, c), zp_s.dtype)],
    )
    return pl.pallas_call(kernel, grid_spec=grid_spec,
                          out_shape=jax.ShapeDtypeStruct((b, t * tm, k, c), zp_s.dtype))(kblk, rel, zp_s, zp_s)


@pytest.mark.parametrize("c", [8, 3])
def test_window_out4d_plain_matches_the_interpreted_kernel_at_the_clamped_block(c):
    """Two tiles of 128 queries, K = 4, blocks of 256 rows in a cloud of
    1024: the second tile's first block is the last, so its second is the
    same block again; every relative row in [0, 2 wblk) is drawn, the
    duplicate's included."""
    b, n, tm, k, wblk = 2, 1024, 128, 4, 256
    rng = np.random.RandomState(70 + c)
    zp_s = rng.randn(b, n, c).astype(np.float32)
    kblk = np.array([[0, n // wblk - 1], [1, n // wblk - 1]], np.int32)
    rel = rng.randint(0, 2 * wblk, (b, 2, 1, tm * k)).astype(np.int32)
    got = probe.window_out4d_plain(torch.from_numpy(zp_s), torch.from_numpy(rel), torch.from_numpy(kblk), wblk, tm, k)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_gather_4d(jnp.asarray(kblk), jnp.asarray(rel), jnp.asarray(zp_s), tm, k, wblk))
    np.testing.assert_array_equal(got.numpy(), want)
    last = got.numpy()[:, tm:].reshape(b, tm * k, c)
    row = np.where(rel[:, 1, 0] < wblk, rel[:, 1, 0], rel[:, 1, 0] - wblk) + (n // wblk - 1) * wblk
    np.testing.assert_array_equal(last, np.take_along_axis(zp_s, row[..., None], axis=1))


def test_window_out4d_equals_row_9_at_the_same_rows():
    """The relative rows ``pos + lo mod wblk`` name row ``lo + pos`` of the
    sorted cloud: P14's plain version equals row 9's, ``window_gather(zp_s,
    lo, pos)``, whenever the window lies in its two blocks."""
    inputs, xyz, new_xyz = _uniform_queries(80, 2, 2048, 1024)
    plan = probe.window_plan(inputs, xyz, new_xyz, 0.3, 512)
    _, pos_s, _ = probe.precut_pos_plain(plan["win"], plan["permw"], plan["q_tiles"], 2048, 0.3, 16)
    kblk, rel = probe.relative_rows(pos_s, plan["lo"], plan["wblk"])
    assert int(kblk.max()) == 2048 // plan["wblk"] - 1
    zp_s = plan["sorted_inputs"] @ torch.rand(6, 5) + 0.5
    got = probe.window_out4d_plain(zp_s, rel, kblk, plan["wblk"], plan["tm"], 16)
    assert torch.equal(got, core.window_gather(zp_s, plan["lo"], pos_s.reshape(2, 1024, 16)))


# --- The tool ----------------------------------------------------------------------------------------

SMALL = dict(b=2, n=2048, m=1024, k=8, c_in=6, f0=8, window=512, radius=0.3, rounds=1)


def test_the_tool_runs_small_on_the_cpu(capsys):
    summary = probe.main(["--device", "cpu"], shapes=SMALL)
    lines = capsys.readouterr().out.splitlines()
    assert "window certificate: shipped=True 4d=True" in lines
    assert ("4D (M, K, C) out vs shipped (T, TRK, C) + reshape: grouped equal=True; idx equal=True; "
            "cnt equal=True") in lines
    assert lines[-1] == "times: taken on the card only"
    assert "card" not in summary and summary["exact"] == {"grouped": True, "idx": True, "cnt": True}


def test_the_tool_refuses_to_run_without_cuda_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.main([], shapes=SMALL)


@pytest.mark.parametrize("attr, part", [("precut_pos_plain", 0), ("precut_pos_plain", 1), ("precut_pos_plain", 2),
                                        ("window_out4d_plain", None)])
def test_the_tool_fails_when_the_4d_path_misses_the_shipped_one(monkeypatch, attr, part):
    """P13's indices, window columns or counts one place late, or P14's rows,
    make the tool raise."""
    real = getattr(probe, attr)

    def late(*a, **k):
        out = real(*a, **k)
        if part is None:
            return out.roll(1, 2)
        return tuple(x.roll(1, -1) if i == part else x for i, x in enumerate(out))

    monkeypatch.setattr(probe, attr, late)
    with pytest.raises(AssertionError, match="misses the shipped path"):
        probe.main(["--device", "cpu"], shapes=SMALL)


def test_the_tool_fails_when_the_certificate_does_not_hold():
    """A window of 128 columns misses the candidates of most tiles."""
    with pytest.raises(AssertionError, match="certificate"):
        probe.main(["--device", "cpu"], shapes={**SMALL, "window": 128})


def test_the_4d_function_refuses_the_probes_static_fallbacks():
    """The JAX function asserts what the shipped one falls back on: a window
    covering the cloud, partial tiles, or no block width dividing N."""
    inputs, xyz, new_xyz = _uniform_queries(90, 1, 1000, 256)
    for q, window in ((new_xyz, 1024), (new_xyz[:, :200], 256), (new_xyz, 256)):
        with pytest.raises(ValueError, match="block width"):
            probe.window_plan(inputs, xyz, q, 0.3, window)


# --- The wrappers against the C entry points they call ------------------------------------------------

def _stub(monkeypatch, module, launch) -> None:
    monkeypatch.setattr(module, "require", _on_cpu)
    monkeypatch.setattr(module, "stream_of", lambda t: (0, 0))
    monkeypatch.setattr(module, "launch", launch)
    monkeypatch.setattr(module, "num_sms", lambda device: 132)


def _probe_shape_tensors():
    win, permw = torch.rand(8, 8, 3, 3072), torch.zeros(8, 8, 1, 3072, dtype=torch.int32)
    q_tiles = torch.rand(8, 8, 128, 3)
    zp_s, rel = torch.rand(8, 8192, 32), torch.zeros(8, 8, 1, 4096, dtype=torch.int32)
    kblk = torch.zeros(8, 8, dtype=torch.int32)
    return win, permw, q_tiles, zp_s, rel, kblk


ENTRIES = {"bq_precut_pos": ("bq_precut_pos", "bq_probes", "pn2_ball_query_precut_pos"),
           "gather_window_out4d": ("gather_window_out4d", "gather_probes", "pn2_gather_window_out4d")}


@pytest.mark.parametrize("call", ["bq_precut_pos", "gather_window_out4d", "gather_window_out4d C3"])
def test_out4d_wrappers_pass_every_argument_of_their_c_entry(monkeypatch, call):
    """At the probe's shape the checks pass on a CPU stand-in; what would
    reach ctypes is caught and counted against the C signature (a mismatch
    shows only on the card)."""
    seen = []
    win, permw, q_tiles, zp_s, rel, kblk = _probe_shape_tensors()
    if call == "bq_precut_pos":
        _stub(monkeypatch, bq_probes, lambda *a: seen.append(a))
        idx, pos, cnt = bq_probes.bq_precut_pos(win, permw, q_tiles, 8192, 0.5, 32)
        assert idx.shape == pos.shape == (8, 8, 128, 32) and cnt.shape == (8, 8, 1, 128)
    else:
        _stub(monkeypatch, gather_probes, lambda *a: seen.append(a))
        c = 3 if call.endswith("C3") else 32
        out = gather_probes.gather_window_out4d(zp_s[..., :c].contiguous(), rel, kblk, 4096, 128, 32)
        assert out.shape == (8, 1024, 32, c)
    (kernel, source, symbol, argtypes, *passed), = seen
    assert (kernel, source, symbol) == ENTRIES[call.split()[0]] and source in build.SOURCES
    assert len(argtypes) == len(passed) == _c_params(source)[symbol]
    assert f"{symbol}_error_string" in (build.CSRC_DIR / f"{source}.cu").read_text()
    if call == "bq_precut_pos":
        assert tuple(passed[3:8]) == (8, 8, 128, 3072, 8192)
        assert passed[9] == 32 and tuple(passed[10:12]) == bq_probes.precut_route(8, 8, 128, 3072, 0)
    else:
        vec = c % 4 == 0
        lanes = 8 if vec else 4  # row 9's plan: 8 vectors of 16 bytes, or 3 floats
        span = gather_probes.plan(64, c, vec, 132)  # 8 clouds x 8 tiles: 4 blocks a tile
        assert span.splits == 4
        assert tuple(passed[3:14]) == (8, 8192, c, 8, 128, 32, 4096, int(vec), lanes, span.splits, span.chunk_rows)


@pytest.mark.parametrize("case", ["N % wblk", "tm * K", "slice", "kblk", "rel dtype", "nsample 0", "window 0",
                                  "permw", "chunk", "picks"])
def test_out4d_wrappers_refuse_what_their_kernels_do_not_take(monkeypatch, case):
    for module in (bq_probes, gather_probes):
        _stub(monkeypatch, module, lambda *a: pytest.fail("launched"))
    win, permw, q_tiles, zp_s, rel, kblk = _probe_shape_tensors()
    gather = gather_probes.gather_window_out4d
    call, match = {
        "N % wblk": (lambda: gather(zp_s[:, :8000], rel, kblk, 4096, 128, 32), "N a multiple of wblk"),
        "tm * K": (lambda: gather(zp_s, rel, kblk, 4096, 128, 16), "tm \\* K"),
        # 128 x 256 picks a tile: 8 bytes a pick take 256 KB beside the ring.
        "slice": (lambda: gather(zp_s, torch.zeros(8, 1, 1, 128 * 256, dtype=torch.int32), kblk[:, :1], 4096, 128, 256),
                  "past a block's 232448"),
        # Rows of 20000 floats: a chunk of one row, 80 KB, and the ring of three past a block's 227 KB.
        "chunk": (lambda: gather(torch.rand(1, 8, 20000), torch.zeros(1, 1, 1, 128, dtype=torch.int32), kblk[:1, :1],
                                 4, 128, 1), "a ring of 3 x 1 rows of 20000 floats"),
        "picks": (lambda: gather(zp_s[:1], torch.zeros(1, 1, 1, 128 * 1024, dtype=torch.int32), kblk[:1, :1], 4096, 128,
                                 1024), "16-bit"),
        "kblk": (lambda: gather(zp_s, rel, kblk[:, :4], 4096, 128, 32), "kblk must have shape"),
        "rel dtype": (lambda: gather(zp_s, rel.long(), kblk, 4096, 128, 32), "rel must be"),
        "nsample 0": (lambda: bq_probes.bq_precut_pos(win, permw, q_tiles, 8192, 0.5, 0), "nsample > 0"),
        "window 0": (lambda: bq_probes.bq_precut_pos(win[..., :0], permw[..., :0], q_tiles, 8192, 0.5, 32), "a window"),
        "permw": (lambda: bq_probes.bq_precut_pos(win, permw[..., :3000], q_tiles, 8192, 0.5, 32), "permw must have"),
    }[case]
    with pytest.raises(ValueError, match=match):
        call()


def test_out4d_shared_memory_at_the_probes_shape():
    """wblk = 4096 at N = 8192, W = 3072 (the two blocks are the whole
    cloud), which no longer counts: P11's plan at the probe's 8 x 8 tiles, a
    ring of three chunks of 128 rows and 8 bytes a pick, 80 KB at K = 32; K =
    64 takes 32 KB more and still leaves two blocks an SM."""
    assert core.pick_wblk(8192, 3072) == 4096
    span = gather_probes.plan(64, 32, True, 132)
    assert span == (4, 128, 3)
    assert gather_probes.window_shared_bytes(32, 128 * 32, span.chunk_rows, span.stages) == 82072
    assert gather_probes.window_shared_bytes(32, 128 * 64, span.chunk_rows, span.stages) == 114840 <= 232448 // 2
