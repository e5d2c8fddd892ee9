"""The launch plans of the FPS, ball-query, kNN, three_interpolate and window-gather kernels, on the CPU.

``ops.cuda.fps.plan``, ``ops.cuda.ballquery.plan`` (the exact kernel) and
``tiles_plan`` and ``windowed_plan`` (the windowed ones over sorted tiles),
``ops.cuda.knn.plan``,
``ops.cuda.interpolate.plan`` and ``ops.cuda.wingather.plan`` are plain Python: they take the card's answers
(resident clusters of each size, the SM count) or the rows' alignment as
arguments, so every route they can pick is checked here without a card; the
card tests in ``tests/test_torch_cuda.py`` hold each route's kernel against
its plain version.
"""

import importlib
import itertools

import pytest
import torch

from pointnet2_tpu_torch.ops import core
from pointnet2_tpu_torch.ops.cuda import ballquery as bq
from pointnet2_tpu_torch.ops.cuda import fps
from pointnet2_tpu_torch.ops.cuda import interpolate
from pointnet2_tpu_torch.ops.cuda import wingather
from pointnet2_tpu_torch.tools import op_bench

# The package's ``knn`` is the wrapper function; the module is reached by name.
knn = importlib.import_module("pointnet2_tpu_torch.ops.cuda.knn")

# What an H100 SXM answers for the routes of 8192 points (132 SMs in GPCs
# that take 58 clusters of 16 and 124 of 8) and two cards that hold fewer clusters.
RESIDENT = {
    "h100": {16: 58, 8: 124, 4: 124, 2: 132, 1: 1056},
    "no_16": {16: 0, 8: 16, 4: 32, 2: 64, 1: 256},
    "small": {16: 1, 8: 2, 4: 4, 2: 8, 1: 16},
}
GRID_N = sorted(n for n in {*range(1, 600, 37), *(2**k + d for k in range(5, 18) for d in (-1, 0, 1)),
                            *range(1000, fps.MAX_POINTS + 1, 4093)} if n <= fps.MAX_POINTS)


def test_fps_candidates_cover_every_n():
    """Every route the plan weighs holds N, in blocks the kernel takes."""
    for n in GRID_N:
        cands = fps.candidates(n)
        assert cands, n
        for c, (threads, ppt) in cands.items():
            assert c in fps.CLUSTERS and c <= 16 and c & (c - 1) == 0
            assert ppt in fps.PPTS and threads % 32 == 0 and 32 <= threads <= fps.max_threads(ppt)
            s = fps.slice_points(n, c)
            assert c * s >= n > (c - 1) * s and threads * ppt >= s
            assert threads * ppt < s + 32 * ppt  # no warp of the block holds nothing but padding
            assert fps.check_plan(n, (c, threads, ppt)) == (c, threads, ppt)
            assert c == 1 or n >= c * fps.MIN_BLOCK_POINTS


@pytest.mark.parametrize("card", sorted(RESIDENT))
def test_fps_plan_keeps_all_clusters_resident(card):
    resident = RESIDENT[card]
    for n, b in itertools.product(GRID_N, (1, 2, 8, 16, 33, 200)):
        cands = fps.candidates(n)
        if not any(resident[k] for k in cands):  # past 65536 points only a cluster of 16 holds a cloud
            with pytest.raises(ValueError, match="no FPS route"):
                fps.plan(b, n, resident)
            continue
        c, threads, ppt = fps.plan(b, n, resident)
        assert cands[c] == (threads, ppt) and c & (c - 1) == 0 and c <= 16
        fitting = [k for k in cands if 0 < resident[k] and resident[k] >= b]
        if fitting:
            # The largest cluster that keeps all B clusters resident at once.
            assert c == max(fitting) and resident[c] >= b
        else:
            # No route runs in one wave: the fewest waves, the larger cluster among equals.
            waves = {k: -(-b // resident[k]) for k in cands if resident[k] > 0}
            assert -(-b // resident[c]) == min(waves.values())
            assert c == max(k for k, w in waves.items() if w == waves[c])


def test_fps_plan_at_the_model_shapes():
    """The routes an H100 takes for a B=8 predict chunk and a B=16 train batch."""
    h100 = RESIDENT["h100"]
    assert fps.plan(8, 8192, h100) == (8, 128, 8)
    assert fps.plan(16, 8192, h100) == (8, 128, 8)
    assert fps.plan(16, 8192, {**h100, 8: 15}) == (4, 256, 8)
    assert fps.plan(16, 1024, h100) == (1, 128, 8)
    assert fps.plan(16, 256, h100) == (1, 128, 2)
    assert fps.plan(16, 64, h100) == (1, 64, 1)
    assert fps.plan(1, fps.MAX_POINTS, h100) == (16, 512, 16)


@pytest.mark.parametrize(
    "b,n,resident",
    [(0, 100, RESIDENT["h100"]), (1, 0, RESIDENT["h100"]), (1, fps.MAX_POINTS + 1, RESIDENT["h100"]),
     (1, fps.MAX_POINTS, RESIDENT["no_16"]), (4, 8192, {c: 0 for c in fps.CLUSTERS})],
)
def test_fps_plan_refuses_what_no_route_takes(b, n, resident):
    with pytest.raises(ValueError):
        fps.plan(b, n, resident)


@pytest.mark.parametrize(
    "n,route",
    [(8192, (8, 128, 4)), (8192, (16, 32, 8)), (8193, (8, 128, 8)), (100, (3, 128, 1)), (100, (1, 100, 1)), (100, (1, 1024, 8)),
     (100, (1, 128, 32)), (100, (32, 32, 1))],
)
def test_fps_check_plan_refuses_bad_routes(n, route):
    with pytest.raises(ValueError):
        fps.check_plan(n, route)


def test_ball_query_plan_fits_shared_memory():
    for b, n, m, sms in itertools.product((1, 2, 8, 16, 300), GRID_N[::3], (1, 37, 256, 1024, 4096), (1, 132)):
        warps, tile = bq.plan(b, n, m, sms)
        assert 1 <= warps <= bq.MAX_WARPS and warps & (warps - 1) == 0
        assert tile % 32 == 0 and 32 <= tile <= bq.TILE_POINTS
        assert tile >= n or tile == bq.TILE_POINTS
        assert bq.shared_bytes(n, tile) <= min(2 * bq.TILE_POINTS * 12, bq.MAX_SHARED_BYTES)
        assert bq.check_plan(n, (warps, tile)) == (warps, tile)
        blocks = b * -(-m // (warps * bq.QUERIES_PER_WARP))
        # The largest block that still leaves a block for every other SM, where one can.
        assert 2 * blocks >= sms or warps == 1
        assert warps == bq.MAX_WARPS or 2 * b * -(-m // (2 * warps * bq.QUERIES_PER_WARP)) < sms


def test_ball_query_plan_at_the_model_shapes():
    assert bq.plan(8, 8192, 1024, 132) == (16, 4096)
    assert bq.plan(16, 8192, 1024, 132) == (16, 4096)
    assert bq.plan(16, 1024, 256, 132) == (8, 1024)
    assert bq.plan(16, 64, 16, 132) == (1, 64)
    assert bq.shared_bytes(8192, 4096) == 2 * 4096 * 12
    assert bq.shared_bytes(1024, 1024) == 1024 * 12


TILE_SHAPES = [(m, tm, w) for m, tm in ((1024, 128), (256, 128), (128, 128), (64, 64), (100, 100), (4096, 128))
               for w in (128, 512, 3072, 14528, 16384)]


@pytest.mark.parametrize("sms", [132, 114, 16])
def test_tiles_plan_fills_the_card_or_stops(sms):
    """Every split divides the tile; it doubles until the blocks' warps fill
    each SM to TILES_WARPS_PER_SM, or until halving would leave a block fewer
    than TILES_MIN_QUERIES queries; one warp a query up to TILES_MAX_WARPS."""
    for (m, tm, w), b in itertools.product(TILE_SHAPES, (1, 2, 8, 16, 65)):
        split, warps = bq.tiles_plan(b, m, tm, w, sms)
        assert bq.check_tiles_plan(m, tm, (split, warps)) == (split, warps)
        assert tm % split == 0 and split & (split - 1) == 0
        assert warps == min(bq.TILES_MAX_WARPS, tm // split)
        staged = 16 * w <= bq.MAX_SHARED_BYTES
        held = min(bq.SM_SHARED_BYTES // (16 * w + 1024) if staged else 32, 64 // warps)
        fills = min(b * (m // tm) * split, held * sms) * warps >= bq.TILES_WARPS_PER_SM * sms
        halves = tm % (2 * split) == 0 and tm // (2 * split) >= bq.TILES_MIN_QUERIES
        assert fills or not halves
        if split > 1:  # the split before did not fill the card
            prev = min(bq.TILES_MAX_WARPS, 2 * tm // split)
            held = min(bq.SM_SHARED_BYTES // (16 * w + 1024) if staged else 32, 64 // prev)
            assert min(b * (m // tm) * split // 2, held * sms) * prev < bq.TILES_WARPS_PER_SM * sms


def test_tiles_plan_at_the_model_shapes():
    """SA1 of semantic.json with the production window: 8 blocks a tile at the
    B=8 predict chunk, 4 at the B=16 train batch, 16 warps each, on an H100."""
    assert bq.tiles_plan(8, 1024, 128, 3072, 132) == (8, 16)
    assert bq.tiles_plan(16, 1024, 128, 3072, 132) == (4, 16)
    assert bq.tiles_plan(1, 1024, 128, 16384, 132) == (16, 8)
    assert bq.tiles_plan(1, 128, 128, 512, 132) == (16, 8)
    assert bq.tiles_plan.cache_info().currsize > 0  # cached, as the other plans


@pytest.mark.parametrize("route", [(0, 16), (3, 16), (256, 1), (8, 0), (8, 33)])
def test_tiles_check_plan_refuses_bad_routes(route):
    with pytest.raises(ValueError, match="route"):
        bq.check_tiles_plan(1024, 128, route)


@pytest.mark.parametrize("b,m,tm,w", [(0, 1024, 128, 3072), (8, 1000, 128, 3072), (8, 1024, 128, 0)])
def test_tiles_plan_refuses_what_no_route_takes(b, m, tm, w):
    with pytest.raises(ValueError, match="tiles"):
        bq.tiles_plan(b, m, tm, w, 132)


@pytest.mark.parametrize("b,n,m", [(0, 10, 10), (1, 0, 10), (1, 10, 0), (2**24, 10, 2**14)])
def test_ball_query_plan_refuses_what_no_route_takes(b, n, m):
    with pytest.raises(ValueError):
        bq.plan(b, n, m, 132)


@pytest.mark.parametrize(
    "n,route", [(8192, (0, 128)), (8192, (17, 128)), (8192, (4, 16)), (8192, (4, 100)), (40000, (4, 9728))],
)
def test_ball_query_check_plan_refuses_bad_routes(n, route):
    """Warps past 16, tiles off the 32-multiples, two buffers past shared memory."""
    with pytest.raises(ValueError):
        bq.check_plan(n, route)


# The FP levels of semantic.json: (dense queries, coarse references).
FP_LEVELS = [(64, 16), (256, 64), (1024, 256), (8192, 1024)]
KNN_GRID = sorted({*FP_LEVELS, (1, 1), (7, 3), (100, 40), (37, 1500), (8192, 8192), (65536, 64), (3, 100000)})


@pytest.mark.parametrize("k", [1, 3, 16, 17, 64])
def test_knn_plan_covers_the_grid(k):
    for (nq, m), b, sms in itertools.product(KNN_GRID, (1, 2, 8, 16, 300), (1, 132)):
        if k > m:
            with pytest.raises(ValueError):
                knn.plan(b, nq, m, k, sms)
            continue
        lanes, threads = knn.plan(b, nq, m, k, sms)
        assert knn.check_plan(b, nq, k, (lanes, threads)) == (lanes, threads)
        assert lanes in (1, 2, 4, 8, 16, 32) and threads % 32 == 0 and 32 <= threads
        if k > knn.MAX_REGISTER_K:
            assert lanes == 32 and threads == 32 * knn.LIST_WARPS
            continue
        assert threads <= knn.MAX_THREADS and threads <= -(-nq * lanes // 32) * 32
        # Every lane keeps its floor of points, and the lanes stop doubling once
        # the launch has its threads an SM.
        assert lanes == 1 or m // lanes >= knn.MIN_REFS_PER_LANE
        assert lanes == 1 or b * nq * (lanes // 2) < sms * knn.TARGET_THREADS_PER_SM
        fills = b * nq * lanes >= sms * knn.TARGET_THREADS_PER_SM
        assert fills or lanes == 32 or m // (2 * lanes) < knn.MIN_REFS_PER_LANE


def test_knn_plan_at_the_model_shapes():
    """The routes an H100 (132 SMs) takes at the four FP levels, B=8 and B=16."""
    want = {
        8: [(1, 64), (4, 256), (8, 256), (1, 256)],
        16: [(1, 64), (4, 256), (4, 256), (1, 256)],
    }
    for b, routes in want.items():
        assert [knn.plan(b, nq, m, 3, 132) for nq, m in FP_LEVELS] == routes
    assert knn.plan(16, 8192, 1024, 32, 132) == (32, 128)
    assert knn.plan(1, 64, 29056, 29056, 132) == (32, 32)


@pytest.mark.parametrize(
    "b,nq,m,k", [(0, 10, 10, 3), (1, 0, 10, 3), (1, 10, 0, 1), (1, 10, 5, 6), (1, 10, 40000, 29057), (2**24, 2**20, 64, 3)],
)
def test_knn_plan_refuses_what_no_route_takes(b, nq, m, k):
    with pytest.raises(ValueError):
        knn.plan(b, nq, m, k, 132)


@pytest.mark.parametrize(
    "k,route", [(3, (3, 256)), (3, (64, 256)), (3, (1, 512)), (3, (4, 100)), (3, (4, 0)), (17, (16, 128)),
                (17, (32, 512)), (29056, (32, 64)), (1024, (32, 8 * 32 * 8))],
)
def test_knn_check_plan_refuses_bad_routes(k, route):
    """Lanes off the powers of two, blocks past 256 threads (register route) or
    8 warps (list route), a list route whose lists pass shared memory."""
    with pytest.raises(ValueError):
        knn.check_plan(2, 1024, k, route)


@pytest.mark.parametrize("k,route,b", [(3, (1, 32), 2**16), (64, (32, 256), 2**14)])
def test_knn_check_plan_refuses_a_grid_past_int(k, route, b):
    """A forced route is held to the grid limit the plan keeps: ``b`` clouds
    of 2**20 queries, 32 or 8 queries a block, make 2**31 blocks; half as
    many clouds launch."""
    with pytest.raises(ValueError, match="grid"):
        knn.check_plan(b, 2**20, k, route)
    assert knn.check_plan(b // 2, 2**20, k, route) == route


def test_knn_limits():
    assert knn.MAX_K == 29056 and knn.MAX_K >= 1024
    assert knn.check_plan(1, 1024, 1024, (32, 256)) == (32, 256)  # k = 1024 at M = 1024 in a full list block


@pytest.mark.parametrize(
    "c,c1,aligned,skip_ok,want",
    [
        (128, 3, True, False, (False, False)),  # FP4: rows of 131 floats, 4-byte accesses
        (256, 64, True, True, (True, True)),  # FP3
        (256, 128, True, True, (True, True)),  # FP2
        (512, 256, True, True, (True, True)),  # FP1
        (256, 192, True, True, (True, True)),  # MSG's FP2: SA2's two scales, 64 + 128 skip channels
        (256, 96, True, True, (True, True)),  # MSG's FP3: SA1's two scales, 32 + 64
        (512, 0, True, False, (True, False)),  # no skip
        (64, 64, False, True, (False, False)),  # points off a 16-byte boundary
        (7, 5, True, False, (False, False)),
        (8, 4, True, False, (True, False)),
        (3, 0, True, False, (False, False)),
        (16, 6, True, True, (False, False)),
        (16, 4, True, False, (True, False)),  # a skip whose rows are not aligned: copied 4 bytes at a time
    ],
)
def test_three_interpolate_plan(c, c1, aligned, skip_ok, want):
    assert interpolate.plan(c, c1, aligned, skip_ok) == want


@pytest.mark.parametrize(
    "c,c1,aligned,skip_ok,want",
    [
        (128, 3, True, False, (False, False)),  # FP4 in bfloat16: rows of 131, one element a lane
        (256, 64, True, True, (True, True)),  # FP3: 8 bfloat16 a 16-byte access
        (512, 256, True, True, (True, True)),  # FP1
        (256, 192, True, True, (True, True)),  # MSG's FP2
        (256, 96, True, True, (True, True)),  # MSG's FP3
        (256, 4, True, True, (False, False)),  # C + C1 not a multiple of 8
        (12, 4, True, False, (False, False)),  # C not a multiple of 8 (float32 would take it)
        (256, 64, True, False, (True, False)),  # a float32 skip in a float32 row beside bfloat16 points
        (64, 64, False, True, (False, False)),  # points off a 16-byte boundary
    ],
)
def test_three_interpolate_plan_bf16(c, c1, aligned, skip_ok, want):
    assert interpolate.plan(c, c1, aligned, skip_ok, elem=2) == want


def test_three_interpolate_route_of_bfloat16_tensors():
    """The wrapper's plan reads the element size and the skip's type off the tensors."""
    points = torch.zeros(2, 16, 256, dtype=torch.bfloat16)
    assert interpolate.planned_route(points, torch.zeros(2, 32, 64, dtype=torch.bfloat16)) == (True, True)
    # A float32 skip makes the row float32 and is copied 16 bytes at a time;
    # a bfloat16 skip in a float32 row is widened element by element.
    assert interpolate.planned_route(points, torch.zeros(2, 32, 64, dtype=torch.float32)) == (True, True)
    assert interpolate.planned_route(points.float(), torch.zeros(2, 32, 64, dtype=torch.bfloat16)) == (True, False)
    assert interpolate.planned_route(points[..., :12].contiguous()) == (False, False)
    assert interpolate.out_dtype(points, torch.zeros(1, dtype=torch.float32)) == torch.float32
    g = torch.zeros(2, 32, 131, dtype=torch.bfloat16)
    assert interpolate.grad_vec(g[..., :128], 128) is False and interpolate.grad_vec(g[..., :128].contiguous(), 128)
    assert interpolate.round_weights("default", torch.bfloat16) and not interpolate.round_weights("default", torch.float32)
    with pytest.raises(ValueError, match="precision"):
        interpolate.round_weights("low", torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row", [448, 352])
def test_three_interpolate_grad_reads_msg_cotangents_in_vectors(row, dtype):
    """MSG's FP2 and FP3 hand the backward the first 256 channels of a
    448- or 352-wide concat cotangent: both strides multiples of 4."""
    g = torch.zeros(2, 32, row, dtype=dtype)[..., :256]
    assert not g.is_contiguous() and interpolate.grad_vec(g, 256)


def test_three_interpolate_plan_refuses_empty_rows():
    with pytest.raises(ValueError):
        interpolate.plan(0, 3, True, False)


# -- the window gather (row 9) -------------------------------------------------------


@pytest.mark.parametrize(
    "c,aligned,want",
    [
        (32, True, (True, 8)),  # SA1's projected rows: 8 vectors, a lane each
        (16, True, (True, 4)),  # MSG's SA1 scale0 (f0 = 16): 4 vectors, a lane each
        (16, False, (False, 16)),  # the same rows off a 16-byte boundary: a float a lane
        (32, False, (False, 16)),  # the same rows off a 16-byte boundary: floats, 2 a lane
        (4, True, (True, 1)),
        (64, True, (True, 16)),
        (72, True, (True, 16)),  # 18 vectors: past the top lane count, a loop
        (128, True, (True, 16)),
        (7, True, (False, 8)),  # one lane of 8 idle
        (3, True, (False, 4)),
        (1, True, (False, 1)),
        (33, False, (False, 16)),
        (12, True, (True, 4)),  # 3 vectors
    ],
)
def test_window_gather_plan(c, aligned, want):
    assert wingather.plan(c, aligned) == want


def test_window_gather_plan_refuses_empty_rows():
    with pytest.raises(ValueError):
        wingather.plan(0, True)


@pytest.mark.parametrize("route", [(True, 8), (False, 3), (False, 32), (False, 0)])
def test_window_gather_check_route_refuses_bad_routes(route):
    with pytest.raises(ValueError, match="route"):
        wingather.check_route(route, vec_ok=False)


@pytest.mark.parametrize("route", [(v, lanes) for v in (True, False) for lanes in wingather.GATHER_LANES])
def test_window_gather_check_route_takes_every_built_route(route):
    assert wingather.check_route(route, vec_ok=True) == route


def test_window_gather_planned_route_follows_the_source_alignment():
    """A contiguous source 4 bytes off a 16-byte boundary takes the float
    route, and refuses a forced vector one."""
    aligned = torch.zeros(2, 64, 32)
    offset = torch.zeros(2 * 64 * 32 + 1)[1:].view(2, 64, 32)
    assert aligned.data_ptr() % 16 == 0 and offset.data_ptr() % 16 == 4 and offset.is_contiguous()
    assert wingather.planned_route(aligned) == (True, 8)
    assert wingather.planned_route(offset) == (False, 16)
    assert wingather.planned_route(offset, route=(False, 4)) == (False, 4)
    with pytest.raises(ValueError, match="route"):
        wingather.planned_route(offset, route=(True, 8))


def test_window_gather_sweep_covers_every_route():
    assert len(op_bench.gather_routes(32, True)) == 2 * len(wingather.GATHER_LANES)
    assert all(not vec for vec, _ in op_bench.gather_routes(7, True))
    assert len(set(map(op_bench.gather_route_key, op_bench.gather_routes(32, True)))) == 10


def _gather_picks(seed, b, n, m, tiles, k, w):
    gen = torch.Generator().manual_seed(seed)
    lo = torch.randint(0, n - w + 1, (b, tiles), generator=gen, dtype=torch.int32)
    pos = torch.randint(0, w, (b, m, k), generator=gen, dtype=torch.int32)
    return lo, pos


@pytest.mark.parametrize(
    "b,n,m,tiles,k,c,w",
    [
        (1, 64, 8, 1, 4, 4, 16), (2, 256, 32, 4, 5, 7, 64), (3, 100, 12, 3, 3, 33, 100), (2, 512, 64, 8, 8, 32, 128),
        (1, 8192, 1024, 8, 32, 32, 3072),  # one cloud at SA1 with the production window
    ],
)
def test_gather_source_rows_name_the_plain_gathers_rows(b, n, m, tiles, k, c, w):
    """``index_select`` of the flat source at these rows is the window gather:
    the library call and the bound read the rows the gather copies."""
    lo, pos = _gather_picks(b * n + k, b, n, m, tiles, k, w)
    zp = torch.randn((b, n, c), generator=torch.Generator().manual_seed(5))
    rows = op_bench.gather_source_rows(lo, pos, n)
    assert rows.dtype == torch.int64 and rows.shape == (b * m * k,)
    got = torch.index_select(zp.reshape(b * n, c), 0, rows).view(b, m, k, c)
    assert torch.equal(got, core.window_gather(zp, lo, pos))


@pytest.mark.parametrize(
    "lo,pos,n,picked",
    [
        ([[0]], [[[3, 3, 3]]], 8, 1),  # one row picked three times: read once
        ([[0]], [[[0, 1, 2]]], 8, 3),
        ([[0, 1]], [[[0, 1], [0, 1]]], 8, 3),  # two tiles whose windows overlap: rows 0, 1, 2
        ([[1], [1]], [[[0, 4]], [[0, 4]]], 8, 4),  # the same picks in two clouds are different rows
        ([[0]], [[[7, 7], [6, 7]]], 8, 2),  # picks at N - 1
    ],
)
def test_window_gather_bound_reads_each_picked_row_once(lo, pos, n, picked):
    lo = torch.tensor(lo, dtype=torch.int32)
    pos = torch.tensor(pos, dtype=torch.int32)
    c = 4
    rows = op_bench.gather_source_rows(lo, pos, n)
    outputs = pos.numel()
    assert op_bench.work_window_gather(lo, rows, c) == (
        picked * c * 4 + lo.numel() * 4 + outputs * 4 + outputs * c * 4, 0)


# -- the round-1 windowed ball query (row 11) and the windowed kNN (row 10) ----------

# semantic.json's SA1-SA3 with the round-1 default window max(2 nsample, N // 4):
# (N, M, tm, w), and a cloud whose window passes shared memory.
WINDOWED_LEVELS = [(8192, 1024, 128, 2048), (1024, 256, 128, 256), (256, 64, 64, 128)]


@pytest.mark.parametrize("sms", [132, 16])
def test_windowed_plan_is_the_tiles_plan_for_its_buffer(sms):
    """The tiles plan for blocks that stage up to min(N, w) columns, down to
    WINDOWED_MIN_QUERIES queries a block."""
    for (n, m, tm, w), b in itertools.product([*WINDOWED_LEVELS, (65536, 1024, 128, 16384), (100, 128, 128, 384)],
                                              (1, 8, 16, 65)):
        route = bq.windowed_plan(b, n, m, tm, w, sms)
        assert route == bq.tiles_plan(b, m, tm, min(n, w), sms, bq.WINDOWED_MIN_QUERIES)
        split, warps = route
        assert tm // split >= min(tm, bq.WINDOWED_MIN_QUERIES) and warps == min(bq.TILES_MAX_WARPS, tm // split)


def test_windowed_plan_covers_the_card_at_the_model_shapes():
    """On an H100 (132 SMs) at B=16 every level launches at least a block an
    SM (the kernel before ran one block a tile: 128, 32 and 16), and SA1
    takes the calibrated kernel's split."""
    blocks = {}
    for b in (8, 16):
        for n, m, tm, w in WINDOWED_LEVELS:
            split, warps = bq.windowed_plan(b, n, m, tm, w, 132)
            blocks[b, n] = b * (m // tm) * split
    assert bq.windowed_plan(16, 8192, 1024, 128, 2048, 132) == (4, 16)
    assert bq.windowed_plan(8, 8192, 1024, 128, 2048, 132) == (8, 16)
    assert all(blocks[16, n] >= 132 for n, *_ in WINDOWED_LEVELS)
    assert blocks[16, 1024] == 1024 and blocks[16, 256] == 256 and blocks[8, 1024] == 512
    assert bq.windowed_plan.cache_info().currsize > 0


def test_windowed_plan_keeps_the_tiles_plan_as_it_was():
    """The calibrated kernel's plan (rows 7 and 8) does not move: 8 queries a
    block at the fewest."""
    assert bq.tiles_plan(1, 128, 128, 512, 132) == (16, 8)
    assert bq.tiles_plan(1, 128, 128, 512, 132, bq.WINDOWED_MIN_QUERIES) == (32, 4)


@pytest.mark.parametrize("b", [65535, 65536, 2**20])
def test_windowed_plan_takes_any_number_of_clouds(b):
    """The round-1 kernel's grid is one dimension of clouds x tiles x split
    blocks: past 65535 clouds the plan still gives a route, one block a tile
    (the card is full), and its blocks fit the grid."""
    for n, m, tm, w in WINDOWED_LEVELS:
        split, warps = bq.windowed_plan(b, n, m, tm, w, 132)
        assert split == 1 and warps == min(bq.TILES_MAX_WARPS, tm)
        assert b * (m // tm) < 2**31
