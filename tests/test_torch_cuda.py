"""The CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and carries the ``cuda``
marker; without a card each one skips (the ``cuda_device`` fixture decides,
at run time). The file imports neither JAX nor the JAX package, so it runs
on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerances: FPS, ball query and kNN equal bit for bit, and so do the four
calibrated-window kernels (the windowed ball query, with and without window
columns, the window gather and the windowed kNN) and their ``ok``;
three_interpolate
within rtol=1e-6, atol=1e-6 (it is exact by construction; the tolerance is
the one ``chip_smoke.py`` holds it to); three_interpolate_grad bit for bit,
and the same on two runs: it sums each element in its plain version's order
(slot j, then the queries ascending), which ``index_add_`` keeps on the CPU
and, for rows wider than 32 floats, on the card under PyTorch's
deterministic algorithms (``utils.bench.deterministic_algorithms``, which
the plain side of those comparisons runs under). Autograd through the plain forward sums the same addends query by
query instead, so that comparison keeps rtol=1e-5, atol=1e-5
(``AUTOGRAD_ORDER_TOL``). The train step's kernel path against its plain
path: both under deterministic algorithms, two kernel-path steps equal, each
gradient within 1e-3 of its max abs of the plain path's.
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.ops import core, cuda, library
from pointnet2_tpu_torch.ops.cuda import ballquery as cuda_bq
from pointnet2_tpu_torch.ops.cuda import fps as cuda_fps
from pointnet2_tpu_torch.ops.cuda import interpolate as cuda_interp
from pointnet2_tpu_torch.ops.cuda import wingather as cuda_gather
from pointnet2_tpu_torch.utils.bench import deterministic_algorithms
from test_torch_library import _inputs as pn2_inputs

# The package's ``knn`` is the wrapper function; the module is reached by name.
cuda_knn = importlib.import_module("pointnet2_tpu_torch.ops.cuda.knn")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cloud(seed, b, n, scale=2.0, device="cuda"):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.rand(b, n, 3) * scale).astype(np.float32)).to(device)


@pytest.mark.parametrize("b,n,m", [(2, 128, 16), (1, 200, 32), (3, 1000, 100), (2, 8192, 64), (1, 1, 1)])
def test_fps_centroids_kernel(cuda_device, b, n, m):
    xyz = _cloud(0, b, n)
    idx, cent = ops.fps_centroids(xyz, m, impl="cuda")
    want_idx, want_cent = ops.fps_centroids(xyz, m, impl="torch")
    assert idx.dtype == torch.int32
    assert torch.equal(idx, want_idx) and torch.equal(cent, want_cent)


@pytest.mark.parametrize(
    "b,n,m,radius,nsample",
    [(2, 128, 128, 0.3, 8), (1, 300, 100, 0.5, 4), (2, 64, 37, 0.8, 16), (1, 16, 20, 1.5, 32),
     (2, 4096, 256, 0.25, 32),
     (2, 8192, 1024, 0.25, 16), (2, 1024, 256, 0.5, 16)],  # MSG's SA1 and SA2 scale0: half radius, k = 16
)
def test_ball_query_kernel(cuda_device, b, n, m, radius, nsample):
    xyz1 = _cloud(1, b, n, scale=1.0)
    xyz2 = _cloud(2, b, m, scale=1.0)
    idx, cnt = ops.ball_query(xyz1, xyz2, radius, nsample, impl="cuda")
    want_idx, want_cnt = ops.ball_query(xyz1, xyz2, radius, nsample, impl="torch")
    assert torch.equal(cnt, want_cnt) and torch.equal(idx, want_idx)


def test_ball_query_kernel_on_the_boundary(cuda_device):
    """Points exactly on and 1 ulp off the sphere: FMA contraction would flip them."""
    q = torch.tensor([[[0.25, 0.5, 0.75]]], device=cuda_device).repeat(1, 6, 1)
    on = q[0, 0].clone()
    on[0] += 0.5
    pts = [on]
    for direction in (-1.0, 1.0):
        p = on.clone()
        p[0] = torch.nextafter(p[0], torch.tensor(direction * float("inf"), device=cuda_device))
        pts.append(p)
    data = torch.stack(pts)[None].contiguous()
    idx, cnt = ops.ball_query(data, q, 0.5, 4, impl="cuda")
    want_idx, want_cnt = ops.ball_query(data, q, 0.5, 4, impl="torch")
    assert torch.equal(cnt, want_cnt) and torch.equal(idx, want_idx)
    assert int(cnt[0, 0]) == 1 and int(idx[0, 0, 0]) == 1  # only the point 1 ulp inside


@pytest.mark.parametrize("b,m,nq,k", [(2, 64, 100, 3), (1, 16, 64, 1), (2, 1500, 37, 5), (1, 20, 20, 16),
                                      (2, 1024, 8192, 3)])
def test_knn_kernel(cuda_device, b, m, nq, k):
    refs = _cloud(3, b, m)
    queries = _cloud(4, b, nq)
    dist, idx = ops.knn(refs, queries, k, impl="cuda")
    want_dist, want_idx = ops.knn(refs, queries, k, impl="torch")
    assert torch.equal(idx, want_idx) and torch.equal(dist, want_dist)


def test_knn_kernel_ties(cuda_device):
    g = torch.stack(torch.meshgrid(torch.arange(3.0), torch.arange(3.0), torch.arange(2.0), indexing="ij"), -1)
    g = g.reshape(-1, 3)
    refs = torch.cat([g, g.flip(0)])[None].to(cuda_device).contiguous()
    queries = torch.tensor([[[0.5, 0.5, 0.5], [1, 1, 0], [2, 0, 1]]], device=cuda_device)
    dist, idx = ops.knn(refs, queries, 6, impl="cuda")
    want_dist, want_idx = ops.knn(refs, queries, 6, impl="torch")
    assert torch.equal(idx, want_idx) and torch.equal(dist, want_dist)


@pytest.mark.parametrize("b,m,c,n", [(2, 16, 512, 64), (1, 100, 7, 37), (2, 1024, 128, 8192)])
def test_three_interpolate_kernel(cuda_device, b, m, c, n):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    points = torch.randn((b, m, c), generator=gen, device=cuda_device)
    dist, idx = ops.three_nn(_cloud(6, b, n), _cloud(7, b, m), impl="cuda")
    weight = ops.interpolation_weights(dist)
    got = ops.three_interpolate(points, idx, weight, impl="cuda")
    want = ops.three_interpolate(points, idx, weight, impl="torch")
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,skip", [(64, 256, 192), (256, 1024, 96)])
def test_three_interpolate_kernel_with_msg_skips(cuda_device, m, n, skip, dtype):
    """MSG's FP2 and FP3: 256 interpolated channels beside SA2's and SA1's
    concatenated scales (192 and 96 channels), on the 16-byte route, in
    float32 and in bfloat16 (the bf16 modes, bit for bit)."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    points = torch.randn((8, m, 256), generator=gen, device=cuda_device).to(dtype)
    skip_feats = torch.randn((8, n, skip), generator=gen, device=cuda_device).to(dtype)
    dist, idx = ops.three_nn(_cloud(6, 8, n), _cloud(7, 8, m), impl="cuda")
    weight = ops.interpolation_weights(dist)
    precision = "default" if dtype == torch.bfloat16 else None
    assert cuda_interp.planned_route(points, skip_feats) == (True, True)
    got = ops.three_interpolate(points, idx, weight, impl="cuda", precision=precision, skip=skip_feats)
    want = ops.three_interpolate(points, idx, weight, impl="torch", precision=precision, skip=skip_feats)
    assert got.shape == (8, n, 256 + skip) and torch.equal(got[..., 256:], skip_feats)
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# Autograd through the plain forward sums a row's addends query by query, not
# slot by slot as the backward kernel and its plain version do.
AUTOGRAD_ORDER_TOL = dict(rtol=1e-5, atol=1e-5)


def _grad_inputs(b, m, c, n, device, skip=0):
    """A seeded cotangent (the first C channels of a (B, N, C + skip) tensor,
    as the FP concat's backward hands it over, when ``skip``), the 3-NN
    indices and weights of seeded clouds."""
    gen = torch.Generator(device=device).manual_seed(11)
    g = torch.randn((b, n, c + skip), generator=gen, device=device)[..., :c]
    dist, idx = ops.three_nn(_cloud(12, b, n), _cloud(13, b, m), impl="cuda")
    return g, idx, ops.interpolation_weights(dist)


def _plain_grad(g, idx, weight, m):
    """The plain backward in its fixed order: on the CPU, where ``index_add_``
    sums serially (``tests/test_torch_grad_order.py``), and, for rows wider
    than 32 floats, on the card under deterministic algorithms, which gives
    the same bits (for narrower rows PyTorch's deterministic ``index_add_``
    adds each call's sum of a row's addends to the row instead)."""
    want = ops.three_interpolate_grad(g.cpu(), idx.cpu(), weight.cpu(), m, impl="torch").to(g.device)
    if g.shape[2] > 32:
        with deterministic_algorithms():
            assert torch.equal(ops.three_interpolate_grad(g, idx, weight, m, impl="torch"), want)
    return want


@pytest.mark.parametrize(
    "b,m,c,n,skip",
    [(16, 16, 512, 64, 256), (16, 64, 256, 256, 128), (16, 256, 256, 1024, 64), (16, 1024, 128, 8192, 3),
     (16, 16, 512, 64, 0), (16, 1024, 128, 8192, 0),  # the train step's, strided as it hands them over, and not
     (16, 64, 256, 256, 192), (16, 256, 256, 1024, 96),  # MSG's FP2 and FP3: 448- and 352-wide cotangents
     (2, 100, 7, 37, 0), (1, 3, 33, 50, 0)],  # C off the multiples of 32; M = 3: every query names every row
)
def test_three_interpolate_grad_kernel(cuda_device, b, m, c, n, skip):
    g, idx, weight = _grad_inputs(b, m, c, n, cuda_device, skip)
    got = ops.three_interpolate_grad(g, idx, weight, m, impl="cuda")
    assert got.shape == (b, m, c) and got.is_contiguous()
    assert torch.equal(got, _plain_grad(g, idx, weight, m))
    assert torch.equal(got, ops.three_interpolate_grad(g, idx, weight, m, impl="cuda"))  # the same bits again


def test_three_interpolate_grad_kernel_takes_a_non_contiguous_cotangent(cuda_device):
    g, idx, weight = _grad_inputs(2, 64, 40, 256, cuda_device)
    wide = torch.cat([g, torch.ones_like(g)], dim=-1)[..., :40]
    assert not wide.is_contiguous()
    got = cuda.three_interpolate_grad(wide, idx, weight, 64)
    want = cuda.three_interpolate_grad(g, idx, weight, 64)
    assert torch.equal(got, want) and torch.equal(want, _plain_grad(g, idx, weight, 64))
    # Read in place through its strides: the second half of a concat, and a
    # slice along the batch and the rows; copied first: channels that do not
    # lie next to each other (a transpose, a broadcast).
    tail = torch.cat([torch.ones_like(g), g], dim=-1)[..., 40:]
    assert torch.equal(cuda.three_interpolate_grad(tail, idx, weight, 64), want)
    padded = torch.zeros((4, 300, 40), device=cuda_device)
    padded[::2, 10:266] = g
    assert torch.equal(cuda.three_interpolate_grad(padded[::2, 10:266], idx, weight, 64), want)
    moved = g.transpose(1, 2).contiguous().transpose(1, 2)
    assert moved.stride(2) != 1
    assert torch.equal(cuda.three_interpolate_grad(moved, idx, weight, 64), want)
    ones = torch.ones((), device=cuda_device).expand(2, 256, 40)
    assert torch.equal(cuda.three_interpolate_grad(ones, idx, weight, 64),
                       cuda.three_interpolate_grad(ones.contiguous(), idx, weight, 64))
    with pytest.raises(ValueError, match="contiguous"):
        cuda.three_interpolate_grad(g, idx.transpose(1, 2).contiguous().transpose(1, 2), weight, 64)
    with pytest.raises(ValueError, match="float32"):
        cuda.three_interpolate_grad(g.double(), idx, weight, 64)


def test_three_interpolate_grad_kernel_duplicates_and_zero_weights(cuda_device):
    g = torch.tensor([[[1.0, 2.0], [3.0, 4.0]]], device=cuda_device)
    idx = torch.tensor([[[1, 1, 2], [2, 0, 0]]], dtype=torch.int32, device=cuda_device)
    weight = torch.tensor([[[0.25, 0.5, 0.25], [1.0, 0.0, 0.0]]], device=cuda_device)
    got = cuda.three_interpolate_grad(g, idx, weight, 4)
    want = torch.tensor([[[0.0, 0.0], [0.75, 1.5], [3.25, 4.5], [0.0, 0.0]]], device=cuda_device)
    assert torch.equal(got, want)  # sums of two exact binary fractions: any order gives the same
    # At FP4's train shape: queries naming one row two or three times, zero
    # weights (a -0.0 addend leaves a row +0.0), addends of mixed magnitudes,
    # rows of up to a few hundred addends (the rank-count route past 32).
    b, m, c, n = 16, 1024, 128, 8192
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    _, idx, weight = _grad_inputs(b, m, c, n, cuda_device)
    wide = torch.randn((b, n, c + 3), generator=gen, device=cuda_device)
    g = (wide * torch.pow(10.0, torch.randint(-6, 7, wide.shape, generator=gen, device=cuda_device).float()))[..., :c]
    idx = idx.clone()
    idx[:, ::7, 1] = idx[:, ::7, 0]
    idx[:, ::11, 2] = idx[:, ::11, 0]
    idx[:, ::13] = torch.randint(0, 4, (b, idx[:, ::13].shape[1], 3), generator=gen, device=cuda_device,
                                 dtype=torch.int32)
    weight = weight.clone()
    weight[:, ::5, 2] = 0.0
    got = cuda.three_interpolate_grad(g, idx, weight, m)
    assert torch.equal(got, _plain_grad(g, idx, weight, m))
    assert torch.equal(got, cuda.three_interpolate_grad(g, idx, weight, m))
    assert int(torch.bincount(idx[0].flatten().long()).max()) > 32


def test_three_interpolate_function_on_the_kernel_path(cuda_device):
    """Forward and backward through the two kernels against the plain Function,
    and against autograd through the plain forward."""
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    points = torch.randn((4, 64, 96), generator=gen, device=cuda_device, requires_grad=True)
    g, idx, weight = _grad_inputs(4, 64, 96, 256, cuda_device)
    weight = weight.requires_grad_()
    cuda.reset_launches()
    out = ops.three_interpolate(points, idx, weight)
    got_p, got_w = torch.autograd.grad(out, (points, weight), g)
    assert cuda.LAUNCHES["three_interpolate"] == 1 and cuda.LAUNCHES["three_interpolate_grad"] == 1
    with deterministic_algorithms():
        plain_p, plain_w = torch.autograd.grad(ops.three_interpolate(points, idx, weight, impl="torch"),
                                               (points, weight), g)
    assert torch.equal(got_p, plain_p) and torch.equal(got_w, plain_w)
    want_p, want_w = torch.autograd.grad(core.three_interpolate(points, idx, weight), (points, weight), g)
    torch.testing.assert_close(got_p, want_p, **AUTOGRAD_ORDER_TOL)
    torch.testing.assert_close(got_w, want_w, rtol=1e-5, atol=1e-4)


def test_fps_centroids_kernel_input_gradient(cuda_device):
    xyz = _cloud(15, 2, 300).requires_grad_()
    cot = torch.randn(2, 40, 3, device=cuda_device)
    (got,) = torch.autograd.grad(ops.fps_centroids(xyz, 40, impl="cuda")[1], (xyz,), cot)
    (want,) = torch.autograd.grad(ops.fps_centroids(xyz, 40, impl="torch")[1], (xyz,), cot)
    assert torch.equal(got, want)


def test_small_train_step_kernel_path_against_plain_path(cuda_device):
    """One Adam step, dropout off, from the same weights and batch, both paths
    under PyTorch's deterministic algorithms (the plain path's index_add_ and
    both paths' index_put_ with accumulate then sum in a fixed order): two
    kernel-path steps give the same gradients bit for bit; against the plain
    path the loss within rtol 1e-5, each parameter gradient within 1e-3 of
    its max abs (cuBLAS may sum in other orders on the two paths' shapes)."""
    _train_step_kernel_path_against_plain_path("ssg", ball_queries=4)


def test_small_msg_train_step_kernel_path_against_plain_path(cuda_device):
    """The same for the MSG model: its two dense levels query two scales each."""
    _train_step_kernel_path_against_plain_path("msg", ball_queries=6)


def _train_step_kernel_path_against_plain_path(arch: str, ball_queries: int) -> None:
    from pointnet2_tpu_torch.config import Config
    from pointnet2_tpu_torch.train import Trainer

    cfg = Config(num_point=512, batch_size=4, l1_npoint=128, l2_npoint=32, l3_npoint=16, l4_npoint=8,
                 l1_nsample=8, l2_nsample=8, l3_nsample=8, l4_nsample=8)
    rng = np.random.RandomState(16)
    points = np.concatenate([rng.rand(4, 512, 3) * [8.0, 8.0, 4.9], rng.rand(4, 512, 3)], -1).astype(np.float32)
    batch = {"points": points, "labels": rng.randint(0, 9, (4, 512)),
             "weights": (rng.rand(4, 512) * (rng.rand(4, 512) > 0.25)).astype(np.float32)}
    runs = {}
    with deterministic_algorithms():
        for run, impl in (("kernel", None), ("again", None), ("plain", "torch")):
            trainer = Trainer(cfg, ops_impl=impl, dropout_rate=0.0, arch=arch)
            trainer.init_state(seed=0, bn_stats="random")
            cuda.reset_launches()
            metrics = trainer.train_step(batch)
            runs[run] = (metrics, {k: p.grad.clone() for k, p in trainer.model.named_parameters()},
                         dict(cuda.LAUNCHES))
    (got, got_grads, launches), (want, want_grads, plain_launches) = runs["kernel"], runs["plain"]
    assert launches == {**{k: 4 for k in ("fps_centroids", "knn", "three_interpolate", "three_interpolate_grad")},
                        "ball_query": ball_queries}
    assert not plain_launches
    assert all(torch.equal(got_grads[k], g) for k, g in runs["again"][1].items())
    torch.testing.assert_close(got["loss"], want["loss"], rtol=1e-5, atol=0)
    for key, ref in want_grads.items():
        scale = float(ref.abs().max())
        torch.testing.assert_close(got_grads[key], ref, rtol=0, atol=1e-3 * scale + 1e-6, msg=key)


def test_launch_counts_and_default_dispatch(cuda_device):
    cuda.reset_launches()
    xyz = _cloud(8, 1, 256)
    _, cent = ops.fps_centroids(xyz, 32)  # impl=None on a CUDA tensor: the kernel
    ops.ball_query(xyz, cent, 0.5, 8)
    dist, idx = ops.three_nn(xyz, cent)
    ops.three_interpolate(torch.rand(1, 32, 4, device=cuda_device), idx, ops.interpolation_weights(dist))
    assert dict(cuda.LAUNCHES) == {"fps_centroids": 1, "ball_query": 1, "knn": 1, "three_interpolate": 1}
    ops.fps_centroids(xyz, 32, impl="torch")
    assert cuda.LAUNCHES["fps_centroids"] == 1


def _raise(*args, **kwargs):
    raise AssertionError("a plain version of ops.core was called on the kernel path")


@pytest.mark.parametrize("name", sorted(library.SCHEMAS))
def test_pn2_operators_on_cuda_tensors_never_run_a_plain_version(cuda_device, name, monkeypatch):
    """Each ``pn2`` operator on CUDA tensors runs its kernel: with every
    function of ``ops.core`` made to raise, it still answers, bit for bit as
    before, and launches its kernel once a call."""
    cases = pn2_inputs(cuda_device)[name]
    op = getattr(torch.ops.pn2, name)
    before = [op(*args) for args in cases]
    for attr, fn in list(vars(core).items()):
        if inspect.isfunction(fn) and fn.__module__ == core.__name__:
            monkeypatch.setattr(core, attr, _raise)
    cuda.reset_launches()
    after = [op(*args) for args in cases]
    torch.cuda.synchronize()
    assert sum(cuda.LAUNCHES.values()) == len(cases)
    for got, want in zip(after, before):
        for a, b in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            assert a.is_cuda and torch.equal(a, b), name


def test_wrappers_check_their_inputs(cuda_device):
    xyz = _cloud(9, 1, 64)
    with pytest.raises(ValueError, match="contiguous"):
        cuda.ball_query(xyz, xyz[:, ::2], 0.5, 4)
    with pytest.raises(ValueError, match="float32"):
        cuda.fps_centroids(xyz.double(), 8)
    # k > 16 takes the list route: the answer, not a refusal; k past M is refused.
    for k in (17, 32):
        dist, idx = cuda.knn(xyz, xyz, k)
        want_dist, want_idx = core.knn(xyz, xyz, k)
        assert torch.equal(idx, want_idx) and torch.equal(dist, want_dist)
    with pytest.raises(ValueError, match="k"):
        cuda.knn(xyz, xyz, 65)


# -- calibrated windows ----------------------------------------------------------


def _box(seed, b, n, scale=(8.0, 1.0, 1.0)):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.rand(b, n, 3) * scale).astype(np.float32)).to("cuda")


def _sorted_tiles(xyz, queries, tm):
    """What the calibrated ops hand a tile kernel: the sorted cloud, its
    original indices, the sorted queries, and window starts on 128-multiples."""
    perm = torch.argsort(xyz[..., 0], dim=1, stable=True)
    xs = core._take_rows(xyz, perm)
    qs = core._take_rows(queries, torch.argsort(queries[..., 0], dim=1, stable=True))
    return xs, perm.to(torch.int32), qs


@pytest.mark.parametrize(
    "b,n,m,radius,nsample,window",
    [(2, 1024, 256, 0.3, 8, 512), (1, 2048, 512, 0.05, 32, 640), (2, 8192, 1024, 0.5, 32, 3072),
     (1, 4096, 128, 3.0, 32, 3072),  # every column in the ball: counts far above nsample
     (1, 8192, 1024, 0.5, 32, 7168),  # 112 KB of shared memory: the opt-in above 48 KB
     (2, 512, 64, 0.2, 5, 256),  # one tile of 64 queries, nsample off the powers of two
     (2, 8192, 1024, 0.25, 16, 3072)],  # MSG's SA1 scale0 with the production window
)
def test_ball_query_tiles_kernels(cuda_device, b, n, m, radius, nsample, window):
    xyz = _box(20, b, n)
    queries = xyz[:, :: n // m][:, :m].contiguous()
    xs, perm, qs = _sorted_tiles(xyz, queries, min(128, m))
    t = max(m // 128, 1)
    lo = torch.randint(0, (n - window) // 128 + 1, (b, t), device=cuda_device, dtype=torch.int32) * 128
    got = cuda.ball_query_tiles(xs, perm, qs, lo, radius, nsample, window)
    want = core.ball_query_tiles(xs, perm, qs, lo, radius, nsample, window)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got_pos = cuda.ball_query_tiles_pos(xs, perm, qs, lo, radius, nsample, window)
    want_pos = core.ball_query_tiles_pos(xs, perm, qs, lo, radius, nsample, window)
    assert all(torch.equal(g, w) for g, w in zip(got_pos, want_pos))
    assert torch.equal(got_pos[0], got[0]) and torch.equal(got_pos[2], got[1])


# (b, n, m, tiles, k, c): SA1 (8 tiles a cloud, 8 vectors a row); odd rows
# (floats, one lane of 8 idle); 16 lanes; K not a power of two with one vector
# a row; 18 vectors a row, past the top lane count; floats past 16 lanes;
# MSG's SA1 scale0 (K = 16 picks of rows of 16 floats: 4 vectors, 4 lanes).
GATHER_SHAPES = [
    (2, 8192, 1024, 8, 32, 32), (1, 512, 128, 1, 8, 7), (2, 1024, 256, 2, 4, 64),
    (3, 640, 96, 3, 5, 4), (2, 1024, 256, 4, 24, 72), (1, 300, 64, 4, 3, 33),
    (2, 8192, 1024, 8, 16, 16),
]


def _gather_inputs(gen, b, n, m, tiles, k, w, device):
    lo = torch.randint(0, n - w + 1, (b, tiles), generator=gen, device=device, dtype=torch.int32)
    pos = torch.randint(0, w, (b, m, k), generator=gen, device=device, dtype=torch.int32)
    lo[-1, -1] = n - w
    pos[-1, -1, -1] = w - 1  # a pick of the cloud's last row: lo + pos = N - 1
    return lo, pos


@pytest.mark.parametrize("b,n,m,tiles,k,c", GATHER_SHAPES)
def test_window_gather_kernel(cuda_device, b, n, m, tiles, k, c):
    """The planned route and every forced one (16-byte vectors where the rows
    allow, floats, each lane count) bit for bit; a
    contiguous source 4 bytes off 16-byte alignment plans the float route,
    refuses the vector one, and gathers bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    zp = torch.randn((b, n, c), generator=gen, device=cuda_device)
    lo, pos = _gather_inputs(gen, b, n, m, tiles, k, min(256, n), cuda_device)
    want = core.window_gather(zp, lo, pos)
    assert torch.equal(cuda.window_gather(zp, lo, pos), want)
    vec, lanes = cuda_gather.planned_route(zp)
    assert vec == (c % 4 == 0)
    for route in [(v, n_lanes) for v in {vec, False} for n_lanes in cuda_gather.GATHER_LANES]:
        assert torch.equal(cuda.window_gather(zp, lo, pos, route=route), want), route
    offset = torch.randn(b * n * c + 1, generator=gen, device=cuda_device)[1:].view(b, n, c)
    assert offset.data_ptr() % 16 == 4 and not cuda_gather.planned_route(offset)[0]
    with pytest.raises(ValueError, match="route"):
        cuda.window_gather(offset, lo, pos, route=(True, lanes))
    assert torch.equal(cuda.window_gather(offset, lo, pos), core.window_gather(offset, lo, pos))


@pytest.mark.parametrize("b,tiles", [(1, 70000), (70000, 1)])
def test_window_gather_kernel_past_the_grid_limits(cuda_device, b, tiles):
    """More tiles, or more clouds, than a grid dimension holds (65535): the
    kernel loops over the rest."""
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    n, k, c = 16, 2, 4
    zp = torch.randn((b, n, c), generator=gen, device=cuda_device)
    lo, pos = _gather_inputs(gen, b, n, tiles, tiles, k, 8, cuda_device)
    assert torch.equal(cuda.window_gather(zp, lo, pos), core.window_gather(zp, lo, pos))


# Forced (split, warps) routes of the windowed ball query: one block a tile
# (the design before the split), the plan's at SA1, one query a block, and
# warps that loop over several queries each.
TILES_ROUTES = [(1, 16), (2, 16), (4, 16), (8, 16), (16, 8), (32, 4), (128, 1), (4, 4), (1, 32)]


@pytest.mark.parametrize("b", [8, 16])
@pytest.mark.parametrize("nsample", [32, 64])
def test_ball_query_tiles_kernels_on_every_route(cuda_device, b, nsample):
    """SA1 of semantic.json with the production window on the inputs the
    calibrated op makes: the planned route and every forced one, bit for bit."""
    xyz = _box(26, b, 8192, scale=(8.0, 8.0, 4.9))
    _, cent = ops.fps_centroids(xyz, 1024)
    perm, xs, _, qs, lo, ok = core.ball_query_window_plan(xyz, cent, 0.5, 3072)
    assert bool(ok)
    want = core.ball_query_tiles(xs, perm, qs, lo, 0.5, nsample, 3072)
    want_pos = core.ball_query_tiles_pos(xs, perm, qs, lo, 0.5, nsample, 3072)
    sms = cuda_bq.num_sms(xs.device.index)
    assert cuda_bq.tiles_route(xs, 1024, 128, 3072) == cuda_bq.tiles_plan(b, 1024, 128, 3072, sms)
    for route in (None, *TILES_ROUTES):
        got = cuda.ball_query_tiles(xs, perm, qs, lo, 0.5, nsample, 3072, route=route)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), route
        got = cuda.ball_query_tiles_pos(xs, perm, qs, lo, 0.5, nsample, 3072, route=route)
        assert all(torch.equal(g, w) for g, w in zip(got, want_pos)), route
    with pytest.raises(ValueError, match="route"):
        cuda.ball_query_tiles(xs, perm, qs, lo, 0.5, nsample, 3072, route=(3, 16))


@pytest.mark.parametrize("nsample", [8, 64])
def test_ball_query_tiles_kernel_at_the_x_boundary(cuda_device, nsample):
    """Columns at dx = +-r exactly (out of the span and of the ball), one ulp
    inside (in both), and runs of equal x, on every route."""
    qx = 2.0
    cloud = _box(27, 1, 512, scale=(4.0, 0.01, 0.01))
    cloud[0, ::8, 0] = torch.round(cloud[0, ::8, 0] * 4.0) / 4.0  # runs of equal x
    edge = torch.tensor([qx - 0.5, qx + 0.5], device=cuda_device)
    cloud[0, :2, 0] = edge
    cloud[0, 2:4, 0] = torch.nextafter(edge, torch.full_like(edge, qx))
    cloud[0, :4, 1:] = 0.0
    queries = torch.zeros((1, 128, 3), device=cuda_device)
    queries[0, :, 0] = qx + torch.linspace(-0.3, 0.3, 128, device=cuda_device)
    queries[0, 64, 0] = qx
    perm, xs, _, qs, lo, _ = core.ball_query_window_plan(cloud, queries, 0.5, 512)
    want = core.ball_query_tiles_pos(xs, perm, qs, lo, 0.5, nsample, 512)
    for route in (None, (1, 16), (8, 16), (128, 1)):
        got = cuda.ball_query_tiles_pos(xs, perm, qs, lo, 0.5, nsample, 512, route=route)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), route


@pytest.mark.parametrize(
    "b,m,nq,k,window",
    [(2, 1024, 8192, 3, 512), (1, 512, 1024, 4, 384), (2, 130, 256, 5, 128), (1, 1000, 640, 16, 256)],
)
def test_knn_tiles_kernel(cuda_device, b, m, nq, k, window):
    refs = _box(22, b, m)
    refs[:, ::5, 0] = refs[:, 1:2, 0]  # repeated x: ties within the window order
    refs[:, 7::9] = refs[:, 6::9][:, : refs[:, 7::9].shape[1]]  # repeated points: distance ties
    xs, perm, qs = _sorted_tiles(refs, _box(23, b, nq), 128)
    mpad = (m + 127) // 128 * 128
    lo = torch.randint(0, (mpad - window) // 128 + 1, (b, nq // 128), device=cuda_device, dtype=torch.int32) * 128
    got = cuda.knn_tiles(xs, perm, qs, lo, k, window)
    want = core.knn_tiles(xs, perm, qs, lo, k, window)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("window", [3072, 256])
def test_calibrated_ops_on_the_kernel_path(cuda_device, window):
    """The whole calibrated ops, kernels against plain versions, ``ok`` included,
    at the SA1 and FP4 shapes of a chunk; 256 is too small for SA1."""
    xyz = _box(24, 2, 8192, scale=(8.0, 8.0, 4.9))
    _, cent = ops.fps_centroids(xyz, 1024)
    got = ops.ball_query_calibrated(xyz, cent, 0.5, 32, window, impl="cuda")
    want = ops.ball_query_calibrated(xyz, cent, 0.5, 32, window, impl="torch")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert bool(got[2]) == (window == 3072)
    inputs = torch.cat([xyz, torch.rand_like(xyz)], -1)
    w0, b0 = torch.randn(6, 32, device=cuda_device), torch.randn(32, device=cuda_device)
    got = ops.project_group_calibrated(inputs, w0, b0, xyz, cent, 0.5, 32, window, impl="cuda")
    want = ops.project_group_calibrated(inputs, w0, b0, xyz, cent, 0.5, 32, window, impl="torch")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    fp_window = 512 if window == 3072 else 128
    got = ops.three_nn_calibrated(xyz, cent, fp_window, impl="cuda")
    want = ops.three_nn_calibrated(xyz, cent, fp_window, impl="torch")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if bool(got[2]):
        assert all(torch.equal(g, w) for g, w in zip(got[:2], ops.three_nn(xyz, cent, impl="cuda")))


def test_windowed_model_launch_counts(cuda_device):
    """Eval without gradients: the fused grouping at the level whose cloud is
    wider than the window, the exact kernels where it falls back statically."""
    from pointnet2_tpu_torch.config import Config
    from pointnet2_tpu_torch.models import PointNet2SemSeg

    cfg = Config(num_point=2048, l1_npoint=512, l2_npoint=128, l3_npoint=32, l4_npoint=16)
    model = PointNet2SemSeg(cfg, bq_window=1024, fp_window=256).to(cuda_device).eval()
    x = torch.cat([_box(25, 2, 2048, scale=(8.0, 8.0, 4.9)), torch.rand(2, 2048, 3, device=cuda_device)], -1)
    certificates = []
    cuda.reset_launches()
    with torch.no_grad():
        model(x, certificates=certificates)
    assert dict(cuda.LAUNCHES) == {
        "fps_centroids": 4, "ball_query_sliced_pos": 1, "window_gather": 1, "ball_query": 3,
        "knn_sliced": 1, "knn": 3, "three_interpolate": 4,
    }
    assert len(certificates) == 8


def test_msg_model_launch_counts(cuda_device):
    """The MSG model's eval forward without gradients: one FPS a level shared
    by its scales, two ball queries at each MSG level; with the windows the
    fused grouping runs once a scale at SA1 (SA2's 512 points fall back to the
    exact kernel), and every scale reports a certificate."""
    from pointnet2_tpu_torch.config import Config
    from pointnet2_tpu_torch.models import PointNet2SemSegMSG

    cfg = Config(num_point=2048, l1_npoint=512, l2_npoint=128, l3_npoint=32, l4_npoint=16)
    x = torch.cat([_box(25, 2, 2048, scale=(8.0, 8.0, 4.9)), torch.rand(2, 2048, 3, device=cuda_device)], -1)
    exact = PointNet2SemSegMSG(cfg).to(cuda_device).eval()
    windowed = PointNet2SemSegMSG(cfg, bq_window=1024, fp_window=256).to(cuda_device).eval()
    windowed.load_state_dict(exact.state_dict())
    certificates = []
    with torch.no_grad():
        cuda.reset_launches()
        want = exact(x)
        assert dict(cuda.LAUNCHES) == {"fps_centroids": 4, "ball_query": 6, "knn": 4, "three_interpolate": 4}
        cuda.reset_launches()
        got = windowed(x, certificates=certificates)
    assert dict(cuda.LAUNCHES) == {
        "fps_centroids": 4, "ball_query_sliced_pos": 2, "window_gather": 2, "ball_query": 4,
        "knn_sliced": 1, "knn": 3, "three_interpolate": 4,
    }
    assert len(certificates) == 10
    if all(bool(ok) for _, ok in certificates):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_windowed_wrappers_check_their_inputs(cuda_device):
    xyz = _box(26, 1, 1024)
    xs, perm, qs = _sorted_tiles(xyz, xyz[:, :256].contiguous(), 128)
    lo = torch.zeros((1, 2), dtype=torch.int32, device=cuda_device)
    # nsample > 32 keeps the sorted list in the output row: the answer, not a refusal.
    got = cuda.ball_query_tiles(xs, perm, qs, lo, 0.1, 33, 256)
    assert all(torch.equal(g, w) for g, w in zip(got, core.ball_query_tiles(xs, perm, qs, lo, 0.1, 33, 256)))
    with pytest.raises(ValueError, match="window"):
        cuda.ball_query_tiles(xs, perm, qs, lo, 0.1, 8, 2048)  # wider than the cloud
    with pytest.raises(ValueError, match="int32"):
        cuda.ball_query_tiles(xs, perm.long(), qs, lo, 0.1, 8, 256)
    # k > 16 takes the list route.
    got = cuda.knn_tiles(xs, perm, qs, lo, 17, 256)
    assert all(torch.equal(g, w) for g, w in zip(got, core.knn_tiles(xs, perm, qs, lo, 17, 256)))


# -- the op surface: index-only FPS and the round-1 windowed ball query -----------


@pytest.mark.parametrize("b,n,m", [(2, 128, 16), (1, 200, 32), (3, 1000, 100), (16, 8192, 1024), (1, 1, 1)])
def test_farthest_point_sample_kernel(cuda_device, b, n, m):
    """Equal to the plain version and to the fused kernel's indices."""
    xyz = _cloud(30, b, n)
    idx = ops.farthest_point_sample(xyz, m, impl="cuda")
    assert idx.dtype == torch.int32 and idx.shape == (b, m)
    assert torch.equal(idx, ops.farthest_point_sample(xyz, m, impl="torch"))
    assert torch.equal(idx, ops.fps_centroids(xyz, m, impl="cuda")[0])


def _clustered(seed, b, n, band=0.02):
    """Half the points in a thin band of x: the tiles over the band do not fit a window."""
    xyz = _box(seed, b, n, scale=(8.0, 8.0, 4.9))
    xyz[:, : n // 2, 0] = 4.0 + band * xyz[:, : n // 2, 0] / 8.0
    return xyz.contiguous()


@pytest.mark.parametrize(
    "b,n,m,radius,nsample,window,cloud",
    [(2, 8192, 1024, 0.5, 32, None, "box"),  # SA1: the default window 2048, tiles fit and fall back
     (2, 1024, 256, 1.0, 32, None, "box"),  # SA2
     (2, 256, 64, 2.0, 32, None, "box"),  # SA3: one tile of 64 queries
     (2, 8192, 1024, 0.5, 32, None, "clustered"),  # the band's tiles fall back
     (1, 65536, 1024, 0.3, 32, None, "box"),  # window 16384: past shared memory, read from L2
     (2, 8192, 1024, 0.8, 64, 3072, "box"),  # nsample past one warp: the list in the output row
     (1, 1000, 256, 0.4, 8, 256, "box"),  # N off the 128-multiples
     (1, 4096, 128, 3.0, 40, 1024, "box"),  # every column in the ball
     (2, 100, 37, 0.5, 16, None, "box")],  # M off the tile: the exact kernel, statically
)
def test_ball_query_windowed_kernel(cuda_device, b, n, m, radius, nsample, window, cloud):
    """Equal to the plain windowed version and to the exact kernel, bit for bit."""
    xyz = _clustered(31, b, n) if cloud == "clustered" else _box(31, b, n, scale=(8.0, 8.0, 4.9))
    queries = xyz[:, torch.randperm(n, generator=torch.Generator().manual_seed(32))[:m].to(cuda_device)]
    queries = queries.contiguous()
    got = core.ball_query_windowed(
        xyz, queries, radius, nsample, window,
        exact=torch.ops.pn2.ball_query, tiles=torch.ops.pn2.ball_query_window_tiles,
    )
    if window is None:
        public = ops.ball_query(xyz, queries, radius, nsample, impl="windowed")
        assert all(torch.equal(g, p) for g, p in zip(got, public))
    want = core.ball_query_windowed(xyz, queries, radius, nsample, window)
    exact = ops.ball_query(xyz, queries, radius, nsample, impl="cuda")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, e) for g, e in zip(got, exact))


def test_ball_query_windowed_kernel_takes_both_branches_without_a_host_read(cuda_device):
    """Fitting and falling-back tiles in one call, under sync debug mode "error"."""
    xyz = _clustered(33, 2, 8192)
    queries = xyz[:, ::8].contiguous()
    w = core.round_up(core.default_bq_window(8192, 32), core.LANES)
    *_, lo, hi = core.ball_query_window_bounds(xyz, queries, 0.5, w)
    fits = (hi - lo) <= w
    assert bool(fits.any()) and not bool(fits.all())
    cuda.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ops.ball_query(xyz, queries, 0.5, 32, impl="windowed")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert dict(cuda.LAUNCHES) == {"ball_query_windowed": 1}
    assert all(torch.equal(g, e) for g, e in zip(got, ops.ball_query(xyz, queries, 0.5, 32, impl="torch")))


def test_op_surface_wrappers_check_their_inputs(cuda_device):
    xyz = _cloud(34, 1, 256)
    with pytest.raises(ValueError, match="npoint"):
        cuda.farthest_point_sample(xyz, 257)
    with pytest.raises(ValueError, match="float32"):
        cuda.farthest_point_sample(xyz.double(), 8)
    w = 128
    perm, xs, _, qs, lo, hi = core.ball_query_window_bounds(xyz, xyz[:, :128].contiguous(), 0.2, w)
    with pytest.raises(ValueError, match="int32"):
        cuda.ball_query_window_tiles(xyz, xs, perm.long(), qs, lo, hi, 0.2, 8, w)
    with pytest.raises(ValueError, match="hi"):
        cuda.ball_query_window_tiles(xyz, xs, perm, qs, lo, hi[:, :0], 0.2, 8, w)


# -- the redesigned FPS (a cluster per cloud) and exact ball query (a shared-memory cloud)


def _fps_both(xyz, npoint, route=None):
    """Both FPS entries on ``route`` against the plain version, bit for bit."""
    idx, cent = cuda.fps_centroids(xyz, npoint, route=route)
    want_idx, want_cent = core.fps_centroids(xyz, npoint)
    assert torch.equal(idx, want_idx) and torch.equal(cent, want_cent)
    assert torch.equal(cuda.farthest_point_sample(xyz, npoint, route=route), want_idx)


def _lattice(b, shape=(16, 16, 32)):
    """Integer coordinates: many distances tie, across threads, warps and blocks."""
    g = torch.stack(torch.meshgrid(*(torch.arange(float(s)) for s in shape), indexing="ij"), -1)
    return g.reshape(1, -1, 3).repeat(b, 1, 1).contiguous().to("cuda")


# Every (cluster, threads, ppt) the plan picks for 8192 points, and more.
FPS_ROUTES_8192 = [(16, 128, 4), (8, 128, 8), (4, 256, 8), (2, 512, 8), (1, 512, 16),
                   (16, 256, 2), (8, 1024, 1), (4, 512, 4), (2, 1024, 4)]


@pytest.mark.parametrize("route", FPS_ROUTES_8192)
def test_fps_kernel_routes_on_a_lattice(cuda_device, route):
    """First index of the max where ties cross thread, warp, block and cluster edges."""
    _fps_both(_lattice(2), 300, route)


@pytest.mark.parametrize("route", FPS_ROUTES_8192)
def test_fps_kernel_routes_with_duplicated_points(cuda_device, route):
    xyz = _cloud(40, 2, 8192)
    xyz[:, 4096:] = xyz[:, :4096].flip(1)
    _fps_both(xyz.contiguous(), 300, route)


@pytest.mark.parametrize(
    "n", [127, 128, 129, 255, 256, 257, 511, 512, 513, 1023, 1024, 1025, 2047, 2048, 2049, 4095, 4096,
          4097, 8191, 8192, 8193, 16383, 16384, 16385, 65535, 65536, 65537],
)
def test_fps_kernel_at_the_plan_boundaries(cuda_device, n):
    """N just below, at and above each change of cluster size or points a thread."""
    _fps_both(_cloud(41, 2, n), min(n, 200))


def test_fps_kernel_at_max_points(cuda_device):
    xyz = _cloud(42, 1, cuda_fps.MAX_POINTS, scale=8.0)
    route = cuda_fps.planned_route(xyz, 64)
    assert route[0] * route[1] * route[2] >= cuda_fps.MAX_POINTS
    _fps_both(xyz, 64)
    with pytest.raises(ValueError, match="at most"):
        cuda.fps_centroids(_cloud(42, 1, cuda_fps.MAX_POINTS + 1), 8)


@pytest.mark.parametrize("b", [1, 3, 300])
def test_fps_kernel_batches(cuda_device, b):
    """B = 1, and more clouds than the card holds clusters at once (waves)."""
    xyz = _cloud(43, b, 2048)
    _fps_both(xyz, 64)
    _fps_both(xyz, 64, (16, 128, 1))
    if b == 300:
        assert cuda_fps.resident_clusters(cuda_device.index or 0, True, 16, 128, 1) < b


@pytest.mark.parametrize("n,route", [(1000, None), (1000, (4, 256, 1)), (64, None), (4096, (16, 128, 2))])
def test_fps_kernel_npoint_equals_n(cuda_device, n, route):
    _fps_both(_cloud(44, 2, n), n, route)


def test_fps_plan_takes_the_cards_answers(cuda_device):
    """At the model's shapes every cluster the plan weighs is resident at least once,
    and the route it picks keeps all B clusters resident."""
    dev = cuda_device.index or 0
    for b, n in [(8, 8192), (16, 8192), (16, 1024), (16, 256), (16, 64)]:
        cands = cuda_fps.candidates(n)
        resident = {c: cuda_fps.resident_clusters(dev, True, c, t, p) for c, (t, p) in cands.items()}
        assert all(v > 0 for v in resident.values()), resident
        c, t, p = cuda_fps.plan(b, n, resident)
        assert resident[c] >= b and (c, t, p) == cuda_fps.planned_route(_cloud(0, b, n), 16)


def _ball_both(xyz1, xyz2, radius, nsample, route=None):
    idx, cnt = cuda.ball_query(xyz1, xyz2, radius, nsample, route=route)
    want_idx, want_cnt = core.ball_query(xyz1, xyz2, radius, nsample)
    assert torch.equal(cnt, want_cnt) and torch.equal(idx, want_idx)
    return cnt


# Every (warps, tile) the plan picks at the model's shapes, and tiles far smaller
# than the cloud (many refills of the two buffers).
BALL_ROUTES = [None, (16, 4096), (8, 4096), (4, 1024), (2, 1024), (1, 256), (1, 64), (16, 32), (3, 96)]


@pytest.mark.parametrize("route", BALL_ROUTES)
def test_ball_query_kernel_routes(cuda_device, route):
    xyz1 = _cloud(50, 2, 8192, scale=4.0)
    xyz2 = xyz1[:, ::8].contiguous()
    _ball_both(xyz1, xyz2, 0.25, 32, route)


@pytest.mark.parametrize("route", [None, (16, 4096), (4, 1024), (1, 64)])
def test_ball_query_kernel_dense_balls_stop_early(cuda_device, route):
    """Every point in every ball: each query is full within its first strip."""
    xyz1 = _cloud(51, 2, 8192, scale=1.0)
    xyz2 = _cloud(52, 2, 256, scale=1.0)
    cnt = _ball_both(xyz1, xyz2, 2.0, 32, route)
    assert bool((cnt == 32).all())


@pytest.mark.parametrize("route", [None, (16, 4096), (2, 64)])
def test_ball_query_kernel_empty_balls(cuda_device, route):
    xyz1 = _cloud(53, 2, 5000, scale=1.0)
    xyz2 = _cloud(54, 2, 100, scale=1.0) + 10.0
    xyz2[:, ::2] -= 10.0  # half the queries inside the cloud, half far away
    cnt = _ball_both(xyz1, xyz2.contiguous(), 0.05, 16, route)
    assert bool((cnt[:, 1::2] == 0).all())


@pytest.mark.parametrize("route", [None, (8, 4096), (1, 512)])
def test_ball_query_kernel_nsample_64(cuda_device, route):
    xyz1 = _cloud(55, 2, 8192, scale=2.0)
    _ball_both(xyz1, xyz1[:, ::16].contiguous(), 0.4, 64, route)


@pytest.mark.parametrize("n", [4097, 9192, 12305, 3 * 4096])
def test_ball_query_kernel_past_one_tile(cuda_device, n):
    """N larger than one staged tile and not a multiple of it (and one that is)."""
    xyz1 = _cloud(56, 2, n, scale=3.0)
    _ball_both(xyz1, xyz1[:, ::7].contiguous(), 0.3, 32)


@pytest.mark.parametrize("b,m,route", [(3, 37, None), (3, 37, (16, 4096)), (1, 65, (16, 4096)), (5, 1, None)])
def test_ball_query_kernel_queries_off_the_block(cuda_device, b, m, route):
    """B x M not a multiple of the block's queries: the last block runs part full."""
    _ball_both(_cloud(57, b, 3000), _cloud(58, b, m), 0.3, 16, route)


def test_ball_query_plan_at_the_model_shapes(cuda_device):
    sms = cuda_bq.num_sms(cuda_device.index or 0)
    assert sms == torch.cuda.get_device_properties(0).multi_processor_count
    for b, n, m in [(8, 8192, 1024), (16, 8192, 1024), (16, 1024, 256), (16, 64, 16)]:
        warps, tile = cuda_bq.plan(b, n, m, sms)
        assert cuda_bq.shared_bytes(n, tile) <= cuda_bq.MAX_SHARED_BYTES


# -- the refusals repaired: kNN for any k, the windowed ball query for any nsample and window


@pytest.mark.parametrize("k", [17, 32, 64])
def test_knn_kernel_past_16(cuda_device, k):
    """The roadmap's input (1 x 64 references, 8 queries), and the FP4 shape."""
    torch.manual_seed(0)
    xyz1 = torch.rand(1, 64, 3, device=cuda_device)
    xyz2 = torch.rand(1, 8, 3, device=cuda_device)
    dist, idx = ops.knn(xyz1, xyz2, k)
    want_dist, want_idx = ops.knn(xyz1, xyz2, k, impl="torch")
    assert torch.equal(idx, want_idx) and torch.equal(dist, want_dist)
    refs, queries = _cloud(60, 2, 1024), _cloud(61, 2, 8192)
    dist, idx = ops.knn(refs, queries, k)
    want_dist, want_idx = ops.knn(refs, queries, k, impl="torch")
    assert torch.equal(idx, want_idx) and torch.equal(dist, want_dist)


def test_knn_kernel_k_equals_m(cuda_device):
    """k = M = 1024: every reference enters every list."""
    refs, queries = _cloud(62, 1, 1024), _cloud(63, 1, 64)
    dist, idx = cuda.knn(refs, queries, 1024)
    want_dist, want_idx = core.knn(refs, queries, 1024)
    assert torch.equal(idx, want_idx) and torch.equal(dist, want_dist)


def test_knn_kernel_refuses_only_what_the_card_cannot_hold(cuda_device):
    assert cuda_knn.MAX_K >= 1024
    big = _cloud(64, 1, cuda_knn.MAX_K + 1)
    with pytest.raises(ValueError, match="k"):
        cuda.knn(big, big[:, :4].contiguous(), cuda_knn.MAX_K + 1)


@pytest.mark.parametrize("nsample", [33, 64])
def test_calibrated_ball_query_past_32_samples(cuda_device, nsample):
    """The roadmap's input: (1, 1024, 3) / (1, 128, 3), radius 0.2, window 512,
    and a denser one whose balls hold more than nsample points."""
    torch.manual_seed(0)
    xyz1 = torch.rand(1, 1024, 3, device=cuda_device)
    xyz2 = torch.rand(1, 128, 3, device=cuda_device)
    for radius in (0.2, 0.45):
        got = ops.ball_query_calibrated(xyz1, xyz2, radius, nsample, 512)
        want = ops.ball_query_calibrated(xyz1, xyz2, radius, nsample, 512, impl="torch")
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    inputs = torch.cat([xyz1, torch.rand_like(xyz1)], -1)
    w0, b0 = torch.randn(6, 16, device=cuda_device), torch.randn(16, device=cuda_device)
    got = ops.project_group_calibrated(inputs, w0, b0, xyz1, xyz2, 0.45, nsample, 512)
    want = ops.project_group_calibrated(inputs, w0, b0, xyz1, xyz2, 0.45, nsample, 512, impl="torch")
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("b,n,m,radius,nsample,window", [
    (2, 8192, 1024, 0.5, 64, 3072), (1, 4096, 128, 3.0, 40, 3072), (2, 1024, 256, 0.3, 33, 512),
])
def test_ball_query_tiles_kernels_past_32_samples(cuda_device, b, n, m, radius, nsample, window):
    xyz = _box(65, b, n)
    queries = xyz[:, :: n // m][:, :m].contiguous()
    xs, perm, qs = _sorted_tiles(xyz, queries, min(128, m))
    lo = torch.randint(0, (n - window) // 128 + 1, (b, m // 128), device=cuda_device, dtype=torch.int32) * 128
    got = cuda.ball_query_tiles(xs, perm, qs, lo, radius, nsample, window)
    assert all(torch.equal(g, w) for g, w in zip(got, core.ball_query_tiles(xs, perm, qs, lo, radius, nsample, window)))
    got_pos = cuda.ball_query_tiles_pos(xs, perm, qs, lo, radius, nsample, window)
    want_pos = core.ball_query_tiles_pos(xs, perm, qs, lo, radius, nsample, window)
    assert all(torch.equal(g, w) for g, w in zip(got_pos, want_pos))


@pytest.mark.parametrize("nsample", [32, 64])
def test_calibrated_ball_query_window_past_shared_memory(cuda_device, nsample):
    """window = 16384 at N = 32768: past the 14528 columns a block's shared memory holds."""
    torch.manual_seed(0)
    xyz1 = torch.rand(1, 32768, 3, device=cuda_device) * torch.tensor([8.0, 1.0, 1.0], device=cuda_device)
    xyz2 = xyz1[:, ::32].contiguous()
    got = ops.ball_query_calibrated(xyz1, xyz2, 0.2, nsample, 16384)
    want = ops.ball_query_calibrated(xyz1, xyz2, 0.2, nsample, 16384, impl="torch")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    xs, perm, qs = _sorted_tiles(xyz1, xyz2, 128)
    lo = torch.randint(0, (32768 - 16384) // 128 + 1, (1, 8), device=cuda_device, dtype=torch.int32) * 128
    want = core.ball_query_tiles_pos(xs, perm, qs, lo, 0.2, nsample, 16384)
    for route in (None, (1, 16), (8, 16), (128, 1)):  # the plan's, and forced ones
        got = cuda.ball_query_tiles_pos(xs, perm, qs, lo, 0.2, nsample, 16384, route=route)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), route
        got = cuda.ball_query_tiles(xs, perm, qs, lo, 0.2, nsample, 16384, route=route)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[2]), route


@pytest.mark.parametrize("k,window", [(17, 512), (32, 384), (3, 16384), (32, 16384)])
def test_knn_tiles_kernel_any_k_and_window(cuda_device, k, window):
    m = 32768 if window > 14528 else 1024
    refs = _box(66, 1, m)
    refs[:, 7::9] = refs[:, 6::9][:, : refs[:, 7::9].shape[1]]  # repeated points: distance ties
    xs, perm, qs = _sorted_tiles(refs, _box(67, 1, 1024), 128)
    lo = torch.randint(0, (m - window) // 128 + 1, (1, 8), device=cuda_device, dtype=torch.int32) * 128
    got = cuda.knn_tiles(xs, perm, qs, lo, k, window)
    want = core.knn_tiles(xs, perm, qs, lo, k, window)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    if window <= 512:
        got = ops.knn_calibrated(refs, _box(67, 1, 1024), k, window)
        want = ops.knn_calibrated(refs, _box(67, 1, 1024), k, window, impl="torch")
        assert all(torch.equal(g, w) for g, w in zip(got, want))


# -- the redesigned exact kNN (row 3): S lanes a query, merged by butterfly


def _knn_both(refs, queries, k, route=None):
    dist, idx = cuda.knn(refs, queries, k, route=route)
    want_dist, want_idx = core.knn(refs, queries, k)
    assert torch.equal(idx, want_idx) and torch.equal(dist, want_dist)


# Every (lanes, threads) the plan can pick for k <= 16, and part-full blocks.
KNN_ROUTES = [(1, 256), (2, 256), (4, 256), (8, 256), (16, 256), (32, 256), (1, 64), (4, 32), (32, 32), (8, 96)]


@pytest.mark.parametrize("route", KNN_ROUTES)
@pytest.mark.parametrize("k", [1, 3, 16])
def test_knn_kernel_routes_on_a_lattice(cuda_device, route, k):
    """Integer coordinates and the cloud twice: distances tie within and across lanes."""
    g = _lattice(1, (8, 8, 16))  # 1024 points
    refs = torch.cat([g, g.flip(1)], 1).repeat(2, 1, 1).contiguous()  # 2048: two tiles
    queries = (g[:, ::7] + 0.5).repeat(2, 1, 1).contiguous()
    _knn_both(refs, queries, k, route)
    _knn_both(refs[:, :1000].contiguous(), g[:, ::3].repeat(2, 1, 1).contiguous(), k, route)


@pytest.mark.parametrize("route", KNN_ROUTES)
@pytest.mark.parametrize("k", [1, 3, 16])
def test_knn_kernel_routes_with_duplicated_points(cuda_device, route, k):
    refs = _cloud(68, 2, 1024)
    refs[:, 512:] = refs[:, :512].flip(1)
    _knn_both(refs.contiguous(), _cloud(69, 2, 3000), k, route)


@pytest.mark.parametrize("route", [(32, 32), (32, 128), (32, 256)])
@pytest.mark.parametrize("k", [17, 32, 64])
def test_knn_kernel_list_routes(cuda_device, route, k):
    g = _lattice(1, (8, 8, 16))
    refs = torch.cat([g, g.flip(1)], 1).repeat(2, 1, 1).contiguous()
    _knn_both(refs, (g[:, ::9] + 0.5).repeat(2, 1, 1).contiguous(), k, route)
    _knn_both(_cloud(70, 2, 1100), _cloud(71, 2, 77), k, route)


@pytest.mark.parametrize("b", [8, 16])
def test_knn_kernel_at_the_fp_shapes(cuda_device, b):
    """The four FP levels' 3-NN on the planned route."""
    for nq, m in [(64, 16), (256, 64), (1024, 256), (8192, 1024)]:
        dense, coarse = _cloud(72, b, nq, scale=8.0), _cloud(73, b, m, scale=8.0)
        dist, idx = ops.three_nn(dense, coarse)
        want_dist, want_idx = ops.three_nn(dense, coarse, impl="torch")
        assert torch.equal(idx, want_idx) and torch.equal(dist, want_dist)


def test_knn_plan_at_the_model_shapes(cuda_device):
    sms = cuda_bq.num_sms(cuda_device.index or 0)
    for b, nq, m in [(8, 8192, 1024), (16, 8192, 1024), (16, 1024, 256), (16, 64, 16)]:
        route = cuda_knn.plan(b, nq, m, 3, sms)
        assert cuda_knn.check_plan(b, nq, 3, route) == route
        lanes = route[0]
        assert lanes == 1 or m // lanes >= cuda_knn.MIN_REFS_PER_LANE


# -- the redesigned three_interpolate forward (row 4), the FP concat written by the kernel

FP_SHAPES = [(16, 512, 64, 256), (64, 256, 256, 128), (256, 256, 1024, 64), (1024, 128, 8192, 3)]  # (M, C, N, C1)


def _interp_inputs(b, m, c, n, seed=80):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    points = torch.randn((b, m, c), generator=gen, device="cuda")
    dist, idx = ops.three_nn(_cloud(seed + 1, b, n, 8.0), _cloud(seed + 2, b, m, 8.0))
    return points, idx, ops.interpolation_weights(dist), gen


@pytest.mark.parametrize("b", [8, 16])
@pytest.mark.parametrize("m,c,n,c1", FP_SHAPES)
def test_three_interpolate_kernel_at_the_fp_shapes(cuda_device, b, m, c, n, c1):
    """With the skip as the model gives it (FP4's: the colours, a view of row
    stride 6 into the input cloud) and without."""
    points, idx, weight, gen = _interp_inputs(b, m, c, n)
    if c1 == 3:
        skip = torch.rand((b, n, 6), generator=gen, device=cuda_device)[..., 3:6]
        assert not skip.is_contiguous()
    else:
        skip = torch.randn((b, n, c1), generator=gen, device=cuda_device)
    got = cuda.three_interpolate(points, idx, weight, skip)
    want = core.three_interpolate_concat(points, idx, weight, skip)
    assert got.shape == (b, n, c + c1) and torch.equal(got, want)
    assert torch.equal(cuda.three_interpolate(points, idx, weight), core.three_interpolate(points, idx, weight))


@pytest.mark.parametrize("c,c1,offset", [(7, 5, 0), (128, 4, 0), (128, 3, 0), (64, 64, 1), (8, 0, 1), (3, 0, 0)])
def test_three_interpolate_kernel_aligned_and_unaligned_rows(cuda_device, c, c1, offset):
    """Both widths the plan picks: 4-byte accesses (C or C + C1 off the
    4-multiples, or ``points`` off a 16-byte boundary) and 16-byte ones, the
    skip copied 4 bytes at a time (its rows unaligned); and every forced route."""
    b, m, n = 2, 50, 300
    points, idx, weight, gen = _interp_inputs(b, m, c, n, seed=90)
    if offset:
        points = torch.randn((b * m * c + offset,), generator=gen, device=cuda_device)[offset:].view(b, m, c)
        assert points.data_ptr() % 16
    skip = torch.randn((b, n, c1 + 1), generator=gen, device=cuda_device)[..., 1:] if c1 else None
    want = core.three_interpolate(points, idx, weight) if skip is None else core.three_interpolate_concat(
        points, idx, weight, skip)
    assert torch.equal(cuda.three_interpolate(points, idx, weight, skip), want)
    vec = cuda_interp.planned_route(points, skip)[0]
    for route in (False, True) if vec else (False,):
        assert torch.equal(cuda.three_interpolate(points, idx, weight, skip, route=route), want)
    if not vec:
        with pytest.raises(ValueError, match="route"):
            cuda.three_interpolate(points, idx, weight, skip, route=True)


def test_three_interpolate_kernel_copies_a_skip_it_cannot_stride(cuda_device):
    points, idx, weight, gen = _interp_inputs(2, 64, 32, 256)
    skip = torch.randn((2, 16, 256), generator=gen, device=cuda_device).transpose(1, 2)  # channels 256 apart
    assert torch.equal(cuda.three_interpolate(points, idx, weight, skip),
                       core.three_interpolate_concat(points, idx, weight, skip))


def test_three_interpolate_plan_at_the_fp_shapes(cuda_device):
    """What the wrapper launches with the skips the model hands over."""
    points, idx, weight, gen = _interp_inputs(2, 64, 128, 256)
    colours = torch.rand((2, 256, 6), generator=gen, device=cuda_device)[..., 3:6]
    assert cuda_interp.planned_route(points, colours) == (False, False)
    wide = torch.randn((2, 64, 512), generator=gen, device=cuda_device)
    assert cuda_interp.planned_route(wide, torch.randn((2, 256, 256), device=cuda_device)) == (True, True)


@pytest.mark.parametrize("c1", [3, 64])
def test_fused_three_interpolate_function_on_the_kernel_path(cuda_device, c1):
    """The skip's gradient is the cotangent's slice; the points' gradient reads it in place."""
    points, idx, weight, gen = _interp_inputs(2, 256, 64, 1024)
    p = points.clone().requires_grad_()
    skip = torch.randn((2, 1024, c1 + 3), generator=gen, device=cuda_device)[..., 3:].requires_grad_()
    g = torch.randn((2, 1024, 64 + c1), generator=gen, device=cuda_device)
    got = torch.autograd.grad(ops.three_interpolate(p, idx, weight, skip=skip), (p, skip), g)
    with deterministic_algorithms():
        plain = torch.autograd.grad(ops.three_interpolate(p, idx, weight, impl="torch", skip=skip), (p, skip), g)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    want = torch.autograd.grad(core.three_interpolate_concat(p, idx, weight, skip), (p, skip), g)
    torch.testing.assert_close(got[0], want[0], **AUTOGRAD_ORDER_TOL)
    assert torch.equal(got[1], want[1])


def test_feature_propagation_launches_no_concat(cuda_device):
    """The FP module's fused op: one three_interpolate launch a level and the
    same output as the plain path."""
    from pointnet2_tpu_torch.nn.pointnet import FeaturePropagation

    fp = FeaturePropagation(64 + 32, [48]).to(cuda_device).eval()
    for p in fp.parameters():
        torch.nn.init.normal_(p, std=0.1)
    xyz1, xyz2 = _cloud(95, 2, 512, 8.0), _cloud(96, 2, 128, 8.0)
    points1 = torch.randn(2, 512, 32, device=cuda_device)
    points2 = torch.randn(2, 128, 64, device=cuda_device)
    cuda.reset_launches()
    with torch.no_grad():
        got = fp(xyz1, xyz2, points1, points2)
    assert dict(cuda.LAUNCHES) == {"knn": 1, "three_interpolate": 1}
    fp.ops_impl = "torch"
    with torch.no_grad():
        want = fp(xyz1, xyz2, points1, points2)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# -- the round-1 windowed ball query (row 11) and the windowed kNN (row 10),
# redesigned: split over the card, x-spans, the exact stop


def _windowed_routes(tm):
    """Forced (split, warps) of the round-1 kernel at a tile of ``tm``: one
    block a tile, the plans' splits, one query a block, warps looping."""
    routes = [(1, 16), (2, 16), (4, 16), (8, 16), (16, 8), (32, 4), (64, 2), (128, 1), (4, 4), (1, 32)]
    return [r for r in routes if tm % r[0] == 0]


def _levels(seed, b, clustered=False):
    """SA1-SA3 inputs of semantic.json: bench.py's clouds (or half of them in a
    2 cm band of x) and the FPS centroids of each level."""
    xyz = _box(seed, b, 8192, scale=(8.0, 8.0, 4.9))
    if clustered:
        xyz[:, :4096, 0] = 4.0 + 0.02 * xyz[:, :4096, 0] / 8.0
    out = [xyz.contiguous()]
    for npoint in (1024, 256, 64):
        out.append(ops.fps_centroids(out[-1], npoint)[1].contiguous())
    return out


def _windowed_both(xyz, cent, radius, nsample, routes):
    """The round-1 kernel against its plain version on the op's sorted
    inputs, on the plan's route and each forced one. Returns the tiles that fit."""
    n, m = xyz.shape[1], cent.shape[1]
    w = core.round_up(core.default_bq_window(n, nsample), core.LANES)
    perm, xs, _, qs, lo, hi = core.ball_query_window_bounds(xyz, cent, radius, w)
    want = core.ball_query_window_tiles(xyz, xs, perm, qs, lo, hi, radius, nsample, w)
    for route in (None, *routes):
        got = cuda.ball_query_window_tiles(xyz, xs, perm, qs, lo, hi, radius, nsample, w, route=route)
        assert all(torch.equal(g, h) for g, h in zip(got, want)), route
    return (hi - lo) <= w


@pytest.mark.parametrize("b", [8, 16])
@pytest.mark.parametrize("cloud,nsample", [("box", 32), ("clustered", 32), ("box", 64)])
def test_ball_query_windowed_kernel_on_every_route(cuda_device, b, cloud, nsample):
    """SA1-SA3 of semantic.json at both batches, bench.py's clouds and a
    clustered one (its band's tiles fall back, the others fit), nsample 32
    and 64: every route, bit for bit."""
    lv = _levels(40 + b, b, clustered=cloud == "clustered")
    for i, (radius, tm) in enumerate(((0.5, 128), (1.0, 128), (2.0, 64))):
        fits = _windowed_both(lv[i], lv[i + 1], radius, nsample, _windowed_routes(tm))
        if i > 0:
            assert not bool(fits.any())  # SA2, SA3: every tile scans the whole sorted cloud
        elif cloud == "clustered":
            assert bool(fits.any()) and not bool(fits.all())


def test_ball_query_windowed_kernel_routes_past_shared_memory(cuda_device):
    """A 16384-column window (N = 65536): no span is staged, each read where it lies."""
    xyz = _box(47, 2, 65536, scale=(8.0, 8.0, 4.9))
    cent = xyz[:, torch.randperm(65536, generator=torch.Generator().manual_seed(48))[:1024].to(cuda_device)]
    assert 16384 * 16 > cuda_bq.MAX_SHARED_BYTES
    _windowed_both(xyz, cent.contiguous(), 0.5, 32, [(1, 16), (4, 16), (16, 8), (128, 1)])


def test_ball_query_windowed_kernel_fills_the_card(cuda_device):
    """At SA2 and SA3 of a B=16 batch the plan launches at least a block an SM."""
    sms = cuda_bq.num_sms(cuda_device.index or 0)
    for m, tm, n, w in ((256, 128, 1024, 256), (64, 64, 256, 128)):
        split, _ = cuda_bq.windowed_plan(16, n, m, tm, w, sms)
        assert 16 * (m // tm) * split >= sms


def test_ball_query_windowed_kernel_past_65535_clouds(cuda_device):
    """65537 clouds of 256 points (a 128-column window), 32 queries each: the
    grid is one dimension of clouds x tiles x split blocks, so the number of
    clouds has no limit of its own. Every other cloud's queries lie in a
    narrow band of x, so its tile fits its window; the others fall back."""
    xyz = _box(49, 65537, 256, scale=(1.0, 1.0, 1.0))
    cent = xyz[:, :32].clone()
    cent[::2, :, 0] *= 0.1
    fits = _windowed_both(xyz, cent, 0.2, 8, [(1, 16), (4, 8)])
    assert bool(fits.any()) and not bool(fits.all())


def _knn_tiles_both(refs, queries, k, w, lo=None):
    """The windowed kNN against its plain version on the calibrated op's
    sorted inputs (or the given window starts), bit for bit."""
    perm, xs, _, qs, plan_lo = core.knn_window_plan(refs, queries, w)
    lo = plan_lo if lo is None else lo
    want = core.knn_tiles(xs, perm, qs, lo, k, w)
    got = cuda.knn_tiles(xs, perm, qs, lo, k, w)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("b", [8, 16])
def test_knn_tiles_kernel_at_fp4(cuda_device, b):
    """FP4 of semantic.json with the production window (512) at both
    batches, bit for bit."""
    lv = _levels(50 + b, b)
    _knn_tiles_both(lv[1], lv[0], 3, 512)


@pytest.mark.parametrize("k", list(range(1, 17)))
def test_knn_tiles_kernel_ties_at_the_kth_distance_and_padding(cuda_device, k):
    """A lattice: columns tied at the k-th distance on both sides of each
    query (queries on and between lattice points), repeated x everywhere; a
    window partly past M (padding), and a window with fewer than k real
    columns. Every k from 1 to 16."""
    g = torch.arange(0, 2.0, 0.25, device=cuda_device)
    lattice = torch.stack(torch.meshgrid(g * 2.0, g, g, indexing="ij"), -1).reshape(1, -1, 3)  # 512 points
    lattice = lattice[:, torch.randperm(512, generator=torch.Generator().manual_seed(k)).to(cuda_device)]
    refs = lattice[:, :500].contiguous()  # M = 500: the last window reaches past it
    queries = torch.cat([lattice[:, ::2], lattice[:, 1::2] + 0.125], 1)[:, :512].contiguous()
    _knn_tiles_both(refs, queries, k, 128)
    tiles = queries.shape[1] // 128
    _knn_tiles_both(refs, queries, k, 128,
                    lo=torch.full((1, tiles), 384, dtype=torch.int32, device=cuda_device))  # 116 real columns
    _knn_tiles_both(refs[:, :130].contiguous(), queries, k, 128,
                    lo=torch.full((1, tiles), 128, dtype=torch.int32, device=cuda_device))  # 2 real columns


# -- the host pipeline's copy to the card --------------------------------------


def _train_batches(n, b=16, points=8192, seed=0):
    rng = np.random.RandomState(seed)
    return [
        {"points": rng.rand(b, points, 6).astype(np.float32),
         "labels": rng.randint(0, 9, (b, points)).astype(np.int32),
         "weights": rng.rand(b, points).astype(np.float32)}
        for _ in range(n)
    ]


def test_device_prefetch_batches_equal_their_host_batches(cuda_device):
    """20 batches of the train step's size from a one-worker producer through
    the pinned ring and the side stream, with the consumer's stream kept busy
    between batches: a batch read before its copy ended, or a pinned buffer
    refilled before its copy read it, would show as a wrong value. Each batch
    is copied on the consumer's stream as it arrives, and every yielded
    tensor is checked again after a synchronize."""
    from pointnet2_tpu_torch.data.pipeline import BatchProducer, device_prefetch

    host = _train_batches(20)
    order = iter(range(10**6))
    producer = BatchProducer(lambda: host[next(order) % len(host)], max_queue=4, num_workers=1)
    work = torch.randn(2048, 2048, device=cuda_device)
    yielded, copies = [], []
    try:
        batches = device_prefetch(producer, cuda_device, depth=2)
        for _ in range(len(host)):
            batch = next(batches)
            copies.append({k: v.clone() for k, v in batch.items()})
            yielded.append(batch)
            for _ in range(8):
                work = torch.tanh(work @ work) / 64
    finally:
        producer.stop()
    torch.cuda.synchronize()
    for got, copy, want in zip(yielded, copies, host, strict=True):
        for k, v in want.items():
            assert got[k].is_cuda and got[k].dtype == torch.from_numpy(v).dtype
            assert np.array_equal(got[k].cpu().numpy(), v) and np.array_equal(copy[k].cpu().numpy(), v), k


def test_trainer_to_device_keeps_a_batch_already_on_the_card(cuda_device):
    from pointnet2_tpu_torch.config import Config
    from pointnet2_tpu_torch.data.pipeline import device_prefetch
    from pointnet2_tpu_torch.train import Trainer

    cfg = Config(num_point=512, batch_size=2, l1_npoint=128, l2_npoint=64, l3_npoint=16, l4_npoint=8)
    trainer = Trainer(cfg)
    batch = next(device_prefetch(_train_batches(1, b=2, points=512), cuda_device))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # no host read in the hand-over
    try:
        points, labels, weights = trainer._to_device(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert points.data_ptr() == batch["points"].data_ptr() and weights.data_ptr() == batch["weights"].data_ptr()
    assert labels.is_cuda and labels.dtype == torch.int64 and torch.equal(labels, batch["labels"].long())


@pytest.mark.parametrize("knn", [1, 3, 5])
def test_densify_device_engine_equals_its_plain_version(cuda_device, knn):
    """The densify engine on the card: row 3's kernel, once for a dense cloud
    below a chunk, then the vote and the colors on the device, equal to the
    same function on the plain kNN bit for bit, and to the native engine."""
    from pointnet2_tpu_torch import native
    from pointnet2_tpu_torch.ops.densify import densify_labels_device

    rng = np.random.RandomState(40 + knn)
    sparse = (rng.rand(5000, 3) * 20).astype(np.float32)
    labels = rng.randint(0, 9, 5000).astype(np.int32)
    dense = (rng.rand(100_000, 3) * 20).astype(np.float32)
    cuda.reset_launches()
    got, got_colors = densify_labels_device(sparse, labels, dense, knn, device=cuda_device)
    assert dict(cuda.LAUNCHES) == {"knn": 1}
    assert got.is_cuda and got.dtype == torch.int32 and got_colors.is_cuda and got_colors.dtype == torch.uint8
    want, want_colors = densify_labels_device(sparse, labels, dense, knn, device=cuda_device, impl="torch")
    assert torch.equal(got, want) and torch.equal(got_colors, want_colors)
    host = native.densify_labels_native(sparse, labels, dense, knn)
    if host is not None:
        assert (got.cpu().numpy() == host[0]).mean() >= 0.9999


def test_device_ms_times_by_events_when_the_profiler_records_no_kernel(cuda_device, monkeypatch):
    """``utils.bench.device_ms`` where every profiling session comes back
    without the kernel (a symbol that names none stands in for a dropped
    session): a warning, and the call's time by CUDA events, not an error."""
    from pointnet2_tpu_torch.utils import bench

    monkeypatch.setitem(bench.KERNEL_SYMBOLS, "knn", "no_kernel_has_this_name")
    xyz1, xyz2 = _cloud(0, 1, 4096), _cloud(1, 1, 8192)
    with pytest.warns(RuntimeWarning, match="no device time for knn"):
        ms = bench.device_ms(lambda: ops.knn(xyz1, xyz2, 3, impl="cuda"), "knn", calls=3, tries=2)
    assert 0.0 < ms < 1e3


@pytest.mark.parametrize("integer", [False, True], ids=["random", "integer"])
def test_probe_kernels_equal_their_plain_versions(cuda_device, integer, monkeypatch):
    """The four TPU-probe kernels (``ops.cuda.probes``) against the probe
    tools' plain versions, bit for bit; the FPS ones also against row 6 and
    the oracle: B = 12 (a cluster of G = 8 with empty groups), npoint = N =
    1000 (padding warps; the C = 1 route at every G), N = 8191 (no multiple
    of C), npoint = 1 and 2, N = 16384 (clusters of 16), and at N = 8192
    every route ``packed_candidates`` offers (the plan monkeypatched, as
    ``fps_packed_probe --routes`` times them); integer clouds tie across
    warps, groups and blocks. kNN k up to 32."""
    from pointnet2_tpu_torch.ops import reference
    from pointnet2_tpu_torch.ops.cuda import probes
    from pointnet2_tpu_torch.tools import fps_mask_probe, fps_packed_probe, knn_variant_probe

    def cloud(seed, b, n):
        x = np.random.RandomState(seed).rand(b, n, 3) * 8.0
        return torch.from_numpy((np.round(x) if integer else x).astype(np.float32)).to(cuda_device)

    for b, n, npoint in ((12, 1000, 1000), (12, 8191, 300), (12, 1000, 1), (12, 1000, 2), (5, 16384, 64)):
        xyz = cloud(n + npoint, b, n)
        row6 = cuda.farthest_point_sample(xyz, npoint)
        np.testing.assert_array_equal(row6[:2].cpu().numpy(), reference.farthest_point_sample_np(xyz[:2].cpu().numpy(), npoint))
        for remask in (True, False):
            got = cuda.fps_remask(xyz, npoint, remask)
            want = fps_mask_probe.fps_remask_plain(xyz, npoint, remask)
            assert torch.equal(got, want) and torch.equal(got, row6), (b, n, npoint, remask)
        for g in probes.GROUPS:
            if not probes.packed_candidates(n, g):  # G = 8 at N = 8191
                with pytest.raises(ValueError, match="no FPS route"):
                    cuda.fps_packed(xyz, npoint, g)
                continue
            got = cuda.fps_packed(xyz, npoint, g)
            want = fps_packed_probe.fps_packed_plain(xyz, npoint, g)
            assert torch.equal(got, want) and torch.equal(got, row6), (b, n, npoint, g)
    xyz = cloud(3, 12, 8192)
    row6 = cuda.farthest_point_sample(xyz, 200)
    for g in probes.GROUPS:
        want = fps_packed_probe.fps_packed_plain(xyz, 200, g)
        for route in probes.packed_candidates(8192, g).items():
            with monkeypatch.context() as patch:
                patch.setattr(probes, "packed_device_plan", lambda *args, r=route: (r[0], *r[1]))
                got = cuda.fps_packed(xyz, 200, g)
            assert torch.equal(got, want) and torch.equal(got, row6), (g, route)
    refs, queries = cloud(1, 3, 1000), cloud(2, 3, 700)
    for k in (1, 3, 16, 32):
        for name, plain in (("knn_argmin", knn_variant_probe.knn_argmin_plain),
                            ("knn_tracked", knn_variant_probe.knn_tracked_plain)):
            got, want = getattr(cuda, name)(refs, queries, k), plain(refs, queries, k)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (name, k)


# (B, N, M, nsample) of the sweep kernels: N = 8192 staged whole by bulk
# copies; 20000 through the ring; 1001 by the blocks' own loads (12012-byte
# clouds); M = 300 a short last tile at tm = 256; B = 1.
BQ_SWEEP_CASES = ((2, 8192, 300, 32), (2, 20000, 300, 40), (3, 1001, 300, 8), (1, 8192, 1024, 1),
                  (3, 1000, 300, 40))


@pytest.mark.parametrize("integer", [False, True], ids=["random", "integer"])
def test_bq_probe_kernels_equal_their_plain_versions(cuda_device, monkeypatch, integer):
    """The four ball-query probe kernels (``ops.cuda.bq_probes``) against the
    probe tools' plain versions, bit for bit: ``bq_keys`` at both widths and
    ``bq_fat`` at both tiles (at every cluster size of ``fat_sizes``) also
    against row 2 and the oracle at ``BQ_SWEEP_CASES`` (each staging route;
    nsample 1, 8, 32 and 40, past a warp's lanes), the first query of every
    cloud away from it (an empty ball); the pre-cut kernel on windows that fit (equal to row 2), on
    windows that do not (equal to row 7 in place at the same starts), and
    behind its guard (zeros where the windows do not fit)."""
    from pointnet2_tpu_torch.ops import reference
    from pointnet2_tpu_torch.ops.cuda import bq_probes
    from pointnet2_tpu_torch.tools import bq_cond_probe, bq_fat_probe, bq_i16_probe

    def cloud(seed, b, n):
        x = np.random.RandomState(seed).rand(b, n, 3)
        return (np.round(x * 16) / 16 if integer else x).astype(np.float32)

    routes = set()
    for b, n, m, ns in BQ_SWEEP_CASES:
        x1, x2 = cloud(n, b, n), cloud(m + n, b, m)
        x2[:, 0] = 4.0  # no point within r
        xyz1, xyz2 = torch.from_numpy(x1).to(cuda_device), torch.from_numpy(x2).to(cuda_device)
        row2 = cuda.ball_query(xyz1, xyz2, 0.15, ns)
        oracle = tuple(torch.from_numpy(a).to(cuda_device) for a in reference.ball_query_np(x1, x2, 0.15, ns))
        assert all(torch.equal(r, o) for r, o in zip(row2, oracle)) and not bool(row2[1][:, 0].any())
        for i16 in (False, True):
            got = cuda.bq_keys(xyz1, xyz2, 0.15, ns, i16)
            want = bq_i16_probe.bq_keys_plain(xyz1, xyz2, 0.15, ns, i16)
            assert all(torch.equal(g, w) and torch.equal(g, r) for g, w, r in zip(got, want, row2)), (n, ns, i16)
            routes.add(("keys", bq_probes.key_route(xyz1, m, i16)[-1], bq_probes.staged_whole(n)))
        for tm in (128, 256):
            want = bq_fat_probe.bq_fat_plain(xyz1, xyz2, 0.15, ns, tm)
            routes.add(("fat", bq_probes.fat_route(xyz1, m, tm)[-1], bq_probes.staged_whole(n)))
            for k in bq_probes.fat_sizes(tm):  # every cluster size the plan chooses from
                with monkeypatch.context() as patch:
                    patch.setattr(bq_probes, "fat_plan", lambda *args, k=k: k)
                    got = cuda.bq_fat(xyz1, xyz2, 0.15, ns, tm)
                assert all(torch.equal(g, w) and torch.equal(g, r) for g, w, r in zip(got, want, row2)), (n, ns, tm, k)
    for kernel, bulk in (("keys", "bulk"), ("fat", "multicast")):  # each staging route ran, the ring among them
        assert {(kernel, "cooperative", True), (kernel, bulk, True), (kernel, bulk, False)} <= routes
    xyz1 = torch.from_numpy(cloud(2, 2, 4096)).to(cuda_device)
    xyz2 = xyz1[:, ::4].contiguous()
    for w, fits in ((1536, True), (512, False)):
        plan = bq_cond_probe.precut_plan(xyz1, xyz2, 0.05, w)
        assert bool(bq_cond_probe.fits_of(plan, w)) == fits
        guard = bq_cond_probe.fits_of(plan, w)
        for ns in (8, 40):
            args = (plan["win"], plan["permw"], plan["q_tiles"], 4096, 0.05, ns)
            got = cuda.bq_precut_cond(*args)
            assert all(torch.equal(g, p) for g, p in zip(got, bq_cond_probe.precut_plain(*args)))
            assert all(torch.equal(g, p) for g, p in zip(cuda.bq_precut_decomp(*args), got))
            row7 = cuda.ball_query_tiles(plan["xs"], plan["perm"], plan["q_tiles"].reshape(2, 1024, 3),
                                         plan["lo"], 0.05, ns, w)
            assert torch.equal(got[0].reshape(2, 1024, ns), row7[0]) and torch.equal(got[1].reshape(2, 1024), row7[1])
            guarded = cuda.bq_precut_cond(*args, fits=guard)
            if fits:
                assert all(torch.equal(g, p) for g, p in zip(guarded, got))
                exact = bq_cond_probe.in_query_order(plan, *got)
                assert all(torch.equal(g, r) for g, r in zip(exact, cuda.ball_query(xyz1, xyz2, 0.05, ns)))
            else:
                assert not any(bool(g.any()) for g in guarded)


@pytest.mark.parametrize("c", [64, 32, 8, 3])
def test_gather_probe_kernels_equal_their_plain_versions(cuda_device, c):
    """The four gather probe kernels (``ops.cuda.gather_probes``) against the
    probe tools' plain versions and ``group_points``, bit for bit: B = 5 (not
    a multiple of 8), C = 3 (no 16-byte vectors) beside the probes' widths;
    the window kernel at every unroll on x-sorted points whose last tile's
    second block is clamped, also against row 9 at window starts kblk * W;
    the fused kernel's emitted indices against its input."""
    from pointnet2_tpu_torch.ops.cuda.gather_probes import relative_indices
    from pointnet2_tpu_torch.tools import fused_gather_probe, gather_probe, sp_gather_probe

    b, n, m, k = 5, 2048, 256, 16
    rng = np.random.RandomState(c)
    pts = torch.from_numpy(rng.rand(b, n, c).astype(np.float32)).to(cuda_device)
    idx = torch.from_numpy(rng.randint(0, n, (b, m * k)).astype(np.int32)).to(cuda_device)
    want = core.group_points(pts, idx.view(b, m, k)).view(b, m * k, c)
    for kernel, plain in ((cuda.gather_rows, gather_probe.gather_rows_plain),
                          (cuda.gather_rows_staged, sp_gather_probe.sp_row_plain)):
        got = kernel(pts, idx)
        assert torch.equal(got, plain(pts, idx)) and torch.equal(got, want), kernel.__name__
    rows, emitted = cuda.gather_fused_idx(pts, idx)
    plain_rows, plain_idx = fused_gather_probe.fused_idx_plain(pts, idx)
    assert torch.equal(rows, plain_rows) and torch.equal(rows, want)
    assert torch.equal(emitted, plain_idx) and torch.equal(emitted, idx[:, None, :])

    shapes = dict(n=n, m=m, k=k, span=384, w=512, tm=128)
    pts_np, idx_np, kblk_np = sp_gather_probe.regime_inputs(b, c, shapes)
    assert kblk_np[0, -1] == n // 512 - 1
    sorted_pts, idx3, kblk = (torch.from_numpy(a).to(cuda_device) for a in (pts_np, idx_np, kblk_np))
    rel = relative_indices(idx3, kblk, 512, 128).view(b, m, k)
    row9 = cuda.window_gather(sorted_pts, kblk * 512, rel).view(b, m * k, c)
    window_want = core.group_points(sorted_pts, idx3).view(b, m * k, c)
    for unroll in (4, 8, 16):
        got = cuda.gather_window_staged(sorted_pts, idx3, kblk, 512, 128, unroll)
        assert torch.equal(got, sp_gather_probe.sp_win_plain(sorted_pts, idx3, kblk, 512, 128)), unroll
        assert torch.equal(got, window_want) and torch.equal(got, row9), unroll
    torch.cuda.synchronize()


@pytest.mark.parametrize("k", [16, 32, 64])
def test_out4d_probe_kernels_equal_their_plain_versions(cuda_device, k):
    """The 4-D window grouping's two kernels (``bq_precut_pos``,
    ``gather_window_out4d``) against ``wingather_out4d_probe``'s plain
    versions, bit for bit, and against rows 8 and 9: the pre-cut windows'
    idx, pos and cnt equal row 8 reading them in place, and the 4-D gather
    equals row 9 at rows ``lo + pos``. B = 3 clouds of 2048 points, 1024
    queries apart from them (empty balls, balls short of K), W = 512 (the
    last tile's second block clamped); K = 16 and 32 (a lane a slot), 64 (the
    list in the output rows); C = 3 (no 16-byte vectors) and 32. The whole
    function equals the port's shipped grouping."""
    from pointnet2_tpu_torch.tools import wingather_out4d_probe as probe

    rng = np.random.RandomState(k)
    box = np.array(probe.BOX, np.float32)
    xyz_np = (rng.rand(3, 2048, 3) * box).astype(np.float32)
    inputs = torch.from_numpy(np.concatenate([xyz_np, rng.rand(3, 2048, 3).astype(np.float32)], -1)).to(cuda_device)
    xyz = torch.from_numpy(xyz_np).to(cuda_device)
    new_xyz = torch.from_numpy((rng.rand(3, 1024, 3) * box).astype(np.float32)).to(cuda_device)
    plan = probe.window_plan(inputs, xyz, new_xyz, 0.3, 512)
    args = (plan["win"], plan["permw"], plan["q_tiles"], 2048, 0.3, k)
    got = cuda.bq_precut_pos(*args)
    assert all(torch.equal(g, p) for g, p in zip(got, probe.precut_pos_plain(*args)))
    row8 = cuda.ball_query_tiles_pos(plan["xs"], plan["perm"], plan["qs"], plan["lo"], 0.3, k, 512)
    assert all(torch.equal(g.reshape(r.shape), r) for g, r in zip(got, row8))
    assert int((got[2] == 0).sum()) > 0
    kblk, rel = probe.relative_rows(got[1], plan["lo"], plan["wblk"])
    assert int(kblk.max()) == 2048 // plan["wblk"] - 1
    for c in (3, 32):
        zp_s = plan["sorted_inputs"] @ torch.from_numpy(rng.randn(6, c).astype(np.float32)).to(cuda_device)
        out = cuda.gather_window_out4d(zp_s, rel, kblk, plan["wblk"], plan["tm"], k)
        assert torch.equal(out, probe.window_out4d_plain(zp_s, rel, kblk, plan["wblk"], plan["tm"], k)), c
        assert torch.equal(out, cuda.window_gather(zp_s, plan["lo"], got[1].reshape(3, 1024, k))), c
    w0 = torch.from_numpy(rng.randn(6, 32).astype(np.float32) * 0.1).to(cuda_device)
    b0 = torch.zeros(32, device=cuda_device)
    a = ops.project_group_calibrated(inputs, w0, b0, xyz, new_xyz, 0.3, k, 512)
    b = probe.project_group_sliced_4d(inputs, w0, b0, xyz, new_xyz, 0.3, k, 512)
    assert all(torch.equal(x, y) for x, y in zip(a[:5], b[:5])) and bool(a[5]) == bool(b[5])
    torch.cuda.synchronize()


# The window gathers' span edges: clouds of 2048 rows in blocks of W = 512,
# tiles of 128 queries, window positions drawn over [0, 2W). (B, C, K, first
# blocks of the tiles, one row a tile, unaligned rows): clamped tiles whose
# positions pass W; C = 3 (the cooperative route), 64, 1024 (chunks of 4
# rows: each part's ring wraps) and 32 through an unaligned array
# (cooperative again); K = 16 and 64; spans of one row; 12 tiles (22 parts
# a tile on 132 SMs, not dividing the span) and 160 tiles (one part a tile,
# the ring wrapping through the span).
SPAN_EDGES = [
    (3, 3, 16, (0, 2, 3, 3), False, False),
    (3, 64, 16, (0, 2, 3, 3), False, False),
    (3, 64, 64, (0, 2, 3, 3), False, False),
    (3, 1024, 16, (0, 2, 3, 3), False, False),
    (3, 32, 16, (0, 1, 2, 3), True, False),
    (3, 32, 16, (0, 2, 3, 3), False, True),
    (40, 32, 16, (0, 1, 2, 3), False, False),
    (40, 32, 64, (0, 1, 2, 3), False, True),
    (40, 3, 64, (1, 3), False, False),
]
# (splits, chunk_rows) that `plan` is made to answer beside its own: parts
# not dividing the span in chunks of 5 rows, and one-row chunks (the ring
# wraps at every third row).
SPAN_PLANS = [None, (3, 5), (7, 1)]


@pytest.mark.parametrize("b, c, k, kblk_of, one_row, unaligned", SPAN_EDGES)
def test_window_gathers_on_the_span_edges(cuda_device, monkeypatch, b, c, k, kblk_of, one_row, unaligned):
    """``gather_window_staged`` (every unroll) and ``gather_window_out4d``,
    each at its plan and with ``plan`` answering each ``SPAN_PLANS`` pair,
    against their plain versions, ``group_points`` and row 9 at the rows
    the positions name, bit for bit."""
    from pointnet2_tpu_torch.ops.cuda import gather_probes
    from pointnet2_tpu_torch.tools import sp_gather_probe, wingather_out4d_probe

    n, w, tm = 2048, 512, 128
    t = len(kblk_of)
    rng = np.random.RandomState(b * 1000 + c * 10 + k)
    values = torch.from_numpy(rng.rand(b * n * c + 1).astype(np.float32)).to(cuda_device)
    pts = (values[1:] if unaligned else values[:-1]).view(b, n, c)
    kblk = torch.tensor([kblk_of] * b, dtype=torch.int32, device=cuda_device)
    rel_np = rng.randint(0, 2 * w, (b, t, 1 if one_row else tm * k))
    rel = torch.from_numpy(np.broadcast_to(rel_np, (b, t, tm * k)).astype(np.int32).copy()).to(cuda_device)
    assert gather_probes.span_route("edge", pts, b * t, tm * k)[0] == (c % 4 == 0 and not unaligned)
    rows = sp_gather_probe.window_rows(rel, kblk, n, w).reshape(b, t * tm, k)
    want = core.group_points(pts, rows)
    assert torch.equal(cuda.window_gather(pts, torch.zeros_like(kblk), rows.to(torch.int32)), want)
    idx3 = (kblk.long()[:, :, None] * w + rel.long()).to(torch.int32).reshape(b, t * tm, k)
    assert torch.equal(sp_gather_probe.sp_win_plain(pts, idx3, kblk, w, tm).view(want.shape), want)
    assert torch.equal(wingather_out4d_probe.window_out4d_plain(pts, rel[:, :, None], kblk, w, tm, k), want)
    planned = gather_probes.plan
    for pair in SPAN_PLANS:
        with monkeypatch.context() as patch:
            if pair is not None:
                patch.setattr(gather_probes, "plan", lambda *args, pair=pair: planned(*args)._replace(
                    splits=pair[0], chunk_rows=pair[1]))
            for unroll in (4, 8, 16):
                got = cuda.gather_window_staged(pts, idx3, kblk, w, tm, unroll)
                assert torch.equal(got.view(want.shape), want), (pair, unroll)
            assert torch.equal(cuda.gather_window_out4d(pts, rel[:, :, None], kblk, w, tm, k), want), pair
    torch.cuda.synchronize()


def test_window_gathers_never_fall_back_on_a_cuda_tensor(cuda_device, monkeypatch):
    """A launch the kernel refuses raises: the wrappers take no plain path."""
    from pointnet2_tpu_torch.ops.cuda import gather_probes

    pts = torch.rand(1, 1024, 8, device=cuda_device)
    idx = torch.zeros((1, 128, 4), dtype=torch.int32, device=cuda_device)
    kblk = torch.zeros((1, 1), dtype=torch.int32, device=cuda_device)
    # A ring of 3 x 8000 rows of 32 bytes: past the block's shared memory, which the wrapper is told fits.
    monkeypatch.setattr(gather_probes, "plan", lambda *args: gather_probes.SpanPlan(1, 8000, 3))
    monkeypatch.setattr(gather_probes, "window_shared_bytes", lambda *a: 0)
    with pytest.raises(RuntimeError, match="gather_window_staged kernel failed"):
        cuda.gather_window_staged(pts, idx, kblk, 256, 128, 4)
