"""The CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and carries the ``cuda``
marker; without a card each one skips (the ``cuda_device`` fixture decides,
at run time). The file imports neither JAX nor the JAX package, so it runs
on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerances: FPS, ball query and kNN equal bit for bit; three_interpolate
within rtol=1e-6, atol=1e-6 (it is exact by construction; the tolerance is
the one ``chip_smoke.py`` holds it to); three_interpolate_grad within
rtol=1e-5, atol=1e-5 (it sums a row's few dozen addends with float atomics,
in an order that changes from run to run, and so does ``index_add_``, the
plain version's sum on the card).
"""

import numpy as np
import pytest
import torch

from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.ops import core, cuda

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
     (2, 4096, 256, 0.25, 32)],
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


GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _grad_inputs(b, m, c, n, device):
    gen = torch.Generator(device=device).manual_seed(11)
    g = torch.randn((b, n, c), generator=gen, device=device)
    dist, idx = ops.three_nn(_cloud(12, b, n), _cloud(13, b, m), impl="cuda")
    return g, idx, ops.interpolation_weights(dist)


@pytest.mark.parametrize(
    "b,m,c,n",
    [(16, 16, 512, 64), (16, 64, 256, 256), (16, 256, 256, 1024), (16, 1024, 128, 8192),  # the train step's
     (2, 100, 7, 37), (1, 3, 33, 50)],  # C off the multiples of 32; M = 3: every query names every row
)
def test_three_interpolate_grad_kernel(cuda_device, b, m, c, n):
    g, idx, weight = _grad_inputs(b, m, c, n, cuda_device)
    got = ops.three_interpolate_grad(g, idx, weight, m, impl="cuda")
    want = ops.three_interpolate_grad(g, idx, weight, m, impl="torch")
    assert got.shape == (b, m, c) and got.is_contiguous()
    torch.testing.assert_close(got, want, **GRAD_TOL)
    exact = ops.three_interpolate_grad(g.double(), idx, weight.double(), m, impl="torch")
    torch.testing.assert_close(got.double(), exact, **GRAD_TOL)


def test_three_interpolate_grad_kernel_takes_a_non_contiguous_cotangent(cuda_device):
    g, idx, weight = _grad_inputs(2, 64, 40, 256, cuda_device)
    wide = torch.cat([g, torch.ones_like(g)], dim=-1)[..., :40]
    assert not wide.is_contiguous()
    got = cuda.three_interpolate_grad(wide, idx, weight, 64)
    want = cuda.three_interpolate_grad(g, idx, weight, 64)
    torch.testing.assert_close(got, want, **GRAD_TOL)
    # Read in place through its strides: the second half of a concat, and a
    # slice along the batch and the rows; copied first: channels that do not
    # lie next to each other (a transpose, a broadcast).
    tail = torch.cat([torch.ones_like(g), g], dim=-1)[..., 40:]
    torch.testing.assert_close(cuda.three_interpolate_grad(tail, idx, weight, 64), want, **GRAD_TOL)
    padded = torch.zeros((4, 300, 40), device=cuda_device)
    padded[::2, 10:266] = g
    torch.testing.assert_close(cuda.three_interpolate_grad(padded[::2, 10:266], idx, weight, 64), want, **GRAD_TOL)
    moved = g.transpose(1, 2).contiguous().transpose(1, 2)
    assert moved.stride(2) != 1
    torch.testing.assert_close(cuda.three_interpolate_grad(moved, idx, weight, 64), want, **GRAD_TOL)
    ones = torch.ones((), device=cuda_device).expand(2, 256, 40)
    torch.testing.assert_close(
        cuda.three_interpolate_grad(ones, idx, weight, 64),
        cuda.three_interpolate_grad(ones.contiguous(), idx, weight, 64), **GRAD_TOL,
    )
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


def test_three_interpolate_function_on_the_kernel_path(cuda_device):
    """Forward and backward through the two kernels against autograd through the plain forward."""
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    points = torch.randn((4, 64, 96), generator=gen, device=cuda_device, requires_grad=True)
    g, idx, weight = _grad_inputs(4, 64, 96, 256, cuda_device)
    weight = weight.requires_grad_()
    cuda.reset_launches()
    out = ops.three_interpolate(points, idx, weight)
    got_p, got_w = torch.autograd.grad(out, (points, weight), g)
    assert cuda.LAUNCHES["three_interpolate"] == 1 and cuda.LAUNCHES["three_interpolate_grad"] == 1
    want_p, want_w = torch.autograd.grad(core.three_interpolate(points, idx, weight), (points, weight), g)
    torch.testing.assert_close(got_p, want_p, **GRAD_TOL)
    torch.testing.assert_close(got_w, want_w, rtol=1e-5, atol=1e-4)


def test_fps_centroids_kernel_input_gradient(cuda_device):
    xyz = _cloud(15, 2, 300).requires_grad_()
    cot = torch.randn(2, 40, 3, device=cuda_device)
    (got,) = torch.autograd.grad(ops.fps_centroids(xyz, 40, impl="cuda")[1], (xyz,), cot)
    (want,) = torch.autograd.grad(ops.fps_centroids(xyz, 40, impl="torch")[1], (xyz,), cot)
    assert torch.equal(got, want)


def test_small_train_step_kernel_path_against_plain_path(cuda_device):
    """One Adam step, dropout off, from the same weights and batch: loss rtol
    1e-5; each parameter gradient within 1e-3 of its max abs (atomics and
    cuBLAS sum in other orders than the plain path's index_add_)."""
    from pointnet2_tpu_torch.config import Config
    from pointnet2_tpu_torch.train import Trainer

    cfg = Config(num_point=512, batch_size=4, l1_npoint=128, l2_npoint=32, l3_npoint=16, l4_npoint=8,
                 l1_nsample=8, l2_nsample=8, l3_nsample=8, l4_nsample=8)
    rng = np.random.RandomState(16)
    points = np.concatenate([rng.rand(4, 512, 3) * [8.0, 8.0, 4.9], rng.rand(4, 512, 3)], -1).astype(np.float32)
    batch = {"points": points, "labels": rng.randint(0, 9, (4, 512)),
             "weights": (rng.rand(4, 512) * (rng.rand(4, 512) > 0.25)).astype(np.float32)}
    runs = {}
    for impl in (None, "torch"):
        trainer = Trainer(cfg, ops_impl=impl, dropout_rate=0.0)
        trainer.init_state(seed=0)
        cuda.reset_launches()
        metrics = trainer.train_step(batch)
        runs[impl] = (metrics, {k: p.grad.clone() for k, p in trainer.model.named_parameters()}, dict(cuda.LAUNCHES))
    (got, got_grads, launches), (want, want_grads, plain_launches) = runs[None], runs["torch"]
    assert launches == {k: 4 for k in ("fps_centroids", "ball_query", "knn", "three_interpolate", "three_interpolate_grad")}
    assert not plain_launches
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


def test_wrappers_check_their_inputs(cuda_device):
    xyz = _cloud(9, 1, 64)
    with pytest.raises(ValueError, match="contiguous"):
        cuda.ball_query(xyz, xyz[:, ::2], 0.5, 4)
    with pytest.raises(ValueError, match="float32"):
        cuda.fps_centroids(xyz.double(), 8)
    with pytest.raises(ValueError, match="k"):
        cuda.knn(xyz, xyz, 17)
