"""The CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and carries the ``cuda``
marker; without a card each one skips (the ``cuda_device`` fixture decides,
at run time). The file imports neither JAX nor the JAX package, so it runs
on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider

Tolerances: FPS, ball query and kNN equal bit for bit; three_interpolate
within rtol=1e-6, atol=1e-6 (it is exact by construction; the tolerance is
the one ``chip_smoke.py`` holds it to).
"""

import numpy as np
import pytest
import torch

from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.ops import cuda

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
