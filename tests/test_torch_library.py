"""The kernels as ``pn2`` operators (``ops.library``), on the CPU.

``torch.library.opcheck`` holds each operator's schema, its fake
implementation against its CPU one (shapes, dtypes, strides; symbolic
shapes under AOT dispatch) and checks that no output aliases an input. The
CPU implementation is the plain version of ``ops.core``; the CUDA one, the
``ops.cuda`` wrapper, runs on the card (``tests/test_torch_cuda.py``).
``ops.*`` with ``impl`` None goes through the operators and equals
``impl="torch"`` bit for bit; ``impl="cuda"`` on a CPU tensor raises; an
exported one-op module keeps the operator as a node of its graph. The
operators have no Autograd kernel: where autograd records a float output's
gradient, ``impl=None`` on a CPU tensor calls the plain version, whose
gradients equal those of ``impl="torch"`` bit for bit and JAX's
``jax.grad`` of the same op within 1e-5 (atol) and 1e-4 (rtol).
"""

import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet2_tpu import ops as jops

from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.ops import core, library
from pointnet2_tpu_torch.ops.cuda import ballquery, fps, interpolate, wingather

cuda_knn = importlib.import_module("pointnet2_tpu_torch.ops.cuda.knn")


def _inputs(device="cpu"):
    """Small inputs for every operator, on ``device``: a cloud of 512 points,
    128 queries, and the sorted tiles and windows the calibrated ops hand
    their kernels (made on the CPU by the plain versions)."""
    g = torch.Generator().manual_seed(0)
    xyz = torch.rand(2, 512, 3, generator=g)
    new = xyz[:, :128].contiguous()
    perm, xs, _, qs, lo, _ = core.ball_query_window_plan(xyz, new, 0.2, 256)
    _, _, _, _, lo_r1, hi = core.ball_query_window_bounds(xyz, new, 0.2, 256)
    _, pos, _ = core.ball_query_tiles_pos(xs, perm, qs, lo, 0.2, 16, 256)
    kperm, kxs, _, kqs, klo = core.knn_window_plan(xyz, new, 256)
    dist, idx = core.three_nn(xyz, new)
    weight = core.interpolation_weights(dist)
    points = torch.rand(2, 128, 16, generator=g)
    skip = torch.rand(2, 512, 4, generator=g)
    cotangent = torch.rand(2, 512, 16, generator=g)
    cases = {
        "fps_centroids": [(xyz, 64)],
        "farthest_point_sample": [(xyz, 64)],
        "ball_query": [(xyz, new, 0.2, 16)],
        "ball_query_tiles": [(xs, perm, qs, lo, 0.2, 16, 256)],
        "ball_query_window_tiles": [(xyz, xs, perm, qs, lo_r1, hi, 0.2, 16, 256)],
        "ball_query_tiles_pos": [(xs, perm, qs, lo, 0.2, 16, 256)],
        "window_gather": [(torch.rand(2, 512, 8, generator=g), lo, pos)],
        "knn": [(xyz, new, 5), (xyz[:, :5].contiguous(), xyz[:, :5].contiguous(), 5)],  # k = M too
        "knn_tiles": [(kxs, kperm, kqs, klo, 3, 256)],
        "three_interpolate": [
            (points, idx, weight), (points, idx, weight, skip, "default"),
            (points.bfloat16(), idx, weight, skip, "default"), (points.bfloat16(), idx, weight, skip.bfloat16()),
        ],
        "three_interpolate_grad": [
            (cotangent, idx, weight, 128), (cotangent, idx, weight, 128, "default", torch.bfloat16),
            (cotangent[..., :12], idx, weight, 128),  # a cotangent read through its strides
        ],
    }
    return {
        name: [tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args) for args in argsets]
        for name, argsets in cases.items()
    }


@pytest.mark.parametrize("name", sorted(library.SCHEMAS))
def test_opcheck(name):
    for args in _inputs()[name]:
        result = torch.library.opcheck(getattr(torch.ops.pn2, name).default, args)
        assert set(result.values()) == {"SUCCESS"}, (name, result)


def test_every_leaf_wrapper_is_registered_without_its_route():
    wrappers = {
        "fps_centroids": fps.fps_centroids, "farthest_point_sample": fps.farthest_point_sample,
        "ball_query": ballquery.ball_query, "ball_query_tiles": ballquery.ball_query_tiles,
        "ball_query_window_tiles": ballquery.ball_query_window_tiles,
        "ball_query_tiles_pos": wingather.ball_query_tiles_pos, "window_gather": wingather.window_gather,
        "knn": cuda_knn.knn, "knn_tiles": cuda_knn.knn_tiles,
        "three_interpolate_grad": interpolate.three_interpolate_grad,
    }
    assert set(library.SCHEMAS) == set(wrappers) | {"three_interpolate"} == set(library.CUDA) == set(library.CPU)
    for name, wrapper in wrappers.items():
        assert library.CUDA[name] is wrapper
    for name in library.SCHEMAS:
        schema = getattr(torch.ops.pn2, name).default._schema
        assert "route" not in [a.name for a in schema.arguments], name


@pytest.mark.parametrize("op", ["fps_centroids", "farthest_point_sample", "ball_query", "knn", "three_nn",
                                "three_interpolate_grad", "ball_query_calibrated", "knn_calibrated"])
def test_default_dispatch_on_the_cpu_equals_the_plain_version(op):
    """``impl=None`` on a CPU tensor: the operator's CPU implementation, the
    plain version bit for bit; ``impl="cuda"`` raises."""
    g = torch.Generator().manual_seed(1)
    xyz = torch.rand(2, 512, 3, generator=g)
    new = xyz[:, :128].contiguous()
    dist, idx = core.three_nn(xyz, new)
    args = {
        "fps_centroids": (xyz, 32), "farthest_point_sample": (xyz, 32), "ball_query": (xyz, new, 0.2, 16),
        "knn": (xyz, new, 4), "three_nn": (xyz, new),
        "three_interpolate_grad": (torch.rand(2, 512, 8, generator=g), idx, core.interpolation_weights(dist), 128),
        "ball_query_calibrated": (xyz, new, 0.2, 16, 256), "knn_calibrated": (xyz, new, 3, 256),
    }[op]
    got, want = getattr(ops, op)(*args), getattr(ops, op)(*args, impl="torch")
    for a, b in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(ops, op)(*args, impl="cuda")


class _OneOp(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


@pytest.mark.parametrize("name", ["fps_centroids", "ball_query", "knn", "three_interpolate", "window_gather"])
def test_export_keeps_the_operator(name):
    """A one-op module exported at a symbolic batch holds ``pn2::<name>`` as a
    node, and the loaded program gives the eager results at another batch."""
    tensors = {
        "fps_centroids": lambda x: ops.fps_centroids(x, 16),
        "ball_query": lambda x: ops.ball_query(x, x[:, :32], 0.3, 8),
        "knn": lambda x: ops.knn(x, x[:, :32], 3),
        "three_interpolate": lambda x: ops.three_interpolate(x[:, :32], torch.zeros_like(x, dtype=torch.int32),
                                                             x.abs(), skip=x),
        "window_gather": lambda x: torch.ops.pn2.window_gather(
            x, torch.zeros(x.shape[0], 1, dtype=torch.int32, device=x.device), (x[..., :2] * 4).int()),
    }[name]
    x = torch.rand(3, 128, 3)
    with torch.no_grad():
        program = torch.export.export(_OneOp(tensors), (x,), dynamic_shapes=({0: torch.export.Dim("b", min=1)},))
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert f"pn2.{name}.default" in targets, targets
    y = torch.rand(5, 128, 3)
    got, want = program.module()(y), tensors(y)
    for a, b in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)


def _gradient_case(op):
    """``(torch_loss(impl, *inputs), jax_loss(*inputs), numpy inputs)`` for an
    op with a float output: a fixed random cotangent contracted with it (the
    sum of squares for the grouped rows, whose query order the windowed path
    may change). The cloud is long in x, so that the calibrated windows
    certify (``ok``) and equal the exact ops, as JAX's CPU path computes."""
    rng = np.random.RandomState(2)
    xyz = (rng.rand(2, 1024, 3) * np.float32([16, 1, 1])).astype(np.float32)
    if op == "project_group_calibrated":
        new = xyz[:, :512].copy()
        inputs = rng.rand(2, 1024, 6).astype(np.float32)
        w0, b0 = rng.randn(6, 8).astype(np.float32), rng.randn(8).astype(np.float32)

        def torch_loss(impl, inputs, w0, b0):
            out = ops.project_group_calibrated(inputs, w0, b0, torch.from_numpy(xyz), torch.from_numpy(new),
                                               0.5, 16, 512, impl=impl)
            assert bool(out[-1])
            return (out[0] ** 2).sum()

        def jax_loss(inputs, w0, b0):
            return (jops.project_group_calibrated(inputs, w0, b0, xyz, new, 0.5, 16, 512)[0] ** 2).sum()

        return torch_loss, jax_loss, (inputs, w0, b0)
    queries = xyz + np.float32(0.05) * rng.rand(*xyz.shape).astype(np.float32)
    k = 3 if "three_nn" in op else 5
    cot = rng.rand(2, 1024, k).astype(np.float32)
    args = {"knn": (k,), "knn_calibrated": (k, 512), "three_nn": (), "three_nn_calibrated": (512,)}[op]
    pair = (queries, xyz) if "three_nn" in op else (xyz, queries)  # three_nn takes the queries first

    def torch_loss(impl, x1, x2):
        out = getattr(ops, op)(x1, x2, *args, impl=impl)
        assert "calibrated" not in op or bool(out[-1])
        return (out[0] * torch.from_numpy(cot)).sum()

    def jax_loss(x1, x2):
        return (getattr(jops, op)(x1, x2, *args)[0] * cot).sum()

    return torch_loss, jax_loss, pair


@pytest.mark.parametrize("op", ["knn", "three_nn", "knn_calibrated", "three_nn_calibrated",
                                "project_group_calibrated"])
def test_default_dispatch_on_the_cpu_keeps_the_gradients(op):
    torch_loss, jax_loss, inputs = _gradient_case(op)
    grads = {}
    for impl in (None, "torch"):
        leaves = [torch.tensor(a, requires_grad=True) for a in inputs]
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # the autograd fallback of an operator warns at backward
            torch_loss(impl, *leaves).backward()
        grads[impl] = [leaf.grad for leaf in leaves]
    want = jax.grad(jax_loss, argnums=tuple(range(len(inputs))))(*map(jnp.asarray, inputs))
    for got, plain, ref in zip(grads[None], grads["torch"], want):
        assert got is not None and torch.equal(got, plain)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-4)


def test_three_interpolate_grad_on_the_cpu_keeps_its_gradients():
    """The cotangent op's own gradients (with respect to ``g`` and ``weight``)
    under ``impl=None`` on a CPU tensor equal the plain version's."""
    cotangent, idx, weight, m = _inputs()["three_interpolate_grad"][0]
    grads = {}
    for impl in (None, "torch"):
        g, w = cotangent.clone().requires_grad_(), weight.clone().requires_grad_()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            (ops.three_interpolate_grad(g, idx, w, m, impl=impl) ** 2).sum().backward()
        grads[impl] = (g.grad, w.grad)
    assert all(a is not None and torch.equal(a, b) for a, b in zip(grads[None], grads["torch"]))
