"""The order in which three_interpolate's backward sums, on the CPU.

The CUDA backward (``csrc/interpolate.cu`` ``pn2_three_interpolate_grad``)
sums each element of ``dpoints`` in one fixed order, that of its plain
version ``ops.core.three_interpolate_grad``: slot j = 0, 1, 2, and within a
slot the queries in ascending order, from +0.0, each product rounded before
its add. These tests pin that order on the plain version, on seeded inputs
chosen so that another order gives other bits (addends of mixed magnitudes,
rows named by many queries), and hold the plain version to the JAX package's
cotangent (``jax.vjp`` of the XLA gather form, and the Pallas backward in
interpret mode), which sums in other orders: within a bound derived for
reordering a float32 sum, ``count * 2**-23 * sum |addend|`` an element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pointnet2_tpu.ops import core as jcore
from pointnet2_tpu.ops.pallas.interpolate import _ti_bwd
from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.ops import core

EPS32 = 2.0**-23


def _inputs(seed, b, m, n, c):
    """Mixed magnitudes (1e-6 to 1e6, both signs), zero weights, and indices
    drawn from few rows, with a query naming one row twice now and then."""
    rng = np.random.RandomState(seed)
    g = (rng.randn(b, n, c) * 10.0 ** rng.randint(-6, 7, (b, n, c))).astype(np.float32)
    idx = rng.randint(0, m, (b, n, 3)).astype(np.int32)
    idx[:, ::7, 1] = idx[:, ::7, 0]
    weight = rng.rand(b, n, 3).astype(np.float32)
    weight[:, ::5, 2] = 0.0
    weight /= np.maximum(weight.sum(-1, keepdims=True), np.float32(1e-10))
    return g, idx, weight


def _sequential(g, idx, weight, m, order):
    """dpoints summed one addend at a time in float32, from +0.0: ``order``
    "jq" (slot, then query) or "qj" (query, then slot)."""
    b, n, c = g.shape
    out = np.zeros((b, m, c), np.float32)
    pairs = [(j, q) for j in range(3) for q in range(n)] if order == "jq" else [
        (j, q) for q in range(n) for j in range(3)]
    for bi in range(b):
        for j, q in pairs:
            row = idx[bi, q, j]
            out[bi, row] = out[bi, row] + weight[bi, q, j] * g[bi, q]  # float32 product, then float32 sum
    return out


@pytest.mark.parametrize("b,m,n,c", [(2, 3, 50, 33), (1, 16, 256, 8), (2, 64, 300, 5)])
def test_plain_backward_sums_slot_then_query(b, m, n, c):
    g, idx, weight = _inputs(b * 100 + m, b, m, n, c)
    got = core.three_interpolate_grad(torch.from_numpy(g), torch.from_numpy(idx), torch.from_numpy(weight), m)
    want = _sequential(g, idx, weight, m, "jq")
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    # The inputs tell the orders apart: summing query by query gives other bits.
    assert not np.array_equal(_sequential(g, idx, weight, m, "qj").view(np.int32), want.view(np.int32))
    assert torch.equal(ops.three_interpolate_grad(torch.from_numpy(g), torch.from_numpy(idx),
                                                  torch.from_numpy(weight), m), got)


def test_plain_backward_starts_from_positive_zero():
    """A row whose only addend is -0.0 (a zero weight times a negative g) is
    +0.0, as 0.0 + -0.0 is; a row no query names is +0.0."""
    g = torch.tensor([[[-1.0, 2.0]]])
    idx = torch.tensor([[[0, 0, 0]]], dtype=torch.int32)
    weight = torch.tensor([[[0.0, 0.0, 0.0]]])
    got = core.three_interpolate_grad(g, idx, weight, 2)
    assert not torch.signbit(got).any() and torch.equal(got, torch.zeros(1, 2, 2))


@pytest.mark.parametrize("b,m,n,c", [(2, 37, 200, 70), (1, 16, 64, 129)])
def test_plain_backward_within_the_reorder_bound_of_jax(b, m, n, c):
    g, idx, weight = _inputs(b * 1000 + m, b, m, n, c)
    got = core.three_interpolate_grad(torch.from_numpy(g), torch.from_numpy(idx), torch.from_numpy(weight), m)
    got = got.numpy().astype(np.float64)
    # The bound: count * eps * sum |addend| a row (count of the row's addends).
    abs_sum = core.three_interpolate_grad(torch.from_numpy(np.abs(g)).double(), torch.from_numpy(idx),
                                          torch.from_numpy(weight).double(), m).numpy()
    counts = np.stack([np.bincount(idx[bi].ravel(), minlength=m) for bi in range(b)])[..., None]
    bound = np.maximum(counts, 1) * EPS32 * abs_sum
    points = np.zeros((b, m, c), np.float32)
    _, vjp = jax.vjp(lambda p: jcore.three_interpolate(p, idx, weight), jnp.asarray(points))
    xla = np.asarray(vjp(jnp.asarray(g))[0]).astype(np.float64)
    assert (np.abs(got - xla) <= bound).all()
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(_ti_bwd(jnp.asarray(g), jnp.asarray(idx), jnp.asarray(weight), m, "highest", 128))
    assert (np.abs(got - pallas.astype(np.float64)) <= bound).all()
