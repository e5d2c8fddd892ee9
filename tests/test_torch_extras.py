"""The port's ``nn/extras.py`` against the flax layers of ``pointnet2_tpu/nn/extras.py``.

Each flax layer is initialised, every leaf of its tree replaced by seeded
values (moving statistics included), and the tree handed to the port layer
through ``convert.state_dict_from_flax``; inputs come from a numpy seed.
Outputs agree within rtol 1e-5 (atol 1e-6 for values near zero), in eval and
in train mode, where the updated moving statistics are held too.
"""

import itertools
import math

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pointnet2_tpu.nn import extras as jax_extras
from pointnet2_tpu_torch.convert import _flax_key, state_dict_from_flax
from pointnet2_tpu_torch.nn import extras

TOL = dict(rtol=1e-5, atol=1e-6)


def _randomize(variables, seed):
    rng = np.random.RandomState(seed)
    out = {}
    for path, leaf in flatten_dict(jax.tree_util.tree_map(np.asarray, variables)).items():
        if path[-1] == "var":
            value = rng.uniform(0.5, 2.0, leaf.shape)
        elif path[-1] == "scale":
            value = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            value = rng.normal(0, 0.3, leaf.shape)
        out[path] = value.astype(np.float32)
    return unflatten_dict(out)


def _compare(jax_layer, port_layer, x, seed, train=False):
    variables = _randomize(jax_layer.init(jax.random.PRNGKey(0), x), seed)
    port_layer.load_state_dict(state_dict_from_flax(variables, port_layer))
    with jax.default_matmul_precision("highest"):
        if train:
            want, updates = jax_layer.apply(variables, x, train=True, bn_momentum=0.8, mutable=["batch_stats"])
        else:
            want = jax_layer.apply(variables, x)
    port_layer.train(train)
    with torch.no_grad():
        got = port_layer(torch.from_numpy(x), 0.8)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if train:
        stats = {_flax_key(name)[0]: buf.numpy() for name, buf in port_layer.named_buffers()}
        for path, ref in flatten_dict(updates).items():
            np.testing.assert_allclose(stats[path], np.asarray(ref), **TOL)
    return got


CONVS = [
    (nd, stride, padding)
    for nd, stride, padding in itertools.product((1, 2, 3), (1, 2), ("SAME", "VALID"))
]


@pytest.mark.parametrize("nd,stride,padding", CONVS)
def test_conv_matches_flax(nd, stride, padding):
    """Odd spatial sizes, so that a strided "SAME" pads unevenly (the extra
    row at the end, as lax puts it)."""
    spatial = {1: (17,), 2: (9, 7), 3: (5, 7, 6)}[nd]
    kernel = {1: (3,), 2: (3, 2), 3: (3, 2, 3)}[nd]
    x = np.random.RandomState(nd).randn(2, *spatial, 4).astype(np.float32)
    strides = (stride,) * nd
    jax_layer = jax_extras.ConvND(features=6, kernel_size=kernel, strides=strides, padding=padding)
    port_layer = extras.ConvND(4, 6, kernel, strides=strides, padding=padding)
    got = _compare(jax_layer, port_layer, x, 10 + nd)
    if padding == "SAME":
        assert got.shape[1:-1] == tuple(math.ceil(s / stride) for s in spatial)
    assert float(got.min()) >= 0.0  # the ReLU


@pytest.mark.parametrize("train", [False, True])
def test_conv_with_batch_norm_and_no_activation_matches_flax(train):
    x = np.random.RandomState(4).randn(3, 6, 6, 2).astype(np.float32)
    jax_layer = jax_extras.ConvND(features=5, kernel_size=(3, 3), strides=(2, 2), use_bn=True, activation=None)
    port_layer = extras.ConvND(2, 5, (3, 3), strides=(2, 2), use_bn=True, activation=None)
    got = _compare(jax_layer, port_layer, x, 5, train)
    assert float(got.min()) < 0.0  # no ReLU


@pytest.mark.parametrize("size", [(4, 4), (5, 3)])
@pytest.mark.parametrize("kernel,padding", [((3, 3), "SAME"), ((3, 3), "VALID"), ((4, 4), "SAME"), ((2, 3), "SAME")])
def test_conv_transpose_matches_flax(kernel, padding, size):
    """Stride 2, flax's transpose_kernel=False: an un-flipped (kh, kw, in, out) kernel."""
    x = np.random.RandomState(6).randn(2, *size, 3).astype(np.float32)
    jax_layer = jax_extras.ConvTranspose2D(features=5, kernel_size=kernel, strides=(2, 2), padding=padding)
    port_layer = extras.ConvTranspose2D(3, 5, kernel, strides=(2, 2), padding=padding)
    got = _compare(jax_layer, port_layer, x, 7)
    if padding == "SAME":
        assert got.shape[1:3] == (2 * size[0], 2 * size[1])


def test_conv_transpose_is_not_pytorchs_with_the_same_numbers():
    """The mapping matters: the flax kernel's numbers used as they stand by
    ``F.conv_transpose2d`` (in, out swapped, nothing flipped) give another result."""
    x = np.random.RandomState(8).randn(1, 4, 4, 3).astype(np.float32)
    port_layer = extras.ConvTranspose2D(3, 5, activation=None)
    kernel = port_layer.ConvTranspose_0.kernel.detach()
    with torch.no_grad():
        got = port_layer(torch.from_numpy(x))
        naive = torch.nn.functional.conv_transpose2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), kernel.permute(2, 3, 0, 1), stride=2, padding=1, output_padding=1
        ).permute(0, 2, 3, 1)
    assert got.shape == naive.shape
    assert not torch.allclose(got, naive, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("use_bn,train", [(False, False), (True, False), (True, True)])
def test_fully_connected_matches_flax(use_bn, train):
    x = np.random.RandomState(9).randn(6, 10).astype(np.float32)
    jax_layer = jax_extras.FullyConnected(features=7, use_bn=use_bn)
    port_layer = extras.FullyConnected(10, 7, use_bn=use_bn)
    _compare(jax_layer, port_layer, x, 12, train)


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
@pytest.mark.parametrize("name", ["max_pool2d", "avg_pool2d", "max_pool3d", "avg_pool3d"])
def test_pools_match_flax(name, padding):
    nd = int(name[-2])
    shape = (2, 7, 5, 3) if nd == 2 else (2, 5, 4, 7, 3)  # odd sizes: "SAME" pads
    x = np.random.RandomState(nd).randn(*shape).astype(np.float32)
    want = np.asarray(getattr(jax_extras, name)(x, padding=padding))
    got = getattr(extras, name)(torch.from_numpy(x), padding=padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    kw = dict(kernel_size=(3,) * nd, strides=(1,) + (2,) * (nd - 1), padding=padding)
    np.testing.assert_allclose(
        getattr(extras, name)(torch.from_numpy(x), **kw).numpy(),
        np.asarray(getattr(jax_extras, name)(x, **kw)), **TOL,
    )


def test_xavier_init_and_flax_names():
    torch.manual_seed(0)
    conv = extras.ConvND(4, 6, (3, 3), use_bn=True)
    assert sorted(conv.state_dict()) == [
        "BatchNorm_0.bias", "BatchNorm_0.mean", "BatchNorm_0.scale", "BatchNorm_0.var",
        "Conv_0.bias", "Conv_0.kernel",
    ]
    limit = math.sqrt(6.0 / ((4 + 6) * 9))
    kernel = conv.Conv_0.kernel.detach()
    assert kernel.shape == (3, 3, 4, 6)
    assert float(kernel.abs().max()) <= limit and float(kernel.abs().max()) > 0.8 * limit
    assert not conv.Conv_0.bias.detach().any()
    fc = extras.FullyConnected(10, 7)
    assert float(fc.Dense_0.weight.detach().abs().max()) <= math.sqrt(6.0 / 17)
    assert sorted(extras.ConvTranspose2D(3, 5).state_dict()) == ["ConvTranspose_0.bias", "ConvTranspose_0.kernel"]


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="padding"):
        extras.ConvND(2, 3, (3,), padding="CIRCULAR")
    with pytest.raises(ValueError, match="activation"):
        extras.FullyConnected(2, 3, activation="gelu")
    with pytest.raises(ValueError, match="1-D, 2-D or 3-D"):
        extras.ConvND(2, 3, (1, 1, 1, 1))
    with pytest.raises(ValueError, match="padding"):
        extras.max_pool2d(torch.zeros(1, 4, 4, 1), padding="same")
