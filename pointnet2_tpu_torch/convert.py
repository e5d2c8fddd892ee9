"""Weights across frameworks: flax variable trees to ``state_dict``s, and seeded weights.

The JAX model's ``model.init`` returns ``{"params": ..., "batch_stats": ...}``;
with its leaves as numpy arrays, ``from_flax_variables`` maps it onto the
port's ``PointNet2SemSeg`` by name:

- ``params/<path>/kernel`` (in, out) -> ``<path>.weight`` (out, in), transposed
  for ``nn.Linear``;
- ``batch_stats/<path>/{mean,var}`` -> the BatchNorm buffers ``<path>.{mean,var}``;
- every other ``params`` leaf (``w0``, ``b0``, ``bias``, ``scale``) keeps its
  layout under the dotted path.

Every leaf is consumed exactly once: a missing or a leftover leaf raises.
``to_flax_variables`` is the inverse, from a ``state_dict`` back to the tree.
``init_variables`` builds a tree in the same flax layout from a seed, so a run
needs neither JAX nor a checkpoint.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.models.pointnet2_seg import PointNet2SemSeg


def _flax_key(port_key: str) -> tuple[tuple[str, ...], bool]:
    """Port state_dict key -> (flax leaf path with collection, transposed?)."""
    parts = tuple(port_key.split("."))
    leaf = parts[-1]
    if leaf in ("mean", "var"):
        return ("batch_stats", *parts), False
    if leaf == "weight":
        return ("params", *parts[:-1], "kernel"), True
    return ("params", *parts), False


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()) -> dict[tuple[str, ...], np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = (*prefix, str(key))
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def state_dict_from_flax(variables: Mapping, module: nn.Module) -> dict[str, torch.Tensor]:
    """Map a flax variable tree onto ``module``'s state_dict keys, by name.

    Raises KeyError for a missing or a leftover leaf and ValueError for a
    shape that does not match.
    """
    flat = _flatten(variables)
    out = {}
    for key, tensor in module.state_dict().items():
        path, transposed = _flax_key(key)
        if path not in flat:
            raise KeyError(f"flax variables lack {'/'.join(path)} (for {key})")
        arr = np.asarray(flat.pop(path), dtype=np.float32)
        if transposed:
            arr = arr.T
        if arr.shape != tuple(tensor.shape):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != {tuple(tensor.shape)} of {key}")
        out[key] = torch.tensor(arr)  # a copy: the tree's arrays may be read-only
    if flat:
        raise KeyError(f"unused flax leaves: {sorted('/'.join(p) for p in flat)}")
    return out


def _template(use_color: bool, num_classes: int) -> nn.Module:
    """The port model on the meta device: names and shapes, no storage."""
    with torch.device("meta"):
        return PointNet2SemSeg(num_classes=num_classes, use_color=use_color)


def from_flax_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    """A ``PointNet2SemSeg`` state_dict from the JAX model's variables.

    Colour input and the class count are read off the tree (``sa1/w0`` has 6
    or 3 input rows; ``fc2/kernel`` has num_classes columns).
    """
    params = variables["params"]
    use_color = np.shape(params["sa1"]["w0"])[0] == 6
    num_classes = np.shape(params["fc2"]["kernel"])[1]
    return state_dict_from_flax(variables, _template(use_color, num_classes))


def to_flax_variables(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The flax variable tree (numpy leaves) of a ``PointNet2SemSeg`` state_dict.

    The inverse of ``from_flax_variables``: every key once, ``weight``
    transposed back into ``kernel``.
    """
    tree: dict = {}
    for key, tensor in state_dict.items():
        path, transposed = _flax_key(key)
        arr = tensor.detach().cpu().numpy()
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        if path[-1] in node:
            raise KeyError(f"{key} maps onto {'/'.join(path)} twice")
        node[path[-1]] = np.array(arr.T if transposed else arr)
    return tree


def init_variables(cfg: Config, num_classes: int = 9, seed: int = 0) -> dict:
    """Seeded weights in the flax layout of ``PointNet2SemSeg(...).init``.

    Xavier-uniform kernels (as the flax model initialises them), zero biases,
    unit scales, and moving statistics that are not the identity (means
    N(0, 0.1), variances U(0.5, 2)), so BatchNorm does real work.
    """
    rng = np.random.RandomState(seed)
    tree: dict = {}
    for key, tensor in _template(bool(cfg.use_color), num_classes).state_dict().items():
        path, transposed = _flax_key(key)
        shape = tuple(tensor.shape)[::-1] if transposed else tuple(tensor.shape)
        leaf = path[-1]
        if leaf in ("kernel", "w0"):
            limit = np.sqrt(6.0 / (shape[0] + shape[1]))
            value = rng.uniform(-limit, limit, shape)
        elif leaf == "scale":
            value = np.ones(shape)
        elif leaf == "mean":
            value = rng.normal(0.0, 0.1, shape)
        elif leaf == "var":
            value = rng.uniform(0.5, 2.0, shape)
        else:  # bias, b0
            value = np.zeros(shape)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[leaf] = value.astype(np.float32)
    return tree
