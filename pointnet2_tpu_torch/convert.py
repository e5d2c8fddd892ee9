"""Weights across frameworks: flax variable trees to ``state_dict``s, and seeded weights.

The JAX model's ``model.init`` returns ``{"params": ..., "batch_stats": ...}``;
with its leaves as numpy arrays, ``from_flax_variables`` maps it onto the
port's ``PointNet2SemSeg`` (its SA levels pre-projected, ``sa{i}/w0``, or in
the plain layout of ``pre_project=False``, ``sa{i}/mlp/dense_j``) or
``PointNet2SemSegMSG`` (a tree whose ``sa1`` holds ``scale0``) by name:

- ``params/<path>/kernel`` (in, out) -> ``<path>.weight`` (out, in), transposed
  for ``nn.Linear``;
- ``batch_stats/<path>/{mean,var}`` -> the BatchNorm buffers ``<path>.{mean,var}``;
- every other ``params`` leaf (``w0``, ``b0``, ``bias``, ``scale``) keeps its
  layout under the dotted path.

Every leaf is consumed exactly once: a missing or a leftover leaf raises.
``to_flax_variables`` is the inverse, from a ``state_dict`` back to the tree.
``init_variables`` builds a tree in the same flax layout from a seed, so a run
needs neither JAX nor a checkpoint: with flax's moving statistics (mean 0,
variance 1) by default, as a fresh JAX ``init_state`` has them, or with
``bn_stats="random"`` ones for checks in which BatchNorm must do real work; with
``pre_project=False`` the same weights in the plain layout.

Reference TF checkpoints: own numpy copies of ``pointnet2_tpu/convert.py``'s
``read_tf_checkpoint``, ``tf_vars_to_flax``, ``to_preprojected``,
``flax_to_tf_vars`` and ``convert_checkpoint`` map the reference's TF1
variable names (model.py:22-148 with util/tf_util.py's scopes) to and from
the flax tree of the SSG model:

    layer{i}/conv{j}/weights (1, 1, cin, cout), biases, bn/{gamma, beta,
        moving_mean, moving_variance}   <->  sa{i}/mlp/dense_{j}, bn_{j}
    fa_layer{i}/conv_{j}/...            <->  fp{i}/mlp/dense_{j}, bn_{j}
    fc1/weights (1, 128, 128), fc1/bn/..., fc2/...  <->  fc1, fc1_bn, fc2

with each SA block rewritten into the pre-projected layout (``w0``, ``b0``,
``bn0``, ``mlp_rest``) that ``from_flax_variables`` reads. The reference
model is SSG only: an MSG tree raises ``KeyError: 'mlp'``, as the JAX
functions do. ``state_dict_from_tf`` chains the conversion into
``from_flax_variables``, in either SA layout. A checkpoint is read from an ``.npz`` archive of
``{tf_variable_name: array}`` (one line in any TF1 environment:
``np.savez("ref.npz", **{v.op.name: sess.run(v) for v in
tf.global_variables()})``); any other path needs ``tensorflow``, imported
only then.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.models.pointnet2_seg import model_class


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


def _template(use_color: bool, num_classes: int, arch: str = "ssg", pre_project: bool = True) -> nn.Module:
    """The port model on the meta device: names and shapes, no storage."""
    with torch.device("meta"):
        return model_class(arch)(num_classes=num_classes, use_color=use_color, pre_project=pre_project)


def from_flax_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    """A ``PointNet2SemSeg`` (either SA layout) or ``PointNet2SemSegMSG``
    state_dict from the JAX model's variables.

    The arch, the layout, colour input and the class count are read off the
    tree (an MSG tree's ``sa1`` holds ``scale0``, a plain one's ``mlp``; SA1's
    first kernel, ``w0`` or ``mlp/dense_0/kernel``, has 6 or 3 input rows;
    ``fc2/kernel`` has num_classes columns).
    """
    params = variables["params"]
    sa1 = params["sa1"]
    arch = "msg" if "scale0" in sa1 else "ssg"
    pre_project = "mlp" not in sa1
    if arch == "msg":
        first = sa1["scale0"]["w0"]
    else:
        first = sa1["w0"] if pre_project else sa1["mlp"]["dense_0"]["kernel"]
    use_color = np.shape(first)[0] == 6
    num_classes = np.shape(params["fc2"]["kernel"])[1]
    return state_dict_from_flax(variables, _template(use_color, num_classes, arch, pre_project))


def to_flax_variables(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The flax variable tree (numpy leaves) of a model's state_dict, either arch.

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


BN_STATS = ("flax", "random")


def init_variables(
    cfg: Config, num_classes: int = 9, seed: int = 0, bn_stats: str = "flax", arch: str = "ssg",
    pre_project: bool = True,
) -> dict:
    """Seeded weights in the flax layout of the ``arch`` model's ``init``
    (``PointNet2SemSeg`` or ``PointNet2SemSegMSG``).

    ``pre_project=False`` gives the same weights in the plain SA layout of
    ``PointNet2SemSeg(pre_project=False)`` (SSG only): the pre-projected tree
    carried through ``flax_to_tf_vars`` and ``tf_vars_to_flax(pre_project=False)``,
    so that both layouts of a seed compute the same function.

    Xavier-uniform kernels (as the flax model initialises them), zero biases,
    unit scales, and moving statistics as ``bn_stats`` asks: ``"flax"``, the
    flax model's (means 0, variances 1), or ``"random"`` ones that are not the
    identity (means N(0, 0.1), variances U(0.5, 2)), so that BatchNorm does
    real work. The random statistics are drawn either way, so both give the
    same kernels for a seed.
    """
    if bn_stats not in BN_STATS:
        raise ValueError(f"bn_stats must be one of {BN_STATS}, got {bn_stats!r}")
    flax_stats = bn_stats == "flax"
    rng = np.random.RandomState(seed)
    tree: dict = {}
    for key, tensor in _template(bool(cfg.use_color), num_classes, arch).state_dict().items():
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
            if flax_stats:
                value = np.zeros(shape)
        elif leaf == "var":
            value = rng.uniform(0.5, 2.0, shape)
            if flax_stats:
                value = np.ones(shape)
        else:  # bias, b0
            value = np.zeros(shape)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[leaf] = value.astype(np.float32)
    if not pre_project:
        _template(bool(cfg.use_color), num_classes, arch, pre_project)  # raises for MSG
        return tf_vars_to_flax(flax_to_tf_vars(tree), pre_project=False)
    return tree


# -- reference TF checkpoints --------------------------------------------------


def read_tf_checkpoint(path: str) -> dict[str, np.ndarray]:
    """Load {variable_name: array} from a TF V2 checkpoint or an .npz export."""
    if str(path).endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    import tensorflow as tf  # deferred: only needed for native TF checkpoints

    reader = tf.train.load_checkpoint(str(path))
    out = {}
    for name in reader.get_variable_to_shape_map():
        # Skip optimizer slots (Adam moments etc.): model variables only.
        if "/Adam" in name or name in ("beta1_power", "beta2_power", "global_step"):
            continue
        out[name] = np.asarray(reader.get_tensor(name))
    return out


def _put(tree: dict, path: list[str], value: np.ndarray) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


_BN_PARAM = {"gamma": "scale", "beta": "bias"}
_BN_STAT = {"moving_mean": "mean", "moving_variance": "var"}
_TF_NAME = re.compile(
    r"^(layer(?P<sa>\d+)/conv(?P<saj>\d+)"
    r"|fa_layer(?P<fp>\d+)/conv_(?P<fpj>\d+)"
    r"|(?P<fc>fc[12]))"
    r"(?P<rest>(/bn)?/(weights|biases|gamma|beta|moving_mean|moving_variance))$"
)


def tf_vars_to_flax(tf_vars: dict[str, np.ndarray], pre_project: bool = True) -> dict:
    """Reference TF variables -> {'params': ..., 'batch_stats': ...}, in the
    pre-projected SA layout (``pre_project=False``: the plain one)."""
    params: dict = {}
    stats: dict = {}
    for name, value in sorted(tf_vars.items()):
        m = _TF_NAME.match(name)
        if not m:
            raise ValueError(f"unrecognized reference variable: {name}")
        leaf = name.rsplit("/", 1)[-1]
        is_bn = "/bn/" in name
        if m.group("sa"):
            base = [f"sa{m.group('sa')}", "mlp"]
            j = m.group("saj")
        elif m.group("fp"):
            base = [f"fp{m.group('fp')}", "mlp"]
            j = m.group("fpj")
        else:  # fc1 / fc2
            fc = m.group("fc")
            if is_bn:
                _route_bn([f"{fc}_bn"], leaf, value, params, stats)
                continue
            kernel = value[0] if leaf == "weights" else value  # (1, cin, cout) conv1d
            _put(params, [fc, "kernel" if leaf == "weights" else "bias"], kernel)
            continue
        if is_bn:
            _route_bn(base + [f"bn_{j}"], leaf, value, params, stats)
        elif leaf == "weights":
            _put(params, base + [f"dense_{j}", "kernel"], value[0, 0])
        else:
            _put(params, base + [f"dense_{j}", "bias"], value)

    variables = {"params": params, "batch_stats": stats}
    return to_preprojected(variables) if pre_project else variables


def _route_bn(base: list[str], leaf: str, value: np.ndarray, params: dict, stats: dict) -> None:
    if leaf in _BN_PARAM:
        _put(params, base + [_BN_PARAM[leaf]], value)
    else:
        _put(stats, base + [_BN_STAT[leaf]], value)


def to_preprojected(variables: dict) -> dict:
    """Rewrite plain SA blocks {mlp/dense_j, mlp/bn_j} into the pre-projected
    layout {w0, b0, bn0, mlp_rest/dense_{j-1}, mlp_rest/bn_{j-1}}."""
    params = dict(variables["params"])
    stats = dict(variables.get("batch_stats", {}))
    for key in [k for k in params if re.fullmatch(r"sa\d+", k)]:
        mlp = params[key]["mlp"]
        new_p: dict = {"w0": mlp["dense_0"]["kernel"], "b0": mlp["dense_0"]["bias"], "bn0": mlp["bn_0"],
                       "mlp_rest": {}}
        sa_stats = stats.get(key)  # absent for stat-less trees (e.g. gradients)
        new_s: dict = {"bn0": sa_stats["mlp"]["bn_0"], "mlp_rest": {}} if sa_stats else {}
        j = 1
        while f"dense_{j}" in mlp:
            new_p["mlp_rest"][f"dense_{j - 1}"] = mlp[f"dense_{j}"]
            new_p["mlp_rest"][f"bn_{j - 1}"] = mlp[f"bn_{j}"]
            if sa_stats:
                new_s["mlp_rest"][f"bn_{j - 1}"] = sa_stats["mlp"][f"bn_{j}"]
            j += 1
        params[key] = new_p
        if sa_stats:
            stats[key] = new_s
    return {"params": params, "batch_stats": stats}


def flax_to_tf_vars(variables: dict) -> dict[str, np.ndarray]:
    """Inverse mapping: a flax tree (plain or pre-projected SA layout) ->
    {reference_tf_name: array}, kernels restored to conv shapes."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: dict[str, np.ndarray] = {}

    def emit_dense(tf_scope: str, dense: dict, conv1d: bool = False) -> None:
        k = np.asarray(dense["kernel"])
        out[f"{tf_scope}/weights"] = k[None] if conv1d else k[None, None]
        out[f"{tf_scope}/biases"] = np.asarray(dense["bias"])

    def emit_bn(tf_scope: str, bn_p: dict, bn_s: dict) -> None:
        out[f"{tf_scope}/bn/gamma"] = np.asarray(bn_p["scale"])
        out[f"{tf_scope}/bn/beta"] = np.asarray(bn_p["bias"])
        out[f"{tf_scope}/bn/moving_mean"] = np.asarray(bn_s["mean"])
        out[f"{tf_scope}/bn/moving_variance"] = np.asarray(bn_s["var"])

    for key, block in params.items():
        if re.fullmatch(r"sa\d+", key):
            scope = f"layer{key[2:]}"
            if "w0" in block:  # pre-projected layout
                emit_dense(f"{scope}/conv0", {"kernel": block["w0"], "bias": block["b0"]})
                emit_bn(f"{scope}/conv0", block["bn0"], stats[key]["bn0"])
                rest = block.get("mlp_rest", {})
                j = 0
                while f"dense_{j}" in rest:
                    emit_dense(f"{scope}/conv{j + 1}", rest[f"dense_{j}"])
                    emit_bn(f"{scope}/conv{j + 1}", rest[f"bn_{j}"], stats[key]["mlp_rest"][f"bn_{j}"])
                    j += 1
            else:
                mlp = block["mlp"]
                j = 0
                while f"dense_{j}" in mlp:
                    emit_dense(f"{scope}/conv{j}", mlp[f"dense_{j}"])
                    emit_bn(f"{scope}/conv{j}", mlp[f"bn_{j}"], stats[key]["mlp"][f"bn_{j}"])
                    j += 1
        elif re.fullmatch(r"fp\d+", key):
            scope = f"fa_layer{key[2:]}"
            mlp = block["mlp"]
            j = 0
            while f"dense_{j}" in mlp:
                emit_dense(f"{scope}/conv_{j}", mlp[f"dense_{j}"])
                emit_bn(f"{scope}/conv_{j}", mlp[f"bn_{j}"], stats[key]["mlp"][f"bn_{j}"])
                j += 1
        elif key in ("fc1", "fc2"):
            emit_dense(key, block, conv1d=True)
        elif key == "fc1_bn":
            out["fc1/bn/gamma"] = np.asarray(block["scale"])
            out["fc1/bn/beta"] = np.asarray(block["bias"])
            out["fc1/bn/moving_mean"] = np.asarray(stats["fc1_bn"]["mean"])
            out["fc1/bn/moving_variance"] = np.asarray(stats["fc1_bn"]["var"])
        else:
            raise ValueError(f"unrecognized flax block: {key}")
    return out


def convert_checkpoint(tf_ckpt_path: str, pre_project: bool = True) -> dict:
    """One call: a TF checkpoint path (or .npz) -> flax variables."""
    return tf_vars_to_flax(read_tf_checkpoint(tf_ckpt_path), pre_project=pre_project)


def state_dict_from_tf(tf_ckpt_path: str, pre_project: bool = True) -> dict[str, torch.Tensor]:
    """The port's SSG ``state_dict`` of a reference TF checkpoint (or .npz):
    ``convert_checkpoint`` in the pre-projected layout (``pre_project=False``:
    the plain one, for ``PointNet2SemSeg(pre_project=False)``), then
    ``from_flax_variables`` (every leaf once; a missing or leftover one raises)."""
    return from_flax_variables(convert_checkpoint(tf_ckpt_path, pre_project=pre_project))
