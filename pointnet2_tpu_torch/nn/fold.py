"""Eval-time BatchNorm folding for the bf16 inference mode.

Counterpart of ``pointnet2_tpu/nn/fold.py``. In eval mode BatchNorm is the
affine map ``y = (x - m) * s + b`` with ``s = scale * rsqrt(var + eps)``.
Folding absorbs it into the linear layer before it, in float32:

    kernel' = kernel * s        bias' = (bias - m) * s + b

and makes the BatchNorm an exact identity (scale 1, bias 0, mean 0, var
``1 - eps``, so that ``rsqrt(var + eps)`` is 1.0). The model runs unchanged,
its BatchNorms as no-ops. In bfloat16 the rounding then lands on normalised
activations: unfolded, it lands on the linear layer's raw output, and the
BatchNorm's ``(h - m) * s`` amplifies it wherever ``|h - m|`` is much smaller
than ``|h|``.

The pairs, by the model's names (the flax names, ``convert``):

- ``dense_i`` + ``bn_i`` (``SharedMLP``): ``nn.Linear`` weights are (out,
  in), so a row is scaled;
- ``w0``/``b0`` + ``bn0`` (``SetAbstraction``): ``w0`` is (in, out), so a
  column is scaled; the centres' projection ``c @ w0[:3]`` takes the same
  folded columns, and ``(x @ w0 + b0 - c @ w0[:3] - m) * s + b`` equals
  ``x @ w0' + b0' - c @ w0'[:3]``;
- ``fc1`` + ``fc1_bn`` (the head).

Train mode must not run folded weights: the batch statistics would be taken
again over the scaled activations.
"""

from __future__ import annotations

from typing import Mapping

import torch

BN_EPSILON = 1e-3  # nn.layers.BatchNorm's


def _linear_of(bn: str, state: Mapping[str, torch.Tensor]) -> tuple[str, str, bool] | None:
    """The (weight key, bias key, weight is (out, in)) folded with the
    BatchNorm at ``bn``, or None where the names match no pair."""
    parent, _, name = bn.rpartition(".")
    prefix = f"{parent}." if parent else ""
    if name.startswith("bn_"):
        layer = f"{prefix}dense_{name[3:]}"
        pair = (f"{layer}.weight", f"{layer}.bias", True)
    elif name == "bn0":
        pair = (f"{prefix}w0", f"{prefix}b0", False)
    elif name == "fc1_bn":
        pair = (f"{prefix}fc1.weight", f"{prefix}fc1.bias", True)
    else:
        return None
    return pair if pair[0] in state and pair[1] in state else None


def fold_batch_norm(state_dict: Mapping[str, torch.Tensor], epsilon: float = BN_EPSILON) -> dict:
    """A ``PointNet2SemSeg`` state_dict with every eval BatchNorm folded into
    the linear layer before it; the input is not changed.

    The folded eval forward equals the unfolded one up to float32 rounding.
    Raises ValueError for a BatchNorm (a ``.mean``/``.var`` pair) that no
    naming pattern matches: left unfolded, it would bring back the amplified
    bfloat16 rounding the fold exists to remove. ``epsilon`` must be every
    BatchNorm's (the model's are all 1e-3).
    """
    out = dict(state_dict)
    bns = sorted(key[: -len(".mean")] for key in state_dict if key.endswith(".mean"))
    missed = []
    for bn in bns:
        pair = _linear_of(bn, state_dict)
        if pair is None:
            missed.append(bn)
            continue
        w_key, b_key, rows = pair
        mean, var = state_dict[f"{bn}.mean"], state_dict[f"{bn}.var"]
        scale, bias = state_dict[f"{bn}.scale"], state_dict[f"{bn}.bias"]
        acc = torch.promote_types(var.dtype, torch.float32)
        t = torch.rsqrt(var.to(acc) + epsilon) * scale.to(acc)
        w, b = state_dict[w_key], state_dict[b_key]
        out[w_key] = (w.to(acc) * (t[:, None] if rows else t)).to(w.dtype)
        out[b_key] = ((b.to(acc) - mean.to(acc)) * t + bias.to(acc)).to(b.dtype)
        out[f"{bn}.scale"] = torch.ones_like(scale)
        out[f"{bn}.bias"] = torch.zeros_like(bias)
        out[f"{bn}.mean"] = torch.zeros_like(mean)
        out[f"{bn}.var"] = torch.full_like(var, 1.0 - epsilon)  # var + eps == 1.0: an identity
    if missed:
        raise ValueError(
            f"fold_batch_norm: BatchNorm statistics matched by no linear-layer naming pattern "
            f"(they would stay unfolded): {missed}"
        )
    return out
