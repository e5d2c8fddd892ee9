"""PointNet++ semantic segmentation networks, SSG and MSG, their geometry and their loss.

Counterpart of ``pointnet2_tpu/models/pointnet2_seg.py``:

    input (B, N, 3[+3 rgb])
    SA1..SA4: FPS + ball query, MLPs [32,32,64] / [64,64,128] / [128,128,256] / [256,256,512]
    FP1..FP4: [256,256] / [256,256] / [256,128] / [128,128,128]
    head: Linear 128 -> BatchNorm -> ReLU -> Dropout 0.5 (train only) -> Linear num_classes

``PointNet2SemSegMSG`` (``:292-408``) groups SA1 and SA2 at two scales each
(``msg_scales``: radius/2 with nsample/2 and half-width MLPs, then radius
with nsample) and concatenates them; SA3, SA4, the FP decoder (widened by
the skip channels: 768, 448, 352 and 131 inputs with colour) and the head
are SSG's. ``model_class`` maps the ``arch`` names "ssg"/"msg" to the two.

Module names follow the flax tree (``sa1``, ``fp4``, ``fc1_bn``, ...), so
``convert.from_flax_variables`` maps one onto the other by name. The forward
follows ``self.training``. ``bq_window`` and ``fp_window`` (``:71-96``,
``:181-189``) turn on the calibrated x-windows, one width for every level or
one per level. ``precompute_geometry`` (``:204-289``) computes
the parameter-free neighbour structure of a batch ahead of the forward;
``weighted_ce_sum``/``weighted_ce_loss`` (``:411-441``) are the weighted cross
entropy divided by the number of non-zero weights.

``pre_project=False`` (``:45``, ``:130``) builds every SA level of the SSG
model in the reference's own layout (``nn.pointnet.sample_and_group``: the
raw ``[xyz offsets, features]`` rows grouped first, then the whole MLP,
``sa{i}.mlp.dense_j``/``bn_j``); with ``bq_window`` its ball query goes
through the calibrated operator. ``convert`` maps both layouts.

``compute_dtype`` and ``compute_dtype_min_width`` (``:46-62``, ``:98-106``)
are the bf16 precision modes: the MLP path of every stage, or with the
threshold only of the stages whose narrowest MLP width reaches it, computes
in bfloat16, with float32 parameters, geometry, BatchNorm statistics and
logits. ``with_precision`` gives a model in another mode that shares this
one's parameters and buffers, as the JAX Trainer's ``clone`` does.
"""

from __future__ import annotations

import copy
from typing import Mapping, Optional, Sequence, Union

import torch
from torch import nn

from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.nn.layers import BatchNorm, Momentum, dense
from pointnet2_tpu_torch.parallel import multihost
from pointnet2_tpu_torch.nn.pointnet import (
    Certificates,
    FeaturePropagation,
    SetAbstraction,
    SetAbstractionMSG,
    ball_query,
)

# One width shared by every level, or one per level (None keeps a level exact).
Window = Union[int, Sequence[Optional[int]], None]

SA_MLPS = ([32, 32, 64], [64, 64, 128], [128, 128, 256], [256, 256, 512])
FP_MLPS = ([256, 256], [256, 256], [256, 128], [128, 128, 128])


class PointNet2SemSeg(nn.Module):
    """Input (B, N, 3 + 3*use_color) float32 -> logits (B, N, num_classes).

    ``input_is_leaf`` (default True) treats the input cloud as needing no
    gradient: SA1 then takes the scatter-free leaf path, and the cloud's
    gradient is exactly zero. Set it False where the cloud itself is
    differentiated. ``dropout_rate`` is the head's (0.5 in the reference;
    0.0 switches it off, for comparisons).

    ``bq_window`` (SA levels) and ``fp_window`` (FP levels) are the calibrated
    x-windows: an int for every level, or a 4-sequence of int or None. A level
    whose cloud is not larger than its window runs the exact operator; every
    level with a window reports a certificate (``forward``'s ``certificates``).

    ``compute_dtype`` (None or ``torch.bfloat16``) is the type of the MLP
    path; with ``compute_dtype_min_width`` only the stages whose narrowest
    MLP width is at least that run in it (``fc1`` counts as a stage of width
    128), the others in float32. ``fc2`` always gives float32 logits.

    ``pre_project`` (default True) picks the SA levels' layout: False is the
    reference's, which groups the raw rows first (SSG only: the MSG model,
    like the JAX one, has the pre-projected layout alone).
    """

    def __init__(
        self,
        config: Optional[Config] = None,
        num_classes: int = 9,
        use_color: bool = True,
        ops_impl: Optional[str] = None,
        input_is_leaf: bool = True,
        dropout_rate: float = 0.5,
        bq_window: Window = None,
        fp_window: Window = None,
        compute_dtype: Optional[torch.dtype] = None,
        compute_dtype_min_width: Optional[int] = None,
        pre_project: bool = True,
    ):
        super().__init__()
        cfg = config or Config()
        if not pre_project and self.msg_levels:
            raise ValueError("the MSG model has the pre-projected layout only (pre_project=True)")
        self.pre_project = bool(pre_project)
        self.use_color = bool(use_color)
        if not 0.0 <= dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
        self.dropout_rate = float(dropout_rate)
        self._generator: Optional[torch.Generator] = None
        # Feature widths per level: l0 (colour or none), then each SA's output.
        widths = self._add_encoder(cfg, 3 if self.use_color else 0, ops_impl, input_is_leaf, bq_window)
        coarse = widths[-1]
        for i, mlp in enumerate(FP_MLPS):
            lvl = 3 - i  # target level: 3, 2, 1, 0
            self.add_module(
                f"fp{i + 1}",
                FeaturePropagation(
                    coarse + widths[lvl], mlp, ops_impl, fp_window=level_window(fp_window, i)
                ),
            )
            coarse = mlp[-1]
        self.fc1 = nn.Linear(coarse, 128)
        self.fc1_bn = BatchNorm(128)
        self.fc2 = nn.Linear(128, num_classes)
        self._set_precision(compute_dtype, compute_dtype_min_width)

    # The leading SA levels that group at two scales (PointNet2SemSegMSG's 2).
    msg_levels = 0

    def _add_encoder(self, cfg: Config, width: int, ops_impl, input_is_leaf: bool, bq_window: Window) -> list:
        """Adds ``sa1``..``sa4`` and sets ``sa_stage_widths``, each level's MLP
        widths (over every scale) for the selective precision mode. Returns
        the feature width of each level, the input's (``width``) first."""
        widths, stages = [width], []
        for i, (spec, mlp) in enumerate(zip(cfg.sa_layers, SA_MLPS)):
            kw = dict(leaf_inputs=(i == 0) and input_is_leaf, bq_window=level_window(bq_window, i))
            if i < self.msg_levels:
                half = [c // 2 for c in mlp]
                scales = msg_scales(spec)
                module = SetAbstractionMSG(
                    spec.npoint, [r for r, _ in scales], [k for _, k in scales], (half, mlp), widths[-1],
                    ops_impl, **kw,
                )
                stages.append(half + mlp)
                widths.append(half[-1] + mlp[-1])
            else:
                module = SetAbstraction(
                    spec.npoint, spec.radius, spec.nsample, mlp, widths[-1], ops_impl, pre_project=self.pre_project,
                    **kw,
                )
                stages.append(mlp)
                widths.append(mlp[-1])
            self.add_module(f"sa{i + 1}", module)
        self.sa_stage_widths = tuple(stages)
        return widths

    def _stage_dtype(self, widths: Sequence[int]) -> Optional[torch.dtype]:
        """A stage's compute type under the selective mode (``:98-106``)."""
        if self.compute_dtype is None or self.compute_dtype_min_width is None:
            return self.compute_dtype
        return self.compute_dtype if min(widths) >= self.compute_dtype_min_width else None

    def _set_precision(self, compute_dtype: Optional[torch.dtype], min_width: Optional[int]) -> None:
        if compute_dtype not in (None, torch.bfloat16):
            raise ValueError(f"compute_dtype must be None or torch.bfloat16, got {compute_dtype!r}")
        self.compute_dtype = compute_dtype
        self.compute_dtype_min_width = min_width
        for i, stage in enumerate(self.sa_stage_widths):
            getattr(self, f"sa{i + 1}").set_compute_dtype(self._stage_dtype(stage))
        for i, mlp in enumerate(FP_MLPS):
            getattr(self, f"fp{i + 1}").set_compute_dtype(self._stage_dtype(mlp))
        self.fc1_dtype = self._stage_dtype([128])

    def with_precision(
        self, compute_dtype: Optional[torch.dtype], min_width: Optional[int] = None
    ) -> "PointNet2SemSeg":
        """This model in another precision mode, sharing its parameters and
        buffers (the same tensors: a step of either trains both). Make it
        after moving the model: a later ``.to()`` of one replaces only its
        own buffers."""
        memo = {id(t): t for t in (*self.parameters(), *self.buffers())}
        if self._generator is not None:  # the copy makes its own dropout generator
            memo[id(self._generator)] = None
        clone = copy.deepcopy(self, memo)
        clone._set_precision(compute_dtype, min_width)
        return clone

    def forward(
        self,
        point_cloud: torch.Tensor,
        bn_momentum: Optional[Momentum] = None,
        geometry: Optional[Mapping[str, tuple]] = None,
        generator: Optional[torch.Generator] = None,
        certificates: Optional[Certificates] = None,
    ) -> torch.Tensor:
        """``bn_momentum`` is needed in train mode; ``geometry`` is what
        ``precompute_geometry`` returned for this batch; ``generator`` draws the
        dropout mask (default: one the model keeps on the input's device, seeded with 0).
        ``certificates``, a list, receives ``(name, ok)`` from every windowed
        level, SA1..SA4 then FP1..FP4 (none when ``geometry`` is given)."""
        xyzs = [point_cloud[..., :3].contiguous()]
        feats = [point_cloud[..., 3:6] if self.use_color else None]
        for i in range(4):
            new_xyz, new_points = getattr(self, f"sa{i + 1}")(
                xyzs[-1], feats[-1], bn_momentum,
                None if geometry is None else geometry["sa"][i], certificates,
            )[:2]
            xyzs.append(new_xyz)
            feats.append(new_points)
        for i in range(4):
            lvl = 3 - i
            feats[lvl] = getattr(self, f"fp{i + 1}")(
                xyzs[lvl], xyzs[lvl + 1], feats[lvl], feats[lvl + 1], bn_momentum,
                None if geometry is None else geometry["fp"][i], certificates,
            )
        net = torch.relu(self.fc1_bn(dense(self.fc1, feats[0], self.fc1_dtype), bn_momentum))
        if self.training and self.dropout_rate > 0.0:
            net = self._dropout(net, generator)
        return dense(self.fc2, net)  # float32 logits: the input meets the float32 weights

    def _dropout(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """Zero each element with probability ``dropout_rate``, scale the rest by 1/keep.
        Under a process group of more than one rank the rows of ``x`` are this
        rank's block of the global (micro)batch, the ranks' blocks equal in size."""
        if generator is None:
            if self._generator is None or self._generator.device != x.device:
                self._generator = torch.Generator(device=x.device).manual_seed(0)
            generator = self._generator
        shard = multihost.data_parallel()
        if shard is None:
            draw = torch.rand(x.shape, generator=generator, device=x.device)
        else:
            # The global batch's mask, of which this rank keeps its rows: one
            # process drawing for the whole batch draws the same.
            rank, world = shard
            b = x.shape[0]
            draw = torch.rand((world * b, *x.shape[1:]), generator=generator, device=x.device)
            draw = draw[rank * b : (rank + 1) * b]
        keep = draw >= self.dropout_rate
        return torch.where(keep, x / (1.0 - self.dropout_rate), torch.zeros((), dtype=x.dtype, device=x.device))


class PointNet2SemSegMSG(PointNet2SemSeg):
    """The multi-scale-grouping variant: ``PointNet2SemSeg`` with SA1 and SA2
    replaced by ``SetAbstractionMSG`` levels of two scales (``msg_scales``,
    MLPs ``(half, mlp)``), which concatenate 96 and 192 features. The
    arguments are ``PointNet2SemSeg``'s: ``bq_window`` is shared by an MSG
    level's scales (calibrate for the largest radius); a stage's selective
    precision reads the narrowest width over both scales; SA1's scales take
    the leaf path with ``input_is_leaf``.
    """

    msg_levels = 2


ARCHES = {"ssg": PointNet2SemSeg, "msg": PointNet2SemSegMSG}


def model_class(arch: str) -> type:
    """The model of an ``arch`` name, "ssg" or "msg"; ValueError for another."""
    if arch not in ARCHES:
        raise ValueError(f"unknown arch {arch!r}, expected 'ssg'/'msg'")
    return ARCHES[arch]


def msg_scales(spec) -> tuple:
    """An MSG dense level's grouping scales from its ``SALayerSpec``:
    ``((radius / 2, max(nsample // 2, 1)), (radius, nsample))``."""
    return ((spec.radius / 2.0, max(spec.nsample // 2, 1)), (spec.radius, spec.nsample))


def level_window(window: Window, i: int) -> Optional[int]:
    """Level ``i``'s width from one shared int or a per-level sequence."""
    if window is None or isinstance(window, int):
        return window
    return window[i]


@torch.no_grad()
def precompute_geometry(
    point_cloud: torch.Tensor,
    config: Optional[Config] = None,
    ops_impl: Optional[str] = None,
    bq_window: Window = None,
    fp_window: Window = None,
    arch: str = "ssg",
) -> tuple[dict, torch.Tensor]:
    """The neighbour structure of the ``arch`` model for a batch, computed once.

    FPS centroids, ball-query groups and the FP levels' 3-NN depend on the
    coordinates alone, never on parameters, so a gradient-accumulation step
    computes them once at full batch width and hands each microbatch its
    slice (``model(x, geometry=...)``). Returns ``(geometry, ok)``:
    ``{"sa": ({"new_xyz", "idx"}, ...), "fp": ({"dist2", "idx"}, ...)}``, every
    leaf with a leading batch axis, and the AND of the windowed levels'
    certificates, a 0-d bool tensor on the device (True without windows).
    With ``arch="msg"`` the two dense levels' ``idx`` is a tuple, one index
    set a grouping scale (``msg_scales``).
    """
    model_class(arch)  # raises for an unknown arch
    cfg = config or Config()
    xyzs = [point_cloud[..., :3].contiguous()]
    ok = torch.ones((), dtype=torch.bool, device=point_cloud.device)
    certificates: Certificates = []
    sa = []
    for i, spec in enumerate(cfg.sa_layers):
        _, new_xyz = ops.fps_centroids(xyzs[-1], spec.npoint, impl=ops_impl)
        window = level_window(bq_window, i)
        if arch == "msg" and i < 2:  # dense levels: one index set a scale
            idx = tuple(
                ball_query(xyzs[-1], new_xyz, r, k, window, ops_impl, certificates) for r, k in msg_scales(spec)
            )
        else:
            idx = ball_query(xyzs[-1], new_xyz, spec.radius, spec.nsample, window, ops_impl, certificates)
        sa.append({"new_xyz": new_xyz, "idx": idx})
        xyzs.append(new_xyz)
    fp = []
    for i in range(len(FP_MLPS)):
        lvl = 3 - i
        window = level_window(fp_window, i)
        if window is None:
            dist2, idx = ops.three_nn(xyzs[lvl], xyzs[lvl + 1], impl=ops_impl)
        else:
            dist2, idx, level_ok = ops.three_nn_calibrated(xyzs[lvl], xyzs[lvl + 1], window, impl=ops_impl)
            ok = ok & level_ok
        fp.append({"dist2": dist2, "idx": idx})
    for _, level_ok in certificates:
        ok = ok & level_ok
    return {"sa": tuple(sa), "fp": tuple(fp)}, ok


def weighted_ce_sum(
    logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of ``ce * w``, number of non-zero weights), both float32 scalars.

    The two sums of the weighted cross entropy, apart, so that gradient
    accumulation can add them over microbatches and divide once.
    """
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    w = weights.float()
    return (ce * w).sum(), (w != 0).sum().float()


def weighted_ce_loss(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Per-point cross entropy times the point's weight, summed, over the count of non-zero weights."""
    total, nonzero = weighted_ce_sum(logits, labels, weights)
    return total / nonzero.clamp_min(1.0)
