"""PointNet++ building blocks: Set Abstraction and Feature Propagation.

Counterpart of ``pointnet2_tpu/nn/pointnet.py`` for the SSG and MSG models,
eval and train:

- ``SetAbstraction``'s default is the pre-projected path (``:239-391``).
  The first MLP layer's linear part runs over all N points before grouping,
  and the centre's xyz projection is subtracted after it:
  ``group(inputs @ w0 + b0, idx) - new_xyz @ w0[:3]``, then ``bn0``, ReLU,
  ``mlp_rest`` and the pooling over each group. With ``leaf_inputs`` (the raw
  cloud, which needs no gradient) the train forward gathers the raw channels,
  subtracts the centre and projects after (``:335-355``), so the backward
  needs no scatter into the cloud; the eval forward takes
  ``ops.project_group_leaf``.
- ``SetAbstractionMSG`` (``:394-535``) groups around one shared FPS at
  several radii and concatenates the per-scale pooled features; each scale
  is a ``SetAbstraction`` fed through the geometry seam below, or, with
  ``pre_project=False``, the literal grouped-first-layer layout.
- ``FeaturePropagation`` is the exact path (``:538-597``): ``three_nn``,
  ``interpolation_weights`` of the detached distances, ``three_interpolate``
  with the skip concat (one kernel writes both on the kernel path;
  ``torch.cat`` after the plain version), and a ``SharedMLP``.

Both take ``compute_dtype`` (``:251-255``, ``:371-374``, ``:581-596``): None
for float32, or bfloat16 for a stage of the bf16 modes. The SA projection,
the centre subtraction and ``bn0`` stay float32 (the features are widened
for the concat with the coordinates), and the cast comes after the ReLU; in
FP the interpolation runs at ``precision="default"`` and the skip features
are cast to the stage's type before the concat, whose type is the promoted
one of the two halves, as in JAX.

They take ``geometry``, the neighbour structure computed beforehand
(``models.precompute_geometry``), in place of their own FPS, ball query or
3-NN. A ``SetAbstraction`` given the centroids alone (``{"new_xyz"}``,
``:251-270``) skips FPS and still groups, through the fused windowed path
where that applies. The index searches run under ``no_grad``: no parameter
reaches them.

Calibrated windows (``:174-193``, ``:272-326``, ``:551-574``): with
``bq_window`` the ball query, and with ``fp_window`` the 3-NN, run through
``ops.*_calibrated``; the eval forward without gradients groups SA features
through ``ops.project_group_calibrated`` and keeps the per-centroid work in
x-sorted query order, un-permuting only the pooled output. Each windowed
level appends ``("bq_window_ok", ok)`` or ``("fp_window_ok", ok)`` to the
``certificates`` list it is given, where flax sows them.

The options of the JAX module (``:131-391``) are all here, though no model
of either package uses most of them: ``pre_project=False``, the reference's
own layout (``sample_and_group``: one gather of ``[xyz, features]``, the rows
``[xyz offsets, features]``, a ``SharedMLP`` named ``mlp``), which
``PointNet2SemSeg(pre_project=False)`` runs; ``use_knn`` (the ``nsample``
nearest points in place of the ball); ``group_all`` (one group of every
point around the origin, ``sample_and_group_all``); ``mlp2``, a
``SharedMLP`` after the pooling; the pooling modes of ``pool``;
``use_xyz=False`` (the features alone, no offsets); and ``use_bn=False``
(no BatchNorm anywhere in the module). The branches follow the JAX order:
``group_all`` first, then the pre-projected path where it applies, else the
plain one.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from pointnet2_tpu_torch import ops
from pointnet2_tpu_torch.nn.layers import BatchNorm, Momentum, SharedMLP

# What a windowed level appends for the caller: (name, 0-d bool tensor).
Certificates = List[Tuple[str, torch.Tensor]]


POOLINGS = ("max", "avg", "weighted_avg", "max_and_avg")


@torch.no_grad()
def ball_query(xyz, new_xyz, radius: float, nsample: int, window: Optional[int], impl: Optional[str],
               certificates: Optional[Certificates]) -> torch.Tensor:
    """The group indices of one grouping scale: the exact ball query, or with
    ``window`` the calibrated one, whose certificate goes to ``certificates``."""
    if window is None:
        return ops.ball_query(xyz, new_xyz, radius, nsample, impl=impl)[0]
    idx, _, ok = ops.ball_query_calibrated(xyz, new_xyz, radius, nsample, window, impl=impl)
    if certificates is not None:
        certificates.append(("bq_window_ok", ok))
    return idx


@torch.no_grad()
def group_indices(xyz, new_xyz, radius: float, nsample: int, use_knn: bool, window: Optional[int],
                  impl: Optional[str], certificates: Optional[Certificates]) -> torch.Tensor:
    """(B, M, nsample) indices: the ``nsample`` nearest points with ``use_knn``
    (``ops.knn``; the window does not apply), else ``ball_query``."""
    if use_knn:
        return ops.knn(xyz, new_xyz, nsample, impl=impl)[1]
    return ball_query(xyz, new_xyz, radius, nsample, window, impl, certificates)


def sample_and_group(
    xyz: torch.Tensor,
    points: Optional[torch.Tensor],
    npoint: int,
    radius: float,
    nsample: int,
    use_knn: bool = False,
    use_xyz: bool = True,
    impl: Optional[str] = None,
    window: Optional[int] = None,
    certificates: Optional[Certificates] = None,
    geometry: Optional[Mapping[str, torch.Tensor]] = None,
):
    """FPS centroids, ball-query (or kNN) groups and the offsets from each
    centre (``:33-92``): ``(new_xyz, new_points, idx, grouped_xyz)`` of shapes
    (B, npoint, 3), (B, npoint, nsample, 3 + C) (C alone without ``use_xyz``;
    the offsets alone without features), (B, npoint, nsample) and
    (B, npoint, nsample, 3). One gather of ``[xyz, points]`` gives both the
    offsets and the features. ``geometry``: ``{"new_xyz", "idx"}`` computed
    beforehand, or ``{"new_xyz"}`` alone, which skips FPS only."""
    if geometry is not None and "idx" in geometry:
        new_xyz, idx = geometry["new_xyz"], geometry["idx"]
    else:
        if geometry is not None:
            new_xyz = geometry["new_xyz"]
        else:
            _, new_xyz = ops.fps_centroids(xyz, npoint, impl=impl)
        idx = group_indices(xyz, new_xyz, radius, nsample, use_knn, window, impl, certificates)
    if points is None:
        grouped_xyz = ops.group_points(xyz, idx) - new_xyz[:, :, None, :]
        return new_xyz, grouped_xyz, idx, grouped_xyz
    grouped_all = ops.group_points(torch.cat([xyz, points.to(xyz.dtype)], dim=-1), idx)
    grouped_xyz = grouped_all[..., :3] - new_xyz[:, :, None, :]
    grouped_points = grouped_all[..., 3:].to(points.dtype)
    new_points = torch.cat([grouped_xyz, grouped_points], dim=-1) if use_xyz else grouped_points
    return new_xyz, new_points, idx, grouped_xyz


def sample_and_group_all(xyz: torch.Tensor, points: Optional[torch.Tensor], use_xyz: bool = True):
    """One group of every point, centred on the origin (``:95-110``): the
    outputs of ``sample_and_group`` with npoint 1 and nsample N, the rows
    ``[xyz, points]`` (``points`` alone without ``use_xyz``)."""
    b, n, _ = xyz.shape
    new_xyz = xyz.new_zeros((b, 1, 3))
    idx = torch.arange(n, dtype=torch.int32, device=xyz.device).expand(b, 1, n)
    grouped_xyz = xyz[:, None]
    if points is None:
        return new_xyz, grouped_xyz, idx, grouped_xyz
    new_points = torch.cat([xyz, points], dim=-1) if use_xyz else points
    return new_xyz, new_points[:, None], idx, grouped_xyz


def pool(new_points: torch.Tensor, grouped_xyz: Optional[torch.Tensor], pooling: str) -> torch.Tensor:
    """Pooling over each group (axis 2, ``:113-128``): ``max``, ``avg``,
    ``weighted_avg`` (weights ``exp(-5 |offset|)`` normalised over the group;
    needs ``grouped_xyz``) or ``max_and_avg`` (the mean, then the max, side
    by side)."""
    if pooling == "max":
        return new_points.amax(dim=2)
    if pooling == "avg":
        return new_points.mean(dim=2)
    if pooling == "weighted_avg":
        dists = torch.sqrt((grouped_xyz * grouped_xyz).sum(dim=-1, keepdim=True))
        exp_dists = torch.exp(-dists * 5.0)
        weights = exp_dists / exp_dists.sum(dim=2, keepdim=True)
        return (new_points * weights).sum(dim=2)
    if pooling == "max_and_avg":
        return torch.cat([new_points.mean(dim=2), new_points.amax(dim=2)], dim=-1)
    raise ValueError(f"unknown pooling {pooling!r}, expected one of {POOLINGS}")


class SetAbstraction(nn.Module):
    """(B, N, 3) xyz + (B, N, C) features -> (B, npoint, 3) centroids,
    (B, npoint, ``out_features``) pooled features and (B, npoint, nsample)
    group indices (with ``group_all``: one centroid at the origin, and every
    point in its group).

    ``in_features`` is C (0 when there are no features). The grouped rows are
    ``[xyz offsets, features]``, 3 + C wide, or C without ``use_xyz`` (the
    offsets alone when there are no features). Parameters keep the flax
    layout: on the pre-projected path ``w0`` (rows, mlp[0]) applied as
    ``x @ w0``, ``b0``, ``bn0`` and ``mlp_rest``; on the plain path
    (``pre_project=False`` or ``group_all``) a ``SharedMLP`` ``mlp``; and
    ``mlp2`` after the pooling where it is given. ``use_bn=False`` drops every
    BatchNorm. With ``use_knn`` the groups are the ``nsample`` nearest points
    and ``bq_window`` does not apply.
    """

    def __init__(
        self,
        npoint: int,
        radius: float,
        nsample: int,
        mlp: Sequence[int],
        in_features: int,
        ops_impl: Optional[str] = None,
        leaf_inputs: bool = False,
        bq_window: Optional[int] = None,
        compute_dtype: Optional[torch.dtype] = None,
        *,
        mlp2: Optional[Sequence[int]] = None,
        group_all: bool = False,
        pooling: str = "max",
        use_knn: bool = False,
        use_xyz: bool = True,
        use_bn: bool = True,
        pre_project: bool = True,
    ):
        super().__init__()
        if pooling not in POOLINGS:
            raise ValueError(f"unknown pooling {pooling!r}, expected one of {POOLINGS}")
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.ops_impl = ops_impl
        self.leaf_inputs = leaf_inputs
        self.bq_window = bq_window
        self.group_all = group_all
        self.pooling = pooling
        self.use_knn = use_knn
        self.use_xyz = use_xyz
        self.use_bn = use_bn
        width = in_features + (3 if use_xyz or not in_features else 0)
        # The JAX module's test (``:209``): with neither offsets nor features
        # there is nothing to project first.
        self.pre_projected = not group_all and pre_project and bool(mlp) and (use_xyz or in_features > 0)
        if self.pre_projected:
            f0 = mlp[0]
            self.w0 = nn.Parameter(torch.empty(width, f0))
            self.b0 = nn.Parameter(torch.zeros(f0))
            if use_bn:
                self.bn0 = BatchNorm(f0)
            self.mlp_rest = SharedMLP(f0, mlp[1:], use_bn=use_bn)
        else:
            self.mlp = SharedMLP(width, mlp, use_bn=use_bn)
        pooled = (mlp[-1] if mlp else width) * (2 if pooling == "max_and_avg" else 1)
        self.mlp2 = SharedMLP(pooled, mlp2, use_bn=use_bn) if mlp2 else None
        self.out_features = mlp2[-1] if mlp2 else pooled
        self.set_compute_dtype(compute_dtype)

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> None:
        self.compute_dtype = dtype
        for name in ("mlp_rest", "mlp", "mlp2"):
            part = getattr(self, name, None)
            if part is not None:
                part.dtype = dtype

    def forward(
        self,
        xyz: torch.Tensor,
        points: Optional[torch.Tensor],
        bn_momentum: Optional[Momentum] = None,
        geometry: Optional[Mapping[str, torch.Tensor]] = None,
        certificates: Optional[Certificates] = None,
    ):
        if geometry is not None and (self.group_all or (self.use_knn and "idx" in geometry)):
            # Precomputed indices are the ball query's (models.precompute_geometry):
            # in place of kNN or group-all indices they would change the function.
            raise ValueError(
                "precomputed geometry is only valid for the ball-query SSG "
                f"path (got group_all={self.group_all}, use_knn={self.use_knn})"
            )
        if self.group_all:
            new_xyz, new_points, idx, grouped_xyz = sample_and_group_all(xyz, points, self.use_xyz)
        elif self.pre_projected:
            return self._pre_projected(xyz, points, bn_momentum, geometry, certificates)
        else:
            new_xyz, new_points, idx, grouped_xyz = sample_and_group(
                xyz, points, self.npoint, self.radius, self.nsample, self.use_knn, self.use_xyz,
                self.ops_impl, self.bq_window, certificates, geometry,
            )
        h = self.mlp(new_points, bn_momentum)
        return new_xyz, self._after_pool(pool(h, grouped_xyz, self.pooling), bn_momentum), idx

    def _pre_projected(self, xyz, points, bn_momentum, geometry, certificates):
        if points is None:
            inputs = xyz
        else:  # a bfloat16 stage's features widened: the projection runs in float32
            dtype = torch.promote_types(xyz.dtype, points.dtype)
            inputs = torch.cat([xyz.to(dtype), points.to(dtype)], dim=-1) if self.use_xyz else points.to(dtype)
        if geometry is not None:
            new_xyz = geometry["new_xyz"]
        else:
            _, new_xyz = ops.fps_centroids(xyz, self.npoint, impl=self.ops_impl)
        if geometry is not None and "idx" in geometry:
            idx = geometry["idx"]
        else:
            # Centroids-only geometry ({"new_xyz"}) skips FPS alone: the
            # grouping, fused or not, still runs here.
            if self.fused_window():
                return self._fused_window(xyz, inputs, new_xyz, bn_momentum, certificates)
            idx = group_indices(
                xyz, new_xyz, self.radius, self.nsample, self.use_knn, self.bq_window, self.ops_impl, certificates
            )
        if self.leaf_inputs and self.training:
            # (x - c) @ w0[:3] in place of x @ w0[:3] - c @ w0[:3]: equal up to
            # float32 reassociation, and nothing is scattered back into the cloud.
            grouped_in = ops.group_points(inputs, idx)  # (B, M, K, cin)
            if self.use_xyz:
                grouped_in = torch.cat(
                    [grouped_in[..., :3] - new_xyz[:, :, None, :], grouped_in[..., 3:]], dim=-1
                )
            h = grouped_in @ self.w0 + self.b0
        else:
            if self.leaf_inputs:
                h = ops.project_group_leaf(inputs, self.w0, self.b0, idx)
            else:
                zp = inputs @ self.w0 + self.b0  # (B, N, f0): layer-1 linear over all points
                h = ops.group_points(zp, idx)
            if self.use_xyz:
                zq = new_xyz @ self.w0[:3]  # the centres' xyz projection, no bias
                h = h - zq[:, :, None, :]
        h = self._rest(h, bn_momentum)
        grouped_xyz = None
        if self.pooling == "weighted_avg":
            grouped_xyz = ops.group_points(xyz, idx) - new_xyz[:, :, None, :]
        return new_xyz, self._after_pool(pool(h, grouped_xyz, self.pooling), bn_momentum), idx

    def fused_window(self) -> bool:
        """Whether the grouping takes the fused windowed path: eval only
        (train-mode BatchNorm's batch statistics would sum in another order
        over permuted rows), and only without autograd (the gather kernel has
        no backward); never for kNN groups, nor for ``weighted_avg``, which
        needs the offsets in the original order (``:282-288``)."""
        return (
            self.bq_window is not None and not self.training and not torch.is_grad_enabled()
            and not self.use_knn and self.pooling != "weighted_avg"
        )

    def _cast(self, h: torch.Tensor) -> torch.Tensor:
        return h if self.compute_dtype is None else h.to(self.compute_dtype)

    def _rest(self, h: torch.Tensor, bn_momentum) -> torch.Tensor:
        """``bn0`` (with ``use_bn``), ReLU, the cast to the stage's type, ``mlp_rest``."""
        if self.use_bn:
            h = self.bn0(h, bn_momentum)
        return self.mlp_rest(self._cast(torch.relu(h)), bn_momentum)

    def _after_pool(self, h: torch.Tensor, bn_momentum) -> torch.Tensor:
        return h if self.mlp2 is None else self.mlp2(h, bn_momentum)

    def _fused_window(self, xyz, inputs, new_xyz, bn_momentum, certificates: Optional[Certificates]):
        """The eval forward through ``ops.project_group_calibrated``: the grouped
        rows come in x-sorted query order (when ``qperm`` is not None), every
        per-centroid op below is row-independent in eval, and only the pooled
        output is put back in the original order."""
        grouped, idx, _, qperm, inv_q, ok = ops.project_group_calibrated(
            inputs, self.w0, self.b0, xyz, new_xyz, self.radius, self.nsample,
            self.bq_window, impl=self.ops_impl,
        )
        if certificates is not None:
            certificates.append(("bq_window_ok", ok))
        h = grouped
        if self.use_xyz:
            centers = new_xyz if qperm is None else ops.gather_points(new_xyz, qperm)
            h = grouped - (centers @ self.w0[:3])[:, :, None, :]
        new_points = pool(self._rest(h, bn_momentum), None, self.pooling)
        if inv_q is not None:
            new_points = ops.gather_points(new_points, inv_q)
        return new_xyz, self._after_pool(new_points, bn_momentum), idx


class SetAbstractionMSG(nn.Module):
    """Multi-scale grouping: (B, N, 3) xyz + (B, N, C) features -> (B, npoint, 3)
    centroids and (B, npoint, sum of each scale's mlp[-1]) features, the
    concat of the per-scale max-pooled features around one shared FPS.

    ``pre_project=True`` (the default) makes scale i a ``SetAbstraction``
    named ``scale{i}`` fed the level's centroids and its own group indices
    through the geometry seam, so it keeps the pre-projected forward, the
    leaf path's scatter-free train backward and the flax names
    ``sa1/scale0/{w0,b0,bn0,mlp_rest}``. Under the fused condition (eval, no
    autograd, a window) a scale gets the centroids alone and groups through
    its own fused windowed path. ``pre_project=False`` is the literal layout:
    one gather of ``[xyz, points]`` a scale, the rows ``[features, xyz
    offsets]`` (in that order) into a ``SharedMLP`` named ``mlp_{i}``.

    ``use_xyz=False`` groups the features alone and ``use_bn=False`` drops
    every BatchNorm, in either layout. ``bq_window`` is shared by the scales
    (calibrated for the largest radius); without the fused path each scale
    appends its own certificate.
    ``geometry`` is ``{"new_xyz", "idx"}`` with ``idx`` a tuple, one index set
    a scale (``models.precompute_geometry(arch="msg")``).
    """

    def __init__(
        self,
        npoint: int,
        radius_list: Sequence[float],
        nsample_list: Sequence[int],
        mlp_list: Sequence[Sequence[int]],
        in_features: int,
        ops_impl: Optional[str] = None,
        leaf_inputs: bool = False,
        bq_window: Optional[int] = None,
        compute_dtype: Optional[torch.dtype] = None,
        pre_project: bool = True,
        use_xyz: bool = True,
        use_bn: bool = True,
    ):
        super().__init__()
        self.npoint = npoint
        self.scales = tuple(zip(radius_list, nsample_list))
        self.ops_impl = ops_impl
        self.bq_window = bq_window
        self.pre_project = pre_project
        self.use_xyz = use_xyz
        width = in_features + (3 if use_xyz or not in_features else 0)
        for i, ((radius, nsample), mlp) in enumerate(zip(self.scales, mlp_list)):
            if pre_project:
                self.add_module(f"scale{i}", SetAbstraction(
                    npoint, radius, nsample, mlp, in_features, ops_impl, leaf_inputs=leaf_inputs,
                    bq_window=bq_window, use_xyz=use_xyz, use_bn=use_bn,
                ))
            else:
                self.add_module(f"mlp_{i}", SharedMLP(width, mlp, use_bn=use_bn))
        self.set_compute_dtype(compute_dtype)

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> None:
        self.compute_dtype = dtype
        for i in range(len(self.scales)):
            if self.pre_project:
                getattr(self, f"scale{i}").set_compute_dtype(dtype)
            else:
                getattr(self, f"mlp_{i}").dtype = dtype

    def forward(
        self,
        xyz: torch.Tensor,
        points: Optional[torch.Tensor],
        bn_momentum: Optional[Momentum] = None,
        geometry: Optional[Mapping] = None,
        certificates: Optional[Certificates] = None,
    ):
        if geometry is not None:
            sets = geometry["idx"]
            count = len(sets) if isinstance(sets, (tuple, list)) else 1  # one tensor: an SSG level's
            if count != len(self.scales):
                raise ValueError(f"geometry carries {count} index sets for {len(self.scales)} grouping scales")
            new_xyz = geometry["new_xyz"]
        else:
            _, new_xyz = ops.fps_centroids(xyz, self.npoint, impl=self.ops_impl)
        fused = geometry is None and self.pre_project and self.scale0.fused_window()
        feats = []
        for i, (radius, nsample) in enumerate(self.scales):
            if fused:  # the scale groups on its own, through the fused windowed path
                feats.append(getattr(self, f"scale{i}")(
                    xyz, points, bn_momentum, {"new_xyz": new_xyz}, certificates
                )[1])
                continue
            if geometry is not None:
                idx = geometry["idx"][i]
            else:
                idx = ball_query(xyz, new_xyz, radius, nsample, self.bq_window, self.ops_impl, certificates)
            if self.pre_project:
                feats.append(getattr(self, f"scale{i}")(
                    xyz, points, bn_momentum, {"new_xyz": new_xyz, "idx": idx}
                )[1])
            else:
                feats.append(self._literal(i, xyz, points, new_xyz, idx, bn_momentum))
        return new_xyz, torch.cat(feats, dim=-1)

    def _literal(self, i, xyz, points, new_xyz, idx, bn_momentum) -> torch.Tensor:
        """Scale i in the literal layout: one gather of ``[xyz, points]``, the
        rows ``[features, xyz offsets]`` (the features alone without
        ``use_xyz``), the MLP, the max over each group."""
        if points is None:
            grouped = ops.group_points(xyz, idx) - new_xyz[:, :, None, :]
        else:
            grouped_all = ops.group_points(torch.cat([xyz, points.to(xyz.dtype)], dim=-1), idx)
            features = grouped_all[..., 3:].to(points.dtype)
            if self.use_xyz:
                grouped = torch.cat([features, grouped_all[..., :3] - new_xyz[:, :, None, :]], dim=-1)
            else:
                grouped = features
        return getattr(self, f"mlp_{i}")(grouped, bn_momentum).amax(dim=2)


class FeaturePropagation(nn.Module):
    """Interpolate (B, M, C2) coarse features onto (B, N, 3) dense points,
    concatenate the (B, N, C1) skip features, and apply a shared MLP (without
    BatchNorms with ``use_bn=False``; the JAX module has no ``use_xyz``)."""

    def __init__(
        self, in_features: int, mlp: Sequence[int], ops_impl: Optional[str] = None,
        fp_window: Optional[int] = None, compute_dtype: Optional[torch.dtype] = None, use_bn: bool = True,
    ):
        super().__init__()
        self.ops_impl = ops_impl
        self.fp_window = fp_window
        self.mlp = SharedMLP(in_features, mlp, use_bn=use_bn)
        self.set_compute_dtype(compute_dtype)

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> None:
        self.compute_dtype = dtype
        self.mlp.dtype = dtype

    def forward(
        self,
        xyz1: torch.Tensor,
        xyz2: torch.Tensor,
        points1: Optional[torch.Tensor],
        points2: torch.Tensor,
        bn_momentum: Optional[Momentum] = None,
        geometry: Optional[Mapping[str, torch.Tensor]] = None,
        certificates: Optional[Certificates] = None,
    ):
        if geometry is not None:
            dist2, idx = geometry["dist2"], geometry["idx"]
        elif self.fp_window is not None:
            with torch.no_grad():
                dist2, idx, ok = ops.three_nn_calibrated(xyz1, xyz2, self.fp_window, impl=self.ops_impl)
            if certificates is not None:
                certificates.append(("fp_window_ok", ok))
        else:
            with torch.no_grad():
                dist2, idx = ops.three_nn(xyz1, xyz2, impl=self.ops_impl)
        # Distances are geometry, not parameters: no gradient goes back through them.
        weight = ops.interpolation_weights(dist2.detach())
        # A bfloat16 stage interpolates at default precision (bfloat16 weights)
        # and concatenates its skip features in bfloat16.
        precision = "default" if self.compute_dtype == torch.bfloat16 else None
        if points1 is not None and self.compute_dtype is not None:
            points1 = points1.to(self.compute_dtype)
        # With skip features, the interpolation and the concat in one op:
        # on the kernel path one kernel writes both halves of each row.
        interpolated = ops.three_interpolate(
            points2, idx, weight, impl=self.ops_impl, precision=precision, skip=points1
        )
        return self.mlp(interpolated, bn_momentum)
