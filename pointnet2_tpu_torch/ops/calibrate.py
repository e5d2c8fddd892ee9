"""Window calibration for the calibrated-window operators (host-side NumPy).

An own copy of ``pointnet2_tpu/ops/calibrate.py``: the port imports nothing
of the JAX package. ``ops.ball_query_calibrated`` and
``ops.three_nn_calibrated`` look only at a ``window``-wide slice of the
x-sorted dataset for each tile of 128 sorted queries, and return a
certificate that the slice was enough. This module computes, from
representative clouds, the window each level would need: calibration picks
the width, the certificates prove it on every batch.

``calibrate_model_windows`` takes the FPS centroids from the port's own
``ops.fps_centroids`` (the CUDA kernel on the card, unless given another
device), so the spans it measures are those of the model's own queries.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

_LANES = 128


def parse_window_arg(v: str):
    """A command-line value for a window: an int (one width for every level),
    ``auto`` (calibrate from sampled batches), or a per-level comma list such
    as ``3072,768,-,-`` where ``-``/``none`` keeps that level exact."""
    if v == "auto":
        return v
    if "," in v:
        return tuple(
            None if s.strip().lower() in ("-", "none", "") else int(s)
            for s in v.split(",")
        )
    return int(v)


def required_bq_window(xyz: np.ndarray, queries: np.ndarray, radius: float) -> int:
    """The most columns any 128-query tile must sweep for the ball query.

    Mirrors the window placement of the windowed ball query: tiles cut from
    the x-sorted queries, the window starting at the 128-aligned floor of the
    leftmost in-radius column and reaching the rightmost one.
    """
    b, n, _ = xyz.shape
    m = queries.shape[1]
    tm = min(_LANES, m)
    t = max(m // tm, 1)
    worst = 0
    for bi in range(b):
        xs = np.sort(xyz[bi, :, 0])
        qs = np.sort(queries[bi, :, 0])[: t * tm].reshape(t, tm)
        lo = np.searchsorted(xs, qs.min(axis=1) - radius)
        hi = np.searchsorted(xs, qs.max(axis=1) + radius)
        lo_aligned = (lo // _LANES) * _LANES
        worst = max(worst, int((hi - lo_aligned).max()))
    return worst


def required_fp_window(dataset: np.ndarray, queries: np.ndarray, k: int = 3) -> int:
    """The smallest 128-multiple window that certifies exact kNN.

    Simulates the windowed kNN's centred window placement and its strict
    certificate (k-th pick below the squared x-gap to the nearest column left
    out) for each candidate width; returns the smallest width that certifies
    every query, or the padded dataset size when none does (the op then runs
    the exact kernel).
    """
    b, m, _ = dataset.shape
    nq = queries.shape[1]
    tq = min(_LANES, nq)
    t = max(nq // tq, 1)
    mpad = int(np.ceil(m / _LANES) * _LANES)
    worst = _LANES
    for bi in range(b):
        order = np.argsort(dataset[bi, :, 0], kind="stable")
        xsx = dataset[bi, order, 0]
        qorder = np.argsort(queries[bi, :, 0], kind="stable")
        qs = queries[bi][qorder][: t * tq].reshape(t, tq, 3)
        d2 = ((qs.reshape(-1, 1, 3) - dataset[bi][None]) ** 2).sum(-1)
        kth = np.sort(d2, axis=1)[:, k - 1].reshape(t, tq)
        qx = qs[..., 0]
        mid = (
            np.searchsorted(xsx, qx.min(axis=1))
            + np.searchsorted(xsx, qx.max(axis=1))
        ) // 2
        need = mpad  # no width below the cloud size certifies
        for w in range(_LANES, mpad, _LANES):
            lo = ((mid - w // 2 + _LANES // 2) // _LANES) * _LANES
            lo = np.clip(lo, 0, max(mpad - w, 0))
            xl = xsx[np.clip(lo - 1, 0, m - 1)]
            xr = xsx[np.clip(lo + w, 0, m - 1)]
            bl = np.where((lo > 0)[:, None], np.maximum(qx - xl[:, None], 0.0) ** 2, np.inf)
            br = np.where((lo + w < m)[:, None], np.maximum(xr[:, None] - qx, 0.0) ** 2, np.inf)
            if (kth < np.minimum(bl, br)).all():
                need = w
                break
        worst = max(worst, need)
    return worst


def calibrate_model_windows(
    sa_specs: Sequence[Tuple[int, float]],
    num_point: int,
    sample_xyz: Callable[[], np.ndarray],
    num_batches: int = 8,
    margin: float = 1.25,
    device: Optional[str | torch.device] = None,
) -> Tuple[Optional[int], Optional[int]]:
    """``(bq_window, fp_window)`` from sampled batches, each None where no
    window would engage.

    ``sa_specs`` is ``[(npoint, radius), ...]`` per SA level; ``sample_xyz()``
    returns one (B, N, 3+) float32 batch of raw clouds. The centroids of each
    level come from ``ops.fps_centroids`` on ``device`` (CUDA unless given).
    Per level the worst width is kept, and one width per operator is chosen
    that is safe at every level where it engages (``choose_window``).
    """
    from pointnet2_tpu_torch import ops
    from pointnet2_tpu_torch.infer import resolve_device

    dev = resolve_device(device)
    nlevels = len(sa_specs)
    bq_req = [0] * nlevels  # per level: cloud -> ball query of its centroids
    fp_req = [0] * nlevels  # per level: centroids -> 3-NN back onto the cloud
    for _ in range(num_batches):
        cloud = np.ascontiguousarray(sample_xyz()[..., :3], np.float32)
        for li, (npoint, radius) in enumerate(sa_specs):
            _, cent = ops.fps_centroids(torch.from_numpy(cloud).to(dev), npoint)
            centroids = cent.cpu().numpy()
            bq_req[li] = max(bq_req[li], required_bq_window(cloud, centroids, radius))
            fp_req[li] = max(fp_req[li], required_fp_window(centroids, cloud))
            cloud = centroids

    # bq at level li queries the previous cloud; fp at li queries back onto it
    clouds = [num_point] + [npoint for npoint, _ in sa_specs[:-1]]
    fp_clouds = [npoint for npoint, _ in sa_specs]
    return choose_window(bq_req, clouds, margin), choose_window(fp_req, fp_clouds, margin)


def choose_window(
    reqs: Sequence[int], cloud_sizes: Sequence[int], margin: float = 1.25
) -> Optional[int]:
    """One width safe at every level it engages, or None if it never would.

    A window W engages at a level only when W is below that level's cloud
    size (otherwise the operator runs the exact kernel), so W is raised
    (margin-scaled, 128-aligned) until every engaged level's requirement is
    met; where no width below a cloud certifies, W is raised to the cloud
    size, which disengages that level.
    """
    w = 0
    for req, cloud in sorted(zip(reqs, cloud_sizes), key=lambda t: -t[1]):
        if w and w >= cloud:
            continue  # disengaged: the exact kernel runs
        need = int(np.ceil(req * margin / _LANES) * _LANES)
        w = max(w, cloud if need >= cloud else need)
    return w if 0 < w < max(cloud_sizes) else None
