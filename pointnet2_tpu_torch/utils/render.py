"""Headless point-cloud rendering to PNG.

An own copy of ``pointnet2_tpu/utils/render.py`` (the port imports nothing of
the JAX package). matplotlib is imported when a frame is rendered, not with
the module: a machine without it runs everything but ``--render``, which
raises ``ImportError`` there.

The reference uses a live Open3D visualizer (visualize.py:9-42,
kitti_predict.py:151-204). This environment has no display, so frames are
rendered as orthographic top/front scatter plots with matplotlib — the same
label palette, writable per-frame for a playback sequence.
"""

from __future__ import annotations

import importlib

import numpy as np


def require_matplotlib():
    """The ``matplotlib`` module, or an ``ImportError`` that says what needs it."""
    try:
        return importlib.import_module("matplotlib")
    except ImportError as e:
        raise ImportError(
            "rendering frames (--render) needs matplotlib, which is not installed here; "
            "run without --render, or render the saved .pcd files on a machine that has it"
        ) from e


def render_cloud_png(
    points: np.ndarray,
    colors: np.ndarray | None,
    out_path: str,
    title: str | None = None,
    max_points: int = 200_000,
    views: tuple = (("top (x-y)", 0, 1), ("front (x-z)", 0, 2)),
    dpi: int = 120,
) -> str:
    """Write an orthographic scatter render of (points, colors) to out_path.

    colors: (N, 3) in [0, 1] or None (falls back to height coloring).
    """
    matplotlib = require_matplotlib()
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = np.asarray(points)
    if len(pts) > max_points:
        sel = np.random.RandomState(0).choice(len(pts), max_points, replace=False)
        pts = pts[sel]
        colors = colors[sel] if colors is not None else None
    c = colors if colors is not None else pts[:, 2]

    fig, axes = plt.subplots(1, len(views), figsize=(8 * len(views), 8))
    if len(views) == 1:
        axes = [axes]
    for ax, (name, ix, iy) in zip(axes, views):
        ax.scatter(pts[:, ix], pts[:, iy], s=0.05, c=c)
        ax.set_title(name)
        ax.set_aspect("equal")
    if title:
        fig.suptitle(title)
    fig.savefig(out_path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return out_path
