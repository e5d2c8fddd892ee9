"""Self-contained interactive HTML point-cloud viewer.

An own copy of ``pointnet2_tpu/utils/html_viewer.py`` (the port imports
nothing of the JAX package); it writes the same bytes for the same input.
The reference opens a live Open3D window (visualize.py:9-42). Headless, the
viewer is instead one HTML file with the cloud embedded (base64 Float32 and
Uint8 arrays) and a dependency-free canvas renderer: drag to orbit,
shift-drag to pan, wheel to zoom. It works in any browser, offline.
"""

from __future__ import annotations

import base64
import json
import pathlib

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body { margin:0; background:#111; color:#ccc; font:13px sans-serif; overflow:hidden }
 #hud { position:fixed; top:8px; left:10px; pointer-events:none }
 canvas { display:block; cursor:grab }
</style></head>
<body>
<div id="hud">__TITLE__ — __NPTS__ points · drag: orbit · shift-drag: pan · wheel: zoom</div>
<canvas id="c"></canvas>
<script>
const META = __META__;
function decode(b64, T) {
  const bin = atob(b64); const bytes = new Uint8Array(bin.length);
  for (let i = 0; i < bin.length; i++) bytes[i] = bin.charCodeAt(i);
  return new T(bytes.buffer);
}
const pts = decode("__PTS__", Float32Array);
const cols = decode("__COLS__", Uint8Array);
const n = META.n;
const canvas = document.getElementById("c");
const ctx = canvas.getContext("2d");
let yaw = 0.6, pitch = -1.0, dist = META.radius * 2.2;
let panX = 0, panY = 0;
let dragging = false, panning = false, lastX = 0, lastY = 0;

function resize() {
  canvas.width = innerWidth; canvas.height = innerHeight; draw();
}
addEventListener("resize", resize);
canvas.addEventListener("mousedown", e => {
  dragging = true; panning = e.shiftKey; lastX = e.clientX; lastY = e.clientY;
});
addEventListener("mouseup", () => dragging = false);
addEventListener("mousemove", e => {
  if (!dragging) return;
  const dx = e.clientX - lastX, dy = e.clientY - lastY;
  lastX = e.clientX; lastY = e.clientY;
  if (panning) { panX += dx; panY += dy; }
  else { yaw += dx * 0.005; pitch += dy * 0.005;
         pitch = Math.max(-Math.PI / 2, Math.min(Math.PI / 2, pitch)); }
  requestAnimationFrame(draw);
});
canvas.addEventListener("wheel", e => {
  e.preventDefault();
  dist *= Math.exp(e.deltaY * 0.001);
  requestAnimationFrame(draw);
}, { passive: false });

function draw() {
  const w = canvas.width, h = canvas.height;
  const img = ctx.createImageData(w, h);
  const data = img.data;
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const f = 1.2 * Math.min(w, h);
  const cx0 = META.center[0], cy0 = META.center[1], cz0 = META.center[2];
  for (let i = 0; i < n; i++) {
    let x = pts[3 * i] - cx0, y = pts[3 * i + 1] - cy0, z = pts[3 * i + 2] - cz0;
    let rx = cy * x + sy * y, ry = -sy * x + cy * y;          // yaw about z
    // pitch about the screen-horizontal axis: mixes depth (rx) and z
    let rx2 = cp * rx + sp * z, rz2 = -sp * rx + cp * z;
    const depth = rx2 + dist;
    if (depth <= 0.05 * META.radius) continue;
    const sxp = (ry / depth) * f + w / 2 + panX;
    const syp = (-rz2 / depth) * f + h / 2 + panY;
    const px = sxp | 0, py = syp | 0;
    if (px < 0 || px >= w || py < 0 || py >= h) continue;
    const o = 4 * (py * w + px);
    data[o] = cols[3 * i]; data[o + 1] = cols[3 * i + 1];
    data[o + 2] = cols[3 * i + 2]; data[o + 3] = 255;
  }
  ctx.putImageData(img, 0, 0);
}
resize();
</script></body></html>
"""


def write_html_viewer(
    points: np.ndarray,
    colors: np.ndarray | None,
    out_path: str | pathlib.Path,
    title: str = "point cloud",
    max_points: int = 400_000,
) -> str:
    """Write a standalone interactive viewer HTML for (points, colors).

    colors: (N, 3) floats in [0, 1] or None (height-colored fallback).
    """
    pts = np.asarray(points, np.float64)
    if colors is None:
        z = pts[:, 2]
        t = (z - z.min()) / max(np.ptp(z), 1e-9)
        colors = np.stack([t, 0.4 + 0.2 * t, 1.0 - t], axis=1)
    cols = np.asarray(colors, np.float64)
    if len(pts) > max_points:
        sel = np.random.RandomState(0).choice(len(pts), max_points, replace=False)
        pts, cols = pts[sel], cols[sel]

    center = pts.mean(axis=0)
    radius = float(np.linalg.norm(pts - center, axis=1).max() or 1.0)
    meta = {"n": len(pts), "center": center.tolist(), "radius": radius}
    pts32 = pts.astype(np.float32).reshape(-1)
    cols8 = np.clip(np.round(cols * 255.0), 0, 255).astype(np.uint8).reshape(-1)

    html = (
        _TEMPLATE.replace("__TITLE__", title)
        .replace("__NPTS__", f"{len(pts):,}")
        .replace("__META__", json.dumps(meta))
        .replace("__PTS__", base64.b64encode(pts32.tobytes()).decode("ascii"))
        .replace("__COLS__", base64.b64encode(cols8.tobytes()).decode("ascii"))
    )
    out_path = pathlib.Path(out_path)
    out_path.write_text(html)
    return str(out_path)
