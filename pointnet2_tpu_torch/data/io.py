"""Point-cloud file I/O without Open3D.

An own copy of ``pointnet2_tpu/data/io.py``: the port imports nothing of the
JAX package. Files written by either are read by the other, bit for bit.

The reference leans on Open3D's C++ readers/writers (read_point_cloud /
write_point_cloud, e.g. preprocess.py:53-54, predict.py:194-197). This module
is a self-contained NumPy implementation of the formats the pipeline touches:

- .pcd  (ascii + binary, PCL packed-float ``rgb`` and split r/g/b fields)
- .pts  (Semantic3D intermediate: count header + "x y z i r g b" rows)
- .txt  (Semantic3D raw: "x y z i r g b" rows, no header)
- .labels (one int per line)

Colors follow the Open3D convention: float64 in [0, 1].
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Optional

import numpy as np

_PCD_DTYPES = {
    ("F", 4): np.float32,
    ("F", 8): np.float64,
    ("U", 1): np.uint8,
    ("U", 2): np.uint16,
    ("U", 4): np.uint32,
    ("I", 1): np.int8,
    ("I", 2): np.int16,
    ("I", 4): np.int32,
}


@dataclasses.dataclass
class PointCloud:
    points: np.ndarray  # (N, 3) float64
    colors: Optional[np.ndarray] = None  # (N, 3) float64 in [0, 1]
    intensity: Optional[np.ndarray] = None  # (N,) float32

    def __len__(self) -> int:
        return len(self.points)


def _parse_pcd_header(f) -> dict:
    header = {}
    while True:
        line = f.readline().decode("ascii", errors="replace").strip()
        if not line or line.startswith("#"):
            continue
        key, _, rest = line.partition(" ")
        header[key.upper()] = rest.split()
        if key.upper() == "DATA":
            header["DATA"] = rest.strip().lower()
            break
    return header


def read_pcd(path: str | pathlib.Path) -> PointCloud:
    """Read a .pcd file (ascii or binary)."""
    path = pathlib.Path(path)
    with open(path, "rb") as f:
        h = _parse_pcd_header(f)
        fields = [s.lower() for s in h["FIELDS"]]
        sizes = [int(s) for s in h["SIZE"]]
        types = [s.upper() for s in h["TYPE"]]
        counts = [int(s) for s in h.get("COUNT", ["1"] * len(fields))]
        npoints = int(h["POINTS"][0])
        if any(c != 1 for c in counts):
            raise ValueError(f"{path}: COUNT != 1 not supported")
        np_dtype = np.dtype(
            [
                (name, _PCD_DTYPES[(t, s)])
                for name, t, s in zip(fields, types, sizes)
            ]
        )
        if h["DATA"] == "ascii":
            # Parse each column directly in its DECLARED type. Going through
            # float64 text and casting back would double-round packed-rgb
            # float32 bit patterns (denormals etc.) and corrupt the colors.
            arr = np.loadtxt(f, dtype=np_dtype, max_rows=npoints, ndmin=1)
            rec = {name: arr[name] for name in fields}
        elif h["DATA"] == "binary":
            buf = f.read(npoints * np_dtype.itemsize)
            arr = np.frombuffer(buf, dtype=np_dtype, count=npoints)
            rec = {name: arr[name] for name in fields}
        else:
            raise ValueError(f"{path}: DATA {h['DATA']!r} not supported")

    points = np.stack(
        [np.asarray(rec["x"], np.float64), rec["y"], rec["z"]], axis=1
    ).astype(np.float64)

    colors = None
    if "rgb" in rec:
        packed = np.asarray(rec["rgb"])
        if packed.dtype.kind == "f":
            packed = packed.astype(np.float32).view(np.uint32)
        else:
            packed = packed.astype(np.uint32)
        r = (packed >> 16) & 0xFF
        g = (packed >> 8) & 0xFF
        b = packed & 0xFF
        colors = np.stack([r, g, b], axis=1).astype(np.float64) / 255.0
    elif all(c in rec for c in ("r", "g", "b")):
        colors = np.stack([rec["r"], rec["g"], rec["b"]], axis=1).astype(np.float64)
        if colors.max(initial=0.0) > 1.0:
            colors /= 255.0

    intensity = (
        np.asarray(rec["intensity"], np.float32) if "intensity" in rec else None
    )
    return PointCloud(points=points, colors=colors, intensity=intensity)


def write_pcd(
    path: str | pathlib.Path,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    binary: bool = True,
) -> None:
    """Write a .pcd (binary by default, like Open3D's write_point_cloud).

    colors: (N, 3) in [0, 1] (written as PCL packed-float rgb) — optional.
    """
    points = np.asarray(points, np.float64).reshape(-1, 3)
    n = len(points)
    has_color = colors is not None
    fields = "x y z rgb" if has_color else "x y z"
    sizes = "4 4 4 4" if has_color else "4 4 4"
    types = "F F F F" if has_color else "F F F"
    counts = "1 1 1 1" if has_color else "1 1 1"
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {fields}\n"
        f"SIZE {sizes}\n"
        f"TYPE {types}\n"
        f"COUNT {counts}\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    xyz = points.astype(np.float32)
    if has_color:
        c = np.asarray(colors, np.float64).reshape(-1, 3)
        if c.max(initial=0.0) > 1.0:
            c = c / 255.0
        rgb8 = np.clip(np.round(c * 255.0), 0, 255).astype(np.uint32)
        packed = (rgb8[:, 0] << 16) | (rgb8[:, 1] << 8) | rgb8[:, 2]
        rgbf = packed.view(np.float32)

    path = pathlib.Path(path)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            if has_color:
                rec = np.empty(
                    n,
                    dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("rgb", "<f4")],
                )
                rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
                rec["rgb"] = rgbf
            else:
                rec = np.empty(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
                rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
            f.write(rec.tobytes())
        else:
            if has_color:
                cols = np.column_stack([xyz, rgbf.astype(np.float64)])
            else:
                cols = xyz
            np.savetxt(f, cols, fmt="%.10g")


def read_semantic3d_txt(path: str | pathlib.Path) -> PointCloud:
    """Read a raw Semantic3D .txt: "x y z intensity r g b" per line."""
    raw = np.loadtxt(path, dtype=np.float64, ndmin=2)
    if raw.shape[1] < 3:
        raise ValueError(f"{path}: expected >=3 columns")
    points = raw[:, :3]
    intensity = raw[:, 3].astype(np.float32) if raw.shape[1] >= 4 else None
    colors = raw[:, 4:7] / 255.0 if raw.shape[1] >= 7 else None
    return PointCloud(points=points, colors=colors, intensity=intensity)


def read_pts(path: str | pathlib.Path) -> PointCloud:
    """Read a .pts file: first line is the point count, then x y z i r g b."""
    with open(path, "r") as f:
        n = int(f.readline().split()[0])
        raw = np.loadtxt(f, dtype=np.float64, max_rows=n, ndmin=2)
    points = raw[:, :3]
    intensity = raw[:, 3].astype(np.float32) if raw.shape[1] >= 4 else None
    colors = raw[:, 4:7] / 255.0 if raw.shape[1] >= 7 else None
    return PointCloud(points=points, colors=colors, intensity=intensity)


def write_pts(path: str | pathlib.Path, cloud: PointCloud) -> None:
    """Write a .pts (count header + x y z i r g b int rows), preprocess.py:36-49."""
    n = len(cloud)
    inten = (
        cloud.intensity
        if cloud.intensity is not None
        else np.zeros((n,), np.float32)
    )
    colors = (
        np.clip(np.round(np.asarray(cloud.colors) * 255.0), 0, 255)
        if cloud.colors is not None
        else np.zeros((n, 3))
    )
    with open(path, "w") as f:
        f.write(f"{n}\n")
        for p, i, c in zip(cloud.points, inten, colors):
            f.write(
                f"{p[0]:.10g} {p[1]:.10g} {p[2]:.10g} {int(i)} "
                f"{int(c[0])} {int(c[1])} {int(c[2])}\n"
            )


def load_labels(path: str | pathlib.Path) -> np.ndarray:
    """One int per line -> int32 array (util/point_cloud_util.py:53-58)."""
    return np.loadtxt(path, dtype=np.int32, ndmin=1)


def write_labels(path: str | pathlib.Path, labels) -> None:
    """int per line (util/point_cloud_util.py:61-63)."""
    np.savetxt(path, np.asarray(labels, np.int64), fmt="%d")
