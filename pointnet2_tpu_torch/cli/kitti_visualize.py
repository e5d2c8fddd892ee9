"""Render the Velodyne frames of KITTI drives to a PNG sequence.

    python -m pointnet2_tpu_torch.cli.kitti_visualize --kitti_root DIR [--dates 2011_09_26]
        [--drives 0095] [--out_dir result/kitti_frames] [--max_frames 10]

Counterpart of the root ``kitti_visualize.py``, flag for flag and line for
line. The reference plays the drive back in an interactive Open3D window
(kitti_visualize.py:6-41); headless, each of the first ``--max_frames``
frames of each drive becomes ``<date>_<drive>_<frame>.png``, a top view
coloured by height. Frames come from the port's ``data.kitti``. Host work
only: no device. matplotlib is imported when the first frame is drawn
(``utils.render.require_matplotlib``), so the module imports without it.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from pointnet2_tpu_torch.data.kitti import iter_velodyne_frames
from pointnet2_tpu_torch.utils.render import require_matplotlib


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kitti_root", required=True)
    parser.add_argument("--dates", nargs="+", default=["2011_09_26"])
    parser.add_argument("--drives", nargs="+", default=["0095"])
    parser.add_argument("--out_dir", default="result/kitti_frames")
    parser.add_argument("--max_frames", type=int, default=10)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Render the frames; returns the PNGs written."""
    flags = build_parser().parse_args(argv)
    matplotlib = require_matplotlib()
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(flags.out_dir, exist_ok=True)
    written = []
    for date in flags.dates:
        for drive in flags.drives:
            for i, scan in enumerate(iter_velodyne_frames(flags.kitti_root, date, drive)):
                if i >= flags.max_frames:
                    break
                pts = scan[:, :3]
                fig, ax = plt.subplots(figsize=(10, 10))
                ax.scatter(pts[:, 0], pts[:, 1], s=0.05, c=pts[:, 2], cmap="viridis")
                ax.set_aspect("equal")
                ax.set_title(f"{date}/{drive} frame {i} ({len(pts)} pts)")
                out = os.path.join(flags.out_dir, f"{date}_{drive}_{i:04d}.png")
                fig.savefig(out, dpi=100, bbox_inches="tight")
                plt.close(fig)
                print("wrote", out)
                written.append(out)
    return written


if __name__ == "__main__":
    main()
