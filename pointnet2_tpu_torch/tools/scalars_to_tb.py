"""Convert a run's ``scalars.jsonl`` into TensorBoard event files.

    python -m pointnet2_tpu_torch.tools.scalars_to_tb --logdir log/semantic [--out log/semantic/tb]
    tensorboard --logdir log/semantic/tb

Counterpart of the JAX repo's ``tools/scalars_to_tb.py``: one run directory
a tag (train, validation), as the reference's per-split FileWriters
(``utils.logging.export_tensorboard``). Needs ``tensorboardX``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from pointnet2_tpu_torch.utils.logging import export_tensorboard


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Write the event files; returns the run directories."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--logdir", required=True, help="dir containing scalars.jsonl")
    ap.add_argument("--out", default=None, help="output dir (default <logdir>/tb)")
    args = ap.parse_args(argv)
    runs = export_tensorboard(args.logdir, args.out)
    for r in runs:
        print("wrote", r)
    return runs


if __name__ == "__main__":
    main()
