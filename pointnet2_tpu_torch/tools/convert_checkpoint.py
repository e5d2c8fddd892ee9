"""Convert a reference TF checkpoint into a checkpoint of the port.

    python -m pointnet2_tpu_torch.tools.convert_checkpoint --tf_ckpt ref.npz --out model.pt \\
        [--config_file semantic.json] [--device cuda]

Counterpart of the JAX repo's ``tools/convert_checkpoint.py``: the reference
SSG model's TF variables (an ``.npz`` export, ``np.savez(out, **{v.op.name:
sess.run(v) for v in tf.global_variables()})`` from any TF1 environment; a
TF V2 checkpoint prefix needs ``tensorflow``) are mapped by name onto the
port's model (``convert.state_dict_from_tf``) and loaded strictly into a
``Trainer`` built from the config, so a missing, leftover or misshapen
variable raises here. One eval forward on a cloud of zeros on ``--device``
(CUDA by default, which must be present) checks the shapes against the
model the config describes. The output is the port's own checkpoint file,
what ``train.save_checkpoint`` writes (step 0, a fresh optimizer state):
``cli.predict --ckpt``, ``cli.kitti_predict --ckpt``,
``tools.export_model --ckpt`` and ``cli.train --resume`` read it. It cannot
write the JAX package's orbax directory.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import torch

from pointnet2_tpu_torch.cli import add_device_flag, cli_device
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.convert import state_dict_from_tf
from pointnet2_tpu_torch.train import Trainer, save_checkpoint


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tf_ckpt", required=True, help="TF ckpt prefix or .npz")
    ap.add_argument("--out", required=True, help="the port's checkpoint file to write (torch.save)")
    ap.add_argument("--config_file", default="semantic.json")
    add_device_flag(ap)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Convert, check the shapes, write; returns the file written, the
    tensors loaded and the seconds of the conversion and of the forward."""
    args = build_parser().parse_args(argv)
    device = cli_device(args.device)
    cfg = Config.from_json(args.config_file)
    t0 = time.perf_counter()
    state = state_dict_from_tf(args.tf_ckpt)
    convert_seconds = time.perf_counter() - t0

    trainer = Trainer(cfg, device=device)
    trainer.model.load_state_dict(state)  # strict: every key once, every shape the config's
    t0 = time.perf_counter()
    with torch.no_grad():
        trainer.infer_forward()(torch.zeros(1, cfg.num_point, cfg.point_dim, device=device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    forward_seconds = time.perf_counter() - t0
    save_checkpoint(os.path.abspath(args.out), trainer)
    print(f"wrote converted checkpoint to {args.out}")
    return {"out": os.path.abspath(args.out), "tensors": len(state), "convert_seconds": convert_seconds,
            "forward_seconds": forward_seconds}


if __name__ == "__main__":
    main()
