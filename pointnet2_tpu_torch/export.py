"""Export of the eval forward as a ``torch.export`` artifact, and its loader.

Counterpart of ``pointnet2_tpu/export.py:39-172``. ``export_model`` writes
the eval forward of a ``Trainer``'s model as a self-contained artifact:

- the weights are in the program (one directory serves, no checkpoint);
- the batch may be symbolic (``batch=None``: one artifact, any batch, the
  forward unchunked), or fixed (the forward in chunks of ``infer_chunk``);
- ``load_exported`` needs ``torch`` and the ``pn2`` operators
  (``ops.library``) alone: no model or ``nn`` code;
- with calibrated windows the program also returns ``ok``, the AND of the
  batch's window certificates, and the manifest says so: a server must
  check it on every batch.

Each kernel is one ``pn2`` node of the exported graph. The JAX package
refuses a symbolic batch with its kernels (``export.py:67-88``) because a
Mosaic grid needs concrete shapes; that has no counterpart here: a ``pn2``
operator plans its launch from the concrete tensors it is given at run
time, so a symbolic-batch artifact runs the kernels too.

An artifact is served on the device it was exported on (``manifest
["device"]``); loading a CUDA artifact without CUDA raises. The trace runs
under ``torch.no_grad()``: the model takes its fused windowed eval path
only without autograd (``nn.pointnet``), so the artifact is the forward a
``Predictor`` runs.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

MANIFEST = "manifest.json"
ARTIFACT = "model.pt2"
# The example batch of a symbolic-batch trace: 1 would be specialised.
SYMBOLIC_EXAMPLE_BATCH = 2


def export_model(trainer, path: str, *, batch: Optional[int] = None, output: str = "labels") -> dict:
    """Write the eval forward of ``trainer.model``'s weights under ``path``.

    The forward is a ``Predictor``'s: built from ``trainer.model.state_dict()``
    with the trainer's ``arch``, ``infer_dtype``, ``bf16_min_width``, windows,
    ``ops_impl``, ``infer_chunk`` and device (a bfloat16 mode folds the eval
    BatchNorms into the weights). ``batch``: a fixed batch (the chunked
    forward), or None for a symbolic one (unchunked). ``output``: "labels"
    (argmax, int32) or "logits". With windows the program returns
    ``(output, ok)``. Writes ``model.pt2`` (``torch.export.save``) and
    ``manifest.json``; returns the manifest.
    """
    from pointnet2_tpu_torch.infer import Predictor, ServedForward

    cfg = trainer.cfg
    checked = trainer.windows_on
    predictor = Predictor(
        cfg, trainer.model.state_dict(), num_classes=trainer.num_classes, infer_chunk=trainer.infer_chunk,
        device=trainer.device, impl=trainer.ops_impl, bq_window=trainer.bq_window, fp_window=trainer.fp_window,
        dtype=trainer.infer_dtype, bf16_min_width=trainer.bf16_min_width, arch=trainer.arch,
        pre_project=trainer.pre_project,
    )
    forward = ServedForward(predictor.model, predictor.infer_chunk if batch else 0, output, checked)
    example = torch.zeros(
        (batch or SYMBOLIC_EXAMPLE_BATCH, cfg.num_point, cfg.point_dim), dtype=torch.float32,
        device=predictor.device,
    )
    dynamic = None if batch else ({0: torch.export.Dim("b", min=1)},)
    with torch.no_grad():
        program = torch.export.export(forward, (example,), dynamic_shapes=dynamic)
    os.makedirs(path, exist_ok=True)
    artifact = os.path.join(path, ARTIFACT)
    torch.export.save(program, artifact)
    manifest = {
        "artifact": ARTIFACT,
        "input_shape": [batch, cfg.num_point, cfg.point_dim],
        "input_dtype": "float32",
        "output": output,
        "num_classes": trainer.num_classes,
        "arch": trainer.arch,
        "infer_dtype": trainer.infer_dtype,
        "bf16_min_width": trainer.bf16_min_width,
        "window_certificate": checked,
        "bq_window": trainer.bq_window,
        "fp_window": trainer.fp_window,
        "device": predictor.device.type,
        "torch_version": torch.__version__,
        "artifact_bytes": os.path.getsize(artifact),
    }
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def load_exported(path: str):
    """``(callable, manifest)`` from an ``export_model`` directory.

    The callable maps ``(B, num_point, point_dim)`` float32 points on the
    manifest's device to the exported output (``(output, ok)`` when the
    manifest says ``window_certificate``), without autograd. Raises
    ``RuntimeError`` for a CUDA artifact where CUDA is absent.
    """
    from pointnet2_tpu_torch.ops import library  # noqa: F401  (registers the pn2 operators)

    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["device"] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported for CUDA and no CUDA device is available")
    module = torch.export.load(os.path.join(path, manifest["artifact"])).module()

    def run(points: torch.Tensor):
        with torch.no_grad():
            return module(points)

    return run, manifest
