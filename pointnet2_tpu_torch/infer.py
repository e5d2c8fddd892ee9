"""The eval forward as a user calls it: ``Predictor``.

Counterpart of ``Trainer._infer_logits_ok`` and ``Trainer._predict_step``
(``pointnet2_tpu/train/trainer.py:482-553``): the model in eval mode, run over
the batch in chunks of ``infer_chunk`` clouds (the grouped tensors' working
set stays at the chunk's size; eval BatchNorm uses moving statistics, so the
chunks are independent and the result is the same), and the argmax as int32
labels.

The Predictor runs on CUDA unless it is given another device, and raises if
CUDA is absent; it never falls back to the CPU.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.models.pointnet2_seg import PointNet2SemSeg


def resolve_device(device: Optional[str | torch.device]) -> torch.device:
    """``None`` means CUDA, which must be present; anything else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the port runs on CUDA by default and no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def full_float32() -> None:
    """Keep float32 matmuls and convolutions in float32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@torch.no_grad()
def chunked_logits(model: PointNet2SemSeg, x: torch.Tensor, chunk: int) -> torch.Tensor:
    """The eval forward of ``model`` over ``x (B, N, 3+C)`` in chunks of ``chunk`` clouds.

    A chunk size that is 0, not below B, or does not divide B runs the batch whole.
    """
    b = x.shape[0]
    if chunk and 0 < chunk < b and b % chunk == 0:
        return torch.cat([model(c) for c in x.split(chunk)])
    return model(x)


class Predictor:
    """Eval-mode ``PointNet2SemSeg`` with batch chunking.

    ``impl`` is passed to every point-set operator: None runs the CUDA
    kernels on a CUDA device, "torch" the plain versions (for comparisons).
    """

    def __init__(
        self,
        cfg: Config,
        state_dict: Mapping[str, torch.Tensor],
        num_classes: int = 9,
        infer_chunk: int = 8,
        device: Optional[str | torch.device] = None,
        impl: Optional[str] = None,
    ):
        full_float32()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.infer_chunk = infer_chunk
        model = PointNet2SemSeg(cfg, num_classes, bool(cfg.use_color), ops_impl=impl)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()

    def infer_logits(self, points: np.ndarray | torch.Tensor) -> torch.Tensor:
        """(B, N, 3+C) float32 -> (B, N, num_classes) logits on the Predictor's device."""
        x = torch.as_tensor(points, dtype=torch.float32).to(self.device)
        return chunked_logits(self.model, x, self.infer_chunk)

    def predict_step(self, points: np.ndarray | torch.Tensor) -> torch.Tensor:
        """(B, N, 3+C) float32 -> (B, N) int32 labels."""
        return self.infer_logits(points).argmax(dim=-1).to(torch.int32)
