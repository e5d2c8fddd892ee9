"""The eval forward as a user calls it: ``Predictor``.

Counterpart of ``Trainer._infer_logits_ok`` and ``Trainer._predict_step``
(``pointnet2_tpu/train/trainer.py:482-553``): the model in eval mode, run over
the batch in chunks of ``infer_chunk`` clouds (the grouped tensors' working
set stays at the chunk's size; eval BatchNorm uses moving statistics, so the
chunks are independent and the result is the same), and the argmax as int32
labels. With calibrated windows (``bq_window``, ``fp_window``),
``predict_step_checked`` also returns whether every window certificate of
the request held (``_predict_step_checked``, ``:555-563``).

The Predictor runs on CUDA unless it is given another device, and raises if
CUDA is absent; it never falls back to the CPU. ``dtype="bfloat16"`` is the
JAX package's production inference mode (``infer_dtype``, ``:120-124``,
``:487-495``): the MLP path in bfloat16 (or, with ``bf16_min_width``, only
its wide stages), on weights whose eval BatchNorms are folded into the
linear layers once, at construction (``nn.fold``); geometry and logits stay
float32, and the checkpoint is the same float32 one.
"""

from __future__ import annotations

from typing import Callable, List, Mapping, Optional

import numpy as np
import torch

from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.models.pointnet2_seg import PointNet2SemSeg, Window, model_class
from pointnet2_tpu_torch.nn.fold import fold_batch_norm

# The precision modes' names (the JAX Trainer's): None is float32.
DTYPES = {"float32": None, "f32": None, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def compute_dtype(name: str, what: str) -> Optional[torch.dtype]:
    """The model's ``compute_dtype`` for a mode name; ValueError for another name."""
    if name not in DTYPES:
        raise ValueError(f"unknown {what} {name!r}, expected 'float32'/'bfloat16'")
    return DTYPES[name]


def check_min_width(bf16_min_width: Optional[int], what: str, *dtypes: Optional[torch.dtype]) -> None:
    """``bf16_min_width`` needs a bfloat16 mode among ``dtypes``: without one
    it would do nothing. ``what`` says which dtypes are not bfloat16."""
    if bf16_min_width is not None and not any(dtypes):
        raise ValueError(f"bf16_min_width is set but {what} — it would silently do nothing")


def resolve_device(device: Optional[str | torch.device]) -> torch.device:
    """``None`` means CUDA, which must be present; anything else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the port runs on CUDA by default and no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def full_float32() -> None:
    """Keep float32 matmuls and convolutions in float32 (TF32 off), and let
    no bfloat16 GEMM reduce its split-K partial sums in bfloat16: the
    reference accumulates in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


@torch.no_grad()
def chunked_logits(
    model: PointNet2SemSeg | Callable, x: torch.Tensor, chunk: int, certificates: Optional[List] = None
) -> torch.Tensor:
    """The eval forward of ``model`` (a module in eval mode, or a function
    called as one) over ``x (B, N, 3+C)`` in chunks of ``chunk`` clouds.

    A chunk size that is 0, not below B, or does not divide B runs the batch
    whole. ``certificates`` receives every chunk's window certificates.
    """
    b = x.shape[0]
    if chunk and 0 < chunk < b and b % chunk == 0:
        return torch.cat([model(c, certificates=certificates) for c in x.split(chunk)])
    return model(x, certificates=certificates)


def all_ok(certificates: List, device: torch.device) -> torch.Tensor:
    """The AND of ``(name, ok)`` certificates as a 0-d bool tensor on ``device``
    (True when there are none), taken on the device without a host read."""
    if not certificates:
        return torch.ones((), dtype=torch.bool, device=device)
    return torch.stack([ok for _, ok in certificates]).all()


class ServedForward(torch.nn.Module):
    """The eval forward as an exported artifact runs it (``export.export_model``):
    ``(B, N, 3+C)`` float32 -> labels ``(B, N)`` int32 (the argmax) or logits,
    in chunks of ``chunk`` clouds (``chunked_logits``; 0 runs the batch whole),
    and with ``checked`` also the AND of the window certificates (``all_ok``)."""

    def __init__(self, model: torch.nn.Module, chunk: int, output: str, checked: bool):
        super().__init__()
        if output not in ("labels", "logits"):
            raise ValueError(f"unknown output {output!r}, expected labels/logits")
        self.model, self.chunk, self.output, self.checked = model, chunk, output, checked

    def forward(self, points: torch.Tensor):
        certificates: Optional[List] = [] if self.checked else None
        logits = chunked_logits(self.model, points, self.chunk, certificates)
        out = logits.argmax(dim=-1).to(torch.int32) if self.output == "labels" else logits
        return (out, all_ok(certificates, points.device)) if self.checked else out


class Predictor:
    """Eval-mode ``PointNet2SemSeg`` (``arch="ssg"``) or ``PointNet2SemSegMSG``
    (``arch="msg"``; the state_dict must be of the same arch) with batch chunking.

    ``impl`` is passed to every point-set operator: None runs the CUDA
    kernels on a CUDA device, "torch" the plain versions (for comparisons).
    ``bq_window``/``fp_window`` are the model's calibrated windows.
    ``dtype`` ("float32" or "bfloat16") and ``bf16_min_width`` are the
    precision mode (see the module docstring). ``pre_project=False`` builds
    the SSG model in the plain SA layout, whose state_dict it must be given.
    """

    def __init__(
        self,
        cfg: Config,
        state_dict: Mapping[str, torch.Tensor],
        num_classes: int = 9,
        infer_chunk: int = 8,
        device: Optional[str | torch.device] = None,
        impl: Optional[str] = None,
        bq_window: Window = None,
        fp_window: Window = None,
        dtype: str = "float32",
        bf16_min_width: Optional[int] = None,
        arch: str = "ssg",
        pre_project: bool = True,
    ):
        model_cls = model_class(arch)
        precision = compute_dtype(dtype, "dtype")
        check_min_width(bf16_min_width, "dtype is not bfloat16", precision)
        full_float32()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.infer_chunk = infer_chunk
        model = model_cls(
            cfg, num_classes, bool(cfg.use_color), ops_impl=impl,
            bq_window=bq_window, fp_window=fp_window,
            compute_dtype=precision, compute_dtype_min_width=bf16_min_width, pre_project=pre_project,
        )
        model.load_state_dict(state_dict if precision is None else fold_batch_norm(state_dict))
        self.model = model.to(self.device).eval()

    def infer_logits(
        self, points: np.ndarray | torch.Tensor, certificates: Optional[List] = None
    ) -> torch.Tensor:
        """(B, N, 3+C) float32 -> (B, N, num_classes) logits on the Predictor's device."""
        x = torch.as_tensor(points, dtype=torch.float32).to(self.device)
        return chunked_logits(self.model, x, self.infer_chunk, certificates)

    def predict_step(self, points: np.ndarray | torch.Tensor) -> torch.Tensor:
        """(B, N, 3+C) float32 -> (B, N) int32 labels."""
        return self.infer_logits(points).argmax(dim=-1).to(torch.int32)

    def predict_step_checked(self, points: np.ndarray | torch.Tensor) -> tuple[torch.Tensor, bool]:
        """``predict_step`` and whether every window certificate of every chunk
        held (True without windows). False means a window left out candidates
        on this request and the labels may differ from the exact path's: the
        caller should recalibrate. One host read a request."""
        certificates: List = []
        labels = self.infer_logits(points, certificates).argmax(dim=-1).to(torch.int32)
        return labels, bool(all_ok(certificates, self.device))
