"""The train step, the eval step, the schedules and checkpoints.

Counterpart of ``pointnet2_tpu/train/trainer.py``:

- one step is the train-mode forward, the weighted cross entropy
  (``models.weighted_ce_loss``), ``backward()``, and one Adam or momentum-SGD
  update, with the BatchNorm moving statistics advanced by the forward and a
  confusion matrix counted on the device (``:316-368``);
- the staircase learning-rate and BatchNorm-momentum schedules (``:35-63``)
  are computed on the host from the integer step, in float32 as the JAX
  functions compute them;
- ``accum_steps = G > 1`` splits the batch into G strided microbatches
  (``batch[j::G]``), sums the gradients of the unnormalised loss over them and
  divides once by the whole batch's count of non-zero weights, then updates
  once. BatchNorm takes each microbatch's own statistics and its moving
  statistics advance G times (ghost BN; ``bn_accum_rescale`` uses
  ``momentum**(1/G)`` so that they advance as in one step). With
  ``hoist_geometry`` FPS, ball query and 3-NN run once on the whole batch
  (``:370-480``);
- ``eval_step`` is the chunked eval forward of ``infer`` plus loss and counts
  (``:528-548``).

The step leaves every metric on the device and reads nothing back: the
caller decides when to synchronise.
"""

from __future__ import annotations

import pathlib
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from pointnet2_tpu_torch import convert
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.infer import chunked_logits, full_float32, resolve_device
from pointnet2_tpu_torch.models.pointnet2_seg import (
    PointNet2SemSeg,
    precompute_geometry,
    weighted_ce_loss,
    weighted_ce_sum,
)
from pointnet2_tpu_torch.utils.metrics import confusion_matrix

# Options of the JAX Trainer that the port does not have yet: the value that
# means "off", and the ROADMAP item that will bring each.
_NOT_PORTED = {
    "arch": ("ssg", "queue 1 item 9 (MSG)"),
    "bq_window": (None, "queue 1 item 7 (calibrated windows)"),
    "fp_window": (None, "queue 1 item 7 (calibrated windows)"),
    "infer_dtype": ("float32", "queue 1 item 8 (precision modes)"),
    "train_dtype": ("float32", "queue 1 item 8 (precision modes)"),
    "bf16_min_width": (None, "queue 1 item 8 (precision modes)"),
}


def _staircase(cfg: Config, step: int) -> np.float32:
    """floor(step * batch_size / decay_step), in float32."""
    return np.floor(np.float32(step) * np.float32(cfg.batch_size) / np.float32(cfg.decay_step))


def learning_rate_schedule(cfg: Config) -> Callable[[int], float]:
    """Staircase exponential decay of the learning rate, with a floor of 1e-5."""

    def schedule(step: int) -> float:
        lr = np.float32(cfg.learning_rate) * np.power(
            np.float32(cfg.learning_rate_decay_rate), _staircase(cfg, step)
        )
        return float(np.maximum(lr, np.float32(1e-5)))

    return schedule


def bn_momentum_schedule(cfg: Config) -> Callable[[int], float]:
    """The decay handed to BatchNorm: ``min(clip, 1 - init * rate**e)``."""

    def schedule(step: int) -> float:
        bn_momentum = np.float32(cfg.bn_init_decay) * np.power(
            np.float32(cfg.bn_decay_decay_rate), _staircase(cfg, step)
        )
        return float(np.minimum(np.float32(cfg.bn_decay_clip), np.float32(1.0) - bn_momentum))

    return schedule


class Trainer:
    """Owns the model, the optimizer and the step counter.

    ``device=None`` means CUDA and raises without it; ``"cpu"`` runs the plain
    versions of the operators. ``ops_impl`` goes to every point-set operator
    (None: the kernels on a CUDA device; "torch": the plain versions).
    ``dropout_rate`` is the head's; 0.0 makes a step deterministic for
    comparisons.
    """

    def __init__(
        self,
        cfg: Config,
        num_classes: int = 9,
        ops_impl: Optional[str] = None,
        accum_steps: int = 1,
        hoist_geometry: bool = True,
        bn_accum_rescale: bool = False,
        device: Optional[str | torch.device] = None,
        infer_chunk: int = 8,
        dropout_rate: float = 0.5,
        **not_ported,
    ):
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"Trainer got an unexpected argument {name!r}")
            off, item = _NOT_PORTED[name]
            if value != off:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported yet: ROADMAP.md {item}"
                )
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if accum_steps > 1 and cfg.batch_size % accum_steps:
            raise ValueError(
                f"accum_steps={accum_steps} must divide cfg.batch_size={cfg.batch_size}"
            )
        if cfg.optimizer not in ("adam", "momentum"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        full_float32()
        self.cfg = cfg
        self.num_classes = num_classes
        self.ops_impl = ops_impl
        self.accum_steps = accum_steps
        self.hoist_geometry = hoist_geometry
        self.bn_accum_rescale = bn_accum_rescale
        self.device = resolve_device(device)
        self.infer_chunk = infer_chunk
        self.lr_schedule = learning_rate_schedule(cfg)
        self.bn_schedule = bn_momentum_schedule(cfg)
        self.model = PointNet2SemSeg(
            cfg, num_classes, bool(cfg.use_color), ops_impl=ops_impl, dropout_rate=dropout_rate
        ).to(self.device)
        self.optimizer = self._new_optimizer()
        self.step = 0

    # -- state ------------------------------------------------------------

    def _new_optimizer(self) -> torch.optim.Optimizer:
        """Adam (b1 0.9, b2 0.999, eps 1e-8 outside the root, bias-corrected) or
        momentum SGD (``t = g + mu*t``, no Nesterov), as optax's; the learning
        rate is set from the schedule before each update."""
        lr = self.lr_schedule(0)
        if self.cfg.optimizer == "adam":
            return torch.optim.Adam(self.model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
        return torch.optim.SGD(self.model.parameters(), lr=lr, momentum=self.cfg.momentum)

    def init_state(self, seed: int = 0) -> None:
        """Seeded weights (``convert.init_variables``), a fresh optimizer, step 0."""
        self.load_variables(convert.init_variables(self.cfg, self.num_classes, seed))

    def load_variables(self, variables: Mapping) -> None:
        """Weights and moving statistics from a flax variable tree; a fresh optimizer, step 0."""
        self.model.load_state_dict(convert.from_flax_variables(variables))
        self.optimizer = self._new_optimizer()
        self.step = 0

    # -- steps ------------------------------------------------------------

    def _to_device(self, batch: Mapping) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        dtype = self.model.fc2.weight.dtype  # float32, unless the caller made the model double
        points = torch.as_tensor(batch["points"]).to(self.device, dtype)
        labels = torch.as_tensor(batch["labels"]).to(self.device).long()
        weights = torch.as_tensor(batch["weights"]).to(self.device, dtype)
        return points, labels, weights

    def train_step(self, batch: Mapping, generator: Optional[torch.Generator] = None) -> dict:
        """One optimizer step on ``batch``: points (B, N, D), labels (B, N), weights (B, N).

        ``generator`` draws the dropout masks (default: the model's own).
        Returns ``loss``, ``accuracy`` and ``confusion`` as tensors on the
        device, and the step's ``learning_rate`` and ``bn_decay`` as floats.
        """
        points, labels, weights = self._to_device(batch)
        lr = self.lr_schedule(self.step)
        bn_momentum = self.bn_schedule(self.step)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        if self.accum_steps > 1:
            metrics, bn_momentum = self._accumulate(points, labels, weights, bn_momentum, generator)
        else:
            logits = self.model(points, bn_momentum=bn_momentum, generator=generator)
            loss = weighted_ce_loss(logits, labels, weights)
            loss.backward()
            preds = logits.detach().argmax(dim=-1)
            metrics = {
                "loss": loss.detach(),
                "accuracy": (preds == labels).float().mean(),
                "confusion": confusion_matrix(labels, preds, self.num_classes),
            }
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        metrics["learning_rate"] = lr
        metrics["bn_decay"] = bn_momentum
        return metrics

    def _accumulate(self, points, labels, weights, bn_momentum, generator):
        """Forward and backward over the strided microbatches; leaves the
        normalised gradient sum in ``.grad``. Returns the metrics and the
        momentum each microbatch's BatchNorm was given."""
        g = self.accum_steps
        b, n = labels.shape
        if b % g:
            raise ValueError(
                f"accum_steps={g} must divide the batch size (got a batch of {b})"
            )
        if self.bn_accum_rescale:
            bn_momentum = float(np.power(np.float32(bn_momentum), np.float32(1.0 / g)))
        geometry = None
        if self.hoist_geometry:
            geometry = precompute_geometry(points, self.cfg, self.ops_impl)
        ce_sum = torch.zeros((), device=self.device)
        nonzero_sum = torch.zeros((), device=self.device)
        correct = torch.zeros((), device=self.device)
        confusion = torch.zeros(
            (self.num_classes, self.num_classes), dtype=torch.int64, device=self.device
        )
        for j in range(g):
            micro_geometry = None
            if geometry is not None:
                micro_geometry = {
                    part: tuple({k: v[j::g].contiguous() for k, v in level.items()} for level in levels)
                    for part, levels in geometry.items()
                }
            logits = self.model(
                points[j::g], bn_momentum=bn_momentum, geometry=micro_geometry, generator=generator
            )
            ce, nonzero = weighted_ce_sum(logits, labels[j::g], weights[j::g])
            ce.backward()  # adds into .grad: the sum over microbatches
            preds = logits.detach().argmax(dim=-1)
            ce_sum += ce.detach()
            nonzero_sum += nonzero
            correct += (preds == labels[j::g]).sum()
            confusion += confusion_matrix(labels[j::g], preds, self.num_classes)
        denom = nonzero_sum.clamp_min(1.0)
        for p in self.model.parameters():
            if p.grad is not None:
                p.grad.div_(denom)
        metrics = {
            "loss": ce_sum / denom,
            "accuracy": correct / float(b * n),
            "confusion": confusion,
        }
        return metrics, bn_momentum

    def eval_step(self, batch: Mapping) -> dict:
        """Eval-mode forward in chunks of ``infer_chunk`` clouds: loss, accuracy, confusion, preds."""
        points, labels, weights = self._to_device(batch)
        logits = chunked_logits(self.model.eval(), points, self.infer_chunk)
        preds = logits.argmax(dim=-1)
        return {
            "loss": weighted_ce_loss(logits, labels, weights),
            "accuracy": (preds == labels).float().mean(),
            "confusion": confusion_matrix(labels, preds, self.num_classes),
            "preds": preds,
        }


# -- checkpointing ---------------------------------------------------------


def save_checkpoint(path: str | pathlib.Path, trainer: Trainer) -> None:
    """Step, model ``state_dict`` and optimizer ``state_dict``, with ``torch.save``."""
    torch.save(
        {
            "step": trainer.step,
            "model": trainer.model.state_dict(),
            "optimizer": trainer.optimizer.state_dict(),
        },
        path,
    )


def restore_checkpoint(path: str | pathlib.Path, trainer: Trainer) -> None:
    """Load what ``save_checkpoint`` wrote into ``trainer``, onto its device."""
    ckpt = torch.load(path, map_location=trainer.device, weights_only=True)
    trainer.model.load_state_dict(ckpt["model"])
    trainer.optimizer.load_state_dict(ckpt["optimizer"])
    trainer.step = int(ckpt["step"])
