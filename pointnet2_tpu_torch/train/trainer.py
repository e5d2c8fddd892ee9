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
- with ``dropout_seed`` each step draws its dropout masks from a generator
  seeded from (``dropout_seed``, step) alone, the counterpart of
  ``fold_in(dropout_rng, state.step)`` (``:319``): a run resumed at step s
  draws the masks an unbroken run draws there;
- ``arch`` is the model, "ssg" (``PointNet2SemSeg``) or "msg"
  (``PointNet2SemSegMSG``, ``:94-99``, ``:207-230``); the hoisted geometry
  carries one index set a grouping scale at MSG's dense levels;
- ``eval_step`` is the chunked eval forward of ``infer`` plus loss and counts
  (``:528-548``);
- under a process group (``parallel.multihost``: one process a device) a
  step takes this rank's block of the global batch, with the global batch's
  BatchNorm statistics and dropout masks (``nn.layers``, the model's head),
  the loss over the global count of non-zero weights, the gradients summed
  over the ranks before the update and the global metrics: every rank takes
  the one-process step on the global batch, as the JAX step does on a batch
  sharded over processes (root ``train.py:353-364``); the eval step's
  metrics are global too;
- with calibrated windows (``bq_window``, ``fp_window``) every step and eval
  step also reports ``window_ok``, the AND of the step's certificates;
  ``predict_step_checked`` and ``check_bq_window`` run the eval forward and
  return the certificates' verdict (``:555-585``);
- ``train_dtype`` and ``infer_dtype`` ("float32" or "bfloat16") and
  ``bf16_min_width`` are the precision modes (``:120-144``, ``:231-260``):
  ``train_model`` and ``infer_model`` are ``model`` in those modes, all three
  sharing one set of float32 master weights and moving statistics
  (``PointNet2SemSeg.with_precision``), so the optimizer, the gradients and
  the checkpoints stay float32. A bfloat16 eval forward runs on the weights
  with their BatchNorms folded in (``nn.fold``, ``:487-495``), through
  ``torch.func.functional_call``; a train step never folds.

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
from pointnet2_tpu_torch.infer import (
    all_ok,
    check_min_width,
    chunked_logits,
    compute_dtype,
    full_float32,
    resolve_device,
)
from pointnet2_tpu_torch.models.pointnet2_seg import (
    Window,
    model_class,
    precompute_geometry,
    weighted_ce_sum,
)
from pointnet2_tpu_torch.nn.fold import fold_batch_norm
from pointnet2_tpu_torch.parallel import multihost
from pointnet2_tpu_torch.utils.metrics import confusion_matrix


def norm_window(name: str, window) -> Window:
    """An int, None, or a sequence of int/None (made a tuple); anything else,
    the command-line word ``auto`` above all, raises: resolve it with
    ``ops.calibrate.calibrate_model_windows`` first."""
    if window is None or isinstance(window, int):
        return window
    if isinstance(window, (list, tuple)) and all(w is None or isinstance(w, int) for w in window):
        return tuple(window)
    raise TypeError(
        f"{name} must be an int, None, or a sequence of int/None (got {window!r}); "
        "'auto' is resolved with pointnet2_tpu_torch.ops.calibrate.calibrate_model_windows first"
    )


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


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step)`` alone."""
    mixed = np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed >> np.uint64(1)))


class Trainer:
    """Owns the model, the optimizer and the step counter.

    ``device=None`` means CUDA and raises without it; ``"cpu"`` runs the plain
    versions of the operators. ``ops_impl`` goes to every point-set operator
    (None: the kernels on a CUDA device; "torch": the plain versions).
    ``dropout_rate`` is the head's; 0.0 makes a step deterministic for
    comparisons. ``dropout_seed``: each step given no generator draws its
    masks from ``step_generator(dropout_seed, step)``, so they depend only on
    the seed and the step, resumed or not (None: the model's own generator).
    ``bq_window``/``fp_window`` are the model's calibrated windows (an int or
    a per-level 4-sequence). ``train_dtype``, ``infer_dtype`` and
    ``bf16_min_width`` are the precision modes (see the module docstring).
    ``arch`` is the model: "ssg" or "msg"; another name raises ValueError.
    ``pre_project=False`` builds the SSG model in the plain SA layout (the
    reference's; ``init_state`` then gives the same seeded weights in it).
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
        dropout_seed: Optional[int] = None,
        bq_window: Window = None,
        fp_window: Window = None,
        infer_dtype: str = "float32",
        train_dtype: str = "float32",
        bf16_min_width: Optional[int] = None,
        arch: str = "ssg",
        pre_project: bool = True,
    ):
        model = model_class(arch)
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if accum_steps > 1 and cfg.batch_size % accum_steps:
            raise ValueError(
                f"accum_steps={accum_steps} must divide cfg.batch_size={cfg.batch_size}"
            )
        if cfg.optimizer not in ("adam", "momentum"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        infer_precision = compute_dtype(infer_dtype, "infer_dtype")
        train_precision = compute_dtype(train_dtype, "train_dtype")
        check_min_width(
            bf16_min_width, "neither infer_dtype nor train_dtype is bfloat16", infer_precision, train_precision
        )
        full_float32()
        self.cfg = cfg
        self.arch = arch
        self.pre_project = pre_project
        self.bq_window = norm_window("bq_window", bq_window)
        self.fp_window = norm_window("fp_window", fp_window)
        self.num_classes = num_classes
        self.ops_impl = ops_impl
        self.accum_steps = accum_steps
        self.hoist_geometry = hoist_geometry
        self.bn_accum_rescale = bn_accum_rescale
        self.device = resolve_device(device)
        self.infer_chunk = infer_chunk
        self.dropout_seed = dropout_seed
        self.lr_schedule = learning_rate_schedule(cfg)
        self.bn_schedule = bn_momentum_schedule(cfg)
        self.model = model(
            cfg, num_classes, bool(cfg.use_color), ops_impl=ops_impl, dropout_rate=dropout_rate,
            bq_window=self.bq_window, fp_window=self.fp_window, pre_project=pre_project,
        ).to(self.device)
        self.infer_dtype, self.train_dtype, self.bf16_min_width = infer_dtype, train_dtype, bf16_min_width
        self.infer_model, self.train_model = (
            self.model if dt is None else self.model.with_precision(dt, bf16_min_width)
            for dt in (infer_precision, train_precision)
        )
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

    def init_state(self, seed: int = 0, bn_stats: str = "flax") -> None:
        """Seeded weights (``convert.init_variables``), a fresh optimizer, step 0.

        The moving statistics are flax's (mean 0, variance 1), as the JAX
        ``init_state`` starts them; ``bn_stats="random"`` asks for ones that are
        not the identity, for checks in which eval BatchNorm must do real work.
        """
        self.load_variables(
            convert.init_variables(
                self.cfg, self.num_classes, seed, bn_stats=bn_stats, arch=self.arch, pre_project=self.pre_project
            )
        )

    def load_variables(self, variables: Mapping) -> None:
        """Weights and moving statistics from a flax variable tree; a fresh optimizer, step 0."""
        self.model.load_state_dict(convert.from_flax_variables(variables))
        self.optimizer = self._new_optimizer()
        self.step = 0

    @property
    def windows_on(self) -> bool:
        return self.bq_window is not None or self.fp_window is not None

    # -- steps ------------------------------------------------------------

    def _to_device(self, batch: Mapping) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The batch's points, labels (int64) and weights as tensors on the
        Trainer's device. A tensor already there in its dtype comes back as
        the same object (``Tensor.to`` returns ``self`` when nothing changes):
        no copy and no synchronisation, so a batch that
        ``data.pipeline.device_prefetch`` copied ahead is used where it lies.
        Labels of another integer type are cast on the device."""
        dtype = self.model.fc2.weight.dtype  # float32, unless the caller made the model double
        return tuple(
            torch.as_tensor(batch[key]).to(self.device, want)
            for key, want in (("points", dtype), ("labels", torch.int64), ("weights", dtype))
        )

    def train_step(self, batch: Mapping, generator: Optional[torch.Generator] = None) -> dict:
        """One optimizer step on ``batch``: points (B, N, D), labels (B, N), weights (B, N).

        ``generator`` draws the dropout masks (default: ``step_generator`` of
        ``dropout_seed`` and this step, else the model's own).
        Returns ``loss``, ``accuracy`` and ``confusion`` as tensors on the
        device, and the step's ``learning_rate`` and ``bn_decay`` as floats;
        with windows also ``window_ok``, a 0-d bool tensor on the device.

        Under a process group (``parallel.multihost``) ``batch`` is this
        rank's block of the global batch, every rank's the same size: the loss
        is divided by the global count of non-zero weights, the gradients are
        summed over the ranks before the update, and the metrics are the
        global batch's, so every rank takes the one-process step on the
        global batch.
        """
        points, labels, weights = self._to_device(batch)
        if generator is None and self.dropout_seed is not None:
            generator = step_generator(self.dropout_seed, self.step, self.device)
        lr = self.lr_schedule(self.step)
        bn_momentum = self.bn_schedule(self.step)
        self.train_model.train()
        self.optimizer.zero_grad(set_to_none=True)
        certificates: list = []
        if self.accum_steps > 1:
            sums, bn_momentum = self._accumulate(
                points, labels, weights, bn_momentum, generator, certificates
            )
            sums["ok"] = all_ok(certificates, self.device)
            sums = _reduce_sums(sums)
            self._finish_gradients(sums["nonzero"].clamp_min(1.0))
        else:
            logits = self.train_model(
                points, bn_momentum=bn_momentum, generator=generator, certificates=certificates
            )
            ce, nonzero = weighted_ce_sum(logits, labels, weights)
            (ce / multihost.all_reduce_(nonzero.clone()).clamp_min(1.0)).backward()
            sums = _reduce_sums(_step_sums(logits, labels, ce, nonzero, self.num_classes, certificates))
            self._finish_gradients()
        metrics = _metrics_of(sums)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        metrics["learning_rate"] = lr
        metrics["bn_decay"] = bn_momentum
        if self.windows_on:
            metrics["window_ok"] = sums["ok"]
        return metrics

    def _finish_gradients(self, denom: Optional[torch.Tensor] = None) -> None:
        """Sum ``.grad`` over the ranks of a group (one collective of every
        gradient, flattened) and divide it by ``denom``, where given."""
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        if multihost.active():
            flat = multihost.all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))
        if denom is not None:
            for g in grads:
                g.div_(denom)

    def _accumulate(self, points, labels, weights, bn_momentum, generator, certificates):
        """Forward and backward over the strided microbatches; leaves the sum
        of the microbatches' unnormalised gradients in ``.grad``. Returns this
        batch's sums (``_step_sums``) and the momentum each microbatch's
        BatchNorm was given; the window certificates go to ``certificates``
        (the hoisted geometry's as one)."""
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
            geometry, geometry_ok = precompute_geometry(
                points, self.cfg, self.ops_impl, self.bq_window, self.fp_window, arch=self.arch
            )
            certificates.append(("geometry_ok", geometry_ok))
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
                    part: tuple({k: _micro(v, j, g) for k, v in level.items()} for level in levels)
                    for part, levels in geometry.items()
                }
            logits = self.train_model(
                points[j::g], bn_momentum=bn_momentum, geometry=micro_geometry, generator=generator,
                certificates=certificates,
            )
            ce, nonzero = weighted_ce_sum(logits, labels[j::g], weights[j::g])
            ce.backward()  # adds into .grad: the sum over microbatches
            preds = logits.detach().argmax(dim=-1)
            ce_sum += ce.detach()
            nonzero_sum += nonzero
            correct += (preds == labels[j::g]).sum()
            confusion += confusion_matrix(labels[j::g], preds, self.num_classes)
        sums = {"ce": ce_sum, "nonzero": nonzero_sum, "correct": correct, "points": float(b * n),
                "confusion": confusion}
        return sums, bn_momentum

    def infer_forward(self):
        """The eval forward as ``chunked_logits`` calls it: ``infer_model`` in
        eval mode, on the current weights with their BatchNorms folded in
        when it computes in bfloat16."""
        model = self.infer_model.eval()
        if self.infer_model is self.model:
            return model
        folded = fold_batch_norm(self.model.state_dict())
        return lambda x, **kwargs: torch.func.functional_call(model, folded, (x,), kwargs)

    def eval_step(self, batch: Mapping) -> dict:
        """Eval-mode forward in chunks of ``infer_chunk`` clouds: loss, accuracy,
        confusion, preds, and with windows ``window_ok``. Under a process group
        the loss, accuracy, confusion and ``window_ok`` are the global batch's
        (each rank's ``preds`` its own rows)."""
        points, labels, weights = self._to_device(batch)
        certificates: list = []
        logits = chunked_logits(self.infer_forward(), points, self.infer_chunk, certificates)
        preds = logits.argmax(dim=-1)
        ce, nonzero = weighted_ce_sum(logits, labels, weights)
        sums = _reduce_sums(_step_sums(logits, labels, ce, nonzero, self.num_classes, certificates))
        metrics = _metrics_of(sums)
        metrics["preds"] = preds
        if self.windows_on:
            metrics["window_ok"] = sums["ok"]
        return metrics

    def predict_step_checked(self, points) -> tuple[torch.Tensor, torch.Tensor]:
        """Eval-mode labels (B, N) int32 and the AND of every chunk's window
        certificates, a 0-d bool tensor on the device: False means a window
        left out candidates on this batch and the caller should recalibrate."""
        x = torch.as_tensor(points).to(self.device, self.model.fc2.weight.dtype)
        certificates: list = []
        logits = chunked_logits(self.infer_forward(), x, self.infer_chunk, certificates)
        return logits.argmax(dim=-1).to(torch.int32), all_ok(certificates, self.device)

    def check_bq_window(self, points) -> bool:
        """Whether every window certificate (ball query and 3-NN) holds on this
        batch, from one eval forward of the whole batch; True without windows."""
        if not self.windows_on:
            return True
        x = torch.as_tensor(points).to(self.device, self.model.fc2.weight.dtype)
        certificates: list = []
        chunked_logits(self.infer_forward(), x, 0, certificates)
        return bool(all_ok(certificates, self.device))


def _step_sums(logits, labels, ce, nonzero, num_classes: int, certificates: list) -> dict:
    """A batch's sums from its logits: the weighted cross entropy and the
    count of non-zero weights (``weighted_ce_sum``), correct points, points,
    the confusion matrix and the AND of the window certificates."""
    preds = logits.detach().argmax(dim=-1)
    return {"ce": ce.detach(), "nonzero": nonzero, "correct": (preds == labels).sum().float(),
            "points": float(labels.numel()), "confusion": confusion_matrix(labels, preds, num_classes),
            "ok": all_ok(certificates, logits.device)}


def _metrics_of(sums: dict) -> dict:
    """The loss (the weighted cross entropy over the count of non-zero
    weights), accuracy and confusion of a batch's sums."""
    return {"loss": sums["ce"] / sums["nonzero"].clamp_min(1.0), "accuracy": sums["correct"] / sums["points"],
            "confusion": sums["confusion"]}


def _reduce_sums(sums: dict) -> dict:
    """``_step_sums`` summed over the ranks of a group in one float64
    collective (the counts are exact there; ``ok`` becomes the AND over the
    ranks); the float sums come back in the cross entropy's type, the
    confusion int64. Without a group, ``sums`` itself."""
    if not multihost.active():
        return sums
    confusion = sums["confusion"]
    scalars = [sums["ce"], sums["nonzero"], sums["correct"]]
    flat = torch.cat([
        torch.stack([t.double() for t in scalars]),
        torch.tensor([sums["points"]], dtype=torch.float64, device=confusion.device),
        (~sums["ok"]).double().reshape(1),
        confusion.double().reshape(-1),
    ])
    flat = multihost.all_reduce_(flat)
    ce, nonzero, correct, points, not_ok = flat[:5].to(sums["ce"].dtype)
    return {"ce": ce, "nonzero": nonzero, "correct": correct, "points": points,
            "confusion": flat[5:].to(torch.int64).reshape(confusion.shape), "ok": not_ok == 0}


def _micro(leaf, j: int, g: int):
    """Microbatch ``j`` of ``g`` of a geometry leaf: a tensor, or a tuple of
    them (an MSG level's index sets, one a scale)."""
    if isinstance(leaf, tuple):
        return tuple(_micro(t, j, g) for t in leaf)
    return leaf[j::g].contiguous()


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


def _load(path: str | pathlib.Path, map_location) -> dict:
    if pathlib.Path(path).is_dir():
        raise ValueError(
            f"{path} is a directory: the port's checkpoints are single torch.save files (what "
            "save_checkpoint writes); it cannot read the JAX package's orbax checkpoint directories"
        )
    return torch.load(path, map_location=map_location, weights_only=True)


def restore_checkpoint(path: str | pathlib.Path, trainer: Trainer) -> None:
    """Load what ``save_checkpoint`` wrote into ``trainer``, onto its device."""
    ckpt = _load(path, trainer.device)
    trainer.model.load_state_dict(ckpt["model"])
    trainer.optimizer.load_state_dict(ckpt["optimizer"])
    trainer.step = int(ckpt["step"])


def load_model_state(path: str | pathlib.Path) -> dict[str, torch.Tensor]:
    """The model ``state_dict`` of a checkpoint ``save_checkpoint`` wrote, on
    the CPU: what a ``Predictor`` needs, without the optimizer's state."""
    return _load(path, "cpu")["model"]
