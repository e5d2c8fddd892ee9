"""Train PointNet++ on Semantic3D with the port, on the card.

    python -m pointnet2_tpu_torch.cli.train --config_file semantic.json [--data_path DIR] [--seed 0]

Counterpart of the root ``train.py``, with its flags by the same names and
its epoch loop:

- sampler threads (``data.pipeline.BatchProducer``) draw batches of boxes
  from the split's scenes, and ``device_prefetch`` copies each to the card
  two batches ahead of its step;
- the losses, the confusion matrix and the window certificates stay on the
  device and are read once an epoch; a failed certificate aborts the run;
- per-class IoU a epoch, eval on the validation split every 5 epochs,
  ``best_model_epoch_NNN.pt`` when the eval accuracy improves, ``model.pt``
  every 10 epochs, and ``model_autosave.pt`` however the loop ends;
- ``--resume`` continues from one of those files, step and optimizer
  included; ``--seed`` makes the batch stream reproducible and so runs one
  sampler thread (``data/rng.py``);
- ``--arch msg`` trains the multi-scale-grouping model
  (``models.PointNet2SemSegMSG``); its checkpoints load only into that arch;
- ``--train_dtype bfloat16`` (with ``--bf16_min_width``, selectively) takes
  the train steps in the mixed-precision mode; the eval epochs run float32
  and the checkpoints hold the float32 master weights either way;
- ``--dist_coordinator HOST:PORT --dist_num_processes P --dist_process_id I``
  runs process I of P (``parallel.multihost``: one process a device,
  ``cuda:(I mod cards)``; NCCL where each process has a card, gloo where
  they share one or run on the CPU). Each process steps on its rows of
  every global batch of ``batch_size`` (which must divide by P), and every
  process takes the same step (``Trainer``: global BatchNorm statistics,
  dropout masks, loss denominator, gradient sums and metrics).
  ``--dist_sampling sharded`` (the default): each process draws its
  ``batch_size / P`` clouds with seed ``seed + 9973 * I``;
  ``replicated``: every process draws the global batch from ``--seed``
  (required) with one sampler thread and keeps its rows, so the batches are
  the one-process run's. Process 0 alone writes ``log_train.txt``,
  ``scalars.jsonl`` and checkpoints (the others log to stdout with a
  ``[proc I]`` prefix); ``--resume`` restores the same file in every
  process, and the processes' states are held equal bit for bit before the
  first step; ``auto`` windows are the largest any process calibrated.

Checkpoints are the port's own ``torch.save`` files (``train.save_checkpoint``):
the JAX package's orbax directories cannot be read. Besides the JAX loop's
log lines, each epoch logs the host's median ms a step and the median ms
the loop waited on the prefetch; ``main`` returns them, with each step's
loss.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time
from datetime import datetime
from typing import Optional, Sequence

import numpy as np
import torch

from pointnet2_tpu_torch.cli import add_device_flag, add_dist_flags, cli_device
from pointnet2_tpu_torch.config import Config
from pointnet2_tpu_torch.data.pipeline import BatchProducer, device_prefetch
from pointnet2_tpu_torch.data.semantic3d import SemanticDataset
from pointnet2_tpu_torch.ops.calibrate import calibrate_model_windows, parse_window_arg
from pointnet2_tpu_torch.parallel import multihost
from pointnet2_tpu_torch.train.trainer import Trainer, restore_checkpoint, save_checkpoint
from pointnet2_tpu_torch.utils.logging import NullLogger, RunLogger, update_progress
from pointnet2_tpu_torch.utils.metrics import ConfusionMatrix


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--train_set", default="train", help="train, train_full")
    parser.add_argument("--config_file", default="semantic.json", help="config path")
    parser.add_argument("--resume", default="", help="checkpoint file to resume from")
    parser.add_argument("--max_epoch", type=int, default=None)
    parser.add_argument("--data_path", default=None)
    parser.add_argument(
        "--seed", type=int, default=None, help="seeds the weights, the sampler and dropout; one sampler thread"
    )
    parser.add_argument(
        "--accum_steps", type=int, default=1,
        help="split each batch into this many microbatches and accumulate gradients "
        "(one optimizer update per batch; ghost-BN moments)",
    )
    parser.add_argument(
        "--hoist_geometry", type=int, default=1, choices=(0, 1),
        help="with --accum_steps > 1: FPS, ball query and 3-NN once at full batch width (1) "
        "or per microbatch (0)",
    )
    parser.add_argument(
        "--bq_window", type=parse_window_arg, default=None,
        help="calibrated ball-query x-window: an int, a per-SA-level list like '3072,768,-,-', or "
        "'auto' to calibrate from sampled training batches at startup; the certificates are AND-ed "
        "over every train batch (checked at each epoch's end) and every eval batch, and the run "
        "aborts if the window was ever too small",
    )
    parser.add_argument(
        "--fp_window", type=parse_window_arg, default=None,
        help="calibrated 3-NN x-window for the FP levels (int or 'auto'); checked like --bq_window",
    )
    parser.add_argument(
        "--train_dtype", default="float32", choices=["float32", "bfloat16"],
        help="training compute dtype: bfloat16 = mixed precision (bfloat16 MLP matmuls and activations; "
        "float32 master weights, BatchNorm statistics, geometry, logits and loss); checkpoints stay float32",
    )
    parser.add_argument(
        "--bf16_min_width", type=int, default=None,
        help="selective mixed precision: with --train_dtype bfloat16, stages whose narrowest MLP width "
        "is below this stay float32 (128 keeps SA1 and SA2 in float32). Default: uniform bfloat16",
    )
    parser.add_argument(
        "--arch", default="ssg", choices=["ssg", "msg"],
        help="model architecture: 'ssg' (the reference flagship) or 'msg' (multi-scale grouping at SA1 and SA2)",
    )
    add_dist_flags(parser)
    parser.add_argument(
        "--dist_sampling", choices=["sharded", "replicated"], default="sharded",
        help="multi-process batches: 'sharded' = each process draws its batch_size/processes clouds with seed "
        "seed + 9973 * process id; 'replicated' = every process draws the global batch from --seed (required) "
        "with one sampler thread and keeps its rows: the one-process run's batches",
    )
    parser.add_argument(
        "--num_workers", type=int, default=None,
        help="sampler threads (default: the CPU count; 1 with --seed)",
    )
    add_device_flag(parser)
    return parser


def _window_error(flags, what: str) -> ValueError:
    return ValueError(
        f"--bq_window={flags.bq_window} / --fp_window={flags.fp_window} exactness certificate "
        f"failed on {what}; the window is too small for this data — recalibrate with "
        "--bq_window auto / --fp_window auto"
    )


def widest_windows(bq: Optional[int], fp: Optional[int]) -> tuple[Optional[int], Optional[int]]:
    """The largest of every process's calibrated windows (None: a process's
    windowing would not engage): every process must run the same model, and a
    larger window certifies whatever a smaller one does. As given in one process."""
    gathered = multihost.allgather_host(np.array([-1 if w is None else w for w in (bq, fp)], np.int64)).max(axis=0)
    return tuple(None if w < 0 else int(w) for w in gathered)


def _median(values: Sequence[float]) -> Optional[float]:
    return statistics.median(values) if values else None


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the training; returns the final step, the checkpoints written and
    each epoch's host timings (ms a step from one step's start to the next
    one's, the last ending at the epoch's read of the device; ms waited on
    the prefetch)."""
    parser = build_parser()
    flags = parser.parse_args(argv)
    device = cli_device(flags.device)
    if flags.dist_sampling == "replicated" and (flags.dist_num_processes or 1) > 1 and flags.seed is None:
        parser.error("--dist_sampling replicated requires --seed (every process must draw the same global batches)")
    if flags.seed is not None:
        # One sampler thread: a seeded stream is reproducible only in the order one thread draws it.
        flags.num_workers = 1

    cfg = Config.from_json(flags.config_file)
    if flags.max_epoch is not None:
        cfg = cfg.replace(max_epoch=flags.max_epoch)
    if flags.data_path is not None:
        cfg = cfg.replace(data_path=flags.data_path)
    nproc = flags.dist_num_processes or 1
    if cfg.batch_size % nproc:
        parser.error(
            f"batch_size {cfg.batch_size} must divide by the process count {nproc} "
            "(each process feeds batch_size/num_processes samples)"
        )
    if nproc > 1 and (cfg.batch_size // nproc) % flags.accum_steps:
        parser.error(f"--accum_steps {flags.accum_steps} must divide each process's batch of {cfg.batch_size // nproc}")

    device = multihost.maybe_initialize_distributed(
        flags.dist_coordinator, flags.dist_num_processes, flags.dist_process_id, device
    )
    try:
        pid = multihost.process_index()
        logger = RunLogger(cfg.logdir) if pid == 0 else NullLogger(pid)
        try:
            return _train(flags, cfg, device, logger)
        finally:
            logger.close()
    finally:
        if nproc > 1:
            multihost.shutdown()


def _train(flags: argparse.Namespace, cfg: Config, device: torch.device, logger) -> dict:
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    nproc, pid = multihost.process_count(), multihost.process_index()
    is_main = pid == 0
    logger.log(
        f"device: {device} ({card})"
        + (f"; {nproc} processes, backend {multihost.backend()}, sampling {flags.dist_sampling}" if nproc > 1 else "")
    )
    # "sharded": each process draws its own shard from a decorrelated stream;
    # "replicated": every process draws the global batches from one seed.
    ds_seed = flags.seed
    if nproc > 1 and flags.dist_sampling == "sharded" and flags.seed is not None:
        ds_seed = flags.seed + 9973 * pid

    def dataset(split: str) -> SemanticDataset:
        return SemanticDataset(
            num_points_per_sample=cfg.num_point, split=split, box_size_x=cfg.box_size_x,
            box_size_y=cfg.box_size_y, use_color=bool(cfg.use_color), path=cfg.data_path, seed=ds_seed,
        )

    train_ds, val_ds = dataset(flags.train_set), dataset("validation")

    if flags.bq_window == "auto" or flags.fp_window == "auto":
        auto_bq, auto_fp = calibrate_model_windows(
            sa_specs=[(s.npoint, s.radius) for s in cfg.sa_layers],
            num_point=cfg.num_point,
            sample_xyz=lambda: train_ds.sample_batch_in_all_files(cfg.batch_size)[0][..., :3],
            num_batches=8,
            device=device,
        )
        auto_bq, auto_fp = widest_windows(auto_bq, auto_fp)
        if flags.bq_window == "auto":
            flags.bq_window = auto_bq
        if flags.fp_window == "auto":
            flags.fp_window = auto_fp
        logger.log(
            f"auto window calibration: bq_window={flags.bq_window}, fp_window={flags.fp_window} "
            "(None = windowing would not engage; full exact kernels run)"
        )

    trainer = Trainer(
        cfg, num_classes=train_ds.num_classes, accum_steps=flags.accum_steps,
        hoist_geometry=bool(flags.hoist_geometry), device=device,
        bq_window=flags.bq_window, fp_window=flags.fp_window, dropout_seed=(flags.seed or 0) + 1,
        train_dtype=flags.train_dtype, bf16_min_width=flags.bf16_min_width, arch=flags.arch,
    )
    trainer.init_state(flags.seed or 0)
    if flags.resume:
        restore_checkpoint(os.path.abspath(flags.resume), trainer)
        logger.log(f"resumed from {flags.resume} at step {trainer.step}")
    multihost.assert_replicated(trainer.model)

    num_train_batches = train_ds.get_num_batches(cfg.batch_size)
    num_val_batches = val_ds.get_num_batches(cfg.batch_size)
    logger.log(f"train batches/epoch: {num_train_batches}, val batches: {num_val_batches}")
    if num_train_batches == 0:
        raise ValueError(
            f"train split '{flags.train_set}' has {train_ds.get_total_num_points()} points across "
            f"{len(train_ds.list_file_data)} scenes — that is 0 batches of batch_size={cfg.batch_size} "
            f"x num_point={cfg.num_point}; reduce batch_size/num_point or provide more data"
        )
    if num_val_batches == 0:
        logger.log("validation split yields 0 batches; skipping eval epochs")

    train_workers = flags.num_workers if flags.num_workers is not None else max(os.cpu_count() or 1, 2)
    logger.log(f"sampler threads: {train_workers}")
    # A process draws the global batch and keeps its rows ("replicated"), or
    # draws its shard alone ("sharded"); one process draws the batch.
    replicated = nproc > 1 and flags.dist_sampling == "replicated"
    sample_bs = cfg.batch_size // nproc if nproc > 1 and not replicated else cfg.batch_size
    if nproc > 1:
        logger.log(f"sampling {flags.dist_sampling}: seed {ds_seed}, {sample_bs} clouds a draw, "
                   f"{cfg.batch_size // nproc} rows a step")

    def named(batch):
        data, labels, weights = batch
        out = {"points": data, "labels": labels, "weights": weights}
        return multihost.local_rows(out) if replicated else out

    train_producer = BatchProducer(
        lambda: named(train_ds.sample_batch_in_all_files(sample_bs, True)),
        max_queue=16, num_workers=train_workers,
    )
    val_producer = BatchProducer(
        lambda: named(val_ds.sample_batch_in_all_files(sample_bs, False)),
        max_queue=8, num_workers=min(2, train_workers),
    )
    train_iter = device_prefetch(train_producer, device, depth=2)
    val_iter = device_prefetch(val_producer, device, depth=2)

    summary: dict = {"step": trainer.step, "checkpoints": [], "epochs": [], "processes": nproc,
                     "backend": multihost.backend(), "bq_window": flags.bq_window, "fp_window": flags.fp_window}

    def save(name: str) -> None:
        if not is_main:  # process 0 writes the run's checkpoints
            return
        path = os.path.abspath(os.path.join(cfg.logdir, name))
        save_checkpoint(path, trainer)
        summary["checkpoints"].append(path)
        logger.log(f"Model saved in file: {path}")

    # Every process has built its model and started its samplers before the first step's collectives.
    multihost.barrier()

    best_acc = 0.0
    try:
        for epoch in range(cfg.max_epoch):
            logger.log(f"**** EPOCH {epoch:03d} ****  {datetime.now()}")
            cm = ConfusionMatrix(train_ds.num_classes)
            # Every metric stays on the device; the epoch reads it back once.
            dev_losses, dev_cm, dev_ok = [], None, None
            step_ms, wait_ms = [], []
            started = None
            for i in range(num_train_batches):
                if is_main:
                    update_progress(i / max(num_train_batches, 1))
                t0 = time.perf_counter()
                if started is not None:
                    step_ms.append((t0 - started) * 1e3)
                started = t0
                batch = next(train_iter)
                wait_ms.append((time.perf_counter() - t0) * 1e3)
                metrics = trainer.train_step(batch)
                dev_losses.append(metrics["loss"])
                dev_cm = metrics["confusion"] if dev_cm is None else dev_cm + metrics["confusion"]
                if "window_ok" in metrics:
                    dev_ok = metrics["window_ok"] if dev_ok is None else dev_ok & metrics["window_ok"]
                last_metrics = metrics
            losses = torch.stack(dev_losses).cpu().numpy()  # the epoch's one wait for the device
            step_ms.append((time.perf_counter() - started) * 1e3)
            if is_main:
                update_progress(1.0)
                print()
            cm.increment_from_matrix(dev_cm)
            if dev_ok is not None and not bool(dev_ok):
                # Some batch's windowed neighbour query left out candidates and its
                # gradients were wrong: abort rather than train on bad groupings.
                raise _window_error(flags, f"a training batch during epoch {epoch}")
            logger.log(f"mean loss: {float(losses.mean()):f}")
            logger.log(f"Overall accuracy : {cm.get_accuracy():f}")
            logger.log(f"Average IoU : {cm.get_mean_iou():f}")
            logger.log(
                f"host ms a step (median of the {len(step_ms) - 1} after the first): {_median(step_ms[1:])}; "
                f"waited on the prefetch (median): {_median(wait_ms[1:])}"
            )
            logger.scalars(
                trainer.step, "train", loss=float(losses.mean()), accuracy=cm.get_accuracy(),
                learning_rate=last_metrics["learning_rate"], bn_decay=last_metrics["bn_decay"],
            )
            ious = [0.0] + cm.get_per_class_ious()
            for c in range(1, train_ds.num_classes):
                logger.log(f"IoU of {train_ds.labels_names[c]} : {ious[c]:f}")
            record = {"epoch": epoch, "train_batches": num_train_batches, "val_batches": 0,
                      "losses": losses.tolist(), "step_ms": step_ms, "prefetch_wait_ms": wait_ms}

            acc = best_acc
            if epoch % 5 == 0 and num_val_batches > 0:
                vcm = ConfusionMatrix(val_ds.num_classes)
                dev_vcm, dev_vok = None, None
                for _ in range(num_val_batches):
                    metrics = trainer.eval_step(next(val_iter))
                    dev_vcm = metrics["confusion"] if dev_vcm is None else dev_vcm + metrics["confusion"]
                    if "window_ok" in metrics:
                        dev_vok = metrics["window_ok"] if dev_vok is None else dev_vok & metrics["window_ok"]
                if dev_vok is not None and not bool(dev_vok):
                    raise _window_error(flags, "a validation batch")
                vcm.increment_from_matrix(dev_vcm)
                record["val_batches"] = num_val_batches
                acc = vcm.get_accuracy()
                logger.log(f"---- EPOCH {epoch:03d} EVALUATION ----")
                logger.log(f"eval accuracy: {acc:f}  mIoU: {vcm.get_mean_iou():f}")
                vious = [0.0] + vcm.get_per_class_ious()
                for c in range(1, val_ds.num_classes):
                    logger.log(f"eval IoU of {val_ds.labels_names[c]} : {vious[c]:f}")
                logger.scalars(
                    trainer.step, "validation", accuracy=acc, miou=vcm.get_mean_iou(),
                    **{f"iou_{val_ds.labels_names[c]}": vious[c] for c in range(1, val_ds.num_classes)},
                )
            summary["epochs"].append(record)

            if acc > best_acc:
                best_acc = acc
                save(f"best_model_epoch_{epoch:03d}.pt")
            if epoch % 10 == 0:
                save("model.pt")
    finally:
        # Whatever ended the loop (the last epoch, an interrupt, an exception),
        # the latest state stays recoverable with --resume.
        try:
            if trainer.step > 0 and is_main:
                save("model_autosave.pt")
                logger.log(f"Autosaved state at step {trainer.step}")
        except Exception as e:  # never mask the original exception
            logger.log(f"autosave failed: {e}")
        train_producer.stop()
        val_producer.stop()
    summary["step"] = trainer.step
    return summary


if __name__ == "__main__":
    main()
