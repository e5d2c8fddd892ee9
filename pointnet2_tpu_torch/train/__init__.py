"""Training: the ``Trainer``, its schedules and checkpoints."""

from pointnet2_tpu_torch.train.trainer import (
    Trainer,
    bn_momentum_schedule,
    learning_rate_schedule,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "Trainer",
    "bn_momentum_schedule",
    "learning_rate_schedule",
    "restore_checkpoint",
    "save_checkpoint",
]
