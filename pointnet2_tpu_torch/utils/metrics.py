"""The confusion matrix on the device.

Own copy of ``confusion_matrix_jax`` (``pointnet2_tpu/utils/metrics.py:15-32``):
rows are labels, columns predictions.
"""

from __future__ import annotations

import torch


def confusion_matrix(labels: torch.Tensor, preds: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, N) labels and predictions -> (C, C) int64 counts, on their device.

    A compare-and-sum over the C*C bins, as the JAX function does it.
    ``torch.bincount`` would do, but on a CUDA tensor it reads the largest
    value back to size its output, which stalls the host inside the train
    step. Labels and predictions are expected in [0, C).
    """
    flat = labels.reshape(-1).long() * num_classes + preds.reshape(-1).long()
    bins = torch.arange(num_classes * num_classes, device=flat.device)
    counts = (flat[:, None] == bins[None, :]).sum(dim=0)
    return counts.reshape(num_classes, num_classes)
