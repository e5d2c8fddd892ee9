"""Confusion matrices: counted on the device, and the host's metrics over them.

Own copies of ``pointnet2_tpu/utils/metrics.py``: ``confusion_matrix`` of its
``confusion_matrix_jax`` (``:15-32``), rows labels and columns predictions;
``ConfusionMatrix`` of its class (``:35-125``), the Semantic3D metrics with
label 0 ignored.
"""

from __future__ import annotations

import numpy as np
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


class ConfusionMatrix:
    """Reference-parity metrics (util/metric.py:7-124)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.confusion_matrix = np.zeros((num_classes, num_classes), dtype=np.int64)

    def increment(self, gt_label: int, pd_label: int) -> None:
        if not (0 <= gt_label < self.num_classes):
            raise ValueError("Invalid value for gt_label")
        if not (0 <= pd_label < self.num_classes):
            raise ValueError("Invalid value for pd_label")
        self.confusion_matrix[gt_label, pd_label] += 1

    def increment_from_list(self, gt_labels, pd_labels) -> None:
        gt = np.asarray(gt_labels).reshape(-1).astype(np.int64)
        pd = np.asarray(pd_labels).reshape(-1).astype(np.int64)
        if gt.shape != pd.shape:
            raise ValueError("gt_labels and pd_labels must have the same length")
        if (gt < 0).any() or (gt >= self.num_classes).any():
            raise ValueError("Invalid value for gt_label")
        if (pd < 0).any() or (pd >= self.num_classes).any():
            raise ValueError("Invalid value for pd_label")
        binned = np.bincount(
            gt * self.num_classes + pd, minlength=self.num_classes**2
        )
        self.confusion_matrix += binned.reshape(self.num_classes, self.num_classes)

    def increment_from_matrix(self, cm) -> None:
        """Accumulate a (C, C) matrix, such as ``confusion_matrix``'s (a device tensor is read back)."""
        if isinstance(cm, torch.Tensor):
            cm = cm.detach().cpu().numpy()
        self.confusion_matrix += np.asarray(cm, dtype=np.int64)

    def get_per_class_ious(self) -> list[float]:
        """IoU per class, ignoring label 0 entirely (gt==0 rows AND pd==0 cols).

        Semantic3D convention, util/metric.py:32-65.
        """
        if (self.confusion_matrix[:, 0] != 0).any():
            print(
                "[Warn] Contains prediction of label 0:", self.confusion_matrix[:, 0]
            )
        valid = self.confusion_matrix[1:, 1:]
        ious = []
        for c in range(len(valid)):
            intersection = valid[c, c]
            union = valid[c, :].sum() + valid[:, c].sum() - intersection
            ious.append(float(intersection) / max(union, 1))
        return ious

    def get_mean_iou(self) -> float:
        ious = self.get_per_class_ious()
        return float(np.sum(ious) / len(ious))

    def get_accuracy(self) -> float:
        valid = self.confusion_matrix[1:, 1:]
        total = valid.sum()
        return float(np.trace(valid)) / total if total else 0.0

    def format_metrics(self, labels=None) -> str:
        """Render the matrix + per-class IoUs as one aligned text block.

        Same information content as the reference's printer
        (util/metric.py:85-124); the table is built functionally as a list of
        padded cell rows and returned (print_metrics prints it), with IoUs
        shown one named class per line instead of a raw list.
        """
        if labels is None:
            labels = [str(v) for v in range(self.num_classes)]
        if len(labels) != self.num_classes:
            raise ValueError("len(labels) != self.num_classes")
        width = max(max(len(x) for x in labels), 7) + 1
        pad = lambda v: str(v).rjust(width)  # noqa: E731
        header = " " * (width + 4) + "".join(pad(name) for name in labels)
        body = [
            "    "
            + pad(name)
            + "".join(pad(int(v)) for v in self.confusion_matrix[i])
            for i, name in enumerate(labels)
        ]
        ious = self.get_per_class_ious()
        iou_lines = [
            f"    {name}: {iou:.6f}" for name, iou in zip(labels[1:], ious)
        ]
        return "\n".join(
            ["Confusion matrix:", header, *body, "IoU per class (label 0 ignored):",
             *iou_lines, f"mIoU: {self.get_mean_iou():.6f}",
             f"Overall accuracy: {self.get_accuracy():.6f}"]
        )

    def print_metrics(self, labels=None) -> None:
        print(self.format_metrics(labels))
