"""Classification metrics from one confusion matrix (counterpart of
``neighbour_feature_pooling_tpu/train/metrics.py``).

Multiclass accuracy and macro F1 / precision / recall, as the reference's
torchmetrics suite computes them, all derived from one (K, K) integer
accumulator that stays on the device through an epoch, so the epoch's
metrics cost one host transfer.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["init_confusion", "confusion_matrix_update", "metrics_from_confusion",
           "metrics_from_confusion_np"]


def init_confusion(num_classes: int, device=None) -> torch.Tensor:
    return torch.zeros((num_classes, num_classes), dtype=torch.int32, device=device)


def confusion_matrix_update(cm: torch.Tensor, logits: torch.Tensor, labels: torch.Tensor,
                            weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Accumulate predictions into a (K, K) confusion matrix (rows = true).

    ``weights`` (0/1 per example) masks the padding examples of an epoch's
    last, partially filled batch. Ties in the logits go to the first
    class, as ``jnp.argmax`` and ``torch.argmax`` both pick."""
    k = cm.shape[0]
    preds = torch.argmax(logits, dim=-1)
    if weights is None:
        weights = torch.ones_like(labels)
    cells = labels.long() * k + preds
    counts = torch.zeros(k * k, dtype=torch.int32, device=cm.device)
    counts.index_add_(0, cells, weights.to(torch.int32))
    return cm + counts.view(k, k)


def metrics_from_confusion(cm: torch.Tensor, eps: float = 1e-12) -> Dict[str, float]:
    """Accuracy and macro precision / recall / F1 from a confusion matrix.

    ``accuracy`` is the reference's metric, torchmetrics'
    ``Accuracy(task="multiclass")``, which averages per-class recall over
    the classes present in the targets (**macro**); ``micro_accuracy`` is
    the plain fraction correct. A class with no predictions (or no true
    samples) contributes 0, as in torchmetrics. Computed in float32 on the
    host."""
    return metrics_from_confusion_np(cm.detach().cpu().numpy(), eps)


def metrics_from_confusion_np(cm, eps: float = 1e-12) -> Dict[str, float]:
    """The numpy form of :func:`metrics_from_confusion`."""
    cm = np.asarray(cm, np.float32)
    total = cm.sum()
    tp = np.diagonal(cm)
    true_per_class = cm.sum(axis=1)
    pred_per_class = cm.sum(axis=0)
    micro = tp.sum() / max(total, 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_per_class > 0, tp / (pred_per_class + eps), 0.0)
        recall = np.where(true_per_class > 0, tp / (true_per_class + eps), 0.0)
        f1 = np.where(precision + recall > 0,
                      2 * precision * recall / (precision + recall + eps), 0.0)
    present = (true_per_class > 0).astype(np.float32)
    macro_acc = float((recall * present).sum() / max(present.sum(), 1.0))
    return {
        "accuracy": macro_acc,
        "micro_accuracy": float(micro),
        "precision": float(precision.mean()),
        "recall": float(recall.mean()),
        "f1": float(f1.mean()),
    }
