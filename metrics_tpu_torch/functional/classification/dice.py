"""Dice score (functional). Port of ``metrics_tpu/functional/classification/dice.py``.

The per-class TP/FP/FN come from three label counts (predicted, support,
hits) instead of the JAX package's one-hot comparison: the same integers,
with no ``(N, C)`` intermediate.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.ops.histogram import label_bincount
from metrics_tpu_torch.utilities.data import to_categorical
from metrics_tpu_torch.utilities.distributed import reduce


def _stat_scores(
    preds: torch.Tensor,
    target: torch.Tensor,
    class_index: int,
    argmax_dim: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """TP/FP/TN/FN/support for one class: the JAX package's legacy per-class
    helper, kept for its API (``dice_score`` counts every class at once).

    Example:
        >>> x = torch.tensor([1, 2, 3])
        >>> y = torch.tensor([0, 2, 3])
        >>> _stat_scores(x, y, class_index=1)
        (tensor(0, dtype=torch.int32), tensor(1, dtype=torch.int32), tensor(2, dtype=torch.int32), tensor(0, dtype=torch.int32), tensor(0, dtype=torch.int32))
    """
    if preds.ndim == target.ndim + 1:
        preds = to_categorical(preds, argmax_dim=argmax_dim)

    tp = torch.sum((preds == class_index) & (target == class_index)).to(torch.int32)
    fp = torch.sum((preds == class_index) & (target != class_index)).to(torch.int32)
    tn = torch.sum((preds != class_index) & (target != class_index)).to(torch.int32)
    fn = torch.sum((preds != class_index) & (target == class_index)).to(torch.int32)
    sup = torch.sum(target == class_index).to(torch.int32)

    return tp, fp, tn, fn, sup


def _class_counts(labels: torch.Tensor, num_classes: int, weights=None) -> torch.Tensor:
    """Counts of each class in ``[0, num_classes)``; any other label counts nowhere."""
    labels = labels.reshape(-1).to(torch.int64)
    return label_bincount(torch.where(labels >= 0, labels, num_classes), num_classes, weights)


def dice_score(
    pred: torch.Tensor,
    target: torch.Tensor,
    bg: bool = False,
    nan_score: float = 0.0,
    no_fg_score: float = 0.0,
    reduction: str = "elementwise_mean",
) -> torch.Tensor:
    """Compute dice score from prediction scores.

    Args:
        pred: estimated probabilities ``(N, C, ...)``.
        target: ground-truth labels ``(N, ...)``.
        bg: whether to also compute dice for the background.
        nan_score: score to return if a NaN occurs (empty denominator).
        no_fg_score: score to return if a class has no foreground pixel.
        reduction: ``'elementwise_mean'`` | ``'sum'`` | ``'none'``.

    Example:
        >>> pred = torch.tensor([[0.85, 0.05, 0.05, 0.05],
        ...                      [0.05, 0.85, 0.05, 0.05],
        ...                      [0.05, 0.05, 0.85, 0.05],
        ...                      [0.05, 0.05, 0.05, 0.85]])
        >>> target = torch.tensor([0, 1, 3, 2])
        >>> dice_score(pred, target)
        tensor(0.3333)
    """
    num_classes = pred.shape[1]
    start = 1 - int(bool(bg))

    # probabilities (one extra dim vs target) get argmaxed; labels pass through
    cat = to_categorical(pred) if pred.ndim == target.ndim + 1 else pred
    cat, target = cat.reshape(-1), target.reshape(-1)
    support = _class_counts(target, num_classes)[start:]
    tp = _class_counts(target, num_classes, weights=cat == target)[start:].to(torch.float32)
    fp = _class_counts(cat, num_classes)[start:].to(torch.float32) - tp
    fn = support.to(torch.float32) - tp

    denom = 2 * tp + fp + fn
    score = torch.where(denom > 0, 2 * tp / torch.clamp(denom, min=1.0), float(nan_score))
    scores = torch.where(support > 0, score, float(no_fg_score)).to(torch.float32)

    return reduce(scores, reduction=reduction)
