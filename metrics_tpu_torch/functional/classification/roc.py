"""Receiver operating characteristic (functional).

Port of ``metrics_tpu/functional/classification/roc.py``, on the curve core
of :mod:`metrics_tpu_torch.functional.classification.precision_recall_curve`:
the binary curve, or every class's or label's curve in one pass.
"""
from typing import List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _clf_curves,
    _place,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.utilities.checks import _sample_weights


def _roc_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int, Optional[int]]:
    return _precision_recall_curve_update(preds, target, num_classes, pos_label)


def _roc_curves(
    preds: torch.Tensor, rel: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Per-row ``(fpr, tpr, thresholds)`` of ``(R, N)`` rows, each opened
    by the ``(0, 0)`` point at its top score plus one. A row without
    negatives or positives raises, the first such row first, as the JAX
    package's per-class loop does."""
    p = _clf_curves(preds, rel, weights)
    for _, pos, neg in p.host:
        if neg <= 0:
            raise ValueError("No negative samples in targets, false positive value should be meaningless")
        if pos <= 0:
            raise ValueError("No positive samples in targets, true positive value should be meaningless")
    n_rows = p.counts.numel()
    # each row's opening point comes first: the rows before hold one slot more each
    open_at = torch.cumsum(p.counts, 0) - p.counts + torch.arange(n_rows, device=p.counts.device)
    at = torch.arange(p.rows.numel(), device=p.rows.device) + p.rows + 1
    fpr = _place(p.fps.double() / p.totals[p.rows, 1], at, open_at, 0.0).float()
    tpr = _place(p.tps.double() / p.totals[p.rows, 0], at, open_at, 0.0).float()
    first = p.thresholds[open_at - torch.arange(n_rows, device=open_at.device)]
    thresholds = _place(p.thresholds, at, open_at, first + 1)
    sizes = [int(k) + 1 for k, _, _ in p.host]
    return fpr.split(sizes), tpr.split(sizes), thresholds.split(sizes)


def _roc_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    pos_label: int,
    sample_weights: Optional[Sequence] = None,
) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[List[torch.Tensor], ...]]:
    """The binary curve; or per-class lists, over ``(N, C)`` scores against
    ``(N,)`` labels (class ``c`` positive) or ``(N, C)`` multi-label
    targets (label value 1 positive)."""
    weights = _sample_weights(sample_weights, preds.shape[0], preds.device)
    if num_classes == 1 and preds.ndim == 1:
        curves = _roc_curves(preds[None], (target == pos_label)[None], weights)
        return tuple(c[0] for c in curves)
    if preds.shape == target.shape:
        rel = target.T == 1
    else:
        rel = target[None, :] == torch.arange(num_classes, device=target.device)[:, None]
    return tuple(list(c) for c in _roc_curves(preds.T, rel, weights))


def roc(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[List[torch.Tensor], ...]]:
    """Computes the Receiver Operating Characteristic (ROC), on the device
    the inputs are on. Works with binary, multiclass and multilabel input.

    Args:
        preds: predictions from model (logits or probabilities)
        target: ground truth values
        num_classes: number of classes (binary problems may omit it)
        pos_label: the positive class; defaults to 1 for binary input and
            must stay ``None`` for multiclass
        sample_weights: non-negative, finite weight of each sample

    Returns:
        ``(fpr, tpr, thresholds)``; per-class lists for multiclass and
        multilabel input.

    Example:
        >>> pred = torch.tensor([0, 1, 2, 3])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> fpr, tpr, thresholds = roc(pred, target, pos_label=1)
        >>> fpr
        tensor([0., 0., 0., 0., 1.])
        >>> tpr
        tensor([0.0000, 0.3333, 0.6667, 1.0000, 1.0000])
        >>> thresholds
        tensor([4, 3, 2, 1, 0])
    """
    preds, target, num_classes, pos_label = _roc_update(preds, target, num_classes, pos_label)
    return _roc_compute(preds, target, num_classes, pos_label, sample_weights)
