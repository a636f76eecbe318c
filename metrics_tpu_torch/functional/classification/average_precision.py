"""Average precision (functional).

Port of ``metrics_tpu/functional/classification/average_precision.py``:
binary inputs and multi-class label-encoded targets go to the co-sort +
tie-scan path (:mod:`metrics_tpu_torch.ops.auroc_kernel`), all C classes in
one batched launch; with ``sample_weights``, the weighted scan (one launch,
the weights shared by every class), which equals the step integral of the
weighted precision-recall curve. Multi-label targets raise the JAX
package's error.
"""
from typing import List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import _precision_recall_curve_update
from metrics_tpu_torch.ops.auroc_kernel import (
    _auroc_ap,
    _auroc_ap_rows,
    _ovr_relevance,
    binary_average_precision,
    multiclass_average_precision,
)
from metrics_tpu_torch.utilities.checks import _sample_weights


def _average_precision_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int, Optional[int]]:
    return _precision_recall_curve_update(preds, target, num_classes, pos_label)


def _average_precision_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    pos_label: Optional[int],
    sample_weights: Optional[Sequence] = None,
) -> Union[List[torch.Tensor], torch.Tensor]:
    """Binary AP, or the per-class list of multi-class AP."""
    weights = _sample_weights(sample_weights, preds.shape[0], preds.device)
    if num_classes == 1:
        if weights is None:
            return binary_average_precision(preds.reshape(-1), target.reshape(-1), pos_label=pos_label)
        return _auroc_ap(preds.reshape(-1), (target.reshape(-1) == pos_label).to(torch.float32), weights=weights)[1]
    if target.ndim != 1:
        # the JAX package's per-class curves refuse (N,) scores against (N, C) targets
        raise ValueError("preds and target must have same number of dimensions, or one additional dimension for preds")
    if weights is None:
        return list(multiclass_average_precision(preds, target))
    return list(_auroc_ap_rows(preds.T, _ovr_relevance(target, num_classes), weights=weights)[1])


def average_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[List[torch.Tensor], torch.Tensor]:
    """Computes the average precision score, on the device the inputs are on.

    Args:
        preds: predictions from model (logits or probabilities)
        target: ground truth values
        num_classes: number of classes (binary problems may omit it)
        pos_label: the positive class; defaults to 1 for binary input and
            must stay ``None`` for multiclass
        sample_weights: non-negative, finite weight of each sample

    Returns:
        average precision score; multiclass returns a per-class list

    Example:
        >>> pred = torch.tensor([0, 1, 2, 3])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> average_precision(pred, target, pos_label=1)
        tensor(1.)
        >>> pred = torch.tensor([[0.75, 0.05, 0.05, 0.05, 0.05],
        ...                      [0.05, 0.75, 0.05, 0.05, 0.05],
        ...                      [0.05, 0.05, 0.75, 0.05, 0.05],
        ...                      [0.05, 0.05, 0.05, 0.75, 0.05]])
        >>> target = torch.tensor([0, 1, 3, 2])
        >>> average_precision(pred, target, num_classes=5)
        [tensor(1.), tensor(1.), tensor(0.2500), tensor(0.2500), tensor(nan)]
    """
    preds, target, num_classes, pos_label = _average_precision_update(preds, target, num_classes, pos_label)
    return _average_precision_compute(preds, target, num_classes, pos_label, sample_weights)
