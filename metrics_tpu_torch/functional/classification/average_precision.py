"""Average precision (functional).

Port of ``metrics_tpu/functional/classification/average_precision.py``'s
exact paths: binary inputs and multi-class label-encoded targets go to the
co-sort + tie-scan path (:mod:`metrics_tpu_torch.ops.auroc_kernel`), all C
classes in one batched launch. What the JAX package computes on its curve
path (multi-label targets, ``sample_weights``) raises
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports it.
"""
from typing import List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import _precision_recall_curve_update
from metrics_tpu_torch.ops.auroc_kernel import binary_average_precision, multiclass_average_precision

_CURVE_TODO = (
    "average precision of {} runs on the curve path (precision_recall_curve), which is not"
    " ported yet: see ROADMAP.md, Queue 1 item 6 (the curve family)"
)


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
    """Binary AP, or the per-class list of multi-class AP; the curve-path
    cases raise."""
    if sample_weights is not None:
        raise NotImplementedError(_CURVE_TODO.format("weighted samples (`sample_weights`)"))
    if num_classes == 1:
        return binary_average_precision(preds.reshape(-1), target.reshape(-1), pos_label=pos_label)
    if target.ndim != 1:
        raise NotImplementedError(_CURVE_TODO.format("multi-label targets"))
    return list(multiclass_average_precision(preds, target))


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
        sample_weights: sample weights (not ported yet)

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
