"""Intersection over union / Jaccard (functional). Port of ``metrics_tpu/functional/classification/iou.py``."""
from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update
from metrics_tpu_torch.utilities.data import get_num_classes
from metrics_tpu_torch.utilities.distributed import reduce


def _iou_from_confmat(
    confmat: torch.Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
    absent_score: float = 0.0,
    reduction: str = "elementwise_mean",
) -> torch.Tensor:
    intersection = torch.diag(confmat)
    union = torch.sum(confmat, dim=0) + torch.sum(confmat, dim=1) - intersection

    # Classes absent from both target AND pred (union == 0) score absent_score.
    scores = intersection.to(torch.float32) / union.to(torch.float32)
    scores = torch.where(union == 0, absent_score, scores)

    # Remove the ignored class index from the scores.
    if ignore_index is not None and 0 <= ignore_index < num_classes:
        scores = torch.cat([scores[:ignore_index], scores[ignore_index + 1:]])
    return reduce(scores, reduction=reduction)


def iou(
    preds: torch.Tensor,
    target: torch.Tensor,
    ignore_index: Optional[int] = None,
    absent_score: float = 0.0,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    reduction: str = "elementwise_mean",
) -> torch.Tensor:
    r"""Intersection over union (Jaccard index) from the confusion matrix.

    ``reduction``: 'elementwise_mean' | 'sum' | 'none'.

    Example:
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> iou(preds, target)
        tensor(0.5833)
    """
    num_classes = get_num_classes(preds=preds, target=target, num_classes=num_classes)
    confmat = _confusion_matrix_update(preds, target, num_classes, threshold)
    return _iou_from_confmat(confmat, num_classes, ignore_index, absent_score, reduction)
