"""Cohen's kappa (functional). Port of ``metrics_tpu/functional/classification/cohen_kappa.py``."""
from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _confusion_matrix_compute,
    _confusion_matrix_update,
)

_cohen_kappa_update = _confusion_matrix_update


def _cohen_kappa_compute(confmat: torch.Tensor, weights: Optional[str] = None) -> torch.Tensor:
    if weights == "none":
        weights = None
    confmat = _confusion_matrix_compute(confmat)
    n_classes = confmat.shape[0]
    sum0 = torch.sum(confmat, dim=0)
    sum1 = torch.sum(confmat, dim=1)
    expected = torch.outer(sum1, sum0) / torch.sum(sum0)  # outer product of marginals

    if weights is None:
        w_mat = 1 - torch.eye(n_classes, dtype=confmat.dtype, device=confmat.device)
    elif weights in ("linear", "quadratic"):
        w_mat = torch.zeros_like(confmat) + torch.arange(n_classes, dtype=confmat.dtype, device=confmat.device)
        if weights == "linear":
            w_mat = torch.abs(w_mat - w_mat.T)
        else:
            w_mat = torch.pow(w_mat - w_mat.T, 2.0)
    else:
        raise ValueError(
            f"Received {weights} for argument ``weights`` but should be either" " None, 'linear' or 'quadratic'"
        )

    k = torch.sum(w_mat * confmat) / torch.sum(w_mat * expected)
    return 1 - k


def cohen_kappa(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    weights: Optional[str] = None,
    threshold: float = 0.5,
) -> torch.Tensor:
    r"""Cohen's kappa: agreement corrected for chance, with optional
    'linear'/'quadratic' disagreement weighting.

    Example:
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> cohen_kappa(preds, target, num_classes=2)
        tensor(0.5000)
    """
    confmat = _cohen_kappa_update(preds, target, num_classes, threshold)
    return _cohen_kappa_compute(confmat, weights)
