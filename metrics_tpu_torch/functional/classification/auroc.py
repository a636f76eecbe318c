"""Area Under the ROC Curve (functional).

Port of the binary branch of ``metrics_tpu/functional/classification/auroc.py``:
binary inputs go to the exact co-sort + tie-scan path
(:mod:`metrics_tpu_torch.ops.auroc_kernel`). The other branches are not
ported yet and raise ``NotImplementedError`` naming the ``ROADMAP.md`` item
that ports them.
"""
from typing import Optional, Sequence

import torch

from metrics_tpu_torch.ops.auroc_kernel import binary_auroc
from metrics_tpu_torch.utilities.checks import _input_format_classification
from metrics_tpu_torch.utilities.enums import DataType

_MULTICLASS_TODO = (
    "AUROC of multi-class and multi-label inputs is not ported yet: see ROADMAP.md, Queue 1"
    " item 4 (multiclass_auroc_ovr) and Queue 2 item 2 (the class-batched tie scan)"
)
_CURVE_TODO = (
    "AUROC with `{}` runs on the curve path (roc, auc, precision_recall_curve), which is not"
    " ported yet: see ROADMAP.md, Queue 1 item 6 (the curve family)"
)


def _auroc_update(preds: torch.Tensor, target: torch.Tensor):
    """Validate input and detect its mode; reshape deep inputs as the JAX package does."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    # use _input_format_classification for validating the input and get the mode of data
    _, _, mode = _input_format_classification(preds, target)

    if mode == DataType.MULTIDIM_MULTICLASS and preds.ndim == target.ndim + 1:
        n_classes = preds.shape[1]
        preds = torch.swapaxes(preds, 0, 1).reshape(n_classes, -1).T
        target = target.reshape(-1)
    if mode == DataType.MULTILABEL and preds.ndim > 2:
        n_classes = preds.shape[1]
        preds = torch.swapaxes(preds, 0, 1).reshape(n_classes, -1).T
        target = torch.swapaxes(target, 0, 1).reshape(n_classes, -1).T

    return preds, target, mode


def _auroc_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    mode: DataType,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    sample_weights: Optional[Sequence] = None,
) -> torch.Tensor:
    """Binary AUROC through the exact kernel path; the other modes raise."""
    if max_fpr is not None:
        if not isinstance(max_fpr, float) or not 0 < max_fpr <= 1:
            raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")
        if mode != DataType.BINARY:
            raise ValueError(
                f"Partial AUC computation not available in"
                f" multilabel/multiclass setting, 'max_fpr' must be"
                f" set to `None`, received `{max_fpr}`."
            )
    if mode != DataType.BINARY:
        raise NotImplementedError(_MULTICLASS_TODO)
    if max_fpr is not None:
        raise NotImplementedError(_CURVE_TODO.format("max_fpr"))
    if sample_weights is not None:
        raise NotImplementedError(_CURVE_TODO.format("sample_weights"))

    pos = 1 if pos_label is None else pos_label
    # keep the curve path's loud failure on degenerate targets
    n_pos = int(torch.sum(target == pos))
    if n_pos == target.numel():
        raise ValueError("No negative samples in targets, false positive value should be meaningless")
    if n_pos == 0:
        raise ValueError("No positive samples in targets, true positive value should be meaningless")
    return binary_auroc(preds.reshape(-1), target.reshape(-1), pos_label=pos)


def auroc(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    sample_weights: Optional[Sequence] = None,
) -> torch.Tensor:
    """Compute Area Under the Receiver Operating Characteristic Curve (ROC AUC)
    of binary inputs, on the device the inputs are on.

    Args:
        preds: predictions from model (probabilities)
        target: ground truth labels
        num_classes: number of classes (binary problems may omit it)
        pos_label: the positive class; defaults to 1 for binary input
        average: averaging of per-class scores (multi-class, not ported yet)
        max_fpr: partial AUC (not ported yet)
        sample_weights: sample weights (not ported yet)

    Example:
        >>> preds = torch.tensor([0.13, 0.26, 0.08, 0.19, 0.34])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> auroc(preds, target, pos_label=1)
        tensor(0.5000)
    """
    preds, target, mode = _auroc_update(preds, target)
    return _auroc_compute(preds, target, mode, num_classes, pos_label, average, max_fpr, sample_weights)
