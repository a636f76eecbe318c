"""Area Under the ROC Curve (functional).

Port of the exact paths of ``metrics_tpu/functional/classification/auroc.py``:
binary inputs, multi-label inputs and one-vs-rest multi-class inputs go to
the co-sort + tie-scan path (:mod:`metrics_tpu_torch.ops.auroc_kernel`),
all classes or labels in one batched launch. What the JAX package computes
on its curve path (``max_fpr``, ``sample_weights``, multi-label ``micro``,
multi-class without ``num_classes`` equal to the score columns) raises
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports it.
"""
from typing import Callable, List, Optional, Sequence, Union

import torch

from metrics_tpu_torch.ops.auroc_kernel import binary_auroc, multiclass_auroc_ovr, multilabel_auroc
from metrics_tpu_torch.ops.histogram import label_bincount
from metrics_tpu_torch.utilities.checks import _input_format_classification
from metrics_tpu_torch.utilities.enums import AverageMethod, DataType

_CURVE_TODO = (
    "AUROC with {} runs on the curve path (roc, auc, precision_recall_curve), which is not"
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


def _reduce_auroc(
    auc_scores: torch.Tensor, average: Optional[str], support_fn: Callable[[], torch.Tensor]
) -> Union[torch.Tensor, List[torch.Tensor]]:
    """Apply NONE/MACRO/WEIGHTED averaging to ``(C,)`` per-class AUC scores;
    NONE returns them as a list of 0-d tensors, as the JAX package does.

    ``support_fn`` lazily computes the per-class support for WEIGHTED.
    """
    if average == AverageMethod.NONE:
        return list(auc_scores)
    if average == AverageMethod.MACRO:
        return torch.mean(auc_scores)
    if average == AverageMethod.WEIGHTED:
        support = support_fn()
        return torch.sum(auc_scores * support / support.sum())

    allowed_average = (AverageMethod.NONE.value, AverageMethod.MACRO.value, AverageMethod.WEIGHTED.value)
    raise ValueError(
        f"Argument `average` expected to be one of the following: {allowed_average} but got {average}"
    )


def _auroc_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    mode: DataType,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    sample_weights: Optional[Sequence] = None,
):
    """AUROC through the exact kernel path; the curve-path cases raise."""
    if max_fpr is not None:
        if not isinstance(max_fpr, float) or not 0 < max_fpr <= 1:
            raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")
        if mode != DataType.BINARY:
            raise ValueError(
                f"Partial AUC computation not available in"
                f" multilabel/multiclass setting, 'max_fpr' must be"
                f" set to `None`, received `{max_fpr}`."
            )
        raise NotImplementedError(_CURVE_TODO.format("`max_fpr`"))
    if sample_weights is not None:
        raise NotImplementedError(_CURVE_TODO.format("`sample_weights`"))

    if mode == DataType.BINARY:
        pos = 1 if pos_label is None else pos_label
        # keep the curve path's loud failure on degenerate targets
        n_pos = int(torch.sum(target == pos))
        if n_pos == target.numel():
            raise ValueError("No negative samples in targets, false positive value should be meaningless")
        if n_pos == 0:
            raise ValueError("No positive samples in targets, true positive value should be meaningless")
        return binary_auroc(preds.reshape(-1), target.reshape(-1), pos_label=pos)

    if mode == DataType.MULTILABEL:
        if average == AverageMethod.MICRO:
            raise NotImplementedError(_CURVE_TODO.format("multi-label `average='micro'`"))
        # keep the curve path's loud failure on degenerate label columns
        pos_per_col = torch.sum(target, dim=0)
        if bool(torch.any(pos_per_col == target.shape[0])):
            raise ValueError("No negative samples in targets, false positive value should be meaningless")
        if bool(torch.any(pos_per_col == 0)):
            raise ValueError("No positive samples in targets, true positive value should be meaningless")
        return _reduce_auroc(multilabel_auroc(preds, target), average, lambda: pos_per_col)

    if preds.ndim == 2 and target.ndim == 1 and num_classes == preds.shape[1]:
        # multi-class and multi-dim multi-class (flattened by _auroc_update)
        return _reduce_auroc(
            multiclass_auroc_ovr(preds, target), average, lambda: label_bincount(target, length=num_classes)
        )
    raise NotImplementedError(
        _CURVE_TODO.format(f"multi-class scores of {tuple(preds.shape)} and `num_classes={num_classes}`")
    )


def auroc(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    sample_weights: Optional[Sequence] = None,
) -> torch.Tensor:
    """Compute Area Under the Receiver Operating Characteristic Curve (ROC AUC),
    on the device the inputs are on.

    Args:
        preds: predictions from model (logits or probabilities)
        target: ground truth labels
        num_classes: number of classes (binary problems may omit it; multi-class
            inputs need it equal to the score columns)
        pos_label: the positive class; defaults to 1 for binary input
        average: ``'macro'`` | ``'weighted'`` | ``None`` (per-class scores);
            multi-label ``'micro'`` is not ported yet
        max_fpr: partial AUC (not ported yet)
        sample_weights: sample weights (not ported yet)

    Example:
        >>> preds = torch.tensor([0.13, 0.26, 0.08, 0.19, 0.34])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> auroc(preds, target, pos_label=1)
        tensor(0.5000)
        >>> preds = torch.tensor([[0.90, 0.05, 0.05],
        ...                       [0.05, 0.90, 0.05],
        ...                       [0.05, 0.05, 0.90],
        ...                       [0.85, 0.05, 0.10],
        ...                       [0.10, 0.10, 0.80]])
        >>> target = torch.tensor([0, 1, 1, 2, 2])
        >>> auroc(preds, target, num_classes=3)
        tensor(0.7778)
    """
    preds, target, mode = _auroc_update(preds, target)
    return _auroc_compute(preds, target, mode, num_classes, pos_label, average, max_fpr, sample_weights)
