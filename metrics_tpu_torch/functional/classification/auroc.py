"""Area Under the ROC Curve (functional).

Port of ``metrics_tpu/functional/classification/auroc.py``, routed as the
JAX package routes it, with every sum on a hand-written tie-scan kernel
(:mod:`metrics_tpu_torch.ops.auroc_kernel`):

* binary, multi-label and one-vs-rest multi-class inputs: one co-sort and
  one scan launch, all classes or labels in one batched launch;
* ``sample_weights``: the weighted scan, one launch for the binary stream or
  for all classes or labels (the weights shared by every row); equal to the
  trapezoid over the weighted curve the JAX package integrates;
* multi-label ``average="micro"``: one launch over the flattened stream;
* ``max_fpr``: the curve (:func:`~metrics_tpu_torch.functional.classification.roc.roc`),
  then the JAX package's interpolation and McClish correction.

Degenerate targets and class totals raise the JAX package's errors.
"""
from typing import Callable, List, Optional, Sequence, Union

import torch

from metrics_tpu_torch.functional.classification.auc import _auc_compute
from metrics_tpu_torch.functional.classification.roc import _roc_compute, _roc_update, roc
from metrics_tpu_torch.ops.auroc_kernel import (
    _ovr_relevance,
    _weighted_stats,
    binary_auroc,
    multiclass_auroc_ovr,
    multilabel_auroc,
)
from metrics_tpu_torch.ops.histogram import label_bincount
from metrics_tpu_torch.ops.tie_scan import auroc_ap_from_stats
from metrics_tpu_torch.utilities.checks import _input_format_classification, _sample_weights
from metrics_tpu_torch.utilities.data import _is_concrete
from metrics_tpu_torch.utilities.enums import AverageMethod, DataType


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


def _check_totals(stats: torch.Tensor) -> None:
    """Raise as the JAX package's curve path does when a stream (the first
    such row of ``(C, 4)`` stats) has no negative or no positive weight."""
    for pos, neg in stats.reshape(-1, 4)[:, 2:].tolist():
        if neg <= 0:
            raise ValueError("No negative samples in targets, false positive value should be meaningless")
        if pos <= 0:
            raise ValueError("No positive samples in targets, true positive value should be meaningless")


def _weighted_auroc(preds: torch.Tensor, rel: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted AUROC of one stream or of ``(C, N)`` rows: one weighted
    launch, equal to the trapezoid over the weighted curve."""
    stats = _weighted_stats(preds, rel.to(torch.float32), weights)
    _check_totals(stats)
    return auroc_ap_from_stats(stats)[0]


def _partial_auroc(fpr: torch.Tensor, tpr: torch.Tensor, max_fpr: float) -> torch.Tensor:
    """McClish-standardized area of the curve up to ``max_fpr``, in float32
    as the JAX package computes it."""
    max_fpr_t = torch.tensor(max_fpr, dtype=fpr.dtype, device=fpr.device)
    # add a single point at max_fpr and interpolate its tpr value
    stop = int(torch.searchsorted(fpr, max_fpr_t, right=True))
    weight = (max_fpr_t - fpr[stop - 1]) / (fpr[stop] - fpr[stop - 1])
    interp_tpr = tpr[stop - 1] + weight * (tpr[stop] - tpr[stop - 1])
    tpr = torch.cat([tpr[:stop], interp_tpr.reshape(1)])
    fpr = torch.cat([fpr[:stop], max_fpr_t.reshape(1)])
    partial_auc = _auc_compute(fpr, tpr)
    # McClish correction: 0.5 if non-discriminant, 1 if maximal
    min_area = 0.5 * max_fpr**2
    max_area = max_fpr
    return 0.5 * (1 + (partial_auc - min_area) / (max_area - min_area))


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
    """AUROC as the JAX package routes it, each sum on a tie-scan kernel."""
    if mode == DataType.BINARY:
        num_classes = 1
        if max_fpr is None and sample_weights is None:
            pos = 1 if pos_label is None else pos_label
            if _is_concrete(target):
                # keep the curve path's loud failure on degenerate targets
                n_pos = int(torch.sum(target == pos))
                if n_pos == target.numel():
                    raise ValueError("No negative samples in targets, false positive value should be meaningless")
                if n_pos == 0:
                    raise ValueError("No positive samples in targets, true positive value should be meaningless")
            return binary_auroc(preds.reshape(-1), target.reshape(-1), pos_label=pos)

    if max_fpr is not None:
        if not isinstance(max_fpr, float) or not 0 < max_fpr <= 1:
            raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")
        if mode != DataType.BINARY:
            raise ValueError(
                f"Partial AUC computation not available in"
                f" multilabel/multiclass setting, 'max_fpr' must be"
                f" set to `None`, received `{max_fpr}`."
            )

    if mode == DataType.MULTILABEL:
        if average == AverageMethod.MICRO:
            # one stream of every (sample, label) pair, as the JAX package's binary roc of the flattened input
            return _auroc_compute(preds.reshape(-1), target.reshape(-1), DataType.BINARY, 1, pos_label,
                                  sample_weights=sample_weights)
        if sample_weights is None and preds.ndim == 2 and target.ndim == 2:
            pos_per_col = torch.sum(target, dim=0)
            if _is_concrete(target):
                # keep the curve path's loud failure on degenerate label columns
                if bool(torch.any(pos_per_col == target.shape[0])):
                    raise ValueError("No negative samples in targets, false positive value should be meaningless")
                if bool(torch.any(pos_per_col == 0)):
                    raise ValueError("No positive samples in targets, true positive value should be meaningless")
            return _reduce_auroc(multilabel_auroc(preds, target), average, lambda: pos_per_col)
        # the JAX package's per-label loop runs over range(num_classes)
        labels = len(range(num_classes))
        weights = _sample_weights(sample_weights, preds.shape[0], preds.device)
        scores = _weighted_auroc(preds[:, :labels].T, target[:, :labels].T == 1, weights)
        return _reduce_auroc(scores, average, lambda: torch.sum(target, dim=0))

    if (
        mode in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS)
        and sample_weights is None
        and preds.ndim == 2
        and target.ndim == 1
        and num_classes == preds.shape[1]
    ):
        return _reduce_auroc(
            multiclass_auroc_ovr(preds, target), average, lambda: label_bincount(target, length=num_classes)
        )

    if mode == DataType.BINARY:
        if max_fpr is None or max_fpr == 1:
            preds, target, _, pos = _roc_update(preds, target, 1, pos_label)
            if sample_weights is not None:
                weights = _sample_weights(sample_weights, preds.numel(), preds.device)
                return _weighted_auroc(preds, target == pos, weights)
            return _auc_compute(*roc(preds, target, 1, pos)[:2])
        fpr, tpr, _ = roc(preds, target, 1, pos_label, sample_weights)
        return _partial_auroc(fpr, tpr, max_fpr)

    # multi-class: the curve path's canonicalization raises the JAX package's errors
    preds, target, num_classes, _ = _roc_update(preds, target, num_classes, pos_label)
    if sample_weights is not None and preds.ndim == 2 and target.ndim == 1:
        weights = _sample_weights(sample_weights, preds.shape[0], preds.device)
        scores = _weighted_auroc(preds.T, _ovr_relevance(target, num_classes), weights)
    else:
        fpr, tpr, _ = _roc_compute(preds, target, num_classes, pos_label, sample_weights)
        if num_classes == 1:
            return _auc_compute(fpr, tpr)
        scores = torch.stack([_auc_compute(x, y) for x, y in zip(fpr, tpr)])
    return _reduce_auroc(scores, average, lambda: label_bincount(target, length=num_classes))


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
        average: ``'micro'`` (multilabel only) | ``'macro'`` | ``'weighted'``
            | ``None`` (per-class scores)
        max_fpr: if set, standardized partial AUC over ``[0, max_fpr]``
            (binary only)
        sample_weights: non-negative, finite weight of each sample

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
