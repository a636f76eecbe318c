"""Accuracy (functional). Port of ``metrics_tpu/functional/classification/accuracy.py``.

The JAX package fuses the value probe and the counting into XLA programs;
here both are a few eager tensor ops on the inputs' device. The common
cases count hits on the raw inputs (threshold, argmax or top-k against the
labels), with no one-hot; the rest take the canonical path. Counts made
from Python sizes are filled on the device (``torch.full``): building a
CUDA tensor from a Python number waits on the host.
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.functional.classification.stat_scores import _top_k_indices
from metrics_tpu_torch.utilities.checks import (
    _fast_path_inputs,
    _fast_path_validate,
    _input_format_classification,
    fast_path_memo,
)
from metrics_tpu_torch.utilities.enums import DataType


def _count(n: int, device: torch.device) -> torch.Tensor:
    return torch.full((), n, dtype=torch.int32, device=device)


def _accuracy_count(
    preds: torch.Tensor, target: torch.Tensor, mode: DataType, subset_accuracy: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(correct, total) int32 counts from canonical inputs."""
    if mode == DataType.BINARY or (mode == DataType.MULTILABEL and subset_accuracy):
        correct = torch.sum(torch.all(preds == target, dim=1))
        total = _count(target.shape[0], target.device)
    elif mode == DataType.MULTILABEL and not subset_accuracy:
        correct = torch.sum(preds == target)
        total = _count(target.numel(), target.device)
    elif mode == DataType.MULTICLASS or (mode == DataType.MULTIDIM_MULTICLASS and not subset_accuracy):
        correct = torch.sum(preds * target)
        total = torch.sum(target)
    else:  # MULTIDIM_MULTICLASS with subset_accuracy
        sample_correct = torch.sum(preds * target, dim=(1, 2))
        correct = torch.sum(sample_correct == target.shape[2])
        total = _count(target.shape[0], target.device)
    return correct.to(torch.int32), total.to(torch.int32)


def _accuracy_hits(preds, target, case: DataType, threshold: float, top_k: Optional[int], subset_accuracy: bool):
    """(correct, total) int32 counts straight from raw inputs that passed
    validation: the counting half of the JAX package's
    ``_accuracy_probe_count``."""
    if preds.dtype in (torch.float16, torch.bfloat16):
        preds = preds.to(torch.float32)
    n = target.shape[0]
    if case == DataType.BINARY:
        hit = (preds >= threshold).to(target.dtype) == target
    elif case == DataType.MULTICLASS and preds.ndim == target.ndim:
        hit = preds == target  # label predictions
    elif case == DataType.MULTICLASS:
        # (N, C) probabilities vs (N,) labels: top-k membership, ties to the
        # lower index as select_topk
        k = top_k or 1
        if k == 1:
            hit = torch.argmax(preds, dim=1) == target
        else:
            hit = torch.any(_top_k_indices(preds, k) == target[:, None], dim=1)
    else:  # MULTILABEL: float scores of the target's shape
        hit = (preds >= threshold).to(target.dtype) == target
        if subset_accuracy:
            hit = torch.all(hit.reshape(n, -1), dim=1)
        else:
            n = target.numel()
    return torch.sum(hit).to(torch.int32), _count(n, target.device)


def _accuracy_fast_update(
    preds: torch.Tensor, target: torch.Tensor, threshold: float, top_k: Optional[int], subset_accuracy: bool
) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The raw-input path for the common cases; None = take the canonical
    path. The canonical checks run on one probe (same errors, same order)
    before the counts are taken."""
    shapes = _fast_path_inputs(preds, target)
    if shapes is None:
        return None
    p_shape, t_shape, preds_float, case, implied_classes = shapes
    if case == DataType.MULTIDIM_MULTICLASS:
        return None
    if case == DataType.MULTICLASS and p_shape != t_shape and (len(p_shape) != 2 or implied_classes < 2):
        return None
    if top_k is not None and (not isinstance(top_k, int) or top_k <= 0 or top_k >= implied_classes):
        return None  # the canonical path raises the top_k errors
    if case == DataType.MULTILABEL and (top_k or not preds_float):
        return None  # top_k raises there; integer multi-label one-hots

    def compute():
        _fast_path_validate(
            preds, target, p_shape, t_shape, case, preds_float,
            threshold=threshold, num_classes=None, is_multiclass=None, top_k=top_k,
        )
        return _accuracy_hits(
            preds.reshape(p_shape), target.reshape(t_shape), case, float(threshold), top_k, subset_accuracy
        )

    key = ("accuracy", id(preds), id(target), float(threshold), top_k, subset_accuracy)
    return fast_path_memo(key, (preds, target), compute)


def _accuracy_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float,
    top_k: Optional[int],
    subset_accuracy: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Count (correct, total) for the detected case: on the raw inputs for
    the common cases, else on the canonicalized ones."""
    fast = _accuracy_fast_update(torch.as_tensor(preds), torch.as_tensor(target), threshold, top_k, subset_accuracy)
    if fast is not None:
        return fast

    preds, target, mode = _input_format_classification(preds, target, threshold=threshold, top_k=top_k)

    if mode == DataType.MULTILABEL and top_k:
        raise ValueError("You can not use the `top_k` parameter to calculate accuracy for multi-label inputs.")

    return _accuracy_count(preds, target, mode, subset_accuracy)


def _accuracy_compute(correct: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return correct.to(torch.float32) / total


def accuracy(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    subset_accuracy: bool = False,
) -> torch.Tensor:
    r"""Computes accuracy; accepts all classification input cases. Runs on
    the device its inputs are on.

    Args:
        preds: Predictions from model (probabilities, or labels)
        target: Ground truth labels
        threshold: probability threshold for binary/multi-label predictions
        top_k: top-K accuracy for (multi-dim) multi-class probability inputs
        subset_accuracy: require whole samples to match for ML/MDMC inputs

    Example:
        >>> target = torch.tensor([0, 1, 2, 3])
        >>> preds = torch.tensor([0, 2, 1, 3])
        >>> accuracy(preds, target)
        tensor(0.5000)

        >>> target = torch.tensor([0, 1, 2])
        >>> preds = torch.tensor([[0.1, 0.9, 0], [0.3, 0.1, 0.6], [0.2, 0.5, 0.3]])
        >>> accuracy(preds, target, top_k=2)
        tensor(0.6667)
    """
    correct, total = _accuracy_update(preds, target, threshold, top_k, subset_accuracy)
    return _accuracy_compute(correct, total)
