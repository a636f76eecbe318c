"""Accuracy (functional). Port of ``metrics_tpu/functional/classification/accuracy.py``.

The JAX package fuses the value probe and the counting into XLA programs;
here both are a few eager tensor ops on the inputs' device.
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utilities.checks import _input_format_classification
from metrics_tpu_torch.utilities.enums import DataType


def _accuracy_count(
    preds: torch.Tensor, target: torch.Tensor, mode: DataType, subset_accuracy: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(correct, total) int32 counts from canonical inputs."""
    if mode == DataType.BINARY or (mode == DataType.MULTILABEL and subset_accuracy):
        correct = torch.sum(torch.all(preds == target, dim=1))
        total = torch.tensor(target.shape[0], device=target.device)
    elif mode == DataType.MULTILABEL and not subset_accuracy:
        correct = torch.sum(preds == target)
        total = torch.tensor(target.numel(), device=target.device)
    elif mode == DataType.MULTICLASS or (mode == DataType.MULTIDIM_MULTICLASS and not subset_accuracy):
        correct = torch.sum(preds * target)
        total = torch.sum(target)
    else:  # MULTIDIM_MULTICLASS with subset_accuracy
        sample_correct = torch.sum(preds * target, dim=(1, 2))
        correct = torch.sum(sample_correct == target.shape[2])
        total = torch.tensor(target.shape[0], device=target.device)
    return correct.to(torch.int32), total.to(torch.int32)


def _accuracy_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float,
    top_k: Optional[int],
    subset_accuracy: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Canonicalize inputs and count (correct, total) for the detected case."""
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
