"""Hamming distance (functional). Port of ``metrics_tpu/functional/classification/hamming_distance.py``.

Over the canonical one-hot layout a multi-class position agrees on every
cell but exactly two when its predicted label is wrong, so label inputs
count ``correct = total - 2 * misses`` from the labels themselves, with no
``(N, C)`` intermediate; thresholded scores compare elementwise. The
canonical path takes the rest and raises the JAX package's errors.
"""
from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.utilities.checks import (
    _fast_path_inputs,
    _fast_path_validate,
    _input_format_classification,
    fast_path_memo,
)
from metrics_tpu_torch.utilities.data import _is_concrete


def _hamming_label_count(preds: torch.Tensor, target: torch.Tensor, threshold: float) -> torch.Tensor:
    """Agreements of thresholded scores, or misses of labels (``(N, C, ...)``
    scores are argmaxed first)."""
    if preds.dtype in (torch.float16, torch.bfloat16):
        preds = preds.to(torch.float32)
    if preds.is_floating_point() and preds.ndim == target.ndim:
        # binary / multi-label: elementwise agreement of thresholded scores
        return torch.sum((preds >= threshold).to(target.dtype) == target)
    if preds.is_floating_point():
        return torch.sum(torch.argmax(preds, dim=1) != target)
    return torch.sum(preds != target)


def _hamming_fast_update(preds, target, threshold: float) -> Optional[Tuple[torch.Tensor, int]]:
    """The label-space path for the common cases; None = take the canonical
    path. Validation parity through the canonical checks on one probe."""
    shapes = _fast_path_inputs(preds, target)
    if shapes is None:
        return None
    p_shape, t_shape, preds_float, case, implied_classes = shapes
    elementwise = preds_float and len(p_shape) == len(t_shape)
    label_pairs = not preds_float  # 1-d/N-d int pairs (MC / MDMC cases)
    if not elementwise and not label_pairs:
        # probabilities vs labels: require a real class axis
        if len(p_shape) != len(t_shape) + 1 or implied_classes < 2:
            return None

    if label_pairs and not (_is_concrete(preds) and _is_concrete(target)):
        # the canonical one-hot width comes from the data maximum, a value
        # probe: while traced, the canonical path owns that failure
        return None

    def compute():
        probe = _fast_path_validate(
            preds, target, p_shape, t_shape, case, preds_float,
            threshold=threshold, num_classes=None, is_multiclass=None, top_k=None,
        )
        count = _hamming_label_count(preds.reshape(p_shape), target.reshape(t_shape), float(threshold))
        n_positions = 1
        for d in t_shape:
            n_positions *= d
        if elementwise:
            n_cells = 1
            for d in p_shape:
                n_cells *= d
            return count, n_cells
        if label_pairs:
            # the canonical one-hot width is the data maximum's (at least 2);
            # metrics-tpu: allow(MTL101) — the probe is host floats, read once
            # under _fast_path_validate's _is_concrete guard (label pairs
            # return above unless concrete)
            width = max(2, int(max(probe.preds_max, probe.target_max)) + 1)
        else:
            width = implied_classes
        total = n_positions * width
        return total - 2 * count, total

    key = ("hamming", id(preds), id(target), float(threshold))
    return fast_path_memo(key, (preds, target), compute)


def _hamming_distance_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
) -> Tuple[torch.Tensor, int]:
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    fast = _hamming_fast_update(preds, target, threshold)
    if fast is not None:
        return fast

    preds, target, _ = _input_format_classification(preds, target, threshold=threshold)

    correct = torch.sum(preds == target)
    total = preds.numel()

    return correct, total


def _hamming_distance_compute(correct: torch.Tensor, total: Union[int, torch.Tensor]) -> torch.Tensor:
    return 1 - correct.to(torch.float32) / total


def hamming_distance(preds: torch.Tensor, target: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    r"""Computes the average Hamming distance (Hamming loss):

    elementwise disagreement rate between predictions and targets, treating
    every label of every sample separately. Runs on the inputs' device.

    Example:
        >>> target = torch.tensor([[0, 1], [1, 1]])
        >>> preds = torch.tensor([[0, 1], [0, 1]])
        >>> hamming_distance(preds, target)
        tensor(0.2500)
    """
    correct, total = _hamming_distance_update(preds, target, threshold)
    return _hamming_distance_compute(correct, total)
