"""Distributed reduction helpers and the host-level gather.

Port of ``metrics_tpu/utilities/distributed.py``: ``reduce`` and
``class_reduce`` are the shared reduction numerics (NaN-to-0 guard
included); ``gather_all_tensors`` delegates to the active
:class:`~metrics_tpu_torch.parallel.backend.SyncBackend`.
"""
from typing import Any, List, Optional

import torch

from metrics_tpu_torch.parallel.backend import get_sync_backend


def reduce(to_reduce: torch.Tensor, reduction: str) -> torch.Tensor:
    """Reduce a tensor by a named method: 'elementwise_mean' | 'none' | 'sum'."""
    if reduction == "elementwise_mean":
        return torch.mean(to_reduce)
    if reduction == "none":
        return to_reduce
    if reduction == "sum":
        return torch.sum(to_reduce)
    raise ValueError("Reduction parameter unknown.")


def class_reduce(
    num: torch.Tensor, denom: torch.Tensor, weights: torch.Tensor, class_reduction: str = "none"
) -> torch.Tensor:
    """Reduce per-class fractions ``num / denom * weights`` with NaN→0 guard.

    ``class_reduction``: 'micro' | 'macro' | 'weighted' | 'none' | None.
    """
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    if class_reduction == "micro":
        fraction = torch.sum(num) / torch.sum(denom)
    else:
        fraction = num / denom

    # Zero-out NaNs produced by 0-denominator classes.
    fraction = torch.where(torch.isnan(fraction), torch.zeros_like(fraction), fraction)

    if class_reduction == "micro":
        return fraction
    if class_reduction == "macro":
        return torch.mean(fraction)
    if class_reduction == "weighted":
        w = weights.to(torch.float32)
        return torch.sum(fraction * (w / torch.sum(w)))
    if class_reduction == "none" or class_reduction is None:
        return fraction

    raise ValueError(
        f"Reduction parameter {class_reduction} unknown."
        f" Choose between one of these: {valid_reduction}"
    )


def gather_all_tensors(result: torch.Tensor, group: Optional[Any] = None) -> List[torch.Tensor]:
    """Gather ``result`` from all ranks into a rank-indexed list (identical everywhere)."""
    return get_sync_backend().gather(result, group=group)
