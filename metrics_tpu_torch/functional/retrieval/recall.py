"""Retrieval recall@k (functional). Port of
``metrics_tpu/functional/retrieval/recall.py``."""
from typing import Optional

import torch

from metrics_tpu_torch.ops.segment import _rank_order
from metrics_tpu_torch.utilities.checks import _check_retrieval_functional_inputs


def _recall_sorted(preds: torch.Tensor, target: torch.Tensor, k: int) -> torch.Tensor:
    rel = target[_rank_order(preds)]
    n_rel = torch.sum(rel)
    relevant = torch.sum(rel[:k])
    return torch.where(n_rel == 0, 0.0, relevant.to(torch.float32) / torch.clamp_min(n_rel, 1))


def retrieval_recall(preds: torch.Tensor, target: torch.Tensor, k: Optional[int] = None) -> torch.Tensor:
    """Computes recall@k for information retrieval over one query.

    Args:
        preds: estimated relevance scores per document.
        target: binary ground-truth relevance per document.
        k: consider only the top k elements (default: all). Tied scores
            rank in input order (see
            :func:`~metrics_tpu_torch.functional.retrieval_average_precision`).

    Example:
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> retrieval_recall(preds, target, k=2)
        tensor(0.5000)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)

    if k is None:
        k = preds.shape[-1]

    if not (isinstance(k, int) and k > 0):
        raise ValueError("`k` has to be a positive integer or None")

    return _recall_sorted(preds.flatten(), target.flatten(), min(k, preds.numel()))
