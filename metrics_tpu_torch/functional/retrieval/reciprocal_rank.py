"""Retrieval reciprocal rank (functional). Port of
``metrics_tpu/functional/retrieval/reciprocal_rank.py``."""
import torch

from metrics_tpu_torch.ops.segment import _rank_order
from metrics_tpu_torch.utilities.checks import _check_retrieval_functional_inputs


def _rr_sorted(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``1 / rank`` of the first relevant document (0 if none): the number
    of relevant documents ranked strictly before position ``i`` is 0 up to
    the first relevant one."""
    rel = target[_rank_order(preds)]
    first = torch.sum(torch.cumsum(rel, 0, dtype=torch.int32) == 0) + 1
    return torch.where(first > rel.shape[0], 0.0, 1.0 / first.to(torch.float32))


def retrieval_reciprocal_rank(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Computes reciprocal rank for information retrieval over one query.

    Returns ``1/rank`` of the highest-scored relevant document, or 0 if no
    ``target`` is positive. Tied scores rank in input order (see
    :func:`~metrics_tpu_torch.functional.retrieval_average_precision`).

    Example:
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([False, True, False])
        >>> retrieval_reciprocal_rank(preds, target)
        tensor(0.5000)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    return _rr_sorted(preds.flatten(), target.flatten())
