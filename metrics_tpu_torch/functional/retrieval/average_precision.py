"""Retrieval average precision (functional). Port of
``metrics_tpu/functional/retrieval/average_precision.py``."""
import torch

from metrics_tpu_torch.ops.segment import _rank_order
from metrics_tpu_torch.utilities.checks import _check_retrieval_functional_inputs


def _ap_sorted(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """AP of one query as ``sum(rel * cum_rel / rank) / n_rel``, with the
    relevant count an int32 cumsum."""
    rel = target[_rank_order(preds)]
    cum_rel = torch.cumsum(rel, 0, dtype=torch.int32)
    rank = torch.arange(1, rel.shape[0] + 1, dtype=torch.float32, device=rel.device)
    n_rel = cum_rel[-1]
    ap = torch.sum(rel * cum_rel.to(torch.float32) / rank) / torch.clamp_min(n_rel, 1)
    return torch.where(n_rel == 0, 0.0, ap)


def retrieval_average_precision(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Computes average precision for information retrieval over one query.

    ``preds`` and ``target`` must be of the same shape; ``target`` is binary
    (bool or 0/1 ints), ``preds`` float scores. Returns 0 if no ``target``
    is positive. Tied scores rank in input order (a stable sort), ``-0.0``
    and ``+0.0`` tie, and NaN ranks last.

    Example:
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> retrieval_average_precision(preds, target)
        tensor(0.8333)
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    return _ap_sorted(preds.flatten(), target.flatten())
