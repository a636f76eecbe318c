"""Mean Reciprocal Rank for information retrieval. Port of
``metrics_tpu/retrieval/mean_reciprocal_rank.py``."""
import torch

from metrics_tpu_torch.functional.retrieval.reciprocal_rank import retrieval_reciprocal_rank
from metrics_tpu_torch.ops.segment import RankedGroupStats, _group_bounds, _group_sums
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric


class RetrievalMRR(RetrievalMetric):
    """Computes Mean Reciprocal Rank over queries.

    Example:
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> mrr = RetrievalMRR(device="cpu")
        >>> mrr(indexes, preds, target)
        tensor(0.7500)
    """

    def _score_groups(self, stats: RankedGroupStats) -> torch.Tensor:
        return _mrr_segments(stats)

    def _metric(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return retrieval_reciprocal_rank(preds, target)


def _first_relevant_ranks(stats: RankedGroupStats) -> torch.Tensor:
    """int64 ``(G,)`` rank of each group's first relevant doc, 0 without
    one. The first relevant doc is the one element of its group that is
    relevant with an inclusive relevant count of 1, so its rank is an exact
    integer sum over the group: no segment-min needed."""
    starts, ends = _group_bounds(stats.group, stats.pos_per_group.shape[0])
    is_first = (stats.relevant > 0) & (stats.cum_relevant == 1)
    return _group_sums(torch.where(is_first, stats.rank, 0), starts, ends)


def _mrr_segments(stats: RankedGroupStats) -> torch.Tensor:
    """1 / (rank of the first relevant doc) per group, 0 without one."""
    first_rank = _first_relevant_ranks(stats)
    return torch.where(first_rank == 0, 0.0, 1.0 / first_rank.to(torch.float32))
