"""Mean Average Precision for information retrieval. Port of
``metrics_tpu/retrieval/mean_average_precision.py``."""
import torch

from metrics_tpu_torch.functional.retrieval.average_precision import retrieval_average_precision
from metrics_tpu_torch.ops.segment import RankedGroupStats, _fixed_point_group_sums, _group_bounds
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric


class RetrievalMAP(RetrievalMetric):
    """Computes Mean Average Precision over queries.

    Example:
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> rmap = RetrievalMAP(device="cpu")
        >>> rmap(indexes, preds, target)
        tensor(0.7917)
    """

    def _score_groups(self, stats: RankedGroupStats) -> torch.Tensor:
        return _map_segments(stats)

    def _metric(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return retrieval_average_precision(preds, target)


def _map_segments(stats: RankedGroupStats) -> torch.Tensor:
    """AP per group: ``sum(rel * cum_rel / rank) / n_rel``, the sums
    bit-reproducible (fixed-point int64 differences at the group ends)."""
    starts, ends = _group_bounds(stats.group, stats.pos_per_group.shape[0])
    terms = stats.relevant.to(torch.float64) * stats.cum_relevant / stats.rank
    ap_sum = _fixed_point_group_sums(terms, starts, ends)
    return (ap_sum / torch.clamp_min(stats.pos_per_group, 1)).to(torch.float32)
