"""Recall@k for information retrieval. Port of
``metrics_tpu/retrieval/recall.py``."""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.retrieval.recall import retrieval_recall
from metrics_tpu_torch.ops.segment import RankedGroupStats, hits_in_topk
from metrics_tpu_torch.retrieval.retrieval_metric import IGNORE_IDX, RetrievalMetric


class RetrievalRecall(RetrievalMetric):
    """Computes mean Recall@k over queries.

    Args:
        k: consider only the top k elements for each query (default: all).

    Example:
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> r2 = RetrievalRecall(k=2, device="cpu")
        >>> r2(indexes, preds, target)
        tensor(0.7500)
    """

    def __init__(
        self,
        empty_target_action: str = "skip",
        exclude: int = IGNORE_IDX,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        k: Optional[int] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(
            empty_target_action=empty_target_action,
            exclude=exclude,
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )

        if (k is not None) and not (isinstance(k, int) and k > 0):
            raise ValueError("`k` has to be a positive integer or None")
        self.k = k

    def _score_groups(self, stats: RankedGroupStats) -> torch.Tensor:
        return _recall_segments(stats, self.k)

    def _metric(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return retrieval_recall(preds, target, k=self.k)


def _recall_segments(stats: RankedGroupStats, k: Optional[int]) -> torch.Tensor:
    """Relevant-in-top-k / total-relevant per group."""
    hits, _ = hits_in_topk(stats, k)
    return hits.to(torch.float32) / torch.clamp_min(stats.pos_per_group, 1)
