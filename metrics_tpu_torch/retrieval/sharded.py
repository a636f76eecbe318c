"""Retrieval metrics with bounded, per-rank accumulation.

Port of ``metrics_tpu/retrieval/sharded.py`` for one process per device:
each rank holds ``capacity_per_device`` slots of the query-id, score and
target streams on its own device
(:class:`~metrics_tpu_torch.parallel.sharded_metric.ShardedStreamsMixin`),
instead of lists of every batch, and ``compute`` runs its own collectives:

* world = 1: the rank's buffers through the scoring core of
  :class:`~metrics_tpu_torch.retrieval.RetrievalMetric`, the slot validity
  folded into its one filter: the bits of the unsharded metric;
* world > 1: the retrieval sample sort
  (:func:`~metrics_tpu_torch.parallel.sample_sort.sample_sort_retrieval`),
  on gloo and NCCL alike: each query is ranked and scored on the one rank
  that owns its id range. A subclass without a whole-epoch scorer (a user
  ``_metric`` only) gathers every rank's streams and scores them on each
  rank.

Overflow is loud: capacity is a constructor contract, checked on the host
before a batch is written.
"""
from typing import Any, Callable, Optional

import torch

from metrics_tpu_torch.ops.segment import RankedGroupStats
from metrics_tpu_torch.parallel.sample_sort import sample_sort_retrieval
from metrics_tpu_torch.parallel.sharded_metric import ShardedStreamsMixin
from metrics_tpu_torch.retrieval.mean_average_precision import RetrievalMAP
from metrics_tpu_torch.retrieval.mean_reciprocal_rank import RetrievalMRR
from metrics_tpu_torch.retrieval.precision import RetrievalPrecision
from metrics_tpu_torch.retrieval.recall import RetrievalRecall
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric


class ShardedRetrievalMetric(ShardedStreamsMixin, RetrievalMetric):
    """Bounded, per-rank accumulation for grouped-query metrics.

    Same update/compute contract as :class:`RetrievalMetric`, but the
    ``idx``/``preds``/``target`` streams are ``capacity_per_device`` slots
    per rank instead of unbounded lists. Combine with a scoring subclass
    (``ShardedRetrievalMAP`` etc.), or subclass and implement the
    reference-style per-query ``_metric``.
    """

    def __init__(self, capacity_per_device: int, **kwargs: Any):
        super().__init__(**kwargs)
        # replace the unbounded list states registered by RetrievalMetric
        # with the bounded streams
        for name in ("idx", "preds", "target"):
            del self._defaults[name]
            del self._persistent[name]
            del self._reductions[name]
            delattr(self, name)
        self._init_streams(
            {"buf_idx": (torch.int32, ()), "buf_preds": (torch.float32, ()), "buf_target": (torch.int32, ())},
            capacity_per_device,
        )

    def _sync_dist(self, dist_sync_fn=None) -> None:
        # compute() runs its own collectives over the shards
        pass

    def update(self, idx: torch.Tensor, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Check and append this rank's batch of flattened (idx, preds, target)."""
        self._append_streams(*self._checked(idx, preds, target))

    def _samplesort_scorer(self) -> Optional[Callable[[RankedGroupStats], torch.Tensor]]:
        """The whole-epoch scorer the sample sort runs on each rank's
        queries; None for a subclass that scores through ``_metric`` only."""
        if type(self)._score_groups is RetrievalMetric._score_groups:
            return None
        return self._score_groups

    def compute(self) -> torch.Tensor:
        scorer = self._samplesort_scorer()
        if scorer is not None and self.world > 1:
            return sample_sort_retrieval(
                self.buf_idx, self.buf_preds, self.buf_target, self._fill(), scorer,
                self.empty_target_action, self.exclude, self.process_group,
            )
        (idx, preds, target), mask = self._gather_streams()
        return self._compute_from_arrays(idx, preds, target, valid_mask=mask)


class ShardedRetrievalMAP(ShardedRetrievalMetric, RetrievalMAP):
    """Mean average precision over queries, bounded per-rank accumulation.

    Example:
        >>> m = ShardedRetrievalMAP(capacity_per_device=8, device="cpu")
        >>> m.update(torch.tensor([0, 0, 0, 0, 1, 1, 1, 1]),
        ...          torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.2, 0.5, 0.1]),
        ...          torch.tensor([False, False, True, False, False, True, False, True]))
        >>> round(float(m.compute()), 4)
        0.7083
    """


class ShardedRetrievalMRR(ShardedRetrievalMetric, RetrievalMRR):
    """Mean reciprocal rank over queries, bounded per-rank accumulation.

    Example:
        >>> m = ShardedRetrievalMRR(capacity_per_device=8, device="cpu")
        >>> m.update(torch.tensor([0, 0, 0, 0, 1, 1, 1, 1]),
        ...          torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.2, 0.5, 0.1]),
        ...          torch.tensor([False, False, True, False, False, True, False, True]))
        >>> round(float(m.compute()), 4)
        0.6667
    """


class ShardedRetrievalPrecision(ShardedRetrievalMetric, RetrievalPrecision):
    """Precision@k over queries, bounded per-rank accumulation.

    Example:
        >>> m = ShardedRetrievalPrecision(capacity_per_device=8, k=2, device="cpu")
        >>> m.update(torch.tensor([0, 0, 0, 0, 1, 1, 1, 1]),
        ...          torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.2, 0.5, 0.1]),
        ...          torch.tensor([False, False, True, False, False, True, False, True]))
        >>> round(float(m.compute()), 4)
        0.25
    """


class ShardedRetrievalRecall(ShardedRetrievalMetric, RetrievalRecall):
    """Recall@k over queries, bounded per-rank accumulation.

    Example:
        >>> m = ShardedRetrievalRecall(capacity_per_device=8, k=2, device="cpu")
        >>> m.update(torch.tensor([0, 0, 0, 0, 1, 1, 1, 1]),
        ...          torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.2, 0.5, 0.1]),
        ...          torch.tensor([False, False, True, False, False, True, False, True]))
        >>> round(float(m.compute()), 4)
        0.5
    """
