"""Base class for grouped-query (information retrieval) metrics.

Port of ``metrics_tpu/retrieval/retrieval_metric.py``: the same states
(``idx``/``preds``/``target`` cat-lists), the same ``empty_target_action``
semantics, the same mean over queries.

``compute()`` does not loop over queries. The exclusion filter, the
densification of the query ids and the ranking of the whole epoch stay on
the device (:func:`~metrics_tpu_torch.ops.segment._ranked_query_stats`):
one stable sort by ``(query id, score desc)``, then scans. Two host reads
per ``compute()`` (the number of kept elements and of queries; one more for
``empty_target_action="error"``), whatever the number of queries; no
O(N) array goes to the host. Subclasses score every query at once in
:meth:`_score_groups`; the reference's per-query :meth:`_metric` is the
fallback for user subclasses.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.segment import RankedGroupStats, _group_bounds, _ranked_query_stats
from metrics_tpu_torch.utilities.checks import _check_retrieval_inputs

#: predictions with target equal to this value are excluded from scoring
IGNORE_IDX = -100


class RetrievalMetric(Metric):
    """Works with binary target data; accepts float predictions.

    ``forward``/``update`` accept same-shape ``indexes``, ``preds`` and
    ``target`` (flattened on entry). ``indexes`` say which query each
    prediction belongs to; ``compute()`` scores each query and returns the
    mean over queries.

    Args:
        empty_target_action:
            What to do with queries that have no positive target:
            ``'skip'`` (default) drops them (0.0 if all are dropped),
            ``'error'`` raises, ``'pos'`` scores them 1.0, ``'neg'`` 0.0.
        exclude:
            Do not take into account predictions where the target is equal to
            this value. default `-100`
        compute_on_step / dist_sync_on_step / process_group / dist_sync_fn / device:
            see :class:`metrics_tpu_torch.Metric`.
    """

    def __init__(
        self,
        empty_target_action: str = "skip",
        exclude: int = IGNORE_IDX,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )

        empty_target_action_options = ("error", "skip", "pos", "neg")
        if empty_target_action not in empty_target_action_options:
            raise ValueError(f"`empty_target_action` received a wrong value {empty_target_action}.")

        self.empty_target_action = empty_target_action
        self.exclude = exclude

        self.add_state("idx", default=[], dist_reduce_fx=None)
        self.add_state("preds", default=[], dist_reduce_fx=None)
        self.add_state("target", default=[], dist_reduce_fx=None)

    def _checked(self, idx, preds, target):
        """The batch on this metric's device, checked and flattened."""
        idx, preds, target = (torch.as_tensor(x, device=self.device) for x in (idx, preds, target))
        idx, preds, target = _check_retrieval_inputs(idx, preds, target, ignore=self.exclude)
        return idx.flatten(), preds.flatten(), target.flatten()

    def update(self, idx: torch.Tensor, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Check shape, check and convert dtypes, flatten and add to accumulators."""
        idx, preds, target = self._checked(idx, preds, target)
        self.idx.append(idx)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> torch.Tensor:
        """Mean of the per-query scores (empty queries per ``empty_target_action``)."""
        return self._compute_from_arrays(torch.cat(self.idx), torch.cat(self.preds), torch.cat(self.target))

    def _compute_from_arrays(
        self,
        idx: torch.Tensor,
        preds: torch.Tensor,
        target: torch.Tensor,
        valid_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Scoring core on concatenated epoch arrays (shared by the list-state
        path above and the sharded bounded-state path,
        :mod:`metrics_tpu_torch.retrieval.sharded`, which folds its
        buffer-slot validity into ``valid_mask`` so filtering happens once)."""
        # drop excluded predictions entirely: they take no rank position
        valid = target != self.exclude
        if valid_mask is not None:
            valid = valid & valid_mask
        keep = torch.nonzero(valid).squeeze(1)  # one host read: the kept count
        stats = _ranked_query_stats(idx[keep], preds[keep], target[keep])
        if stats is None:
            return torch.zeros((), dtype=torch.float32, device=idx.device)
        scores = self._score_groups(stats)

        if self.empty_target_action == "error" and bool(torch.any(stats.pos_per_group == 0)):
            raise ValueError("`compute` method was provided with a query with no positive target.")

        return _reduce_over_queries(scores, stats.pos_per_group, self.empty_target_action)

    def _score_groups(self, stats: RankedGroupStats) -> torch.Tensor:
        """Per-group scores ``(G,)`` of every query at once; this fallback
        loops over the groups on the host and calls :meth:`_metric`.

        The built-in subclasses override it with a few whole-epoch launches.
        User subclasses that only implement the reference-style per-query
        :meth:`_metric` get correct values from this loop, with two caveats:

        * it costs host round trips per query: at 10k+ queries, override
          ``_score_groups`` instead (the statistics in
          :class:`~metrics_tpu_torch.ops.segment.RankedGroupStats` are its
          building blocks);
        * ``_metric`` receives SYNTHESIZED rank-order scores (``0, -1, -2,
          ...``), not the original prediction values: the ranking (and so
          any rank-based metric) is exactly preserved, but score magnitudes
          and tie structure are not.
        """
        starts, ends = _group_bounds(stats.group, stats.pos_per_group.shape[0])
        scores = []
        for lo, hi in zip(starts.tolist(), ends.tolist()):
            rel = stats.relevant[lo:hi]  # already in rank order
            fake_preds = -torch.arange(hi - lo, dtype=torch.float32, device=rel.device)
            scores.append(torch.as_tensor(self._metric(fake_preds, rel.to(torch.int32)), device=rel.device))
        if not scores:
            return torch.zeros((0,), dtype=torch.float32, device=stats.group.device)
        return torch.stack(scores)

    def _metric(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Score a single query (reference extension point)."""
        raise NotImplementedError


def _reduce_over_queries(scores: torch.Tensor, pos_per_group: torch.Tensor, action: str = "skip") -> torch.Tensor:
    """Apply ``empty_target_action`` and average over queries: a float64
    sum of the float32 scores, returned as float32."""
    empty = pos_per_group == 0
    scores = scores.to(torch.float64)
    if action == "pos":
        return torch.where(empty, 1.0, scores).mean().to(torch.float32)
    if action == "neg":
        return torch.where(empty, 0.0, scores).mean().to(torch.float32)
    # skip (error was raised before)
    n_kept = torch.sum(~empty)
    total = torch.sum(torch.where(empty, 0.0, scores))
    return torch.where(n_kept == 0, 0.0, total / torch.clamp_min(n_kept, 1)).to(torch.float32)
