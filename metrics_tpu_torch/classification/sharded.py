"""Exact AUROC / average precision and curves with bounded, per-rank state.

Port of ``metrics_tpu/classification/sharded.py`` (``ShardedCurveMetric``,
the one-vs-rest compute and averaging, ``ShardedAUROC``,
``ShardedAveragePrecision``, ``ShardedROC``,
``ShardedPrecisionRecallCurve``) for one process per device: each rank holds
``capacity_per_device`` slots of the prediction, target and (with
``with_sample_weights=True``) weight streams on its own device
(:class:`~metrics_tpu_torch.parallel.sharded_metric.ShardedStreamsMixin`),
and ``compute`` runs its own collectives. It routes as the JAX package
does, with the sample sort and the class transpose over
``torch.distributed`` in place of its CPU host twins:

* binary, world > 1: the splitter sample sort
  (:func:`~metrics_tpu_torch.parallel.sample_sort.sample_sort_auroc_ap`),
  weighted or not;
* binary, world = 1: the masked one-stream kernel over the local buffers
  (one co-sort and one launch, weighted or not);
* one-vs-rest, world > 1: a class transpose by ``all_to_all``: rank ``d``
  receives every rank's rows of its block of classes, then one batched
  launch for them;
* one-vs-rest, world = 1: one segmented co-sort and one batched launch for
  all classes over the local buffers;
* the curves (``ShardedROC``, ``ShardedPrecisionRecallCurve``): the valid
  rows of every rank gathered onto each rank's device, and the curve built
  there (the JAX package gathers them to its host).

Overflow is loud: capacity is a constructor contract, checked on the host
before a batch is written.
"""
from typing import Any, Optional, Tuple

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import _precision_recall_curve_compute
from metrics_tpu_torch.functional.classification.roc import _roc_compute
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.auroc_kernel import (
    _auroc_ap_rows,
    _ovr_relevance,
    masked_binary_auroc,
    masked_binary_average_precision,
    masked_weighted_binary_auroc,
    masked_weighted_binary_average_precision,
)
from metrics_tpu_torch.parallel.backend import get_sync_backend
from metrics_tpu_torch.parallel.sample_sort import sample_sort_auroc_ap
from metrics_tpu_torch.parallel.sharded_metric import ShardedStreamsMixin
from metrics_tpu_torch.utilities.checks import _min_max, _sample_weights
from metrics_tpu_torch.utilities.data import _is_concrete


def _average_ovr(
    per_class: torch.Tensor, support: torch.Tensor, average: Optional[str], batch_local: bool = False
) -> torch.Tensor:
    """NONE/MACRO/WEIGHTED averaging of per-class one-vs-rest scores
    (``support`` = valid occurrences, or weight totals, per class).

    Epoch-end (``batch_local=False``) averaged modes fail loudly when a
    class never occurred in the stream (its score is NaN and would silently
    poison the mean); the per-class mode returns NaN for absent classes.

    With ``batch_local=True`` (a ``forward`` step value) a mini-batch may
    miss classes, so the average runs over the classes whose score is
    defined: NaN only when none is.
    """
    if average in (None, "none"):
        return per_class
    if batch_local:
        valid = ~torch.isnan(per_class)
        weight = valid.to(support.dtype) if average == "macro" else torch.where(valid, support, 0.0)
        total = weight.sum()
        # an epsilon, not max(·, 1): weighted supports may total below 1
        score = (torch.where(valid, per_class, 0.0) * weight).sum() / torch.clamp_min(total, 1e-30)
        return torch.where(total > 0, score, float("nan")).to(per_class.dtype)
    absent = [c for c, s in enumerate(support.tolist()) if s == 0]
    if absent:
        raise ValueError(
            f"classes {absent} never occurred in the"
            f" accumulated targets; their one-vs-rest score is undefined, so"
            f" average={average!r} cannot be computed (use average=None for"
            " per-class scores with NaN holes)"
        )
    if average == "macro":
        return per_class.mean()
    return (per_class * support / torch.clamp_min(support.sum(), 1e-30)).sum().to(per_class.dtype)


class ShardedCurveMetric(ShardedStreamsMixin, Metric):
    """Base: fixed-capacity per-rank (preds, target[, weights]) stream state.

    Args:
        capacity_per_device: slots held by each rank; the total capacity is
            ``capacity_per_device * world``.
        target_dtype: dtype of the stored targets.
        preds_dtype: dtype of the stored scores; ``torch.bfloat16`` halves
            the buffer, and the result is the exact metric of the
            bf16-rounded scores.
        preds_suffix: trailing shape of one prediction: ``()`` for binary
            scores, ``(C,)`` for per-class score rows.
        with_sample_weights: keep a third, float32 weight stream; every
            ``update`` must then pass ``sample_weights``.
        kwargs: ``Metric``'s (``device``, ``process_group``, ...).
    """

    # only the scalar one-vs-rest family implements the weighted epilogue
    _supports_sample_weights = False

    def __init__(
        self,
        capacity_per_device: int,
        compute_on_step: bool = True,
        target_dtype: torch.dtype = torch.int32,
        preds_dtype: torch.dtype = torch.float32,
        preds_suffix: Tuple[int, ...] = (),
        with_sample_weights: bool = False,
        **kwargs: Any,
    ):
        super().__init__(compute_on_step=compute_on_step, **kwargs)
        self.preds_suffix = tuple(preds_suffix)
        if with_sample_weights and not self._supports_sample_weights:
            raise ValueError(
                f"{type(self).__name__} does not support sample weights;"
                " the scalar epilogue family (ShardedAUROC,"
                " ShardedAveragePrecision) does"
            )
        self.with_sample_weights = bool(with_sample_weights)
        streams = {"buf_preds": (preds_dtype, self.preds_suffix), "buf_target": (target_dtype, ())}
        if self.with_sample_weights:
            streams["buf_weights"] = (torch.float32, ())
        self._init_streams(streams, capacity_per_device)

    def _sync_dist(self, dist_sync_fn=None) -> None:
        # compute() runs its own collectives over the shards
        pass

    def update(self, preds: torch.Tensor, target: torch.Tensor, sample_weights: Optional[torch.Tensor] = None) -> None:
        """Append this rank's batch of ``(n, *preds_suffix)`` scores and
        ``(n,)`` targets. ``sample_weights`` (``(n,)``, non-negative) is
        required iff the metric was constructed ``with_sample_weights=True``;
        they are value-checked here and raise on negative or non-finite
        entries."""
        preds = torch.as_tensor(preds, device=self.device)
        target = torch.as_tensor(target, device=self.device)
        if self.with_sample_weights != (sample_weights is not None):
            raise ValueError(
                "pass `sample_weights` to every update iff the metric was"
                f" constructed with_sample_weights=True (got"
                f" with_sample_weights={self.with_sample_weights},"
                f" sample_weights={'set' if sample_weights is not None else 'None'})"
            )
        sample_weights = _sample_weights(sample_weights, target.shape[0], self.device)
        if target.ndim != 1 or tuple(preds.shape) != (target.shape[0], *self.preds_suffix):
            shape_desc = "(n" + "".join(f", {d}" for d in self.preds_suffix) + ")"
            raise ValueError(
                f"expected preds of shape {shape_desc} and 1-d target,"
                f" got {tuple(preds.shape)} and {tuple(target.shape)}"
            )
        if self.preds_suffix and target.numel() and _is_concrete(target):
            # an out-of-range label would silently count as negative in every
            # one-vs-rest column; one device-to-host copy
            lo, hi = _min_max(target)
            if lo < 0 or hi >= self.preds_suffix[0]:
                raise ValueError(
                    f"target labels must lie in [0, {self.preds_suffix[0]})"
                    f" (the C dimension of preds); got range [{lo}, {hi}]"
                )
        self._append_streams(preds, target, *(() if sample_weights is None else (sample_weights,)))


class _ShardedOVRMetric(ShardedCurveMetric):
    """Shared init and compute of the scalar one-vs-rest curve metrics:
    binary by default, ``num_classes=C`` for ``(N, C)`` score rows with
    integer labels, averaged by :func:`_average_ovr`. Subclasses set the
    masked kernels and ``_output`` (0: AUROC, 1: AP)."""

    _masked_kernel = None
    _masked_weighted_kernel = None
    _output: int = None
    _supports_sample_weights = True

    def __init__(
        self,
        capacity_per_device: int,
        pos_label: int = 1,
        num_classes: Optional[int] = None,
        average: Optional[str] = "macro",
        **kwargs: Any,
    ):
        allowed = (None, "none", "macro", "weighted")
        if average not in allowed:
            raise ValueError(f"Argument `average` expected to be one of {allowed}, got {average}")
        suffix = () if num_classes in (None, 1) else (num_classes,)
        super().__init__(capacity_per_device, preds_suffix=suffix, **kwargs)
        self.pos_label = pos_label
        self.num_classes = num_classes
        self.average = average

    def compute(self) -> torch.Tensor:
        weights = self.buf_weights if self.with_sample_weights else None
        if self.preds_suffix:
            return self._ovr_compute(weights)
        if self.world > 1:
            return sample_sort_auroc_ap(
                self.buf_preds, self.buf_target, self._fill(), self.pos_label, weights, self.process_group
            )[self._output]
        (preds, target, *weights), mask = self._gather_streams()
        if weights:
            return self._masked_weighted_kernel(preds, target, mask, weights[0], self.pos_label)
        return self._masked_kernel(preds, target, mask, self.pos_label)

    def _ovr_scores(self, preds_rows, rel, mask, weights=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """This metric's score and the support of each ``(R, N)`` class row,
        over the ``mask``-valid columns: one batched launch."""
        score = _auroc_ap_rows(preds_rows, rel, mask, weights)[self._output]
        valid = rel if mask is None else rel * mask
        if weights is not None:
            valid = valid * weights
        return score, valid.sum(1, dtype=torch.float64)

    def _ovr_compute(self, weights: Optional[torch.Tensor]) -> torch.Tensor:
        num_classes = self.preds_suffix[0]
        if self.world > 1:
            per_class, support = self._ovr_transposed(num_classes)
        else:
            (preds, target, *w), mask = self._gather_streams()
            per_class, support = self._ovr_scores(preds.T, _ovr_relevance(target, num_classes), mask, *w)
        return _average_ovr(per_class, support, self.average, batch_local=self._batch_local_compute)

    def _ovr_transposed(self, num_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """One-vs-rest scores straight off the per-rank buffers: a class
        transpose by ``all_to_all``. Rank ``d`` owns the classes
        ``[d*B, (d+1)*B)`` (``B = ceil(C / world)``, the last blocks short or
        empty) and receives every rank's valid rows of them, as ``(classes,
        rows)`` runs concatenated in rank order: the ``(C/world, N)`` layout
        the batched scan takes. Targets and weights ride a small
        ``all_gather``; scores and supports of the class blocks are gathered
        back in rank order."""
        backend = get_sync_backend()
        group, me, world = self.process_group, self.rank, self.world
        fill = self._fill()
        fills = torch.stack(backend.gather(torch.tensor(fill, device=self.device), group)).tolist()
        block = -(-num_classes // world)
        first = [min(num_classes, d * block) for d in range(world + 1)]
        local = self.buf_preds[:fill]
        send = torch.cat([local[:, first[d]:first[d + 1]].T.reshape(-1) for d in range(world)])
        mine = first[me + 1] - first[me]
        recv = backend.all_to_all(
            send, [(first[d + 1] - first[d]) * fill for d in range(world)], [mine * f for f in fills], group
        )
        runs = recv.split([mine * f for f in fills])
        preds_rows = torch.cat([run.reshape(mine, f) for run, f in zip(runs, fills)], 1)
        target = torch.cat(backend.gather(self.buf_target[:fill], group))
        weights = torch.cat(backend.gather(self.buf_weights[:fill], group)) if self.with_sample_weights else None
        classes = torch.arange(first[me], first[me + 1], device=self.device)
        rel = (target[None, :] == classes[:, None]).to(torch.float32)
        score, support = self._ovr_scores(preds_rows, rel, None, weights)
        return torch.cat(backend.gather(score, group)), torch.cat(backend.gather(support, group))


class ShardedAUROC(_ShardedOVRMetric):
    """Exact AUROC with bounded, per-rank state.

    Drop-in for :class:`~metrics_tpu_torch.AUROC` on large prediction
    streams: the same exact (sklearn ``roc_auc_score``) value, but each rank
    holds ``capacity_per_device`` rows instead of a list of every batch, and
    compute is one co-sort and one kernel launch on one rank, or the sample
    sort across ranks. Binary scores by default; ``num_classes=C`` for
    ``(N, C)`` score rows with integer labels, averaged per ``average``
    (``"macro"``, ``"weighted"`` or ``None``). ``with_sample_weights=True``
    weights every sample.

    Example:
        >>> m = ShardedAUROC(capacity_per_device=8, device="cpu")
        >>> m.update(torch.tensor([0.1, 0.4, 0.35, 0.8, 0.6, 0.2, 0.9, 0.7]),
        ...          torch.tensor([0, 0, 1, 1, 1, 0, 1, 0]))
        >>> round(float(m.compute()), 4)
        0.8125
    """

    _masked_kernel = staticmethod(masked_binary_auroc)
    _masked_weighted_kernel = staticmethod(masked_weighted_binary_auroc)
    _output = 0


class ShardedAveragePrecision(_ShardedOVRMetric):
    """Exact average precision with bounded, per-rank state.

    Binary by default; ``num_classes=C`` for one-vs-rest with averaging and
    ``with_sample_weights=True`` for weighted samples, like
    :class:`ShardedAUROC`.

    Example:
        >>> m = ShardedAveragePrecision(capacity_per_device=8, with_sample_weights=True, device="cpu")
        >>> m.update(torch.tensor([0.1, 0.4, 0.35, 0.8, 0.6, 0.2, 0.9, 0.7]),
        ...          torch.tensor([0, 0, 1, 1, 1, 0, 1, 0]), sample_weights=torch.ones(8))
        >>> round(float(m.compute()), 4)
        0.8542
    """

    _masked_kernel = staticmethod(masked_binary_average_precision)
    _masked_weighted_kernel = staticmethod(masked_weighted_binary_average_precision)
    _output = 1


class _ShardedCurve(ShardedCurveMetric):
    """Shared init and compute of the sharded curves: the valid rows of
    every rank, gathered in rank order onto this rank's device, then the
    curve of :mod:`metrics_tpu_torch.functional.classification` there
    (``_curve``). The curve has a data-dependent number of points, so only
    the accumulation memory is sharded."""

    _curve = None

    def __init__(
        self, capacity_per_device: int, pos_label: int = 1, num_classes: Optional[int] = None, **kwargs: Any
    ):
        suffix = () if num_classes in (None, 1) else (num_classes,)
        super().__init__(capacity_per_device, preds_suffix=suffix, **kwargs)
        self.pos_label = pos_label
        self.num_classes = num_classes

    def compute(self) -> Tuple[Any, Any, Any]:
        (preds, target), mask = self._gather_streams()
        return self._curve(preds[mask], target[mask], num_classes=self.num_classes or 1, pos_label=self.pos_label)


class ShardedROC(_ShardedCurve):
    """Exact ROC curve with bounded, per-rank state.

    Binary scores by default; ``num_classes=C`` accepts ``(N, C)`` score
    rows with integer labels and returns per-class curve lists, like
    :class:`~metrics_tpu_torch.ROC`.

    Example:
        >>> m = ShardedROC(capacity_per_device=8, device="cpu")
        >>> m.update(torch.tensor([0.1, 0.4, 0.35, 0.8, 0.6, 0.2, 0.9, 0.7]),
        ...          torch.tensor([0, 0, 1, 1, 1, 0, 1, 0]))
        >>> fpr, tpr, thresholds = m.compute()
        >>> tpr
        tensor([0.0000, 0.2500, 0.5000, 0.5000, 0.7500, 0.7500, 1.0000, 1.0000, 1.0000])
    """

    _curve = staticmethod(_roc_compute)


class ShardedPrecisionRecallCurve(_ShardedCurve):
    """Exact precision-recall curve with bounded, per-rank state.

    Binary by default; ``num_classes=C`` for per-class curve lists, like
    :class:`~metrics_tpu_torch.PrecisionRecallCurve`.

    Example:
        >>> m = ShardedPrecisionRecallCurve(capacity_per_device=8, device="cpu")
        >>> m.update(torch.tensor([0.1, 0.4, 0.35, 0.8, 0.6, 0.2, 0.9, 0.7]),
        ...          torch.tensor([0, 0, 1, 1, 1, 0, 1, 0]))
        >>> precision, recall, thresholds = m.compute()
        >>> bool(torch.all(recall[:-1] >= recall[1:]))  # recall is non-increasing
        True
    """

    _curve = staticmethod(_precision_recall_curve_compute)
