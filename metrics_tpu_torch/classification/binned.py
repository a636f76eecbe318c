"""Binned (streaming) curve metrics over score histograms.

Port of ``metrics_tpu/classification/binned.py``. Where the exact curve
metrics store every prediction, these accumulate two fixed-size score
histograms (:func:`~metrics_tpu_torch.ops.histogram.score_histograms`):
state is O(num_bins) whatever the dataset size, sync is a plain ``"sum"``
reduction, and the values converge to the exact ones as ``num_bins`` grows
(the error is bounded by the score quantization, ~1/num_bins).

Weighted histograms are normalized by their totals themselves, not by
``max(total, 1)`` as in the JAX package, so weights that sum below 1 give
the same values as those weights scaled up.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch

from metrics_tpu_torch.classification.sharded import _average_ovr
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.histogram import (
    histogram_auroc,
    histogram_average_precision,
    histogram_pr_curve,
    score_histograms,
)
from metrics_tpu_torch.utilities.checks import _check_retrieval_functional_inputs, _guard_sample_weights, _min_max
from metrics_tpu_torch.utilities.data import _is_concrete


class _BinnedScoreMetric(Metric):
    """Shared runtime for histogram-state metrics.

    Binary (default): binary targets, score probabilities in [0, 1], two
    ``(num_bins,)`` sum-reduced histograms. With ``num_classes=C``: ``(N, C)``
    score rows with integer labels, per-class one-vs-rest ``(C, num_bins)``
    histograms.
    """

    _fused_forward = True  # additive histogram states: one-update forward

    def __init__(
        self,
        num_bins: int = 512,
        num_classes: Optional[int] = None,
        average: Optional[str] = "macro",
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
        if not isinstance(num_bins, int) or num_bins < 2:
            raise ValueError(f"`num_bins` must be an integer >= 2, got {num_bins}")
        allowed = (None, "none", "macro", "weighted")
        if average not in allowed:
            raise ValueError(f"Argument `average` expected to be one of {allowed}, got {average}")
        self.num_bins = num_bins
        self.num_classes = num_classes
        self.average = average

        shape = (num_bins,) if num_classes in (None, 1) else (num_classes, num_bins)
        self.add_state("hist_pos", default=torch.zeros(shape, dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("hist_neg", default=torch.zeros(shape, dtype=torch.float32), dist_reduce_fx="sum")

    @property
    def _is_multiclass(self) -> bool:
        return self.hist_pos.ndim == 2

    def update(self, preds: torch.Tensor, target: torch.Tensor, sample_weights=None) -> None:
        """Add the batch to the histograms. ``sample_weights`` (optional,
        one non-negative finite weight per target element) make them
        weighted sums; they are value-checked and raise otherwise."""
        if sample_weights is not None:
            sample_weights = torch.as_tensor(sample_weights, dtype=torch.float32, device=self.device).flatten()
            n_target = torch.as_tensor(target).numel()
            if sample_weights.shape[0] != n_target:
                raise ValueError(
                    f"expected sample_weights with one weight per target element"
                    f" ({n_target}), got {sample_weights.shape[0]}"
                )
            sample_weights = _guard_sample_weights(sample_weights)
        if self._is_multiclass:
            preds = torch.as_tensor(preds, device=self.device)
            target = torch.as_tensor(target, device=self.device)
            num_classes = self.hist_pos.shape[0]
            if target.ndim != 1 or tuple(preds.shape) != (target.shape[0], num_classes):
                raise ValueError(
                    f"expected preds of shape (n, {num_classes}) and 1-d target,"
                    f" got {tuple(preds.shape)} and {tuple(target.shape)}"
                )
            if _is_concrete(target):  # value probe: skipped while the step engine traces
                lo, hi = (int(v) for v in _min_max(target))
                if lo < 0 or hi >= num_classes:
                    raise ValueError(
                        f"target labels must lie in [0, {num_classes})"
                        f" (the C dimension of preds); got range [{lo}, {hi}]"
                    )
            self._check_prob_range(preds)
            rel = target[:, None] == torch.arange(num_classes, device=target.device)
        else:
            preds, target = _check_retrieval_functional_inputs(preds, target)
            self._check_prob_range(preds)
            preds, rel = preds.flatten(), target.flatten() == 1
        hist_pos, hist_neg = score_histograms(preds, rel, self.num_bins, sample_weights)
        self.hist_pos = self.hist_pos + hist_pos
        self.hist_neg = self.hist_neg + hist_neg

    @staticmethod
    def _check_prob_range(preds: torch.Tensor) -> None:
        if not _is_concrete(preds):
            return
        pmin, pmax = _min_max(preds)
        if pmin < 0 or pmax > 1:
            # logits would be silently clipped into the edge bins
            raise ValueError("The `preds` should be probabilities, but values were detected outside of [0,1] range.")

    def _ovr_scores(self, kernel: Callable) -> torch.Tensor:
        """Per-class one-vs-rest scores of the histogram rows, averaged per
        ``self.average`` (see
        :func:`~metrics_tpu_torch.classification.sharded._average_ovr`: an
        absent class fails an epoch-end average, while a ``forward`` step
        averages over the classes its batch holds)."""
        per_class = kernel(self.hist_pos, self.hist_neg)
        support = self.hist_pos.sum(1)
        return _average_ovr(per_class, support, self.average, batch_local=self._batch_local_compute)


class BinnedAUROC(_BinnedScoreMetric):
    """Streaming binary AUROC over score histograms.

    Unlike :class:`~metrics_tpu_torch.AUROC`, memory and sync cost do not
    grow with the dataset.

    Args:
        num_bins: score quantization resolution (state size and accuracy).
        num_classes: one-vs-rest over ``(N, C)`` score rows when set.
        average: ``"macro"`` | ``"weighted"`` | ``None`` (multiclass only).

    Example:
        >>> m = BinnedAUROC(num_bins=4, device="cpu")
        >>> m.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> m.compute()
        tensor(0.8750)
    """

    def compute(self) -> torch.Tensor:
        if self._is_multiclass:
            return self._ovr_scores(histogram_auroc)
        return histogram_auroc(self.hist_pos, self.hist_neg)


class BinnedPrecisionRecallCurve(_BinnedScoreMetric):
    """Streaming binary precision-recall curve over score histograms.

    Returns ``(precision, recall, thresholds)`` of length ``num_bins + 1``;
    point k classifies ``preds >= thresholds[k]`` positive
    (``thresholds[0] = +inf``, the empty-positive point). With
    ``num_classes=C``, precision and recall are ``(C, num_bins + 1)`` rows
    and the thresholds are shared.

    Example:
        >>> m = BinnedPrecisionRecallCurve(num_bins=4, device="cpu")
        >>> m.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> precision, recall, thresholds = m.compute()
        >>> recall
        tensor([0.0000, 0.5000, 0.5000, 1.0000, 1.0000])
    """

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return histogram_pr_curve(self.hist_pos, self.hist_neg)


class BinnedAveragePrecision(_BinnedScoreMetric):
    """Streaming binary average precision over score histograms.

    Example:
        >>> m = BinnedAveragePrecision(num_bins=4, device="cpu")
        >>> m.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> m.compute()
        tensor(0.8333)
    """

    def compute(self) -> torch.Tensor:
        if self._is_multiclass:
            return self._ovr_scores(histogram_average_precision)
        return histogram_average_precision(self.hist_pos, self.hist_neg)
