"""StatScores (module) and the shared ``_reduce_stat_scores`` averaging helper.

Port of ``metrics_tpu/classification/stat_scores.py``. State is either
int32 sum counters or, under ``reduce='samples'`` /
``mdmc_reduce='samplewise'``, per-batch lists synced by concatenation.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.stat_scores import _stat_scores_compute, _stat_scores_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.enums import AverageMethod, MDMCAverageMethod


class StatScores(Metric):
    """Computes true/false positives/negatives under configurable reductions.

    The counters are int32, as in the JAX package: exact up to 2^31 - 1 per
    counter. A batch's counts are summed in int64 before the cast, so a
    per-class count past 2^24 stays exact. ``reduce="micro"`` sums every
    class into one ``tn``, which reaches 2^31 after about 2^31 / C
    positions.

    Example:
        >>> preds  = torch.tensor([1, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> stat_scores = StatScores(reduce='macro', num_classes=3, device="cpu")
        >>> stat_scores(preds, target)
        tensor([[0, 1, 2, 1, 1],
                [1, 1, 1, 1, 2],
                [1, 0, 3, 0, 1]], dtype=torch.int32)
        >>> stat_scores = StatScores(reduce='micro', device="cpu")
        >>> stat_scores(preds, target)
        tensor([2, 2, 6, 2, 4], dtype=torch.int32)
    """

    _fused_forward = True  # additive counter states: one-update forward

    # metrics-tpu: allow(MTA010) — deliberate: tp/fp/tn/fn stay int32.
    # Exact integer counts are this family's contract (every derived
    # Precision/Recall/F1/FBeta ratio and the doctests pin int32), the
    # 2^31-row saturation horizon is recorded per state in
    # NUMERICS_BASELINE.json for review, and the runtime mitigation is
    # StateGuard(overflow_margin=...) — warn + count before saturation.
    def __init__(
        self,
        threshold: float = 0.5,
        top_k: Optional[int] = None,
        reduce: str = "micro",
        num_classes: Optional[int] = None,
        ignore_index: Optional[int] = None,
        mdmc_reduce: Optional[str] = None,
        is_multiclass: Optional[bool] = None,
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

        self.reduce = reduce
        self.mdmc_reduce = mdmc_reduce
        self.num_classes = num_classes
        self.threshold = threshold
        self.is_multiclass = is_multiclass
        self.ignore_index = ignore_index
        self.top_k = top_k

        if not 0 < threshold < 1:
            raise ValueError(f"The `threshold` should be a float in the (0,1) interval, got {threshold}")

        if reduce not in ["micro", "macro", "samples"]:
            raise ValueError(f"The `reduce` {reduce} is not valid.")

        if mdmc_reduce not in [None, "samplewise", "global"]:
            raise ValueError(f"The `mdmc_reduce` {mdmc_reduce} is not valid.")

        if reduce == "macro" and (not num_classes or num_classes < 1):
            raise ValueError("When you set `reduce` as 'macro', you have to provide the number of classes.")

        if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
            raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

        for s in ("tp", "fp", "tn", "fn"):
            if mdmc_reduce != "samplewise" and reduce != "samples":
                zeros_shape = () if reduce == "micro" else (num_classes,)
                self.add_state(s, default=torch.zeros(zeros_shape, dtype=torch.int32), dist_reduce_fx="sum")
            else:
                self.add_state(s, default=[], dist_reduce_fx=None)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate tp/fp/tn/fn from a batch of predictions and targets."""
        tp, fp, tn, fn = _stat_scores_update(
            preds,
            target,
            reduce=self.reduce,
            mdmc_reduce=self.mdmc_reduce,
            threshold=self.threshold,
            num_classes=self.num_classes,
            top_k=self.top_k,
            is_multiclass=self.is_multiclass,
            ignore_index=self.ignore_index,
        )

        if self.reduce != "samples" and self.mdmc_reduce != "samplewise":
            self.tp = self.tp + tp
            self.fp = self.fp + fp
            self.tn = self.tn + tn
            self.fn = self.fn + fn
        else:
            self.tp.append(tp)
            self.fp.append(fp)
            self.tn.append(tn)
            self.fn.append(fn)

    def _get_final_stats(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Concatenate list states if necessary before compute."""
        if isinstance(self.tp, list):
            return torch.cat(self.tp), torch.cat(self.fp), torch.cat(self.tn), torch.cat(self.fn)
        return self.tp, self.fp, self.tn, self.fn

    def compute(self) -> torch.Tensor:
        """Return ``(..., 5) = [tp, fp, tn, fn, support]`` over all seen batches."""
        tp, fp, tn, fn = self._get_final_stats()
        return _stat_scores_compute(tp, fp, tn, fn)


def _reduce_stat_scores(
    numerator: torch.Tensor,
    denominator: torch.Tensor,
    weights: Optional[torch.Tensor],
    average: Optional[str],
    mdmc_average: Optional[str],
    zero_division: int = 0,
) -> torch.Tensor:
    """Average ``numerator/denominator`` scores with zero-division and ignore masking.

    Negative denominators mark ignored classes (NaN under ``average=None``,
    dropped from averages otherwise); zero denominators score
    ``zero_division``, and so does a weighted average whose weights sum to 0.
    """
    numerator, denominator = numerator.to(torch.float32), denominator.to(torch.float32)
    zero_div_mask = denominator == 0
    ignore_mask = denominator < 0

    if weights is None:
        weights = torch.ones_like(denominator)
    else:
        weights = weights.to(torch.float32)

    numerator = torch.where(zero_div_mask, float(zero_division), numerator)
    denominator = torch.where(zero_div_mask | ignore_mask, 1.0, denominator)
    weights = torch.where(ignore_mask, 0.0, weights)

    if average not in (AverageMethod.MICRO, AverageMethod.NONE, None):
        weights = weights / torch.sum(weights, dim=-1, keepdim=True)

    scores = weights * (numerator / denominator)

    # sum(weights) == 0 happens if the only present class is ignored with average='weighted'
    scores = torch.where(torch.isnan(scores), float(zero_division), scores)

    if mdmc_average == MDMCAverageMethod.SAMPLEWISE:
        scores = torch.mean(scores, dim=0)
        ignore_mask = torch.sum(ignore_mask, dim=0).to(torch.bool)

    if average in (AverageMethod.NONE, None):
        scores = torch.where(ignore_mask, float("nan"), scores)
    else:
        scores = torch.sum(scores)

    return scores
