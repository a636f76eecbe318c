"""FBeta / F1 (functional). Port of ``metrics_tpu/functional/classification/f_beta.py``."""
from typing import Optional

import torch

from metrics_tpu_torch.classification.stat_scores import _reduce_stat_scores
from metrics_tpu_torch.functional.classification.stat_scores import _stat_scores_update
from metrics_tpu_torch.utilities.enums import AverageMethod, MDMCAverageMethod


def _safe_divide(num: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """Division that treats 0-denominators as 1 (prevents NaN)."""
    return num / torch.where(denom == 0.0, 1.0, denom)


def _fbeta_compute(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    beta: float,
    ignore_index: Optional[int],
    average: Optional[str],
    mdmc_average: Optional[str],
) -> torch.Tensor:
    if average == "micro" and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        # mask out -1 sentinel entries (ignored class under macro counting)
        mask = tp >= 0
        precision = _safe_divide(torch.sum(torch.where(mask, tp, 0)).to(torch.float32),
                                 torch.sum(torch.where(mask, tp + fp, 0)).to(torch.float32))
        recall = _safe_divide(torch.sum(torch.where(mask, tp, 0)).to(torch.float32),
                              torch.sum(torch.where(mask, tp + fn, 0)).to(torch.float32))
    else:
        precision = _safe_divide(tp.to(torch.float32), (tp + fp).to(torch.float32))
        recall = _safe_divide(tp.to(torch.float32), (tp + fn).to(torch.float32))

    num = (1 + beta ** 2) * precision * recall
    denom = beta ** 2 * precision + recall
    denom = torch.where(denom == 0.0, 1.0, denom)  # avoid division by 0

    if ignore_index is not None:
        if (
            average not in (AverageMethod.MICRO.value, AverageMethod.SAMPLES.value)
            and mdmc_average == MDMCAverageMethod.SAMPLEWISE
        ):
            num, denom = num.clone(), denom.clone()
            num[..., ignore_index] = -1
            denom[..., ignore_index] = -1
        elif average not in (AverageMethod.MICRO.value, AverageMethod.SAMPLES.value):
            num, denom = num.clone(), denom.clone()
            num[ignore_index, ...] = -1
            denom[ignore_index, ...] = -1

    return _reduce_stat_scores(
        numerator=num,
        denominator=denom,
        weights=None if average != "weighted" else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def fbeta(
    preds: torch.Tensor,
    target: torch.Tensor,
    beta: float = 1.0,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    is_multiclass: Optional[bool] = None,
) -> torch.Tensor:
    r"""Computes the F-beta score (weighted harmonic mean of precision and recall).

    Example:
        >>> target = torch.tensor([0, 1, 2, 0, 1, 2])
        >>> preds = torch.tensor([0, 2, 1, 0, 0, 1])
        >>> fbeta(preds, target, num_classes=3, beta=0.5)
        tensor(0.3333)
    """
    allowed_average = ["micro", "macro", "weighted", "samples", "none", None]
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")

    allowed_mdmc_average = [None, "samplewise", "global"]
    if mdmc_average not in allowed_mdmc_average:
        raise ValueError(f"The `mdmc_average` has to be one of {allowed_mdmc_average}, got {mdmc_average}.")

    if average in ["macro", "weighted", "none", None] and (not num_classes or num_classes < 1):
        raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")

    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

    reduce = "macro" if average in ["weighted", "none", None] else average
    tp, fp, tn, fn = _stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_average,
        threshold=threshold,
        num_classes=num_classes,
        top_k=top_k,
        is_multiclass=is_multiclass,
        ignore_index=ignore_index,
    )

    return _fbeta_compute(tp, fp, tn, fn, beta, ignore_index, average, mdmc_average)


def f1(
    preds: torch.Tensor,
    target: torch.Tensor,
    beta: float = 1.0,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    is_multiclass: Optional[bool] = None,
) -> torch.Tensor:
    r"""Computes the F1 score (``fbeta`` with beta=1).

    Example:
        >>> target = torch.tensor([0, 1, 2, 0, 1, 2])
        >>> preds = torch.tensor([0, 2, 1, 0, 0, 1])
        >>> f1(preds, target, num_classes=3)
        tensor(0.3333)
    """
    return fbeta(preds, target, 1.0, average, mdmc_average, ignore_index, num_classes, threshold, top_k, is_multiclass)
