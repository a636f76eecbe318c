"""R2 score. Port of ``metrics_tpu/functional/regression/r2score.py``."""
from typing import Tuple

import torch

from metrics_tpu_torch.functional.regression.sufficient_stats import regression_sufficient_stats
from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.data import promote_accumulator
from metrics_tpu_torch.utilities.prints import rank_zero_warn


def _r2score_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    _check_same_shape(preds, target)
    if preds.ndim > 2:
        raise ValueError(
            "Expected both prediction and target to be 1D or 2D tensors,"
            f" but received tensors with dimension {tuple(preds.shape)}"
        )
    if preds.shape[0] < 2:
        raise ValueError("Needs at least two samples to calculate r2 score.")

    stats = regression_sufficient_stats(preds, target)
    if stats is not None:  # collection context: one shared pass
        return stats["sum_sq_target"], stats["sum_target"], stats["sum_sq_diff"], target.shape[0]

    preds, target = promote_accumulator(preds, target)
    sum_error = torch.sum(target, dim=0)
    sum_squared_error = torch.sum(target * target, dim=0)
    diff = target - preds
    residual = torch.sum(diff * diff, dim=0)
    return sum_squared_error, sum_error, residual, target.shape[0]


def _r2score_compute(
    sum_squared_error: torch.Tensor,
    sum_error: torch.Tensor,
    residual: torch.Tensor,
    total,
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> torch.Tensor:
    mean_error = sum_error / total
    diff = sum_squared_error - sum_error * mean_error
    raw_scores = 1 - (residual / diff)

    if multioutput == "raw_values":
        r2score = raw_scores
    elif multioutput == "uniform_average":
        r2score = torch.mean(raw_scores)
    elif multioutput == "variance_weighted":
        diff_sum = torch.sum(diff)
        r2score = torch.sum(diff / diff_sum * raw_scores)
    else:
        raise ValueError(
            "Argument `multioutput` must be either `raw_values`,"
            f" `uniform_average` or `variance_weighted`. Received {multioutput}."
        )

    if adjusted < 0 or not isinstance(adjusted, int):
        raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")

    if adjusted != 0:
        # the one host read of the family, as in the JAX package
        total = int(total)
        if adjusted > total - 1:
            rank_zero_warn(
                "More independent regressions than data points in"
                " adjusted r2 score. Falls back to standard r2 score.",
                UserWarning,
            )
        elif adjusted == total - 1:
            rank_zero_warn("Division by zero in adjusted r2 score. Falls back to standard r2 score.", UserWarning)
        else:
            r2score = 1 - (1 - r2score) * (total - 1) / (total - adjusted - 1)
    return r2score


def r2score(
    preds: torch.Tensor,
    target: torch.Tensor,
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> torch.Tensor:
    r"""Computes r2 score (coefficient of determination):

    .. math:: R^2 = 1 - \frac{SS_{res}}{SS_{tot}}

    Args:
        preds: estimated labels
        target: ground truth labels
        adjusted: number of independent regressors for the adjusted score.
        multioutput: one of ``'raw_values'``, ``'uniform_average'`` (default),
            ``'variance_weighted'``.

    Example:
        >>> target = torch.tensor([3., -0.5, 2, 7])
        >>> preds = torch.tensor([2.5, 0.0, 2, 8])
        >>> r2score(preds, target)
        tensor(0.9486)

        >>> target = torch.tensor([[0.5, 1], [-1, 1], [7, -6]])
        >>> preds = torch.tensor([[0., 2], [-1, 2], [8, -5]])
        >>> r2score(preds, target, multioutput='raw_values')
        tensor([0.9654, 0.9082])
    """
    sum_squared_error, sum_error, residual, total = _r2score_update(preds, target)
    return _r2score_compute(sum_squared_error, sum_error, residual, total, adjusted, multioutput)
