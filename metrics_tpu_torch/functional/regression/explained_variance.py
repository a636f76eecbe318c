"""Explained variance. Port of ``metrics_tpu/functional/regression/explained_variance.py``.

The state is five moment sums, so sync is a sum; the zero-division
conventions (numerator 0 → 1, denominator 0 → 0) are ``torch.where``
selects.
"""
from typing import Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.regression.sufficient_stats import regression_sufficient_stats
from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.data import promote_accumulator


def _explained_variance_update(
    preds: torch.Tensor, target: torch.Tensor
) -> Tuple[int, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    _check_same_shape(preds, target)
    # >2-D inputs keep per-(d1, d2, ...) dim-0 moments, which the shared
    # pass does not carry (it collapses image-shaped inputs to full sums)
    stats = regression_sufficient_stats(preds, target) if preds.ndim <= 2 else None
    if stats is not None:  # collection context: one shared pass
        return (
            preds.shape[0],
            stats["sum_diff"],
            stats["sum_sq_diff"],
            stats["sum_target"],
            stats["sum_sq_target"],
        )

    preds, target = promote_accumulator(preds, target)
    diff = target - preds
    sum_error = torch.sum(diff, dim=0)
    sum_squared_error = torch.sum(diff * diff, dim=0)
    sum_target = torch.sum(target, dim=0)
    sum_squared_target = torch.sum(target * target, dim=0)
    return preds.shape[0], sum_error, sum_squared_error, sum_target, sum_squared_target


def _explained_variance_compute(
    n_obs,
    sum_error: torch.Tensor,
    sum_squared_error: torch.Tensor,
    sum_target: torch.Tensor,
    sum_squared_target: torch.Tensor,
    multioutput: str = "uniform_average",
) -> Union[torch.Tensor, Sequence[torch.Tensor]]:
    diff_avg = sum_error / n_obs
    numerator = sum_squared_error / n_obs - diff_avg * diff_avg

    target_avg = sum_target / n_obs
    denominator = sum_squared_target / n_obs - target_avg * target_avg

    # zero-division conventions of the reference: num == 0 -> 1, den == 0 -> 0
    nonzero_numerator = numerator != 0
    nonzero_denominator = denominator != 0
    safe_den = torch.where(nonzero_denominator, denominator, torch.ones_like(denominator))
    output_scores = torch.where(
        nonzero_numerator & nonzero_denominator,
        1.0 - numerator / safe_den,
        torch.where(nonzero_numerator & ~nonzero_denominator, 0.0, 1.0).to(numerator.dtype),
    )

    if multioutput == "raw_values":
        return output_scores
    if multioutput == "uniform_average":
        return torch.mean(output_scores)
    if multioutput == "variance_weighted":
        denom_sum = torch.sum(denominator)
        return torch.sum(denominator / denom_sum * output_scores)
    raise ValueError(
        "Argument `multioutput` must be either `raw_values`,"
        f" `uniform_average` or `variance_weighted`. Received {multioutput}."
    )


def explained_variance(
    preds: torch.Tensor,
    target: torch.Tensor,
    multioutput: str = "uniform_average",
) -> Union[torch.Tensor, Sequence[torch.Tensor]]:
    """Computes explained variance.

    Args:
        preds: estimated labels
        target: ground truth labels
        multioutput: one of ``'raw_values'``, ``'uniform_average'`` (default),
            ``'variance_weighted'``.

    Example:
        >>> target = torch.tensor([3., -0.5, 2, 7])
        >>> preds = torch.tensor([2.5, 0.0, 2, 8])
        >>> explained_variance(preds, target)
        tensor(0.9572)

        >>> target = torch.tensor([[0.5, 1], [-1, 1], [7, -6]])
        >>> preds = torch.tensor([[0., 2], [-1, 2], [8, -5]])
        >>> explained_variance(preds, target, multioutput='raw_values')
        tensor([0.9677, 1.0000])
    """
    n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target = _explained_variance_update(preds, target)
    return _explained_variance_compute(
        n_obs,
        sum_error,
        sum_squared_error,
        sum_target,
        sum_squared_target,
        multioutput,
    )
