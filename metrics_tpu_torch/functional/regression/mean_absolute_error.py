"""Mean absolute error. Port of ``metrics_tpu/functional/regression/mean_absolute_error.py``."""
from typing import Tuple

import torch

from metrics_tpu_torch.functional.regression.sufficient_stats import full_sum, regression_sufficient_stats
from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.data import promote_accumulator


def _mean_absolute_error_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, int]:
    _check_same_shape(preds, target)
    stats = regression_sufficient_stats(preds, target)
    if stats is not None:  # collection context: one shared pass
        return full_sum(stats["sum_abs_diff"]), target.numel()
    preds, target = promote_accumulator(preds, target)
    return torch.sum(torch.abs(preds - target)), target.numel()


def _mean_absolute_error_compute(sum_abs_error: torch.Tensor, n_obs) -> torch.Tensor:
    return sum_abs_error / n_obs


def mean_absolute_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Computes mean absolute error.

    Args:
        preds: estimated labels
        target: ground truth labels

    Example:
        >>> x = torch.tensor([0., 1, 2, 3])
        >>> y = torch.tensor([0., 1, 2, 2])
        >>> mean_absolute_error(x, y)
        tensor(0.2500)
    """
    sum_abs_error, n_obs = _mean_absolute_error_update(preds, target)
    return _mean_absolute_error_compute(sum_abs_error, n_obs)
