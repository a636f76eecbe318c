"""Mean squared log error. Port of ``metrics_tpu/functional/regression/mean_squared_log_error.py``."""
from typing import Tuple

import torch

from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.data import promote_accumulator


def _mean_squared_log_error_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, int]:
    _check_same_shape(preds, target)
    preds, target = promote_accumulator(preds, target)
    sum_squared_log_error = torch.sum((torch.log1p(preds) - torch.log1p(target)) ** 2)
    return sum_squared_log_error, target.numel()


def _mean_squared_log_error_compute(sum_squared_log_error: torch.Tensor, n_obs) -> torch.Tensor:
    return sum_squared_log_error / n_obs


def mean_squared_log_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Computes mean squared log error.

    Args:
        preds: estimated labels
        target: ground truth labels

    Example:
        >>> x = torch.tensor([0., 1, 2, 3])
        >>> y = torch.tensor([0., 1, 2, 2])
        >>> mean_squared_log_error(x, y)
        tensor(0.0207)
    """
    sum_squared_log_error, n_obs = _mean_squared_log_error_update(preds, target)
    return _mean_squared_log_error_compute(sum_squared_log_error, n_obs)
