"""Mean relative error. Port of ``metrics_tpu/functional/regression/mean_relative_error.py``.

A zero target is replaced by 1 in the divisor (``torch.where``), as the JAX
package and its reference do.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utilities.checks import _check_same_shape
from metrics_tpu_torch.utilities.data import promote_accumulator


def _mean_relative_error_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, int]:
    _check_same_shape(preds, target)
    preds, target = promote_accumulator(preds, target)
    target_nz = torch.where(target == 0, torch.ones_like(target), target)
    sum_rltv_error = torch.sum(torch.abs((preds - target) / target_nz))
    return sum_rltv_error, target.numel()


def _mean_relative_error_compute(sum_rltv_error: torch.Tensor, n_obs) -> torch.Tensor:
    return sum_rltv_error / n_obs


def mean_relative_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Computes mean relative error.

    Args:
        preds: estimated labels
        target: ground truth labels

    Example:
        >>> x = torch.tensor([0., 1, 2, 3])
        >>> y = torch.tensor([0., 1, 2, 2])
        >>> mean_relative_error(x, y)
        tensor(0.1250)
    """
    sum_rltv_error, n_obs = _mean_relative_error_update(preds, target)
    return _mean_relative_error_compute(sum_rltv_error, n_obs)
