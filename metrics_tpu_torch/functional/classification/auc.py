"""Area under an arbitrary curve by the trapezoidal rule (functional).

Port of ``metrics_tpu/functional/classification/auc.py``: ``torch.trapezoid``
with the same direction check, which reads two reductions to the host as the
JAX package does. ``reorder=True`` sorts every point (see
:func:`~metrics_tpu_torch.utilities.data._stable_1d_sort`).
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utilities.data import _stable_1d_sort


def _auc_update(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = torch.as_tensor(x)
    y = torch.as_tensor(y)
    if x.ndim > 1 or y.ndim > 1:
        raise ValueError(
            f"Expected both `x` and `y` tensor to be 1d, but got tensors with dimention {x.ndim} and {y.ndim}"
        )
    if x.numel() != y.numel():
        raise ValueError(
            f"Expected the same number of elements in `x` and `y` tensor but received {x.numel()} and {y.numel()}"
        )
    return x, y


def _auc_compute(x: torch.Tensor, y: torch.Tensor, reorder: bool = False) -> torch.Tensor:
    """Direction-aware trapezoid: a non-increasing ``x`` integrates to the
    same area as its increasing mirror."""
    if reorder:
        x, x_idx = _stable_1d_sort(x)
        y = y[x_idx]

    dx = x[1:] - x[:-1]
    if bool(torch.any(dx < 0)):
        if bool(torch.all(dx <= 0)):
            direction = -1.0
        else:
            raise ValueError(
                "The `x` tensor is neither increasing or decreasing. Try setting the reorder argument to `True`."
            )
    else:
        direction = 1.0
    return direction * torch.trapezoid(y, x)


def auc(x: torch.Tensor, y: torch.Tensor, reorder: bool = False) -> torch.Tensor:
    """Computes Area Under the Curve (AUC) using the trapezoidal rule, on the
    device the inputs are on.

    Args:
        x: x-coordinates
        y: y-coordinates
        reorder: if True, sorts ``x`` (stably) before integrating

    Example:
        >>> x = torch.tensor([0, 1, 2, 3])
        >>> y = torch.tensor([0, 1, 2, 2])
        >>> auc(x, y)
        tensor(4.)
        >>> auc(x, y, reorder=True)
        tensor(4.)
    """
    x, y = _auc_update(x, y)
    return _auc_compute(x, y, reorder=reorder)
