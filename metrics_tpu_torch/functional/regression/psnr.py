"""Peak signal-to-noise ratio. Port of ``metrics_tpu/functional/regression/psnr.py``.

Counts and ranges given as Python numbers become tensors made in place on
the inputs' device (``torch.full``), so no update or compute copies from the
host. The log base's factor is computed in float32, as the JAX package
computes it.
"""
from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.regression.sufficient_stats import full_sum, regression_sufficient_stats
from metrics_tpu_torch.utilities.data import promote_accumulator
from metrics_tpu_torch.utilities.distributed import reduce
from metrics_tpu_torch.utilities.prints import rank_zero_warn


def _psnr_compute(
    sum_squared_error: torch.Tensor,
    n_obs: torch.Tensor,
    data_range: torch.Tensor,
    base: float = 10.0,
    reduction: str = "elementwise_mean",
) -> torch.Tensor:
    psnr_base_e = 2 * torch.log(data_range) - torch.log(sum_squared_error / n_obs)
    log_base = torch.log(torch.full((), base, dtype=torch.float32, device=psnr_base_e.device))
    psnr_vals = psnr_base_e * (10 / log_base)
    return reduce(psnr_vals, reduction=reduction)


def _count(n: int, shape, device: torch.device) -> torch.Tensor:
    """An int32 count tensor (the JAX package's ``jnp.asarray(size)``),
    filled on the device."""
    return torch.full(tuple(shape), n, dtype=torch.int32, device=device)


def _psnr_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if dim is None and preds.shape == target.shape:
        # collection context: one shared pass over the inputs (shape-equal
        # only: the path below broadcasts)
        stats = regression_sufficient_stats(preds, target)
        if stats is not None:
            return full_sum(stats["sum_sq_diff"]), _count(target.numel(), (), target.device)
    preds, target = promote_accumulator(preds, target)
    if dim is None:
        sum_squared_error = torch.sum((preds - target) ** 2)
        return sum_squared_error, _count(target.numel(), (), target.device)

    diff = preds - target
    dim_list = [dim] if isinstance(dim, int) else list(dim)
    if not dim_list:
        # an empty ``dim`` reduces nothing (torch.sum would reduce everything)
        return diff * diff, _count(target.numel(), (), target.device)
    sum_squared_error = torch.sum(diff * diff, dim=dim_list)
    n_obs = 1
    for d in dim_list:
        n_obs *= target.shape[d]
    return sum_squared_error, _count(n_obs, sum_squared_error.shape, target.device)


def psnr(
    preds: torch.Tensor,
    target: torch.Tensor,
    data_range: Optional[float] = None,
    base: float = 10.0,
    reduction: str = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> torch.Tensor:
    """Computes the peak signal-to-noise ratio.

    Args:
        preds: estimated signal
        target: ground truth signal
        data_range: the range of the data. If None, determined from the data
            (max - min); must be given when ``dim`` is not None.
        base: a base of a logarithm to use.
        reduction: ``'elementwise_mean'`` | ``'sum'`` | ``'none'``.
        dim: dimensions to reduce PSNR scores over; None reduces over all.

    Example:
        >>> pred = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> psnr(pred, target)
        tensor(2.5527)
    """
    if dim is None and reduction != "elementwise_mean":
        rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")

    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        data_range = torch.max(target) - torch.min(target)
    else:
        data_range = torch.full((), float(data_range), dtype=torch.float32, device=target.device)
    sum_squared_error, n_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, n_obs, data_range, base=base, reduction=reduction)
