"""PSNR (module). Port of ``metrics_tpu/regression/psnr.py``.

Two state modes, as in the JAX package: ``dim=None`` keeps 0-d sum/count
states (synced by a sum); a ``dim`` keeps list states (gathered). With
``data_range=None`` it tracks the target's running min and max in
``min``/``max``-reduced states seeded at 0.0, not at ±inf: the JAX package's
and its reference's quirk, kept (an all-positive target series reports
``min_target == 0``).
"""
from typing import Any, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.regression.psnr import _psnr_compute, _psnr_update
from metrics_tpu_torch.functional.regression.sufficient_stats import regression_sufficient_stats
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.prints import rank_zero_warn


class PSNR(Metric):
    r"""Computes peak signal-to-noise ratio (PSNR):

    .. math:: \text{PSNR}(I, J) = 10 * \log_{10} \left(\frac{\max(I)^2}{\text{MSE}(I, J)}\right)

    Args:
        data_range: the range of the data. If None, determined from the data
            (max - min); must be given when ``dim`` is not None.
        base: a base of a logarithm to use.
        reduction: ``'elementwise_mean'`` | ``'sum'`` | ``'none'``.
        dim: dimensions to reduce PSNR scores over; None reduces over all
            dimensions and batches.
        compute_on_step: forward only calls ``update()`` and returns None if False.
        dist_sync_on_step: sync state across processes at each ``forward()``.
        process_group: scope of synchronization.
        device: where the states live (default ``"cuda"``).

    Example:
        >>> psnr = PSNR(device="cpu")
        >>> preds = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> psnr(preds, target)
        tensor(2.5527)
    """

    # sum counters, min/max trackers and list states all merge by their
    # registered reduction, so the one-update forward applies in every mode
    _fused_forward = True

    def __init__(
        self,
        data_range: Optional[float] = None,
        base: float = 10.0,
        reduction: str = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            device=device,
        )

        if dim is None and reduction != "elementwise_mean":
            rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")

        if dim is None:
            self.add_state("sum_squared_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
            # f32 row counter: int32 saturates at 2^31 rows (MTA010)
            self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")
        else:
            self.add_state("sum_squared_error", default=[])
            self.add_state("total", default=[])

        if data_range is None:
            if dim is not None:
                raise ValueError("The `data_range` must be given when `dim` is not None.")

            self.data_range = None
            # seeded at 0.0, not at the reductions' ±inf identities (module docstring)
            self.add_state("min_target", default=torch.tensor(0.0), dist_reduce_fx="min")
            self.add_state("max_target", default=torch.tensor(0.0), dist_reduce_fx="max")
        else:
            self.data_range = float(data_range)
        self.base = base
        self.reduction = reduction
        self.dim = tuple(dim) if isinstance(dim, Sequence) else dim

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Update state with predictions and targets."""
        sum_squared_error, n_obs = _psnr_update(preds, target, dim=self.dim)
        if self.dim is None:
            if self.data_range is None:
                # track the target's min and max; inside a collection they
                # ride the family's shared pass
                stats = regression_sufficient_stats(preds, target) if preds.shape == target.shape else None
                tmin, tmax = (
                    (stats["min_target"], stats["max_target"])
                    if stats is not None
                    else (torch.min(target), torch.max(target))
                )
                self.min_target = torch.minimum(tmin, self.min_target)
                self.max_target = torch.maximum(tmax, self.max_target)

            self.sum_squared_error = self.sum_squared_error + sum_squared_error
            self.total = self.total + n_obs
        else:
            self.sum_squared_error.append(sum_squared_error)
            self.total.append(n_obs)

    def compute(self) -> torch.Tensor:
        """Compute peak signal-to-noise ratio over state."""
        if self.data_range is not None:
            data_range = torch.full((), self.data_range, dtype=torch.float32, device=self.device)
        else:
            data_range = self.max_target - self.min_target

        if self.dim is None:
            sum_squared_error = self.sum_squared_error
            total = self.total
        else:
            sum_squared_error = torch.cat([torch.ravel(v) for v in self.sum_squared_error])
            total = torch.cat([torch.ravel(v) for v in self.total])
        return _psnr_compute(sum_squared_error, total, data_range, base=self.base, reduction=self.reduction)
