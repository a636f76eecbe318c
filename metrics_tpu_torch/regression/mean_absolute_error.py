"""MeanAbsoluteError (module). Port of ``metrics_tpu/regression/mean_absolute_error.py``."""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.regression.mean_absolute_error import (
    _mean_absolute_error_compute,
    _mean_absolute_error_update,
)
from metrics_tpu_torch.metric import Metric


class MeanAbsoluteError(Metric):
    """Computes mean absolute error; 0-d sum/count states, synced by a sum.

    Example:
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> mean_absolute_error = MeanAbsoluteError(device="cpu")
        >>> mean_absolute_error(preds, target)
        tensor(0.5000)
    """

    _fused_forward = True  # additive counter states: one-update forward

    def __init__(
        self,
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
        self.add_state("sum_abs_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        # f32 row counter: int32 saturates at 2^31 rows (MTA010 horizon)
        self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Update state with predictions and targets."""
        sum_abs_error, n_obs = _mean_absolute_error_update(preds, target)
        self.sum_abs_error = self.sum_abs_error + sum_abs_error
        self.total = self.total + n_obs

    def compute(self) -> torch.Tensor:
        """Computes mean absolute error over state."""
        return _mean_absolute_error_compute(self.sum_abs_error, self.total)
