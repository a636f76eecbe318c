"""MeanSquaredError (module). Port of ``metrics_tpu/regression/mean_squared_error.py``."""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.regression.mean_squared_error import (
    _mean_squared_error_compute,
    _mean_squared_error_update,
)
from metrics_tpu_torch.metric import Metric


class MeanSquaredError(Metric):
    """Computes mean squared error; 0-d sum/count states, synced by a sum.

    Example:
        >>> target = torch.tensor([2.5, 5.0, 4.0, 8.0])
        >>> preds = torch.tensor([3.0, 5.0, 2.5, 7.0])
        >>> mean_squared_error = MeanSquaredError(device="cpu")
        >>> mean_squared_error(preds, target)
        tensor(0.8750)
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
        self.add_state("sum_squared_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        # f32 row counter: int32 saturates at 2^31 rows (MTA010 horizon)
        self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Update state with predictions and targets."""
        sum_squared_error, n_obs = _mean_squared_error_update(preds, target)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.total = self.total + n_obs

    def compute(self) -> torch.Tensor:
        """Computes mean squared error over state."""
        return _mean_squared_error_compute(self.sum_squared_error, self.total)
