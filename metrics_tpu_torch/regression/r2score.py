"""R2Score (module). Port of ``metrics_tpu/regression/r2score.py``."""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.regression.r2score import _r2score_compute, _r2score_update
from metrics_tpu_torch.metric import Metric


class R2Score(Metric):
    r"""Computes r2 score (coefficient of determination):

    .. math:: R^2 = 1 - \frac{SS_{res}}{SS_{tot}}

    State is four per-output moment sums (``(num_outputs,)``) and an f32 row
    counter, synced by a sum.

    Args:
        num_outputs: number of outputs in multioutput setting.
        adjusted: number of independent regressors for the adjusted score.
        multioutput: one of ``'raw_values'``, ``'uniform_average'`` (default),
            ``'variance_weighted'``.
        compute_on_step: forward only calls ``update()`` and returns None if False.
        dist_sync_on_step: sync state across processes at each ``forward()``.
        process_group: scope of synchronization.
        device: where the states live (default ``"cuda"``).

    Example:
        >>> target = torch.tensor([3., -0.5, 2, 7])
        >>> preds = torch.tensor([2.5, 0.0, 2, 8])
        >>> r2score = R2Score(device="cpu")
        >>> r2score(preds, target)
        tensor(0.9486)

        >>> target = torch.tensor([[0.5, 1], [-1, 1], [7, -6]])
        >>> preds = torch.tensor([[0., 2], [-1, 2], [8, -5]])
        >>> r2score = R2Score(num_outputs=2, multioutput='raw_values', device="cpu")
        >>> r2score(preds, target)
        tensor([0.9654, 0.9082])
    """

    _fused_forward = True  # additive counter states: one-update forward

    def __init__(
        self,
        num_outputs: int = 1,
        adjusted: int = 0,
        multioutput: str = "uniform_average",
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
        self.num_outputs = num_outputs

        if adjusted < 0:
            raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
        self.adjusted = adjusted

        allowed_multioutput = ("raw_values", "uniform_average", "variance_weighted")
        if multioutput not in allowed_multioutput:
            raise ValueError(
                f"Invalid input to argument `multioutput`. Choose one of the following: {allowed_multioutput}"
            )
        self.multioutput = multioutput

        self.add_state("sum_squared_error", default=torch.zeros(self.num_outputs), dist_reduce_fx="sum")
        self.add_state("sum_error", default=torch.zeros(self.num_outputs), dist_reduce_fx="sum")
        self.add_state("residual", default=torch.zeros(self.num_outputs), dist_reduce_fx="sum")
        # f32 row counter: int32 saturates at 2^31 rows (MTA010 horizon)
        self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Update state with predictions and targets."""
        sum_squared_error, sum_error, residual, total = _r2score_update(preds, target)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.sum_error = self.sum_error + sum_error
        self.residual = self.residual + residual
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        """Computes r2 score over state."""
        return _r2score_compute(
            self.sum_squared_error, self.sum_error, self.residual, self.total, self.adjusted, self.multioutput
        )
