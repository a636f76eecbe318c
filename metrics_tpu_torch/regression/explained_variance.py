"""ExplainedVariance (module). Port of ``metrics_tpu/regression/explained_variance.py``.

State is five moment sums, so sync is a sum whatever the dataset's size.
The 0-d 0.0 defaults broadcast to per-output sums at the first update, as in
the JAX package.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.regression.explained_variance import (
    _explained_variance_compute,
    _explained_variance_update,
)
from metrics_tpu_torch.metric import Metric


class ExplainedVariance(Metric):
    r"""Computes explained variance:

    .. math:: \text{ExplainedVariance} = 1 - \frac{\text{Var}(y - \hat{y})}{\text{Var}(y)}

    Args:
        multioutput: one of ``'raw_values'``, ``'uniform_average'`` (default),
            ``'variance_weighted'``.
        compute_on_step: forward only calls ``update()`` and returns None if False.
        dist_sync_on_step: sync state across processes at each ``forward()``.
        process_group: scope of synchronization.
        device: where the states live (default ``"cuda"``).

    Example:
        >>> target = torch.tensor([3., -0.5, 2, 7])
        >>> preds = torch.tensor([2.5, 0.0, 2, 8])
        >>> explained_variance = ExplainedVariance(device="cpu")
        >>> explained_variance(preds, target)
        tensor(0.9572)

        >>> target = torch.tensor([[0.5, 1], [-1, 1], [7, -6]])
        >>> preds = torch.tensor([[0., 2], [-1, 2], [8, -5]])
        >>> explained_variance = ExplainedVariance(multioutput='raw_values', device="cpu")
        >>> explained_variance(preds, target)
        tensor([0.9677, 1.0000])
    """

    _fused_forward = True  # additive counter states: one-update forward

    def __init__(
        self,
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
        allowed_multioutput = ("raw_values", "uniform_average", "variance_weighted")
        if multioutput not in allowed_multioutput:
            raise ValueError(
                f"Invalid input to argument `multioutput`. Choose one of the following: {allowed_multioutput}"
            )
        self.multioutput = multioutput
        self.add_state("sum_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("sum_squared_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("sum_target", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("sum_squared_target", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("n_obs", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Update state with predictions and targets."""
        n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target = _explained_variance_update(
            preds, target
        )
        self.n_obs = self.n_obs + n_obs
        self.sum_error = self.sum_error + sum_error
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.sum_target = self.sum_target + sum_target
        self.sum_squared_target = self.sum_squared_target + sum_squared_target

    def compute(self) -> torch.Tensor:
        """Computes explained variance over state."""
        return _explained_variance_compute(
            self.n_obs,
            self.sum_error,
            self.sum_squared_error,
            self.sum_target,
            self.sum_squared_target,
            self.multioutput,
        )
