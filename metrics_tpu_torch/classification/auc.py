"""AUC (module). Port of ``metrics_tpu/classification/auc.py``."""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.classification.auc import _auc_compute, _auc_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities import rank_zero_warn
from metrics_tpu_torch.utilities.data import dim_zero_cat


class AUC(Metric):
    """Computes Area Under the Curve from accumulated ``(x, y)`` points.

    Example:
        >>> auc = AUC(device="cpu")
        >>> auc(torch.tensor([0, 1, 2, 3]), torch.tensor([0, 1, 2, 2]))
        tensor(4.)
    """

    def __init__(
        self,
        reorder: bool = False,
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

        self.reorder = reorder

        self.add_state("x", default=[], dist_reduce_fx=None)
        self.add_state("y", default=[], dist_reduce_fx=None)

        rank_zero_warn(
            "Metric `AUC` will save all targets and predictions in buffer."
            " For large datasets this may lead to large memory footprint."
        )

    def update(self, x: torch.Tensor, y: torch.Tensor) -> None:
        """Append the batch of curve points."""
        x, y = _auc_update(x, y)
        self.x.append(x)
        self.y.append(y)

    def compute(self) -> torch.Tensor:
        """AUC over all accumulated points."""
        x = dim_zero_cat(self.x)
        y = dim_zero_cat(self.y)
        return _auc_compute(x, y, reorder=self.reorder)
