"""MatthewsCorrcoef (module). Port of ``metrics_tpu/classification/matthews_corrcoef.py``."""
from typing import Any, Optional, Union

import torch

from metrics_tpu_torch.functional.classification.matthews_corrcoef import (
    _matthews_corrcoef_compute,
    _matthews_corrcoef_update,
)
from metrics_tpu_torch.metric import Metric


class MatthewsCorrcoef(Metric):
    r"""Matthews correlation coefficient over the accumulated int32 confusion matrix.

    Example:
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> matthews_corrcoef = MatthewsCorrcoef(num_classes=2, device="cpu")
        >>> matthews_corrcoef(preds, target)
        tensor(0.5774)
    """

    _fused_forward = True  # additive counter states: one-update forward

    def __init__(
        self,
        num_classes: int,
        threshold: float = 0.5,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Any] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        self.num_classes = num_classes
        self.threshold = threshold

        self.add_state(
            "confmat", default=torch.zeros((num_classes, num_classes), dtype=torch.int32), dist_reduce_fx="sum"
        )

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate the batch confusion counts."""
        confmat = _matthews_corrcoef_update(preds, target, self.num_classes, self.threshold)
        self.confmat = self.confmat + confmat

    def compute(self) -> torch.Tensor:
        """MCC over all seen batches."""
        return _matthews_corrcoef_compute(self.confmat)
