"""ConfusionMatrix (module). Port of ``metrics_tpu/classification/confusion_matrix.py``."""
from typing import Any, Optional, Union

import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _confusion_matrix_compute,
    _confusion_matrix_update,
)
from metrics_tpu_torch.metric import Metric


class ConfusionMatrix(Metric):
    """Computes the confusion matrix; state is a fixed-shape int32 ``(C, C)``
    (or ``(C, 2, 2)`` multi-label) counter, synced by a sum. A cell is exact
    up to 2^31 - 1; ``compute`` returns float32, as the JAX package does, so
    a cell above 2^24 reads rounded to float32.

    Example:
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> confmat = ConfusionMatrix(num_classes=2, device="cpu")
        >>> confmat(preds, target)
        tensor([[2., 0.],
                [1., 1.]])
    """

    _fused_forward = True  # additive counter states: one-update forward

    def __init__(
        self,
        num_classes: int,
        normalize: Optional[str] = None,
        threshold: float = 0.5,
        multilabel: bool = False,
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
        self.num_classes = num_classes
        self.normalize = normalize
        self.threshold = threshold
        self.multilabel = multilabel

        allowed_normalize = ("true", "pred", "all", "none", None)
        assert self.normalize in allowed_normalize, (
            f"Argument average needs to one of the following: {allowed_normalize}"
        )

        shape = (num_classes, 2, 2) if multilabel else (num_classes, num_classes)
        self.add_state("confmat", default=torch.zeros(shape, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate the batch confusion counts."""
        confmat = _confusion_matrix_update(preds, target, self.num_classes, self.threshold, self.multilabel)
        self.confmat = self.confmat + confmat

    def compute(self) -> torch.Tensor:
        """Confusion matrix over all seen batches (optionally normalized)."""
        return _confusion_matrix_compute(self.confmat, self.normalize)
