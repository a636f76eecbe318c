"""Accuracy (module). Port of ``metrics_tpu/classification/accuracy.py``."""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.classification.accuracy import _accuracy_compute, _accuracy_update
from metrics_tpu_torch.metric import Metric


class Accuracy(Metric):
    r"""Computes accuracy from batches of predictions and targets.

    State: scalar ``correct`` / ``total`` counters with sum-reduce.

    Example:
        >>> target = torch.tensor([0, 1, 2, 3])
        >>> preds = torch.tensor([0, 2, 1, 3])
        >>> accuracy = Accuracy(device="cpu")
        >>> accuracy(preds, target)
        tensor(0.5000)
    """

    _fused_forward = True  # additive counter states: one-update forward

    def __init__(
        self,
        threshold: float = 0.5,
        top_k: Optional[int] = None,
        subset_accuracy: bool = False,
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

        # f32 counters, as in the JAX package: exact up to 2^24 rows and
        # within one f32 rounding beyond, where an int32 counter would wrap
        # at 2^31 rows
        self.add_state("correct", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")

        if not 0 < threshold < 1:
            raise ValueError(f"The `threshold` should be a float in the (0,1) interval, got {threshold}")

        if top_k is not None and (not isinstance(top_k, int) or top_k <= 0):
            raise ValueError(f"The `top_k` should be an integer larger than 0, got {top_k}")

        self.threshold = threshold
        self.top_k = top_k
        self.subset_accuracy = subset_accuracy

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate (correct, total) counts from a batch."""
        correct, total = _accuracy_update(
            preds, target, threshold=self.threshold, top_k=self.top_k, subset_accuracy=self.subset_accuracy
        )

        self.correct = self.correct + correct
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        """Accuracy over all seen batches (state synced across processes first)."""
        return _accuracy_compute(self.correct, self.total)
