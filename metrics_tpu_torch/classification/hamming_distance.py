"""HammingDistance (module). Port of ``metrics_tpu/classification/hamming_distance.py``."""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.classification.hamming_distance import (
    _hamming_distance_compute,
    _hamming_distance_update,
)
from metrics_tpu_torch.metric import Metric


class HammingDistance(Metric):
    r"""Computes the average Hamming distance (Hamming loss) between targets and predictions.

    Example:
        >>> target = torch.tensor([[0, 1], [1, 1]])
        >>> preds = torch.tensor([[0, 1], [0, 1]])
        >>> hamming_distance = HammingDistance(device="cpu")
        >>> hamming_distance(preds, target)
        tensor(0.2500)
    """

    _fused_forward = True  # additive counter states: one-update forward

    def __init__(
        self,
        threshold: float = 0.5,
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

        # f32 counters, as in the JAX package: an int32 count saturates at
        # 2^31 cells
        self.add_state("correct", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")

        if not 0 < threshold < 1:
            raise ValueError("The `threshold` should lie in the (0,1) interval.")
        self.threshold = threshold

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate elementwise (dis)agreement counts from a batch."""
        correct, total = _hamming_distance_update(preds, target, self.threshold)

        self.correct = self.correct + correct
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        """Hamming distance over all seen batches."""
        return _hamming_distance_compute(self.correct, self.total)
