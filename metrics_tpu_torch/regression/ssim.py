"""SSIM (module). Port of ``metrics_tpu/regression/ssim.py``.

Keeps the list-state design: every batch's preds and targets are buffered
(``dist_reduce_fx=None``: gathered and concatenated at sync), and the
blur runs once over the concatenation at ``compute()``.
"""
from typing import Any, Optional, Sequence, Union

import torch

from metrics_tpu_torch.functional.regression.ssim import _ssim_compute, _ssim_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.prints import rank_zero_warn


class SSIM(Metric):
    """Computes Structural Similarity Index Measure (SSIM).

    Args:
        kernel_size: size of the gaussian kernel.
        sigma: standard deviation of the gaussian kernel.
        reduction: ``'elementwise_mean'`` | ``'sum'`` | ``'none'``.
        data_range: range of the image; if None, determined from the images.
        k1: first SSIM stability constant.
        k2: second SSIM stability constant.
        compute_on_step: forward only calls ``update()`` and returns None if False.
        dist_sync_on_step: sync state across processes at each ``forward()``.
        process_group: scope of synchronization.
        device: where the states live (default ``"cuda"``).

    Example:
        >>> gen = torch.Generator().manual_seed(42)
        >>> preds = torch.rand((16, 1, 16, 16), generator=gen)
        >>> target = preds * 0.75
        >>> ssim = SSIM(device="cpu")
        >>> float(ssim(preds, target)) > 0.91
        True
    """

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: str = "elementwise_mean",
        data_range: Optional[float] = None,
        k1: float = 0.01,
        k2: float = 0.03,
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
        rank_zero_warn(
            "Metric `SSIM` will save all targets and"
            " predictions in buffer. For large datasets this may lead"
            " to large memory footprint."
        )

        self.add_state("y", default=[], dist_reduce_fx=None)
        self.add_state("y_pred", default=[], dist_reduce_fx=None)
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.reduction = reduction

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Update state with predictions and targets."""
        preds, target = _ssim_update(preds, target)
        self.y_pred.append(preds)
        self.y.append(target)

    def compute(self) -> torch.Tensor:
        """Computes SSIM over state."""
        preds = torch.cat(self.y_pred, dim=0)
        target = torch.cat(self.y, dim=0)
        return _ssim_compute(
            preds, target, self.kernel_size, self.sigma, self.reduction, self.data_range, self.k1, self.k2
        )
