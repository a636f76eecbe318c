"""Hinge loss (module). Port of ``metrics_tpu/classification/hinge.py``."""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.classification.hinge import MulticlassMode, _hinge_compute, _hinge_update
from metrics_tpu_torch.metric import Metric


class Hinge(Metric):
    r"""Computes the mean Hinge loss, typically used for SVMs.

    See :func:`metrics_tpu_torch.functional.hinge` for the formulas.
    Accumulates a summed measure and a count; sync is a sum.

    Args:
        squared: if True, compute the squared hinge loss.
        multiclass_mode: None / ``'crammer-singer'`` (default) or
            ``'one-vs-all'``.

    Example (binary case):
        >>> target = torch.tensor([0, 1, 1])
        >>> preds = torch.tensor([-2.2, 2.4, 0.1])
        >>> hinge = Hinge(device="cpu")
        >>> hinge(preds, target)
        tensor(0.3000)

        >>> target = torch.tensor([0, 1, 2])
        >>> preds = torch.tensor([[-1.0, 0.9, 0.2], [0.5, -1.1, 0.8], [2.2, -0.5, 0.3]])
        >>> hinge = Hinge(device="cpu")
        >>> hinge(preds, target)
        tensor(2.9000)

        >>> hinge = Hinge(multiclass_mode="one-vs-all", device="cpu")
        >>> hinge(preds, target)
        tensor([2.2333, 1.5000, 1.2333])
    """

    _fused_forward = True  # additive counter states: one-update forward

    def __init__(
        self,
        squared: bool = False,
        multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
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

        self.add_state("measure", default=torch.tensor(0.0), dist_reduce_fx="sum")
        # f32 row counter: int32 saturates at 2^31 rows
        self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")

        if multiclass_mode not in (None, MulticlassMode.CRAMMER_SINGER, MulticlassMode.ONE_VS_ALL):
            raise ValueError(
                "The `multiclass_mode` should be either None / 'crammer-singer' / MulticlassMode.CRAMMER_SINGER"
                "(default) or 'one-vs-all' / MulticlassMode.ONE_VS_ALL,"
                f" got {multiclass_mode}."
            )

        self.squared = squared
        self.multiclass_mode = multiclass_mode

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        measure, total = _hinge_update(preds, target, squared=self.squared, multiclass_mode=self.multiclass_mode)

        self.measure = measure + self.measure
        self.total = total + self.total

    def compute(self) -> torch.Tensor:
        return _hinge_compute(self.measure, self.total)
