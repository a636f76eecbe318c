"""PrecisionRecallCurve (module). Port of ``metrics_tpu/classification/precision_recall_curve.py``."""
from typing import Any, Callable, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _precision_recall_curve_compute,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities import rank_zero_warn
from metrics_tpu_torch.utilities.data import dim_zero_cat


class PrecisionRecallCurve(Metric):
    """Computes precision-recall pairs for different thresholds.

    The states are lists of every batch's canonicalized predictions and
    targets; compute concatenates them and builds every class's curve in
    one pass.

    Example:
        >>> pred = torch.tensor([0, 1, 2, 3])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> pr_curve = PrecisionRecallCurve(pos_label=1, device="cpu")
        >>> precision, recall, thresholds = pr_curve(pred, target)
        >>> precision
        tensor([0.6667, 0.5000, 0.0000, 1.0000])
    """

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
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

        self.num_classes = num_classes
        self.pos_label = pos_label

        self.add_state("preds", default=[], dist_reduce_fx=None)
        self.add_state("target", default=[], dist_reduce_fx=None)

        rank_zero_warn(
            "Metric `PrecisionRecallCurve` will save all targets and predictions in buffer."
            " For large datasets this may lead to large memory footprint."
        )

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Append the canonicalized batch to the curve buffers."""
        preds, target, num_classes, pos_label = _precision_recall_curve_update(
            preds, target, self.num_classes, self.pos_label
        )
        self.preds.append(preds)
        self.target.append(target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def load_state_dict(
        self,
        state_dict: dict,
        prefix: str = "",
        strict: bool = False,
        _warn_on_zero_match: bool = True,
    ) -> None:
        # `num_classes`/`pos_label` are derived from the first batch by
        # update(); a restore bypasses update, so re-derive them by running
        # the canonicalizer on the (already canonical) stored batch
        super().load_state_dict(state_dict, prefix, strict=strict, _warn_on_zero_match=_warn_on_zero_match)
        if self.num_classes is None and self.preds:
            _, _, self.num_classes, self.pos_label = _precision_recall_curve_update(
                self.preds[0], self.target[0], self.num_classes, self.pos_label
            )

    def compute(self) -> Union[Tuple[torch.Tensor, ...], Tuple[List[torch.Tensor], ...]]:
        """``(precision, recall, thresholds)`` over all seen batches."""
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _precision_recall_curve_compute(preds, target, self.num_classes, self.pos_label)
