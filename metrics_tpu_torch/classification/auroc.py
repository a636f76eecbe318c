"""AUROC (module). Port of ``metrics_tpu/classification/auroc.py``."""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.functional.classification.auroc import _auroc_compute, _auroc_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities import rank_zero_warn
from metrics_tpu_torch.utilities.data import dim_zero_cat
from metrics_tpu_torch.utilities.enums import DataType


class AUROC(Metric):
    """Computes Area Under the Receiver Operating Characteristic Curve.

    The states are lists of every batch's predictions and targets; compute
    concatenates them and runs the exact co-sort + tie-scan path (binary
    inputs, or every class or label of multi-class and multi-label inputs in
    one batched launch; see
    :mod:`metrics_tpu_torch.functional.classification.auroc`). Multi-dim
    inputs are flattened to ``(N, C)`` at update.

    Example:
        >>> preds = torch.tensor([0.13, 0.26, 0.08, 0.19, 0.34])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> auroc = AUROC(pos_label=1, device="cpu")
        >>> auroc(preds, target)
        tensor(0.5000)
    """

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
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
        self.average = average
        self.max_fpr = max_fpr

        allowed_average = (None, "macro", "weighted", "micro")
        if self.average not in allowed_average:
            raise ValueError(
                f"Argument `average` expected to be one of the following: {allowed_average} but got {average}"
            )

        if self.max_fpr is not None:
            if not isinstance(max_fpr, float) or not 0 < max_fpr <= 1:
                raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")

        self.mode = None
        self.add_state("preds", default=[], dist_reduce_fx=None)
        self.add_state("target", default=[], dist_reduce_fx=None)

        rank_zero_warn(
            "Metric `AUROC` will save all targets and predictions in buffer."
            " For large datasets this may lead to large memory footprint."
        )

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Append the batch; the input mode must stay constant across batches."""
        preds, target, mode = _auroc_update(preds, target)

        self.preds.append(preds)
        self.target.append(target)

        if self.mode is not None and self.mode != mode:
            raise ValueError(
                "The mode of data (binary, multi-label, multi-class) should be constant, but changed"
                f" between batches from {self.mode} to {mode}"
            )
        self.mode = mode

    def load_state_dict(
        self,
        state_dict: dict,
        prefix: str = "",
        strict: bool = False,
        _warn_on_zero_match: bool = True,
    ) -> None:
        # `mode` is host-side bookkeeping derived from the first batch; a
        # restore bypasses update(), so re-derive it from the canonical shapes
        # the stored states are in (binary -> 1-d preds, multiclass -> (N, C)
        # preds + (N,) target, multilabel -> both 2-d)
        super().load_state_dict(state_dict, prefix, strict=strict, _warn_on_zero_match=_warn_on_zero_match)
        if self.mode is None and self.preds:
            p0, t0 = self.preds[0], self.target[0]
            if p0.ndim == 1:
                self.mode = DataType.BINARY
            elif t0.ndim == p0.ndim:
                self.mode = DataType.MULTILABEL
            else:
                self.mode = DataType.MULTICLASS

    def compute(self) -> torch.Tensor:
        """AUROC over all seen batches."""
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _auroc_compute(
            preds,
            target,
            self.mode,
            self.num_classes,
            self.pos_label,
            self.average,
            self.max_fpr,
        )
