"""CohenKappa (module). Port of ``metrics_tpu/classification/cohen_kappa.py``."""
from typing import Any, Optional, Union

import torch

from metrics_tpu_torch.functional.classification.cohen_kappa import _cohen_kappa_compute, _cohen_kappa_update
from metrics_tpu_torch.metric import Metric


class CohenKappa(Metric):
    r"""Cohen's kappa: inter-annotator agreement corrected for chance, over
    an int32 confusion-matrix state.

    Example:
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> cohenkappa = CohenKappa(num_classes=2, device="cpu")
        >>> cohenkappa(preds, target)
        tensor(0.5000)
    """

    _fused_forward = True  # additive counter states: one-update forward

    # metrics-tpu: allow(MTA010) — deliberate: confmat stays int32. The
    # kappa expected-agreement arithmetic needs exact cell counts; the
    # 2^31-rows horizon is recorded in NUMERICS_BASELINE.json and
    # StateGuard(overflow_margin=...) warns before saturation at run time.
    def __init__(
        self,
        num_classes: int,
        weights: Optional[str] = None,
        threshold: float = 0.5,
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
        self.weights = weights
        self.threshold = threshold

        allowed_weights = ("linear", "quadratic", "none", None)
        if self.weights not in allowed_weights:
            raise ValueError(f"Argument weights needs to one of the following: {allowed_weights}")

        self.add_state(
            "confmat", default=torch.zeros((num_classes, num_classes), dtype=torch.int32), dist_reduce_fx="sum"
        )

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate the batch confusion counts."""
        confmat = _cohen_kappa_update(preds, target, self.num_classes, self.threshold)
        self.confmat = self.confmat + confmat

    def compute(self) -> torch.Tensor:
        """Cohen's kappa over all seen batches."""
        return _cohen_kappa_compute(self.confmat, self.weights)
