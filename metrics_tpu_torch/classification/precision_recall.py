"""Precision / Recall (modules). Port of ``metrics_tpu/classification/precision_recall.py``.

Both subclass :class:`~metrics_tpu_torch.classification.stat_scores.StatScores`
and override only ``compute``.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.functional.classification.precision_recall import _precision_compute, _recall_compute


class Precision(StatScores):
    r"""Computes precision ``TP / (TP + FP)`` under configurable averaging.

    Example:
        >>> preds  = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> precision = Precision(average='macro', num_classes=3, device="cpu")
        >>> precision(preds, target)
        tensor(0.1667)
        >>> precision = Precision(average='micro', device="cpu")
        >>> precision(preds, target)
        tensor(0.2500)
    """

    def __init__(
        self,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: str = "micro",
        mdmc_average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        is_multiclass: Optional[bool] = None,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        allowed_average = ["micro", "macro", "weighted", "samples", "none", None]
        if average not in allowed_average:
            raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")

        super().__init__(
            reduce="macro" if average in ["weighted", "none", None] else average,
            mdmc_reduce=mdmc_average,
            threshold=threshold,
            top_k=top_k,
            num_classes=num_classes,
            is_multiclass=is_multiclass,
            ignore_index=ignore_index,
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )

        self.average = average

    def compute(self) -> torch.Tensor:
        """Precision over all seen batches; shape ``()`` or ``(C,)`` per ``average``."""
        tp, fp, tn, fn = self._get_final_stats()
        return _precision_compute(tp, fp, tn, fn, self.average, self.mdmc_reduce)


class Recall(StatScores):
    r"""Computes recall ``TP / (TP + FN)`` under configurable averaging.

    Example:
        >>> preds  = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> recall = Recall(average='macro', num_classes=3, device="cpu")
        >>> recall(preds, target)
        tensor(0.3333)
        >>> recall = Recall(average='micro', device="cpu")
        >>> recall(preds, target)
        tensor(0.2500)
    """

    def __init__(
        self,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: str = "micro",
        mdmc_average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        is_multiclass: Optional[bool] = None,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        allowed_average = ["micro", "macro", "weighted", "samples", "none", None]
        if average not in allowed_average:
            raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")

        super().__init__(
            reduce="macro" if average in ["weighted", "none", None] else average,
            mdmc_reduce=mdmc_average,
            threshold=threshold,
            top_k=top_k,
            num_classes=num_classes,
            is_multiclass=is_multiclass,
            ignore_index=ignore_index,
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )

        self.average = average

    def compute(self) -> torch.Tensor:
        """Recall over all seen batches; shape ``()`` or ``(C,)`` per ``average``."""
        tp, fp, tn, fn = self._get_final_stats()
        return _recall_compute(tp, fp, tn, fn, self.average, self.mdmc_reduce)
