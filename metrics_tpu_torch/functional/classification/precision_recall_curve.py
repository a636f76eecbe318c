"""Precision-recall curve inputs (functional).

Port of ``_precision_recall_curve_update`` from
``metrics_tpu/functional/classification/precision_recall_curve.py``: the
canonicalization that average precision shares with the curve. The curve's
compute is not ported yet (``ROADMAP.md``, Queue 1 item 6, the curve family).
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utilities import warn_once


def _precision_recall_curve_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int, Optional[int]]:
    """Canonicalize curve inputs to ``(N,)`` binary or ``(N, C)`` column form."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    if not (preds.ndim == target.ndim or preds.ndim == target.ndim + 1):
        raise ValueError("preds and target must have same number of dimensions, or one additional dimension for preds")

    if preds.ndim == target.ndim:
        if pos_label is None:
            # fires per update call on the binary path: rate-limit it
            warn_once("`pos_label` automatically set 1.", key="prc-pos-label-default")
            pos_label = 1
        if num_classes is not None and num_classes != 1:
            # multilabel problem
            if num_classes != preds.shape[1]:
                raise ValueError(
                    f"Argument `num_classes` was set to {num_classes} in"
                    f" metric `precision_recall_curve` but detected {preds.shape[1]}"
                    " number of classes from predictions"
                )
            preds = torch.swapaxes(preds, 0, 1).reshape(num_classes, -1).T
            target = torch.swapaxes(target, 0, 1).reshape(num_classes, -1).T
        else:
            # binary problem
            preds = preds.reshape(-1)
            target = target.reshape(-1)
            num_classes = 1

    # multi class problem
    if preds.ndim == target.ndim + 1:
        if pos_label is not None:
            warn_once(
                "Argument `pos_label` should be `None` when running"
                f" multiclass precision recall curve. Got {pos_label}",
                key="prc-pos-label-multiclass",
            )
        if num_classes != preds.shape[1]:
            raise ValueError(
                f"Argument `num_classes` was set to {num_classes} in"
                f" metric `precision_recall_curve` but detected {preds.shape[1]}"
                " number of classes from predictions"
            )
        preds = torch.swapaxes(preds, 0, 1).reshape(num_classes, -1).T
        target = target.reshape(-1)

    return preds, target, num_classes, pos_label
