"""Confusion matrix (functional). Port of ``metrics_tpu/functional/classification/confusion_matrix.py``.

The count is a fixed-length ``label_bincount`` of ``target * C + pred``
(``(C, 2, 2)`` cells of ``2 * target + pred`` per label for multi-label).
The common cases threshold or argmax the raw inputs and count, with the
validation probe and the largest label read to the host in one copy; the
canonical path (one-hot, then argmax back) takes the rest.
"""
from typing import Optional

import torch

from metrics_tpu_torch.ops.histogram import label_bincount
from metrics_tpu_torch.utilities.checks import (
    _fast_path_inputs,
    _fast_path_validate,
    _input_format_classification,
    fast_path_memo,
)
from metrics_tpu_torch.utilities.data import _is_concrete
from metrics_tpu_torch.utilities.enums import DataType
from metrics_tpu_torch.utilities.prints import rank_zero_warn


def _confmat_count(preds, target, num_classes: int, multilabel: bool) -> torch.Tensor:
    """int32 ``(C, C)`` (or ``(C, 2, 2)`` multi-label) counts of label inputs."""
    if multilabel:
        classes = torch.arange(num_classes, device=target.device)
        unique_mapping = ((2 * target.to(torch.int64) + preds) + 4 * classes).reshape(-1)
        bins = label_bincount(unique_mapping, 4 * num_classes).reshape(num_classes, 2, 2)
    else:
        unique_mapping = target.reshape(-1).to(torch.int64) * num_classes + preds.reshape(-1)
        bins = label_bincount(unique_mapping, num_classes**2).reshape(num_classes, num_classes)
    return bins.to(torch.int32)


def _check_max_label(max_label: int, num_classes: int) -> None:
    """A fixed-length count drops out-of-range cells, so an out-of-range
    label is an error raised here, as in the JAX package."""
    if max_label >= num_classes:
        raise ValueError(
            f"Detected class label {max_label} which is larger than or equal to"
            f" `num_classes`={num_classes} in the confusion matrix computation."
        )


def _confmat_fast_update(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, threshold: float, multilabel: bool
) -> Optional[torch.Tensor]:
    """The label-space path for the common cases; None = take the canonical
    path. The canonical checks run on one probe (``num_classes`` left out of
    them, as the canonical path leaves it out), then the out-of-range label
    error."""
    shapes = _fast_path_inputs(preds, target)
    if shapes is None:
        return None
    p_shape, t_shape, preds_float, case, implied_classes = shapes
    if case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) and p_shape != t_shape:
        if implied_classes < 2:
            return None
    if multilabel and not (case == DataType.MULTILABEL and len(p_shape) == 2):
        # the (C, 2, 2) formula assumes exactly (N, num_classes) columns
        return None
    if case == DataType.MULTILABEL and p_shape[1:] != (num_classes,) and multilabel:
        return None

    def compute():
        p = preds.reshape(p_shape)
        t = target.reshape(t_shape).to(torch.int64)
        if p.is_floating_point():
            if p.dtype in (torch.float16, torch.bfloat16):
                p = p.to(torch.float32)
            if p.ndim == t.ndim + 1:
                pred_labels = torch.argmax(p, dim=1)
            else:
                pred_labels = (p >= threshold).to(torch.int64)
        else:
            pred_labels = p.to(torch.int64)
        # the largest label AFTER argmax/threshold, read with the probe
        max_label = torch.maximum(torch.max(pred_labels), torch.max(t))
        probe = _fast_path_validate(
            preds, target, p_shape, t_shape, case, preds_float,
            threshold=threshold, num_classes=None, is_multiclass=None, top_k=None, extra=max_label,
        )
        if probe is not None and not multilabel:
            _check_max_label(int(probe.extra), num_classes)
        return _confmat_count(pred_labels, t, num_classes, multilabel)

    # CohenKappa / MatthewsCorrcoef / IoU siblings in one collection share
    # the count of a batch
    key = ("confusion_matrix", id(preds), id(target), num_classes, float(threshold), multilabel)
    return fast_path_memo(key, (preds, target), compute)


def _confusion_matrix_update(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, threshold: float = 0.5, multilabel: bool = False
) -> torch.Tensor:
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    fast = _confmat_fast_update(preds, target, num_classes, threshold, multilabel)
    if fast is not None:
        return fast

    preds, target, mode = _input_format_classification(preds, target, threshold, _num_classes_hint=num_classes)
    if mode not in (DataType.BINARY, DataType.MULTILABEL):
        preds = torch.argmax(preds, dim=1)
        target = torch.argmax(target, dim=1)
    if not multilabel and _is_concrete(target):
        _check_max_label(int(torch.maximum(torch.max(preds), torch.max(target))), num_classes)
    return _confmat_count(preds.to(torch.int64), target, num_classes, multilabel)


def _confusion_matrix_compute(confmat: torch.Tensor, normalize: Optional[str] = None) -> torch.Tensor:
    allowed_normalize = ("true", "pred", "all", "none", None)
    assert normalize in allowed_normalize, f"Argument average needs to one of the following: {allowed_normalize}"
    confmat = confmat.to(torch.float32)
    if normalize is not None and normalize != "none":
        if normalize == "true":
            cm = confmat / torch.sum(confmat, dim=1, keepdim=True)
        elif normalize == "pred":
            cm = confmat / torch.sum(confmat, dim=0, keepdim=True)
        elif normalize == "all":
            cm = confmat / torch.sum(confmat)
        if _is_concrete(cm):
            nan_elements = int(torch.sum(torch.isnan(cm)))
            if nan_elements != 0:
                rank_zero_warn(f"{nan_elements} nan values found in confusion matrix have been replaced with zeros.")
        return torch.nan_to_num(cm, nan=0.0)
    return confmat


def confusion_matrix(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    normalize: Optional[str] = None,
    threshold: float = 0.5,
    multilabel: bool = False,
) -> torch.Tensor:
    """Computes the confusion matrix of binary, multi-class or multi-label
    inputs, as float32 on the inputs' device.

    ``normalize``: None | 'true' (over targets) | 'pred' (over predictions) |
    'all'. For multi-label the result is ``(C, 2, 2)``, else ``(C, C)``.

    Example:
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> confusion_matrix(preds, target, num_classes=2)
        tensor([[2., 0.],
                [1., 1.]])
    """
    confmat = _confusion_matrix_update(preds, target, num_classes, threshold, multilabel)
    return _confusion_matrix_compute(confmat, normalize)
