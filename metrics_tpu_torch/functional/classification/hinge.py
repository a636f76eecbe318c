"""Hinge loss (functional). Port of ``metrics_tpu/functional/classification/hinge.py``."""
from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.utilities.enums import DataType, EnumStr


class MulticlassMode(EnumStr):
    """Enum to represent possible multiclass modes of hinge.

    >>> "Crammer-Singer" in list(MulticlassMode)
    True
    """

    CRAMMER_SINGER = "crammer-singer"
    ONE_VS_ALL = "one-vs-all"


def _check_shape_and_type_consistency_hinge(preds: torch.Tensor, target: torch.Tensor) -> DataType:
    if target.ndim > 1:
        raise ValueError(f"The `target` should be one dimensional, got `target` with shape={tuple(target.shape)}.")

    if preds.ndim == 1:
        if preds.shape != target.shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,",
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}.",
            )
        mode = DataType.BINARY
    elif preds.ndim == 2:
        if preds.shape[0] != target.shape[0]:
            raise ValueError(
                "The `preds` and `target` should have the same shape in the first dimension,",
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}.",
            )
        mode = DataType.MULTICLASS
    else:
        raise ValueError(
            f"The `preds` should be one or two dimensional, got `preds` with shape={tuple(preds.shape)}."
        )
    return mode


def _hinge_measures(
    preds: torch.Tensor, target: torch.Tensor, mode: DataType, squared: bool, one_vs_all: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Summed hinge measures and the row count, without boolean indexing."""
    if mode == DataType.MULTICLASS:
        # a single score column broadcasts against the two-class one-hot
        num_classes = max(2, preds.shape[1])
        onehot = target[:, None] == torch.arange(num_classes, device=target.device)

        if one_vs_all:
            # every class pitted against the rest: (N, C) signed margins
            margin = torch.where(onehot, preds, -preds)
        else:
            # Crammer-Singer: true-class score minus the best other score
            p_true = torch.sum(torch.where(onehot, preds, 0.0), dim=1)
            p_other = torch.max(torch.where(onehot, float("-inf"), preds), dim=1).values
            margin = p_true - p_other
    else:
        margin = torch.where(target > 0, preds, -preds)

    measures = torch.clamp(1 - margin, min=0)
    if squared:
        measures = measures**2

    # the row count filled on the device: no host-to-device copy
    total = torch.full((), target.shape[0], dtype=torch.int32, device=target.device)
    return torch.sum(measures, dim=0), total


def _hinge_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    if preds.shape[0] == 1:
        # keep the batch dim when squeezing a single-sample input
        preds, target = preds.squeeze()[None, ...], target.squeeze()[None, ...]
    else:
        preds, target = preds.squeeze(), target.squeeze()

    mode = _check_shape_and_type_consistency_hinge(preds, target)

    if mode == DataType.MULTICLASS:
        if multiclass_mode is None or multiclass_mode == MulticlassMode.CRAMMER_SINGER:
            one_vs_all = False
        elif multiclass_mode == MulticlassMode.ONE_VS_ALL:
            one_vs_all = True
        else:
            raise ValueError(
                "The `multiclass_mode` should be either None / 'crammer-singer' / MulticlassMode.CRAMMER_SINGER"
                "(default) or 'one-vs-all' / MulticlassMode.ONE_VS_ALL,"
                f" got {multiclass_mode}."
            )
    else:
        one_vs_all = False

    return _hinge_measures(preds, target, mode, squared, one_vs_all)


def _hinge_compute(measure: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return measure / total


def hinge(
    preds: torch.Tensor,
    target: torch.Tensor,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
) -> torch.Tensor:
    r"""Computes the mean Hinge loss, typically used for SVMs.

    Binary: ``max(0, 1 - y*ŷ)`` with ``y ∈ {-1, 1}``. Multiclass default is
    the Crammer-Singer loss ``max(0, 1 - ŷ_y + max_{i≠y} ŷ_i)``;
    ``multiclass_mode='one-vs-all'`` instead returns a vector of C
    one-vs-rest losses. ``squared=True`` squares the per-sample measures.

    Only accepts preds shape (N) (binary) or (N, C) (multi-class) and target
    shape (N).

    Example (binary case):
        >>> target = torch.tensor([0, 1, 1])
        >>> preds = torch.tensor([-2.2, 2.4, 0.1])
        >>> hinge(preds, target)
        tensor(0.3000)

        >>> target = torch.tensor([0, 1, 2])
        >>> preds = torch.tensor([[-1.0, 0.9, 0.2], [0.5, -1.1, 0.8], [2.2, -0.5, 0.3]])
        >>> hinge(preds, target)
        tensor(2.9000)

        >>> hinge(preds, target, multiclass_mode="one-vs-all")
        tensor([2.2333, 1.5000, 1.2333])
    """
    measure, total = _hinge_update(preds, target, squared=squared, multiclass_mode=multiclass_mode)
    return _hinge_compute(measure, total)
