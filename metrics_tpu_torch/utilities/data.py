"""Shared tensor utilities.

Port of ``metrics_tpu/utilities/data.py`` (``_stable_1d_sort`` without
its ``nb`` truncation). ``to_onehot`` and
``select_topk`` keep the JAX package's broadcast-compare formulation, so
their outputs match it bit for bit (top-k ties resolve to the lower index,
as ``lax.top_k`` does). The JAX package's ``_is_concrete`` guard has no
counterpart: every tensor is concrete in eager PyTorch.
"""
from typing import Any, Callable, Mapping, Optional, Sequence, Union

import torch

from metrics_tpu_torch.utilities.prints import rank_zero_warn


def dim_zero_cat(x):
    """Concatenate a list of tensors along dim 0 (identity-ish for a lone tensor)."""
    x = x if isinstance(x, (list, tuple)) else [x]
    return torch.cat([torch.atleast_1d(el) for el in x], dim=0)


def dim_zero_sum(x):
    return torch.sum(x, dim=0)


def dim_zero_mean(x):
    return torch.mean(x, dim=0)


def dim_zero_min(x):
    return torch.min(x, dim=0).values


def dim_zero_max(x):
    return torch.max(x, dim=0).values


def _flatten(x):
    return [item for sublist in x for item in sublist]


def to_onehot(label_tensor: torch.Tensor, num_classes: Optional[int] = None) -> torch.Tensor:
    """Convert a dense label tensor ``[N, d1, ...]`` to one-hot ``[N, C, d1, ...]``.

    If ``num_classes`` is None it is inferred from the data maximum.

    Example:
        >>> x = torch.tensor([1, 2, 3])
        >>> to_onehot(x)
        tensor([[0, 1, 0, 0],
                [0, 0, 1, 0],
                [0, 0, 0, 1]])
    """
    if num_classes is None:
        num_classes = int(label_tensor.max()) + 1
    labels = label_tensor.to(torch.int64)
    classes = torch.arange(num_classes, device=labels.device).reshape(
        (1, num_classes) + (1,) * (labels.ndim - 1)
    )
    return (labels.unsqueeze(1) == classes).to(label_tensor.dtype)


def select_topk(prob_tensor: torch.Tensor, topk: int = 1, dim: int = 1) -> torch.Tensor:
    """Binary int32 mask of the top-k entries along ``dim`` (ties: lower index first).

    Example:
        >>> x = torch.tensor([[1.1, 2.0, 3.0], [2.0, 1.0, 0.5]])
        >>> select_topk(x, topk=2)
        tensor([[0, 1, 1],
                [1, 1, 0]], dtype=torch.int32)
    """
    moved = torch.movedim(prob_tensor, dim, -1)
    # a stable descending sort keeps tied entries in index order, which is
    # the tie rule of lax.top_k in the JAX package
    idx = torch.sort(moved, dim=-1, descending=True, stable=True).indices[..., :topk]
    entries = torch.arange(moved.shape[-1], device=moved.device)
    mask = (idx.unsqueeze(-1) == entries).any(dim=-2)
    return torch.movedim(mask, -1, dim).to(torch.int32)


def get_num_classes(preds: torch.Tensor, target: torch.Tensor, num_classes: Optional[int] = None) -> int:
    """Infer the number of classes from data maxima, warning on a mismatch."""
    num_target_classes = int(target.max()) + 1
    num_pred_classes = int(preds.max()) + 1
    num_all_classes = max(num_target_classes, num_pred_classes)

    if num_classes is None:
        num_classes = num_all_classes
    elif num_classes != num_all_classes:
        rank_zero_warn(
            f"You have set {num_classes} number of classes which is"
            f" different from predicted ({num_pred_classes}) and"
            f" target ({num_target_classes}) number of classes",
            RuntimeWarning,
        )
    return num_classes


def _stable_1d_sort(x: torch.Tensor):
    """Stable ascending sort of a 1d tensor, returning ``(values, indices)``
    of every element.

    The JAX package's version cuts both to their first 2049 entries (its
    reference's ``nb`` contract); this one does not, so ``auc(...,
    reorder=True)`` integrates the whole curve.

    Example:
        >>> _stable_1d_sort(torch.tensor([8, 7, 2, 6, 4, 5, 3, 1, 9, 0]))[0]
        tensor([0, 1, 2, 3, 4, 5, 6, 7, 8, 9])
    """
    if x.ndim > 1:
        raise ValueError("Stable sort only works on 1d tensors")
    return torch.sort(x, stable=True)


def apply_to_collection(
    data: Any,
    dtype: Union[type, tuple],
    function: Callable,
    *args: Any,
    wrong_dtype: Optional[Union[type, tuple]] = None,
    **kwargs: Any,
) -> Any:
    """Recursively apply ``function`` to all elements of type ``dtype``.

    Example:
        >>> apply_to_collection(torch.tensor([8, 0, 2, 6, 7]), dtype=torch.Tensor, function=lambda x: x ** 2)
        tensor([64,  0,  4, 36, 49])
        >>> apply_to_collection([8, 0, 2, 6, 7], dtype=int, function=lambda x: x ** 2)
        [64, 0, 4, 36, 49]
        >>> apply_to_collection(dict(abc=123), dtype=int, function=lambda x: x ** 2)
        {'abc': 15129}
    """
    elem_type = type(data)

    if isinstance(data, dtype) and (wrong_dtype is None or not isinstance(data, wrong_dtype)):
        return function(data, *args, **kwargs)

    if isinstance(data, Mapping):
        return elem_type({k: apply_to_collection(v, dtype, function, *args, **kwargs) for k, v in data.items()})

    if isinstance(data, tuple) and hasattr(data, "_fields"):  # namedtuple
        return elem_type(*(apply_to_collection(d, dtype, function, *args, **kwargs) for d in data))

    if isinstance(data, Sequence) and not isinstance(data, str):
        return elem_type([apply_to_collection(d, dtype, function, *args, **kwargs) for d in data])

    return data
