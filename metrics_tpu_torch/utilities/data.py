"""Shared tensor utilities.

Port of ``metrics_tpu/utilities/data.py`` (``_stable_1d_sort`` without
its ``nb`` truncation; ``promote_accumulator`` for the regression family;
``get_group_indexes``, the retrieval family's host-side shim).
``to_onehot`` and ``select_topk`` keep the JAX package's broadcast-compare
formulation, so their outputs match it bit for bit (top-k ties resolve to
the lower index, as ``lax.top_k`` does).

``_is_concrete`` is the JAX package's guard of every value check: False
while the step engine builds a step (``tracing()``, its plain run and its
CUDA-graph warm-up) or a CUDA stream is capturing a graph, True otherwise.
A value check reads the device to the host, which a graph cannot hold, so
the checks are skipped there as JAX skips them under ``jit``.
"""
import threading
from contextlib import contextmanager
from typing import Any, Callable, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from metrics_tpu_torch.utilities.prints import rank_zero_warn


def promote_accumulator(*tensors):
    """Promote floating inputs below float32 (``bfloat16``, ``float16``) to
    float32; ``float64`` stays ``float64`` and integer tensors keep their
    dtype. Sums of squares, products and log-space errors must accumulate in
    at least float32, or cancellation destroys the result."""
    out = tuple(
        t.to(torch.promote_types(t.dtype, torch.float32)) if t.is_floating_point() else t for t in tensors
    )
    return out[0] if len(out) == 1 else out


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


_trace_state = threading.local()


@contextmanager
def tracing():
    """Scope in which this thread builds an engine step: :func:`_is_concrete`
    is False inside. Nested scopes stay traced until the outermost exits."""
    prev = getattr(_trace_state, "active", False)
    _trace_state.active = True
    try:
        yield
    finally:
        _trace_state.active = prev


def _is_concrete(x: Any = None) -> bool:
    """True when value checks may read ``x`` to the host: not inside
    :func:`tracing`, and no CUDA stream of this thread capturing a graph.
    ``x`` is accepted for the JAX package's call form and not read."""
    if getattr(_trace_state, "active", False):
        return False
    return not (torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing())


def to_onehot(label_tensor: torch.Tensor, num_classes: Optional[int] = None) -> torch.Tensor:
    """Convert a dense label tensor ``[N, d1, ...]`` to one-hot ``[N, C, d1, ...]``.

    If ``num_classes`` is None it is inferred from the data maximum, which
    needs a concrete tensor (not one the step engine is tracing).

    Example:
        >>> x = torch.tensor([1, 2, 3])
        >>> to_onehot(x)
        tensor([[0, 1, 0, 0],
                [0, 0, 1, 0],
                [0, 0, 0, 1]])
    """
    if num_classes is None:
        if not _is_concrete(label_tensor):
            raise ValueError(
                "`num_classes` must be given when `to_onehot` is traced under jit; "
                "inferring it from the data maximum requires a concrete array."
            )
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


def to_categorical(x: torch.Tensor, argmax_dim: int = 1) -> torch.Tensor:
    """Probabilities ``[N, C, d1, ...]`` -> int32 labels by argmax (ties:
    the lower index, as in the JAX package).

    Example:
        >>> to_categorical(torch.tensor([[0.2, 0.5], [0.9, 0.1]]))
        tensor([1, 0], dtype=torch.int32)
    """
    return torch.argmax(x, dim=argmax_dim).to(torch.int32)


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


def get_group_indexes(idx: torch.Tensor) -> List[torch.Tensor]:
    """Per-unique-value index lists, in order of first appearance.

    Host-side compatibility shim for the reference's Python loop: it copies
    ``idx`` to the host. The retrieval metrics never call it; they rank
    every query at once with one sort (:mod:`metrics_tpu_torch.ops.segment`).
    The lists are int32 tensors on ``idx``'s device.

    Example:
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> get_group_indexes(indexes)
        [tensor([0, 1, 2], dtype=torch.int32), tensor([3, 4, 5, 6], dtype=torch.int32)]
    """
    idx = torch.as_tensor(idx)
    idx_np = idx.cpu().numpy()
    uniques, first_pos = np.unique(idx_np, return_index=True)
    order = np.argsort(first_pos, kind="stable")
    return [
        torch.from_numpy(np.nonzero(idx_np == u)[0].astype(np.int32)).to(idx.device) for u in uniques[order]
    ]
