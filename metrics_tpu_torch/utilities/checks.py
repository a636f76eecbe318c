"""Input canonicalization and validation for classification metrics.

Port of the classification half of ``metrics_tpu/utilities/checks.py``:
the same case taxonomy, canonical ``(N, C)`` / ``(N, C, X)`` binary int
outputs, and the same errors raised in the same order.

* Shape/dtype dispatch is pure Python over shapes.
* Value checks (label ranges, probability bounds, probabilities summing
  to 1) read one *value probe*: five scalars computed on the inputs'
  device and copied to the host in one transfer.
* The canonicalizing transform (threshold / top-k / one-hot / reshape) is
  a handful of eager tensor ops.

The label-space fast paths of the accuracy, hamming, confusion-matrix and
stat-score counts share ``_fast_path_inputs`` / ``_fast_path_validate``:
they skip the canonicalizing transform and validate from the same probe.

Every probe is guarded by ``_is_concrete``, as in the JAX package: while
the step engine builds a step or a CUDA graph is being captured, value
checks are skipped (a graph cannot hold a host read) and ``num_classes``
must be given where it would be inferred from the data.

``shared_canonicalization`` / ``fast_path_memo`` are the JAX package's
per-step sharing memo: inside one ``MetricCollection`` step, siblings with
the same options canonicalize the batch once, share one fast-path count
(Precision / Recall / F1 count the batch once between them) and, in the
regression family, one pass of moments
(``functional/regression/sufficient_stats.py``).
"""
import threading
from contextlib import contextmanager
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.utilities.data import _is_concrete, select_topk, to_onehot
from metrics_tpu_torch.utilities.enums import DataType


def _is_floating(x: torch.Tensor) -> bool:
    return x.is_floating_point()


def _squeeze_shape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Shape after removing all size-1 dims except a size-1 leading N (torch squeeze semantics)."""
    shape = tuple(shape)
    if len(shape) and shape[0] == 1:
        return (1,) + tuple(s for s in shape[1:] if s != 1)
    return tuple(s for s in shape if s != 1)


class _Probe(NamedTuple):
    """Host-side scalar summary of the inputs."""

    preds_min: float
    preds_max: float
    target_min: int
    target_max: int
    prob_sum_ok: bool
    # one more scalar a caller asked to read in the same copy
    extra: Optional[float] = None


def _value_probe(preds, target, p_shape, t_shape, check_prob_sum, sum_atol=1e-5, extra=None) -> _Probe:
    """Min/max of both inputs and the probabilities-sum-to-1 flag, read to
    the host in ONE device-to-host copy (one synchronization). ``extra``, a
    0-d tensor on the inputs' device, rides along in the same copy."""
    preds = preds.reshape(p_shape).to(torch.float32)
    target = target.reshape(t_shape)
    if check_prob_sum:
        s = torch.sum(preds, dim=1)
        prob_ok = torch.all(torch.isclose(s, torch.ones_like(s), atol=sum_atol))
    else:
        prob_ok = torch.ones((), dtype=torch.bool, device=preds.device)
    # float64 holds every f32 value and every integer label below 2^53 exactly
    scalars = [preds.min(), preds.max(), target.min(), target.max(), prob_ok]
    if extra is not None:
        scalars.append(extra)
    raw = torch.stack([x.double() for x in scalars]).tolist()
    return _Probe(raw[0], raw[1], int(raw[2]), int(raw[3]), bool(raw[4]), raw[5] if extra is not None else None)


def _prob_sum_atol(preds: torch.Tensor, p_shape: Tuple[int, ...], check_prob_sum: bool) -> float:
    """Tolerance for the probabilities-sum-to-1 check.

    Half-precision probabilities were rounded on input: their sum is
    legitimately 1 ± C·eps(dtype). fp32 keeps the strict default.
    """
    if not check_prob_sum:
        return 1e-5
    n_classes_dim = p_shape[1] if len(p_shape) > 1 else 1
    return max(1e-5, n_classes_dim * float(torch.finfo(preds.dtype).eps))


def _check_same_shape(pred: torch.Tensor, target: torch.Tensor) -> None:
    """Check that predictions and target have the same shape, else raise error."""
    if pred.shape != target.shape:
        raise RuntimeError("Predictions and targets are expected to have the same shape")


_canon_memo = threading.local()
_CANON_MEMO_MAX = 64


@contextmanager
def shared_canonicalization():
    """Share work on one batch across the metrics that see it within this
    context.

    ``MetricCollection`` and ``CompositionalMetric`` wrap their fan-out in
    this. Results are memoized by input tensor identity plus the full
    option tuple; the memo pins the input tensors so ids stay valid, and
    dies with the context. Nested contexts share the outermost memo.

    Scope it to ONE step (one batch), as ``MetricCollection`` does: the memo
    pins every distinct input it sees, so a past ``_CANON_MEMO_MAX``
    entries it is cleared (trading sharing for boundedness).
    """
    prev = getattr(_canon_memo, "store", None)
    _canon_memo.store = {} if prev is None else prev
    try:
        yield
    finally:
        _canon_memo.store = prev


def fast_path_memo(key: tuple, originals: tuple, compute):
    """Memoize ``compute()`` under :func:`shared_canonicalization`, keyed on
    ``key`` (input identity + options), pinning ``originals`` so their ids
    stay valid. Outside a sharing context it just runs ``compute``."""
    store = getattr(_canon_memo, "store", None)
    if store is None:
        return compute()
    hit = store.get(key)
    if hit is not None:
        return hit[-1]
    result = compute()
    if result is not None:
        if len(store) >= _CANON_MEMO_MAX:
            store.clear()  # mis-scoped context: stay bounded
        store[key] = (*originals, result)
    return result


def _detect_case(
    p_shape: Tuple[int, ...],
    t_shape: Tuple[int, ...],
    preds_float: bool,
) -> Tuple[DataType, int]:
    """Shape/dtype case detection; returns the case and the implied number of classes."""
    p_ndim, t_ndim = len(p_shape), len(t_shape)

    if p_ndim == t_ndim:
        if p_shape != t_shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,"
                f" got `preds` with shape={p_shape} and `target` with shape={t_shape}."
            )
        if p_ndim == 1 and preds_float:
            case = DataType.BINARY
        elif p_ndim == 1 and not preds_float:
            case = DataType.MULTICLASS
        elif p_ndim > 1 and preds_float:
            case = DataType.MULTILABEL
        else:
            case = DataType.MULTIDIM_MULTICLASS

        implied_classes = int(np.prod(p_shape[1:])) if p_ndim > 1 else 1

    elif p_ndim == t_ndim + 1:
        if not preds_float:
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if p_shape[2:] != t_shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be"
                " (N, C, ...), and the shape of `target` should be (N, ...)."
            )

        implied_classes = p_shape[1]
        case = DataType.MULTICLASS if p_ndim == 2 else DataType.MULTIDIM_MULTICLASS
    else:
        raise ValueError(
            "Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be (N, ...)"
            " and `preds` should be (N, C, ...)."
        )

    return case, implied_classes


def _check_num_classes_binary(num_classes: int, is_multiclass: Optional[bool]) -> None:
    if num_classes > 2:
        raise ValueError("Your data is binary, but `num_classes` is larger than 2.")
    if num_classes == 2 and not is_multiclass:
        raise ValueError(
            "Your data is binary and `num_classes=2`, but `is_multiclass` is not True."
            " Set it to True if you want to transform binary data to multi-class format."
        )
    if num_classes == 1 and is_multiclass:
        raise ValueError(
            "You have binary data and have set `is_multiclass=True`, but `num_classes` is 1."
            " Either set `is_multiclass=None`(default) or set `num_classes=2`"
            " to transform binary data to multi-class format."
        )


def _check_num_classes_mc(
    preds_float: bool,
    probe: Optional[_Probe],
    num_classes: int,
    is_multiclass: Optional[bool],
    implied_classes: int,
    shapes_equal: bool,
) -> None:
    if num_classes == 1 and is_multiclass is not False:
        raise ValueError(
            "You have set `num_classes=1`, but predictions are integers."
            " If you want to convert (multi-dimensional) multi-class data with 2 classes"
            " to binary/multi-label, set `is_multiclass=False`."
        )
    if num_classes > 1:
        if is_multiclass is False and implied_classes != num_classes:
            raise ValueError(
                "You have set `is_multiclass=False`, but the implied number of classes "
                " (from shape of inputs) does not match `num_classes`. If you are trying to"
                " transform multi-dim multi-class data with 2 classes to multi-label, `num_classes`"
                " should be either None or the product of the size of extra dimensions (...)."
                " See Input Types in Metrics documentation."
            )
        if probe is not None and num_classes <= probe.target_max:
            raise ValueError("The highest label in `target` should be smaller than `num_classes`.")
        if probe is not None and not preds_float and num_classes <= probe.preds_max:
            raise ValueError("The highest label in `preds` should be smaller than `num_classes`.")
        if not shapes_equal and num_classes != implied_classes:
            raise ValueError("The size of C dimension of `preds` does not match `num_classes`.")


def _check_num_classes_ml(num_classes: int, is_multiclass: Optional[bool], implied_classes: int) -> None:
    if is_multiclass and num_classes != 2:
        raise ValueError(
            "Your have set `is_multiclass=True`, but `num_classes` is not equal to 2."
            " If you are trying to transform multi-label data to 2 class multi-dimensional"
            " multi-class, you should set `num_classes` to either 2 or None."
        )
    if not is_multiclass and num_classes != implied_classes:
        raise ValueError("The implied number of classes (from shape of inputs) does not match num_classes.")


def _check_top_k(
    top_k: int, case: DataType, implied_classes: int, is_multiclass: Optional[bool], preds_float: bool
) -> None:
    if case == DataType.BINARY:
        raise ValueError("You can not use `top_k` parameter with binary data.")
    if not isinstance(top_k, int) or top_k <= 0:
        raise ValueError("The `top_k` has to be an integer larger than 0.")
    if not preds_float:
        raise ValueError("You have set `top_k`, but you do not have probability predictions.")
    if is_multiclass is False:
        raise ValueError("If you set `is_multiclass=False`, you can not set `top_k`.")
    if case == DataType.MULTILABEL and is_multiclass:
        raise ValueError(
            "If you want to transform multi-label data to 2 class multi-dimensional"
            "multi-class data using `is_multiclass=True`, you can not use `top_k`."
        )
    if top_k >= implied_classes:
        raise ValueError("The `top_k` has to be strictly smaller than the `C` dimension of `preds`.")


def _run_value_checks(
    probe: _Probe,
    preds_float: bool,
    target_float: bool,
    case: DataType,
    shapes_equal: bool,
    implied_classes: int,
    is_multiclass: Optional[bool],
) -> None:
    """Value-level validation from the probe scalars."""
    if probe.target_min < 0:
        raise ValueError("The `target` has to be a non-negative tensor.")
    if not preds_float and probe.preds_min < 0:
        raise ValueError("If `preds` are integers, they have to be non-negative.")
    if preds_float and (probe.preds_min < 0 or probe.preds_max > 1):
        raise ValueError("The `preds` should be probabilities, but values were detected outside of [0,1] range.")
    if is_multiclass is False and probe.target_max > 1:
        raise ValueError("If you set `is_multiclass=False`, then `target` should not exceed 1.")
    if is_multiclass is False and not preds_float and probe.preds_max > 1:
        raise ValueError("If you set `is_multiclass=False` and `preds` are integers, then `preds` should not exceed 1.")

    if shapes_equal and preds_float and probe.target_max > 1:
        raise ValueError(
            "If `preds` and `target` are of shape (N, ...) and `preds` are floats, `target` should be binary."
        )

    if case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) and preds_float and not probe.prob_sum_ok:
        raise ValueError("Probabilities in `preds` must sum up to 1 across the `C` dimension.")

    if not shapes_equal and probe.target_max >= implied_classes:
        raise ValueError(
            "The highest label in `target` should be smaller than the size of the `C` dimension of `preds`."
        )


def _check_classification_inputs(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float,
    num_classes: Optional[int],
    is_multiclass: Optional[bool],
    top_k: Optional[int],
    p_shape: Optional[Tuple[int, ...]] = None,
    t_shape: Optional[Tuple[int, ...]] = None,
    probe: Optional[_Probe] = None,
) -> DataType:
    """Full validation pipeline; returns the detected input case. When
    ``probe`` is None and the inputs are concrete, one is computed here;
    without a probe the value checks are skipped."""
    p_shape = p_shape if p_shape is not None else _squeeze_shape(preds.shape)
    t_shape = t_shape if t_shape is not None else _squeeze_shape(target.shape)
    preds_float = _is_floating(preds)
    target_float = _is_floating(target)

    if target_float:
        raise ValueError("The `target` has to be an integer tensor.")
    if not 0 < threshold < 1:
        raise ValueError(f"The `threshold` should be a float in the (0,1) interval, got {threshold}")
    if (p_shape[0] if p_shape else 0) != (t_shape[0] if t_shape else 0):
        raise ValueError("The `preds` and `target` should have the same first dimension.")

    case, implied_classes = _detect_case(p_shape, t_shape, preds_float)
    shapes_equal = p_shape == t_shape

    if probe is None and _is_concrete(preds) and _is_concrete(target):
        check_prob_sum = case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) and preds_float
        probe = _value_probe(
            preds, target, p_shape, t_shape, check_prob_sum, _prob_sum_atol(preds, p_shape, check_prob_sum)
        )

    if probe is not None:
        _run_value_checks(probe, preds_float, target_float, case, shapes_equal, implied_classes, is_multiclass)

    if not shapes_equal and is_multiclass is False and implied_classes != 2:
        raise ValueError(
            "You have set `is_multiclass=False`, but have more than 2 classes in your data,"
            " based on the C dimension of `preds`."
        )

    if num_classes:
        if case == DataType.BINARY:
            _check_num_classes_binary(num_classes, is_multiclass)
        elif case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
            _check_num_classes_mc(preds_float, probe, num_classes, is_multiclass, implied_classes, shapes_equal)
        elif case == DataType.MULTILABEL:
            _check_num_classes_ml(num_classes, is_multiclass, implied_classes)

    if top_k is not None:
        _check_top_k(top_k, case, implied_classes, is_multiclass, preds_float)

    return case


def _fast_path_inputs(preds: torch.Tensor, target: torch.Tensor):
    """Shared eligibility preamble of the label-space fast paths (hamming,
    confusion matrix, stat scores): int target, matching first dims, and a
    detectable case. Returns ``(p_shape, t_shape, preds_float, case,
    implied_classes)`` or None, which means "take the canonical path": that
    path raises the JAX package's errors for the rejected inputs."""
    if _is_floating(target):
        return None
    p_shape = _squeeze_shape(preds.shape)
    t_shape = _squeeze_shape(target.shape)
    preds_float = _is_floating(preds)
    if (p_shape[0] if p_shape else 0) != (t_shape[0] if t_shape else 0):
        return None
    try:
        case, implied_classes = _detect_case(p_shape, t_shape, preds_float)
    except ValueError:
        return None
    return p_shape, t_shape, preds_float, case, implied_classes


def _fast_path_validate(
    preds,
    target,
    p_shape,
    t_shape,
    case,
    preds_float,
    threshold: float,
    num_classes: Optional[int],
    is_multiclass: Optional[bool],
    top_k: Optional[int],
    extra=None,
) -> Optional[_Probe]:
    """Validate a fast path's inputs as the canonical path does, from one
    value probe (under its probabilities-sum-to-1 condition; ``extra`` rides
    in the same copy). Returns the probe, or None without reading anything
    while the inputs are not concrete: value checks are skipped there."""
    if not (_is_concrete(preds) and _is_concrete(target)):
        return None
    check_prob_sum = case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) and preds_float
    probe = _value_probe(
        preds, target, p_shape, t_shape, check_prob_sum, _prob_sum_atol(preds, p_shape, check_prob_sum), extra
    )
    _check_classification_inputs(
        preds, target, threshold=threshold, num_classes=num_classes, is_multiclass=is_multiclass, top_k=top_k,
        p_shape=p_shape, t_shape=t_shape, probe=probe,
    )
    return probe


def _canonicalize(preds, target, p_shape, t_shape, case, threshold, top_k, num_classes, is_multiclass):
    """The canonicalizing transform: threshold / top-k / one-hot / reshape."""
    preds = preds.reshape(p_shape)
    target = target.reshape(t_shape)

    if preds.dtype in (torch.float16, torch.bfloat16):
        preds = preds.to(torch.float32)

    if case in (DataType.BINARY, DataType.MULTILABEL) and not top_k:
        preds = (preds >= threshold).to(torch.int32)
        num_classes = num_classes if not is_multiclass else 2

    if case == DataType.MULTILABEL and top_k:
        preds = select_topk(preds, top_k)

    if case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) or is_multiclass:
        # dtype re-checked here: the threshold step above may have converted
        # float preds to ints
        if preds.is_floating_point():
            num_classes = preds.shape[1]
            preds = select_topk(preds, top_k or 1)
        else:
            preds = to_onehot(preds, max(2, int(num_classes)))

        target = to_onehot(target, max(2, int(num_classes)))

        if is_multiclass is False:
            preds, target = preds[:, 1, ...], target[:, 1, ...]

    if (case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) and is_multiclass is not False) or is_multiclass:
        target = target.reshape(target.shape[0], target.shape[1], -1)
        preds = preds.reshape(preds.shape[0], preds.shape[1], -1)
    else:
        target = target.reshape(target.shape[0], -1)
        preds = preds.reshape(preds.shape[0], -1)

    # Some operations above create an extra dimension for MC/binary case - remove it.
    if preds.ndim > 2 and preds.shape[-1] == 1:
        preds, target = preds.squeeze(-1), target.squeeze(-1)

    return preds.to(torch.int32), target.to(torch.int32)


def _input_format_classification(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    is_multiclass: Optional[bool] = None,
    _num_classes_hint: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, DataType]:
    """Canonicalize classification inputs to binary ``(N, C)`` or ``(N, C, X)`` int32 tensors.

    Inside :func:`shared_canonicalization` the result is memoized on the
    inputs' identity and every option, so siblings with the same options
    canonicalize a batch once. ``_num_classes_hint`` is the one-hot width
    to use when the inputs are not concrete and ``num_classes`` is None (a
    caller that knows the width but must keep it out of the checks).

    Returns:
        preds: binary int32 tensor ``(N, C)`` or ``(N, C, X)``
        target: binary int32 tensor of the same shape
        case: the detected :class:`DataType`
    """
    store = getattr(_canon_memo, "store", None)
    memo_key = None
    if store is not None:
        memo_key = (id(preds), id(target), threshold, top_k, num_classes, is_multiclass, _num_classes_hint)
        hit = store.get(memo_key)
        if hit is not None:
            return hit[2]
    originals = (preds, target)  # pinned with the result, so their ids stay valid
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)

    p_shape = _squeeze_shape(preds.shape)
    t_shape = _squeeze_shape(target.shape)
    preds_float = _is_floating(preds)

    # the probe is computed here (not inside the checks) so its values are
    # available for num_classes inference below
    probe = None
    if _is_concrete(preds) and _is_concrete(target):
        try:
            case_tmp, _ = _detect_case(p_shape, t_shape, preds_float)
            check_prob_sum = case_tmp in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) and preds_float
        except ValueError:
            check_prob_sum = False
        if not _is_floating(target):
            probe = _value_probe(
                preds, target, p_shape, t_shape, check_prob_sum, _prob_sum_atol(preds, p_shape, check_prob_sum)
            )

    case = _check_classification_inputs(
        preds,
        target,
        threshold=threshold,
        num_classes=num_classes,
        is_multiclass=is_multiclass,
        top_k=top_k,
        p_shape=p_shape,
        t_shape=t_shape,
        probe=probe,
    )

    nc = num_classes
    needs_onehot = (case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) or is_multiclass) and not preds_float
    if needs_onehot and nc is None:
        if probe is not None:
            nc = int(max(probe.preds_max, probe.target_max)) + 1
        elif _num_classes_hint is not None:
            nc = _num_classes_hint
        else:
            raise ValueError(
                "`num_classes` is required when label inputs are traced under jit;"
                " it cannot be inferred from the data maximum."
            )

    preds_c, target_c = _canonicalize(
        preds,
        target,
        p_shape=p_shape,
        t_shape=t_shape,
        case=case,
        threshold=float(threshold),
        top_k=top_k,
        num_classes=nc,
        is_multiclass=is_multiclass,
    )
    if store is not None:
        if len(store) >= _CANON_MEMO_MAX:
            store.clear()  # mis-scoped context: stay bounded
        store[memo_key] = (*originals, (preds_c, target_c, case))
    return preds_c, target_c, case


def _min_max(x: torch.Tensor) -> Tuple[float, float]:
    """``(min, max)`` of a non-empty tensor in one device-to-host copy."""
    lo, hi = torch.stack([x.min(), x.max()]).tolist()
    return lo, hi


def _check_retrieval_functional_inputs(preds, target) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validate binary ``preds``/``target`` of one shape; returns float32
    preds and int32 targets. The JAX package's errors, in its order."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)

    if preds.shape != target.shape:
        raise ValueError("`preds` and `target` must be of the same shape")

    if not preds.numel() or not target.numel():
        raise ValueError("`preds` and `target` must be non-empty")

    if target.is_floating_point() or target.is_complex():
        raise ValueError("`target` must be a tensor of booleans or integers")

    if _is_concrete(target):
        lo, hi = _min_max(target)
        if int(hi) > 1 or int(lo) < 0:
            raise ValueError("`target` must be of type `binary`")

    if not _is_floating(preds):
        raise ValueError("`preds` must be a tensor of floats")

    return preds.to(torch.float32), target.to(torch.int32)


def _check_sample_weights_range(sample_weights: torch.Tensor) -> None:
    """Eager value probe shared by every weighted state design: reject
    negative, NaN (via the min >= 0 comparison) and infinite weights. A
    negative weight breaks the monotone-cumulant designs, an infinite one
    silently poisons the cumulants. Min and max are read to the host in one
    device-to-host copy; an empty or traced tensor is not probed."""
    if not (_is_concrete(sample_weights) and sample_weights.numel()):
        return
    lo, hi = _min_max(sample_weights)
    if not (lo >= 0 and np.isfinite(hi)):
        raise ValueError(f"sample_weights must be non-negative finite, got range [{lo}, {hi}]")


def _guard_sample_weights(sample_weights: torch.Tensor) -> torch.Tensor:
    """Validate sample weights on every path. Concrete weights take the
    range check (:func:`_check_sample_weights_range`), which raises, and
    come back unchanged. Traced weights cannot be read: negative entries
    become NaN instead, so they surface as a NaN value, not as a plausible
    wrong one (the JAX package's in-graph guard)."""
    if _is_concrete(sample_weights):
        _check_sample_weights_range(sample_weights)
        return sample_weights
    return torch.where(sample_weights < 0, float("nan"), sample_weights)


def _sample_weights(sample_weights: Optional[Any], n: int, device: torch.device) -> Optional[torch.Tensor]:
    """``sample_weights`` as a checked ``(n,)`` float32 tensor on ``device``
    (None stays None): one weight per sample, non-negative and finite."""
    if sample_weights is None:
        return None
    weights = torch.as_tensor(sample_weights, dtype=torch.float32, device=device)
    if tuple(weights.shape) != (n,):
        raise ValueError(f"expected 1-d sample_weights of shape {(n,)}, got {tuple(weights.shape)}")
    return _guard_sample_weights(weights)


def _check_retrieval_inputs(
    indexes, preds, target, ignore: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Validate retrieval ``(indexes, preds, target)``; returns int32
    indexes, float32 preds and int32 targets. The JAX package's errors, in
    its order. The ``ignore`` value is masked (to 0) only for the binary
    check: shapes and data pass through intact, so the retrieval metrics'
    ``exclude`` filtering sees every ignored entry."""
    indexes = torch.as_tensor(indexes)
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)

    if preds.shape != target.shape:
        raise ValueError("`preds` and `target` must be of the same shape")
    if indexes.shape != target.shape:
        raise ValueError("`indexes`, `preds` and `target` must be of the same shape")

    if indexes.is_floating_point() or indexes.is_complex() or indexes.dtype == torch.bool:
        raise ValueError("`indexes` must be a tensor of long integers")

    check_target = target if ignore is None else torch.where(target == ignore, torch.zeros_like(target), target)
    preds, _ = _check_retrieval_functional_inputs(preds, check_target)

    return indexes.to(torch.int32), preds, target.to(torch.int32)
