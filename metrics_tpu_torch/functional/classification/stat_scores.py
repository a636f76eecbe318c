"""Stat scores (tp/fp/tn/fn): the shared counting core of the classification pack.

Port of ``metrics_tpu/functional/classification/stat_scores.py``. Two
paths give the same counts:

* the canonical path canonicalizes both inputs to ``(N, C)`` / ``(N, C, X)``
  0/1 indicators (``_input_format_classification``) and sums over them;
* the label-space path counts multi-class labels without any one-hot: three
  bincounts of ``group * C + label`` (support, hits, predicted positives),
  where the group is the whole stream or, under ``mdmc_reduce="samplewise"``,
  the sample. Binary and multi-label inputs are thresholded and summed.

The label-space path takes the common cases and leaves the rest to the
canonical path, which raises the JAX package's errors in its order. Its
validation reads one value probe to the host, and its counts
(``label_bincount``) read nothing, so an update synchronizes once at any
number of classes. The JAX package shares one count among sibling metrics
of a collection (``fast_path_memo``); that sharing is not ported.
"""
import os
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.ops.histogram import label_bincount
from metrics_tpu_torch.utilities.checks import (
    _check_classification_inputs,
    _fast_path_inputs,
    _fast_path_probe,
    _input_format_classification,
)
from metrics_tpu_torch.utilities.enums import DataType

_TRUTHY = frozenset(("1", "true", "yes", "on"))


def debug_enabled() -> bool:
    """True when ``METRICS_TPU_DEBUG`` is set to a true value (read on each call)."""
    return os.environ.get("METRICS_TPU_DEBUG", "").strip().lower() in _TRUTHY


def _del_column(x: torch.Tensor, index: int) -> torch.Tensor:
    """Delete the column at ``index``."""
    return torch.cat([x[:, :index], x[:, (index + 1):]], dim=1)


def _set_column(x: torch.Tensor, index: int, value: int) -> torch.Tensor:
    """``x`` with its last-dim entry ``index`` set to ``value`` (a copy)."""
    x = x.clone()
    x[..., index] = value
    return x


def _stat_scores(
    preds: torch.Tensor,
    target: torch.Tensor,
    reduce: str = "micro",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Count tp/fp/tn/fn over the reduce dims of canonical ``(N,C)``/``(N,C,X)`` inputs.

    Output shapes: ``(N,C)`` inputs — micro: scalar, macro: ``(C,)``,
    samples: ``(N,)``; ``(N,C,X)`` inputs — micro: ``(N,)``, macro:
    ``(N,C)``, samples: ``(N,X)``.

    **Precondition (strict):** ``preds`` and ``target`` must be *canonical
    0/1 indicator tensors*, the output of
    :func:`~metrics_tpu_torch.utilities.checks._input_format_classification`.
    The sufficient-stats identity below (``fp = Σp − Σtp``,
    ``fn = Σt − Σtp``, ``tn = M − Σt − Σp + Σtp``) is only an identity when
    every element is exactly 0 or 1; any other value (probabilities that
    skipped thresholding, label ints ≥ 2) silently corrupts all four counts.
    Callers must canonicalize first; set ``METRICS_TPU_DEBUG=1`` to assert
    the precondition (one more read of the inputs to the host).
    """
    if reduce == "micro":
        dim = (0, 1) if preds.ndim == 2 else (1, 2)
    elif reduce == "macro":
        dim = (0,) if preds.ndim == 2 else (2,)
    elif reduce == "samples":
        dim = (1,)

    if debug_enabled():
        for name, x in (("preds", preds), ("target", target)):
            flags = torch.stack([torch.all((x == 0) | (x == 1)).double(), x.min().double(), x.max().double()])
            ok, lo, hi = flags.tolist()
            if not ok:
                raise AssertionError(
                    f"_stat_scores requires canonical 0/1 indicator inputs;"
                    f" {name} has non-indicator values (range [{lo}, {hi}]) —"
                    " canonicalize via _input_format_classification first"
                )

    # three int64 reductions: exact where int32 partial sums would wrap
    s_t = torch.sum(target, dim=dim)
    s_p = torch.sum(preds, dim=dim)
    s_tp = torch.sum(target * preds, dim=dim)
    m = 1
    for d in dim:
        m *= preds.shape[d]

    tp = s_tp
    fp = s_p - s_tp
    tn = m - s_t - s_p + s_tp
    fn = s_t - s_tp
    return tp.to(torch.int32), fp.to(torch.int32), tn.to(torch.int32), fn.to(torch.int32)


def _stat_scores_count(preds, target, reduce, mdmc_reduce, ignore_index):
    """Counting on canonical inputs."""
    if preds.ndim == 3 and mdmc_reduce == "global":
        preds = torch.swapaxes(preds, 1, 2).reshape(-1, preds.shape[1])
        target = torch.swapaxes(target, 1, 2).reshape(-1, target.shape[1])

    # Drop the ignored class column when class identity doesn't matter.
    if ignore_index is not None and reduce != "macro":
        preds = _del_column(preds, ignore_index)
        target = _del_column(target, ignore_index)

    tp, fp, tn, fn = _stat_scores(preds, target, reduce=reduce)

    # Mark the ignored class's statistics with -1 sentinels.
    if ignore_index is not None and reduce == "macro":
        tp, fp, tn, fn = (_set_column(x, ignore_index, -1) for x in (tp, fp, tn, fn))

    return tp, fp, tn, fn


def _top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """``(M, k)`` class indices of the k largest scores of each position of
    ``(N, C, ...)`` scores, positions in sample-major order. A stable
    descending sort breaks ties toward the lower index, as ``lax.top_k``
    does in the JAX package; ``torch.topk`` does not fix an order on ties."""
    idx = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.movedim(idx, 1, -1).reshape(-1, k)


def _stat_scores_label_count(
    preds, target, p_shape, t_shape, case, reduce, mdmc_reduce, num_classes, top_k, threshold, ignore_index
):
    """tp/fp/tn/fn straight from raw inputs that have passed validation: the
    counting half of the JAX package's ``_stat_scores_probe_count`` (the
    probe half is ``_fast_path_probe``).

    The canonical path expands both inputs to ``(N, C)`` one-hots and sums
    over them; in label space the same per-class counts are three bincounts
    (predicted positives, support, hits), and the micro/samples reductions
    derive from them, with no ``(N, C)`` intermediate. MDMC-global flattens
    to the 2-d layout; MDMC-samplewise keeps a per-sample axis by counting
    ``sample_id * C + label``.
    """
    preds = preds.reshape(p_shape)
    target = target.reshape(t_shape)
    if preds.dtype in (torch.float16, torch.bfloat16):
        preds = preds.to(torch.float32)
    samplewise = case == DataType.MULTIDIM_MULTICLASS and mdmc_reduce == "samplewise"

    if case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
        num_cols = num_classes
        n_samples = t_shape[0]
        flat_t = target.reshape(-1).to(torch.int64)
        memb_ignore = None
        if preds.ndim == target.ndim + 1:  # (N, C, ...) probabilities
            # labels of the positions in sample-major order, as flat_t
            k = top_k or 1
            if k == 1:
                pred_labels = torch.argmax(preds, dim=1).reshape(-1)
                hit = pred_labels == flat_t
                if ignore_index is not None:
                    memb_ignore = pred_labels == ignore_index
            else:
                idx = _top_k_indices(preds, k)
                hit = torch.any(idx == flat_t[:, None], dim=1)
                if ignore_index is not None:
                    memb_ignore = torch.any(idx == ignore_index, dim=1)
        else:  # label predictions
            k = 1
            pred_labels = preds.reshape(-1).to(torch.int64)
            hit = pred_labels == flat_t
            if ignore_index is not None:
                memb_ignore = pred_labels == ignore_index

        m = flat_t.shape[0]
        # per-(group, class) counts: one flat bincount; group = the whole
        # stream for global reductions, the sample for MDMC-samplewise
        if samplewise:
            groups, x = n_samples, m // n_samples
            sid = torch.arange(m, device=flat_t.device) // x
            t_bins = sid * num_cols + flat_t
            p_bins = sid * num_cols + pred_labels if k == 1 else (sid[:, None] * num_cols + idx).reshape(-1)
        else:
            groups, x = 1, m
            t_bins, p_bins = flat_t, (pred_labels if k == 1 else idx.reshape(-1))
        length = groups * num_cols
        gshape = (groups, num_cols) if samplewise else (num_cols,)
        support = label_bincount(t_bins, length).reshape(gshape)
        tp_c = label_bincount(t_bins, length, weights=hit).reshape(gshape)
        count_pred = label_bincount(p_bins, length).reshape(gshape)
        fn_c = support - tp_c
        fp_c = count_pred - tp_c
        tn_c = x - support - fp_c

        if reduce == "macro":
            tp, fp, tn, fn = (v.to(torch.int32) for v in (tp_c, fp_c, tn_c, fn_c))
            if ignore_index is not None:
                tp, fp, tn, fn = (_set_column(v, ignore_index, -1) for v in (tp, fp, tn, fn))
        elif reduce == "micro":
            if ignore_index is not None:
                keep = torch.arange(num_cols, device=flat_t.device) != ignore_index
                tp_c, fp_c, tn_c, fn_c = (v * keep for v in (tp_c, fp_c, tn_c, fn_c))
            tp, fp, tn, fn = (torch.sum(v, dim=-1).to(torch.int32) for v in (tp_c, fp_c, tn_c, fn_c))
        else:  # samples: per position over the binary layout
            t_valid = flat_t != ignore_index if ignore_index is not None else torch.ones_like(hit)
            tp = (hit & t_valid).to(torch.int32)
            kk = k - memb_ignore.to(torch.int32) if ignore_index is not None else k
            cols = num_cols - (1 if ignore_index is not None else 0)
            fp = (kk - tp).to(torch.int32)
            fn = (t_valid.to(torch.int32) - tp).to(torch.int32)
            tn = (cols - tp - fp - fn).to(torch.int32)
            if samplewise:  # (N, X) per-sample rows, as the canonical dim=1
                tp, fp, tn, fn = (v.reshape(n_samples, -1) for v in (tp, fp, tn, fn))
    elif case == DataType.MULTILABEL:
        # threshold to the canonical 0/1 layout, then the shared counting
        # (_stat_scores); ignore_index drops the column outright for
        # class-blind reductions, as _stat_scores_count does
        pbin = (preds >= threshold).to(torch.int32)
        tbin = target.to(torch.int32)
        if reduce == "macro":
            tp, fp, tn, fn = _stat_scores(pbin, tbin, reduce="macro")
            if ignore_index is not None:
                tp, fp, tn, fn = (_set_column(v, ignore_index, -1) for v in (tp, fp, tn, fn))
        else:
            if ignore_index is not None:
                pbin = _del_column(pbin, ignore_index)
                tbin = _del_column(tbin, ignore_index)
            tp, fp, tn, fn = _stat_scores(pbin, tbin, reduce=reduce)
    else:  # BINARY: canonical layout is (N, 1)
        pbin = (preds >= threshold).to(torch.int32).reshape(-1, 1)
        tbin = target.to(torch.int32).reshape(-1, 1)
        tp, fp, tn, fn = _stat_scores(pbin, tbin, reduce=reduce)
        if reduce == "micro":
            # canonical micro output for (N, 1) is a scalar
            tp, fp, tn, fn = (v.reshape(()) for v in (tp, fp, tn, fn))

    return tp, fp, tn, fn


def _stat_scores_fast_update(
    preds, target, reduce, mdmc_reduce, num_classes, top_k, threshold, is_multiclass, ignore_index
):
    """The label-space path for the common cases; None = take the canonical path.

    Validation parity: the probe's scalars run through the same
    ``_check_classification_inputs`` pipeline (the arguments the canonical
    call passes, the same errors), then the same ``ignore_index`` check.
    """
    if is_multiclass is not None:
        return None
    shapes = _fast_path_inputs(preds, target)
    if shapes is None:
        return None
    p_shape, t_shape, preds_float, case, implied_classes = shapes

    if top_k is not None and (
        not isinstance(top_k, int)
        or top_k <= 0
        or top_k >= implied_classes
        or case in (DataType.BINARY, DataType.MULTILABEL)
        or not preds_float
    ):
        return None  # the canonical path raises the top_k errors
    if case == DataType.MULTIDIM_MULTICLASS and mdmc_reduce not in ("global", "samplewise"):
        return None  # missing-mdmc error: the canonical path raises it
    if case == DataType.BINARY and ignore_index is not None:
        return None  # "can not use ignore_index with binary data"
    if case == DataType.MULTILABEL and len(p_shape) != 2:
        return None  # deep multi-label flattens to (N, C*X) canonically
    if case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
        if len(p_shape) == len(t_shape):
            # label predictions: the one-hot width is num_classes (or the
            # data max, which the canonical path reads)
            if num_classes is None:
                return None
            n_cols = num_classes
        else:
            if implied_classes < 2:
                return None
            n_cols = implied_classes
    else:
        n_cols = p_shape[1] if len(p_shape) > 1 else 1

    probe = _fast_path_probe(preds, target, p_shape, t_shape, case, preds_float)
    _check_classification_inputs(
        preds, target, threshold=threshold, num_classes=num_classes, is_multiclass=is_multiclass, top_k=top_k,
        p_shape=p_shape, t_shape=t_shape, probe=probe,
    )
    if ignore_index is not None and not 0 <= ignore_index < n_cols:
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {n_cols} classes")
    return _stat_scores_label_count(
        preds, target, p_shape, t_shape, case, reduce, mdmc_reduce, n_cols, top_k, float(threshold), ignore_index
    )


def _stat_scores_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    reduce: str = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    is_multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Validate the inputs and count the tp/fp/tn/fn partial statistics."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target)
    fast = _stat_scores_fast_update(
        preds, target, reduce, mdmc_reduce, num_classes, top_k, threshold, is_multiclass, ignore_index
    )
    if fast is not None:
        return fast

    preds, target, _ = _input_format_classification(
        preds, target, threshold=threshold, num_classes=num_classes, is_multiclass=is_multiclass, top_k=top_k
    )

    if ignore_index is not None and not 0 <= ignore_index < preds.shape[1]:
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {preds.shape[1]} classes")

    if ignore_index is not None and preds.shape[1] == 1:
        raise ValueError("You can not use `ignore_index` with binary data.")

    if preds.ndim == 3 and not mdmc_reduce:
        raise ValueError(
            "When your inputs are multi-dimensional multi-class, you have to set the `mdmc_reduce` parameter"
        )

    return _stat_scores_count(preds, target, reduce=reduce, mdmc_reduce=mdmc_reduce, ignore_index=ignore_index)


def _stat_scores_compute(tp: torch.Tensor, fp: torch.Tensor, tn: torch.Tensor, fn: torch.Tensor) -> torch.Tensor:
    outputs = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)  # the last column is the support
    return torch.where(outputs < 0, -1, outputs)


def stat_scores(
    preds: torch.Tensor,
    target: torch.Tensor,
    reduce: str = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    is_multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    """Count true/false positives/negatives (+support) under the given reduction.

    Returns ``(..., 5) = [tp, fp, tn, fn, support]``, int32, on the inputs'
    device; the leading shape follows ``reduce`` / ``mdmc_reduce`` as in the
    JAX package.

    Example:
        >>> preds  = torch.tensor([1, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> stat_scores(preds, target, reduce='macro', num_classes=3)
        tensor([[0, 1, 2, 1, 1],
                [1, 1, 1, 1, 2],
                [1, 0, 3, 0, 1]], dtype=torch.int32)
        >>> stat_scores(preds, target, reduce='micro')
        tensor([2, 2, 6, 2, 4], dtype=torch.int32)
    """
    if reduce not in ["micro", "macro", "samples"]:
        raise ValueError(f"The `reduce` {reduce} is not valid.")

    if mdmc_reduce not in [None, "samplewise", "global"]:
        raise ValueError(f"The `mdmc_reduce` {mdmc_reduce} is not valid.")

    if reduce == "macro" and (not num_classes or num_classes < 1):
        raise ValueError("When you set `reduce` as 'macro', you have to provide the number of classes.")

    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

    tp, fp, tn, fn = _stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_reduce,
        top_k=top_k,
        threshold=threshold,
        num_classes=num_classes,
        is_multiclass=is_multiclass,
        ignore_index=ignore_index,
    )
    return _stat_scores_compute(tp, fp, tn, fn)
