"""Precision-recall curve (functional), and the curve core ROC shares.

Port of ``metrics_tpu/functional/classification/precision_recall_curve.py``.
One binary curve and the C per-class curves of a multi-class input are the
same computation over ``(R, N)`` score rows, on the device the inputs are on:

* one sort of every row (the JAX package's int32 total-order key for float32
  scores, a stable sort of the negated values for other dtypes, whose
  values the key would round), the relevance and the weights gathered along;
* cumulative counts along each row: int32, exact past 2^24 (the JAX
  package's float32 cumsum is not), or float64 weight sums made monotone by
  a cummax, as the JAX package repairs its float32 ones;
* a curve point at the last element of each run of equal scores, by float
  inequality as in the JAX package, so each NaN score is a point of its own;
* one ``torch.nonzero`` over every row's point mask, after one read of the
  per-row point counts and class totals: two device-to-host reads per curve
  compute, for any number of rows, where the JAX package loops over the
  classes with a host step each;
* the per-row results are views of flat outputs assembled on the device.

The sort is stable, so ties (and NaN scores among themselves) keep their
input order, as on the JAX package's CPU path.
"""
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.ops.auroc_kernel import _sortable_key
from metrics_tpu_torch.utilities import warn_once
from metrics_tpu_torch.utilities.checks import _sample_weights


def _sorted_cumulants(preds: torch.Tensor, rel: torch.Tensor, weights: Optional[torch.Tensor] = None):
    """Each row of ``(R, N)`` scores sorted descending, with cumulative true
    and false positives: ``(preds_s, tps, fps, is_last)``, all ``(R, N)``.

    ``rel`` is the bool relevance, ``weights`` optional ``(N,)`` weights that
    every row shares. ``is_last`` marks the last element of each run of
    equal sorted scores."""
    if preds.dtype == torch.float32:
        order = torch.sort(_sortable_key(preds), dim=-1, stable=True).indices
    else:
        order = torch.sort(-preds, dim=-1, stable=True).indices
    preds_s = torch.gather(preds, -1, order)
    rel_s = torch.gather(rel, -1, order)
    if weights is None:
        tps = torch.cumsum(rel_s, -1, dtype=torch.int32)
        fps = torch.arange(1, preds.shape[-1] + 1, dtype=torch.int32, device=preds.device) - tps
    else:
        w_s = weights.to(torch.float64)[order]
        # a parallel prefix sum of non-negative terms can dip by an ulp; the
        # true sums never decrease, so a cummax repairs it
        tps = torch.cummax(torch.cumsum(torch.where(rel_s, w_s, 0.0), -1), -1).values
        fps = torch.cummax(torch.cumsum(torch.where(rel_s, 0.0, w_s), -1), -1).values
    is_last = torch.ones_like(rel_s)
    is_last[:, :-1] = preds_s[:, 1:] != preds_s[:, :-1]
    return preds_s, tps, fps, is_last


class _Points(NamedTuple):
    """The curve points of every row, row-major, descending within a row."""

    rows: torch.Tensor  # (M,) row of each point
    fps: torch.Tensor  # (M,) cumulative false positives (int32, or float64 weighted)
    tps: torch.Tensor  # (M,) cumulative true positives
    thresholds: torch.Tensor  # (M,) the point's score, in the scores' dtype
    counts: torch.Tensor  # (R,) points per row
    totals: torch.Tensor  # (R, 2) float64 class totals [pos, neg]
    host: List[List[float]]  # per row [points, pos total, neg total], on the host


def _clf_curves(
    preds: torch.Tensor, rel: torch.Tensor, weights: Optional[torch.Tensor] = None, stop_at_full_recall: bool = False
) -> _Points:
    """The curve points of each row of ``(R, N)`` scores against bool
    relevance: one per distinct score, or, with ``stop_at_full_recall``, up
    to the first point that reaches the row's positive total (the
    precision-recall curve's cut)."""
    preds_s, tps, fps, is_last = _sorted_cumulants(preds, rel, weights)
    if stop_at_full_recall:
        full = is_last & (tps == tps[:, -1:])
        is_last = is_last & (torch.cumsum(full, -1, dtype=torch.int32) == full)
    counts = is_last.sum(-1)
    totals = torch.stack([tps[:, -1], fps[:, -1]], 1).double()
    host = torch.cat([counts[:, None].double(), totals], 1).tolist()
    rows, cols = torch.nonzero(is_last, as_tuple=True)
    return _Points(rows, fps[rows, cols], tps[rows, cols], preds_s[rows, cols], counts, totals, host)


def _place(values: torch.Tensor, at: torch.Tensor, extra_at: torch.Tensor, extra: Union[float, torch.Tensor]):
    """A flat tensor holding ``values`` at ``at`` and ``extra`` at ``extra_at``.
    A Python number is made a tensor on the device first: assigned as it
    is, it would be copied from the host, which waits for the device."""
    out = values.new_empty(values.numel() + extra_at.numel())
    out[at] = values
    out[extra_at] = extra if isinstance(extra, torch.Tensor) else values.new_full((), extra)
    return out


def _binary_clf_curve(
    preds: torch.Tensor,
    target: torch.Tensor,
    sample_weights: Optional[Sequence] = None,
    pos_label: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cumulative ``(fps, tps, thresholds)`` at each distinct score,
    descending: int32 counts, or float64 weight sums."""
    if preds.ndim > target.ndim:
        preds = preds[:, 0]
    weights = _sample_weights(sample_weights, preds.numel(), preds.device)
    points = _clf_curves(preds.reshape(1, -1), (target == pos_label).reshape(1, -1), weights)
    return points.fps, points.tps, points.thresholds


def _pr_curves(
    preds: torch.Tensor, rel: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Per-row ``(precision, recall, thresholds)`` of ``(R, N)`` rows: each
    row's points up to full recall in ascending threshold order, precision
    and recall closed by ``(1, 0)``."""
    p = _clf_curves(preds, rel, weights, stop_at_full_recall=True)
    n_rows = p.counts.numel()
    starts = torch.cumsum(p.counts, 0) - p.counts
    rank = torch.arange(p.rows.numel(), device=p.rows.device) - starts[p.rows]
    backwards = starts[p.rows] + p.counts[p.rows] - 1 - rank
    tps, fps = p.tps.double(), p.fps.double()
    # each earlier row holds one more slot: its closing point
    at = backwards + p.rows
    close_at = starts + p.counts + torch.arange(n_rows, device=starts.device)
    precision = _place(tps / (tps + fps), at, close_at, 1.0).float()
    recall = _place(tps / p.totals[p.rows, 0], at, close_at, 0.0).float()
    thresholds = torch.empty_like(p.thresholds)
    thresholds[backwards] = p.thresholds
    sizes = [int(k) for k, _, _ in p.host]
    return precision.split([k + 1 for k in sizes]), recall.split([k + 1 for k in sizes]), thresholds.split(sizes)


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


def _precision_recall_curve_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    pos_label: int,
    sample_weights: Optional[Sequence] = None,
) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[List[torch.Tensor], ...]]:
    """The binary curve, or per-class lists over ``(N, C)`` scores and
    ``(N,)`` labels (class ``c``'s curve takes ``c`` as its positive label);
    all classes in one pass."""
    if num_classes == 1:
        if preds.ndim > target.ndim:
            preds = preds[:, 0]
        weights = _sample_weights(sample_weights, preds.numel(), preds.device)
        curves = _pr_curves(preds.reshape(1, -1), (target == pos_label).reshape(1, -1), weights)
        return tuple(c[0] for c in curves)
    if target.ndim != 1:
        # the JAX package runs each class's curve as a binary one, whose
        # canonicalization refuses (N,) scores against (N, C) targets
        raise ValueError("preds and target must have same number of dimensions, or one additional dimension for preds")
    weights = _sample_weights(sample_weights, preds.shape[0], preds.device)
    classes = torch.arange(num_classes, device=target.device)
    curves = _pr_curves(preds.T, target[None, :] == classes[:, None], weights)
    return tuple(list(c) for c in curves)


def precision_recall_curve(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[List[torch.Tensor], ...]]:
    """Computes precision-recall pairs for different thresholds, on the
    device the inputs are on.

    Args:
        preds: predictions from model (probabilities)
        target: ground truth labels
        num_classes: number of classes (binary problems may omit it)
        pos_label: the positive class; defaults to 1 for binary input and
            must stay ``None`` for multiclass (each class takes a turn)
        sample_weights: non-negative, finite weight of each sample

    Returns:
        ``(precision, recall, thresholds)``; element ``i`` of precision/recall
        is the score for predictions with ``score >= thresholds[i]``, with a
        final ``(1, 0)`` point appended. Multiclass returns per-class lists.

    Example:
        >>> pred = torch.tensor([0, 1, 2, 3])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> precision, recall, thresholds = precision_recall_curve(pred, target, pos_label=1)
        >>> precision
        tensor([0.6667, 0.5000, 0.0000, 1.0000])
        >>> recall
        tensor([1.0000, 0.5000, 0.0000, 0.0000])
        >>> thresholds
        tensor([1, 2, 3])
    """
    preds, target, num_classes, pos_label = _precision_recall_curve_update(preds, target, num_classes, pos_label)
    return _precision_recall_curve_compute(preds, target, num_classes, pos_label, sample_weights)
