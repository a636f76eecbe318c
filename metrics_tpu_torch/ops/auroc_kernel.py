"""Exact AUROC / average precision: one co-sort plus O(N) scans.

Port of ``metrics_tpu/ops/auroc_kernel.py``: binary streams, and C streams
at once for one-vs-rest multi-class and multi-label inputs. The integral
over deduped curve points equals a sum over tie groups, each closing one
segment from the previous group's cumulative counts; those previous-group
counts are forward-filled with a ``cummax`` (cumulative counts never
decrease). So the whole computation is one sort plus scans: no gather of
curve points, no host round-trip.

Where the tensors are decides the path:

* CUDA: the co-sort (a library radix sort, ``torch.sort``, as ``lax.sort``
  was in the JAX package; along ``dim=1`` for ``(C, N)`` rows; per-sample
  weights gathered beside the payload), then the hand-written tie-scan
  kernel, one launch for one stream or for all C rows, weighted or not
  (:func:`~metrics_tpu_torch.ops.tie_scan.tie_group_reduce`,
  :func:`~metrics_tpu_torch.ops.tie_scan.tie_group_reduce_rows`), then
  :func:`~metrics_tpu_torch.ops.tie_scan.auroc_ap_from_stats`.
* CPU: the plain group formulas along the last dim (:func:`_tie_groups`,
  :func:`_auroc_from_groups`, :func:`_ap_from_groups`); weighted streams
  take the kernel's plain version.

The sort key is the JAX package's total-order map, computed in int32
(:func:`_sortable_key`): ascending key == descending score, ``-0.0`` and
``+0.0`` share one key, NaN sorts last. :func:`_descending_key` gives its
uint32 form, bit-identical to the JAX package's key.
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.ops.tie_scan import auroc_ap_from_stats, tie_group_reduce, tie_group_reduce_rows

_INT32_MIN = -(2**31)
_INT32_MAX = 2**31 - 1


def _sortable_key(preds: torch.Tensor) -> torch.Tensor:
    """int32 sort key: ascending key == descending f32 score.

    The standard bit-level monotone map of f32 onto signed int32, inverted.
    ``-0.0`` is mapped to ``+0.0`` first (in bit space) so equal scores share
    one key, i.e. one tie group; NaN scores sort last.
    """
    p = preds.to(torch.float32).contiguous()
    b = p.view(torch.int32)
    b = torch.where(b == _INT32_MIN, 0, b)
    ascending = torch.where(b >= 0, b, b ^ _INT32_MAX)
    return torch.where(torch.isnan(p), _INT32_MAX, ~ascending)


def _descending_key(preds: torch.Tensor) -> torch.Tensor:
    """uint32 sort key, bit-identical to ``metrics_tpu``'s: ascending key ==
    descending score. It is :func:`_sortable_key` with the sign bit flipped."""
    return (_sortable_key(preds) ^ _INT32_MIN).view(torch.uint32)


def _score_from_key(key: torch.Tensor) -> torch.Tensor:
    """Invert :func:`_descending_key`: the f32 score of a uint32 key. Exact
    for every float except the canonicalized ones: ``-0.0`` comes back as
    ``+0.0`` and NaNs come back as *a* NaN."""
    ascending = ~(key.view(torch.int32) ^ _INT32_MIN)
    b = torch.where(ascending >= 0, ascending, ascending ^ _INT32_MAX)
    return b.view(torch.float32)


def _payload(rel: torch.Tensor, weight: Optional[torch.Tensor]) -> torch.Tensor:
    """The packed ``rel + 2*weight`` payload (both in {0, 1}): only 3 and 2
    move counts, so weight-0 (masked) elements are inert wherever they sort."""
    return rel + 2.0 if weight is None else rel + 2.0 * weight


def _co_sort(
    preds: torch.Tensor, rel: torch.Tensor, mask: Optional[torch.Tensor] = None, weights: Optional[torch.Tensor] = None
):
    """Sort the keys, carry the payload (and the weights) along:
    ``(key_s int32, payload_s f32)``, or ``(key_s, payload_s, weights_s f32)``
    when per-sample ``weights`` are given.

    Unstable on purpose: every consumer reads sums only at tie-group
    boundaries, which no permutation within a group can change. ``mask``
    (default all-ones) must be binary {0, 1}: masked elements are counted
    nowhere, so they cannot affect the result wherever their (arbitrary,
    even ±inf) score sorts them."""
    key_s, order = torch.sort(_sortable_key(preds))
    payload_s = _payload(rel, mask)[order]
    if weights is None:
        return key_s, payload_s
    return key_s, payload_s, weights.to(torch.float32)[order]


def _co_sort_rows(keys: torch.Tensor, payload: torch.Tensor, weights: Optional[torch.Tensor] = None):
    """The segmented co-sort of ``(C, N)`` rows: each row of int32 ``keys``
    sorted on its own (a library sort along ``dim=1``, as ``lax.sort`` under
    ``jax.vmap`` was), its payload row (and the ``(N,)`` per-sample
    ``weights``, the same for every row) gathered along."""
    key_s, order = torch.sort(keys, dim=1)
    payload_s = torch.gather(payload, 1, order)
    if weights is None:
        return key_s, payload_s
    return key_s, payload_s, torch.gather(weights.to(torch.float32).expand_as(payload), 1, order)


def _tie_groups(key_s: torch.Tensor, payload_s: torch.Tensor):
    """Cumulative counts + tie masks of key-sorted streams along the last
    dim (one ``(N,)`` stream or ``(C, N)`` rows).

    Returns ``(tps, fps, is_last, tps_prev, fps_prev)`` where ``*_prev`` are
    the cumulative counts *before* each element's tie group, forward-filled
    to the whole group: valid at group firsts, -inf elsewhere; ``cummax``
    fills forward because cumulative counts are non-decreasing.
    """
    pos_w = (payload_s == 3.0).to(torch.float32)
    neg_w = (payload_s == 2.0).to(torch.float32)
    # count in i32, not f32: an f32 cumsum of {0,1} sticks at 2^24
    tps = torch.cumsum(pos_w.to(torch.int32), -1, dtype=torch.int32).to(torch.float32)
    fps = torch.cumsum(neg_w.to(torch.int32), -1, dtype=torch.int32).to(torch.float32)

    boundary = key_s[..., 1:] != key_s[..., :-1]
    one = torch.ones(*key_s.shape[:-1], 1, dtype=torch.bool, device=key_s.device)
    is_first = torch.cat([one, boundary], -1)
    is_last = torch.cat([boundary, one], -1)

    tps_prev = torch.cummax(torch.where(is_first, tps - pos_w, float("-inf")), -1).values
    fps_prev = torch.cummax(torch.where(is_first, fps - neg_w, float("-inf")), -1).values
    return tps, fps, is_last, tps_prev, fps_prev


def _auroc_from_groups(tps, fps, is_last, tps_prev, fps_prev) -> torch.Tensor:
    """Tie-corrected trapezoid area over groups → normalized AUROC per
    stream (NaN when a class is absent)."""
    area = torch.sum(torch.where(is_last, 0.5 * (tps + tps_prev) * (fps - fps_prev), 0.0), -1)
    n_pos = tps[..., -1]
    n_neg = fps[..., -1]
    return torch.where(n_pos * n_neg == 0, float("nan"), area / torch.clamp_min(n_pos * n_neg, 1.0))


def _ap_from_groups(tps, fps, is_last, tps_prev) -> torch.Tensor:
    """Per-threshold ``ΔR·P`` sum over groups → average precision per
    stream (NaN when no positives)."""
    n_pos = tps[..., -1]
    precision = tps / torch.clamp_min(tps + fps, 1.0)
    ap = torch.sum(torch.where(is_last, (tps - tps_prev) * precision, 0.0), -1) / torch.clamp_min(n_pos, 1.0)
    return torch.where(n_pos == 0, float("nan"), ap)


def _scores(
    key_s: torch.Tensor, payload_s: torch.Tensor, weights_s: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(AUROC, AP) of co-sorted streams, one ``(N,)`` or ``(C, N)`` rows,
    on the device their tensors are on: the kernel on CUDA (one launch for
    all rows), the plain group formulas on the CPU. Weighted streams take
    the weighted kernel on CUDA and its plain version on the CPU."""
    reduce = tie_group_reduce if key_s.ndim == 1 else tie_group_reduce_rows
    if weights_s is not None:
        return auroc_ap_from_stats(reduce(key_s, payload_s, weights_s=weights_s))
    if key_s.device.type == "cuda":
        return auroc_ap_from_stats(reduce(key_s, payload_s))
    if key_s.device.type != "cpu":
        raise ValueError(f"exact AUROC/AP runs on CUDA or CPU tensors, got a tensor on {key_s.device}")
    tps, fps, is_last, tps_prev, fps_prev = _tie_groups(key_s, payload_s)
    return _auroc_from_groups(tps, fps, is_last, tps_prev, fps_prev), _ap_from_groups(tps, fps, is_last, tps_prev)


def _auroc_ap(
    preds: torch.Tensor,
    rel: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(AUROC, AP) of one 1-d stream over its ``mask``-valid elements,
    weighted by ``weights`` where given, on the device its tensors are on.
    A masked element's weight is never read, whatever it holds."""
    return _scores(*_co_sort(preds, rel, mask, weights))


def _auroc_ap_rows(
    preds: torch.Tensor,
    rel: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(C,)`` AUROC and AP of C streams given as ``(C, N)`` score and
    relevance rows, over the ``(N,)`` ``mask``-valid columns and weighted by
    the ``(N,)`` ``weights`` where given: one segmented co-sort and one
    batched tie scan (the weighted one with weights) for all rows."""
    payload = _payload(rel, None if mask is None else mask.to(torch.float32))
    return _scores(*_co_sort_rows(_sortable_key(preds), payload, weights))


def _weighted_stats(preds: torch.Tensor, rel: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``[area, ap_sum, pos, neg]`` of one ``(N,)`` stream, or ``(C, 4)`` of
    ``(C, N)`` rows, weighted by the ``(N,)`` ``weights``: one co-sort and
    one weighted tie-scan launch (its plain version on the CPU). Normalize
    with :func:`~metrics_tpu_torch.ops.tie_scan.auroc_ap_from_stats`."""
    if preds.ndim == 1:
        key_s, payload_s, weights_s = _co_sort(preds, rel, None, weights)
        return tie_group_reduce(key_s, payload_s, weights_s=weights_s)
    key_s, payload_s, weights_s = _co_sort_rows(_sortable_key(preds), _payload(rel, None), weights)
    return tie_group_reduce_rows(key_s, payload_s, weights_s=weights_s)


def _ovr_relevance(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``(C, N)`` one-vs-rest relevance rows of ``(N,)`` labels, built in the
    class-major layout the batched scan takes (no ``(N, C)`` one-hot)."""
    classes = torch.arange(num_classes, device=target.device)
    return (target.reshape(1, -1) == classes[:, None]).to(torch.float32)


def multiclass_auroc_ovr(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-class one-vs-rest AUROC of ``(N, C)`` scores vs ``(N,)`` labels.

    One segmented sort and one batched tie-scan launch for all C classes,
    as the JAX package's ``jax.vmap`` over classes is one program. Classes
    absent from ``target`` (or covering all of it) yield NaN.

    Example:
        >>> preds = torch.tensor([[0.5, 0.3, 0.2], [0.2, 0.5, 0.3], [0.1, 0.3, 0.6], [0.4, 0.4, 0.2], [0.3, 0.2, 0.5]])
        >>> multiclass_auroc_ovr(preds, torch.tensor([0, 1, 2, 1, 1]))
        tensor([1.0000, 0.6667, 1.0000])
    """
    return _auroc_ap_rows(preds.T, _ovr_relevance(target, preds.shape[1]))[0]


def multiclass_average_precision(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-class exact average precision of ``(N, C)`` scores vs ``(N,)``
    labels, batched like :func:`multiclass_auroc_ovr` (the JAX package's
    ``jax.vmap`` of ``binary_average_precision`` over classes). Classes
    absent from ``target`` yield NaN.

    Example:
        >>> preds = torch.tensor([[0.5, 0.3, 0.2], [0.2, 0.5, 0.3], [0.1, 0.3, 0.6], [0.4, 0.4, 0.2], [0.3, 0.2, 0.5]])
        >>> multiclass_average_precision(preds, torch.tensor([0, 1, 2, 1, 1]))
        tensor([1.0000, 0.8667, 1.0000])
    """
    return _auroc_ap_rows(preds.T, _ovr_relevance(target, preds.shape[1]))[1]


def multilabel_auroc(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-label AUROC of ``(N, C)`` scores vs ``(N, C)`` binary targets
    (label 1 is relevant), batched like :func:`multiclass_auroc_ovr`."""
    return _auroc_ap_rows(preds.T, (target.T == 1).to(torch.float32))[0]


def _relevance(target: torch.Tensor, pos_label: int) -> torch.Tensor:
    return (target == pos_label).to(torch.float32)


def binary_auroc(preds: torch.Tensor, target: torch.Tensor, pos_label: int = 1) -> torch.Tensor:
    """Exact AUROC of 1-d scores vs binary targets (NaN for a single class).

    Tie-correct: tied scores form one ROC point (the tie group's chord), as
    in sklearn's ``roc_auc_score``.

    Example:
        >>> binary_auroc(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        tensor(0.7500)
    """
    return _auroc_ap(preds, _relevance(target, pos_label))[0]


def binary_average_precision(preds: torch.Tensor, target: torch.Tensor, pos_label: int = 1) -> torch.Tensor:
    """Exact average precision of 1-d scores vs binary targets.

    Tie-correct: AP = sum over distinct thresholds of ``(R_k - R_{k-1}) * P_k``.
    Targets with no positive sample yield NaN.

    Example:
        >>> round(float(binary_average_precision(
        ...     torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))), 4)
        0.8333
    """
    return _auroc_ap(preds, _relevance(target, pos_label))[1]


def masked_binary_auroc(
    preds: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, pos_label: int = 1
) -> torch.Tensor:
    """Exact AUROC over the ``mask``-valid subset, static shape.

    Invalid entries get weight 0 in the cumulative counts — no score
    sentinel, so even valid ``±inf`` scores (raw logits) stay exact.
    """
    return _auroc_ap(preds, _relevance(target, pos_label), mask.to(torch.float32))[0]


def masked_binary_average_precision(
    preds: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, pos_label: int = 1
) -> torch.Tensor:
    """Exact average precision over the ``mask``-valid subset."""
    return _auroc_ap(preds, _relevance(target, pos_label), mask.to(torch.float32))[1]


def masked_weighted_binary_auroc(
    preds: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, weights: torch.Tensor, pos_label: int = 1
) -> torch.Tensor:
    """Exact AUROC over the ``mask``-valid subset with non-negative
    per-sample ``weights``: one co-sort and one weighted tie-scan launch.
    Masked entries move nothing, whatever their score or weight. NaN when
    either class has zero total weight."""
    return _auroc_ap(preds, _relevance(target, pos_label), mask.to(torch.float32), weights)[0]


def masked_weighted_binary_average_precision(
    preds: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, weights: torch.Tensor, pos_label: int = 1
) -> torch.Tensor:
    """Exact average precision over the ``mask``-valid subset with
    non-negative per-sample ``weights`` (NaN when the positives weigh 0)."""
    return _auroc_ap(preds, _relevance(target, pos_label), mask.to(torch.float32), weights)[1]
