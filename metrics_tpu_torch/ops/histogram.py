"""Label-space counts and score histograms for the streaming curve metrics.

Port of ``metrics_tpu/ops/histogram.py``. The JAX package counts through a
one-hot contraction because XLA:TPU lowers scatter-add serially; on a GPU
an atomic add per element is the direct form, one pass over the labels or
scores. No Pallas kernel is involved: the JAX package's Pallas histogram
was retired.

Score histograms: unweighted counts are integer adds (exact and
deterministic), weighted sums float64 adds cast to float32 (on CUDA the
atomic adds sum in no fixed order, so the low bits of a weighted histogram
may differ from run to run). Both add into a buffer of the known length
with ``index_add_``, which reads nothing to the host. The curves read off the histograms
are evaluated in float64 and returned in float32. Unlike the JAX package,
which divides by ``max(total, 1)``, they divide by each class total itself
and test each total on its own for degeneracy, so weight totals below 1
give the same curves as the same weights scaled up.

Under ``torch.func.vmap`` (a cohort step batches every tenant's update)
both counts are custom operators with their own batching rule: the tenant
axis becomes part of the index, and every tenant is counted by ONE
``index_add`` over the flat ``(tenant, bucket)`` space, whatever the
number of tenants. functorch's own rule for ``index_add`` loops over the
batch, one kernel per tenant.
"""
from typing import Optional, Tuple

import torch


# past this many labels, atomic adds into one buffer queue on the few
# addresses of the largest classes (2.7-3.3 ms for 8,388,608 labels in 19-361
# buckets on an H100, against 0.44-0.49 ms spread over 512 copies:
# scripts/torch_label_bincount_compare.py); fewer labels, or a buffer too
# long to copy, take one buffer (0.007 ms for 5,000 labels)
_SPREAD_MIN_LABELS = 1 << 20
_SPREAD_MAX_LENGTH = 4096
_COPIES = 512


def _batched(*tensors: Optional[torch.Tensor]) -> bool:
    """True when a tensor is batched by ``torch.func.vmap``."""
    return any(t is not None and torch._C._functorch.is_batchedtensor(t) for t in tensors)


def _batch_first(x: torch.Tensor, dim: Optional[int], size: int) -> torch.Tensor:
    """``x`` with its vmap batch dim first (broadcast when it has none)."""
    return x.expand(size, *x.shape) if dim is None else x.movedim(dim, 0)


def label_bincount(indices: torch.Tensor, length: int, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 counts of each label in ``[0, length)``, under the JAX package's
    out-of-range contract: negatives clamp to bucket 0, labels ``>= length``
    are dropped. ``weights`` (bool, the shape of ``indices``) counts a label
    only where it is True.

    The counts are an ``index_add_`` into a buffer of the known length.
    ``torch.bincount`` would size its output from the data: on CUDA it reads
    the input's min and max back to the host, a synchronization per count.
    Many labels add into ``_COPIES`` copies of the buffer, position by
    position in turn, and the copies are summed. Integer adds give the same
    counts in any order.

    Under ``torch.func.vmap`` the count is one ``index_add`` over every
    tenant (:func:`_label_counts_vmap`).

    Example:
        >>> label_bincount(torch.tensor([-1, 0, 2, 2, 5]), length=3)
        tensor([2, 0, 2])
        >>> label_bincount(torch.tensor([0, 2, 2]), length=3, weights=torch.tensor([True, False, True]))
        tensor([1, 0, 1])
    """
    if _batched(indices, weights):
        return _label_counts(indices, length, weights)
    idx = indices.reshape(-1).to(torch.int64).clamp_min(0)
    # out-of-range labels go to one spare bucket, cut off below
    idx = torch.where(idx < length, idx, length)
    if idx.numel() < _SPREAD_MIN_LABELS or length > _SPREAD_MAX_LENGTH:
        ones = torch.ones_like(idx) if weights is None else weights.reshape(-1).to(torch.int64)
        counts = torch.zeros(length + 1, dtype=torch.int64, device=idx.device)
        return counts.index_add_(0, idx, ones)[:length]
    # int32 copies: each holds at most numel / _COPIES + 1 counts
    ones = torch.ones_like(idx, dtype=torch.int32) if weights is None else weights.reshape(-1).to(torch.int32)
    lanes = torch.arange(idx.numel(), device=idx.device) % _COPIES
    counts = torch.zeros((_COPIES, length + 1), dtype=torch.int32, device=idx.device)
    counts.view(-1).index_add_(0, lanes * (length + 1) + idx, ones)
    return counts.sum(0)[:length]


@torch.library.custom_op("metrics_tpu_torch::label_counts", mutates_args=())
def _label_counts(indices: torch.Tensor, length: int, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`label_bincount` as an operator, so that ``vmap`` reaches its rule."""
    return label_bincount(indices, length, weights)


@_label_counts.register_fake
def _label_counts_fake(indices, length, weights):
    """The counts' shape, dtype and device, for a trace over fake tensors
    (the program audit's abstract steps)."""
    return indices.new_empty((length,), dtype=torch.int64)


@_label_counts.register_vmap
def _label_counts_vmap(info, in_dims, indices, length, weights):
    """Every tenant's counts from one count over the flat ``(tenant,
    bucket)`` index: the out-of-range contract per tenant (negatives to 0,
    labels ``>= length`` to the tenant's spare bucket), then tenant ``t``'s
    buckets offset by ``t * (length + 1)``. The flat count takes
    :func:`label_bincount`'s own path (the spread past 2^20 labels)."""
    tenants = info.batch_size
    idx = _batch_first(indices, in_dims[0], tenants).reshape(tenants, -1).to(torch.int64).clamp_min(0)
    idx = torch.where(idx < length, idx, length)
    idx = idx + (length + 1) * torch.arange(tenants, device=idx.device)[:, None]
    if weights is not None:
        weights = _batch_first(weights, in_dims[2], tenants).reshape(-1)
    counts = label_bincount(idx.reshape(-1), tenants * (length + 1), weights)
    return counts.reshape(tenants, length + 1)[:, :length], 0


@torch.library.custom_op("metrics_tpu_torch::bucket_sums", mutates_args=())
def _bucket_sums(index: torch.Tensor, adds: torch.Tensor, buckets: int) -> torch.Tensor:
    """``adds`` summed into ``buckets`` buckets at ``index``, under ``vmap``
    one ``index_add`` over every tenant's buckets (:func:`_bucket_sums_vmap`)."""
    return torch.zeros(buckets, dtype=adds.dtype, device=index.device).index_add_(0, index, adds)


@_bucket_sums.register_fake
def _bucket_sums_fake(index, adds, buckets):
    return index.new_empty((buckets,), dtype=adds.dtype)


@_bucket_sums.register_vmap
def _bucket_sums_vmap(info, in_dims, index, adds, buckets):
    tenants = info.batch_size
    index = _batch_first(index, in_dims[0], tenants)
    index = index + buckets * torch.arange(tenants, device=index.device)[:, None]
    adds = _batch_first(adds, in_dims[1], tenants)
    return _bucket_sums(index.reshape(-1), adds.reshape(-1), tenants * buckets).reshape(tenants, buckets), 0


def score_histograms(
    preds: torch.Tensor, rel: torch.Tensor, num_bins: int, weights: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score histograms over [0, 1] of ``(N,)`` scores, or one-vs-rest ones
    of the C columns of ``(N, C)`` scores: float32 ``(hist_pos, hist_neg)``
    of shape ``(num_bins,)`` or ``(C, num_bins)``.

    ``rel`` (bool, the scores' shape) marks the positives; ``weights``
    (optional ``(N,)``, non-negative) weights every column of a sample
    alike. Scores are quantized as the JAX package quantizes them,
    ``int(score * num_bins)`` clipped into ``[0, num_bins)``; one
    ``index_add_`` fills both histograms of every column.

    Example:
        >>> score_histograms(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([False, False, True, True]), 4)
        (tensor([0., 1., 0., 1.]), tensor([1., 1., 0., 0.]))
    """
    bins = torch.clamp((preds * num_bins).to(torch.int64), 0, num_bins - 1)
    columns = 1 if preds.ndim == 1 else preds.shape[1]
    if preds.ndim == 2:
        bins = bins + num_bins * torch.arange(columns, device=preds.device)
    # positives fill the first columns * num_bins buckets, negatives the next
    index = (bins + (columns * num_bins) * (~rel)).reshape(-1)
    if weights is None:
        adds = torch.ones_like(index)
    else:
        weights = weights.to(torch.float64)
        adds = (weights if preds.ndim == 1 else weights[:, None].expand(preds.shape)).reshape(-1)
    if _batched(index, adds):
        hist = _bucket_sums(index, adds, 2 * columns * num_bins)
    else:
        hist = torch.zeros(2 * columns * num_bins, dtype=adds.dtype, device=index.device)
        hist = hist.index_add_(0, index, adds)
    hist = hist.to(torch.float32)
    hist = hist.reshape(2, columns, num_bins)
    if preds.ndim == 1:
        return hist[0, 0], hist[1, 0]
    return hist[0], hist[1]


def _cum_counts_and_thresholds(hist_pos: torch.Tensor, hist_neg: torch.Tensor):
    """Descending-threshold cumulative ``(tps, fps, thresholds)`` along the
    last dim, origin first: float64 sums and float32 thresholds.

    Point k counts scores landing in the top k bins, i.e. classifying
    positive at ``preds >= thresholds[k]`` where the threshold is the LOWER
    edge of the lowest included bin; the origin's threshold is +inf
    (sklearn's convention) because scores of exactly 1.0 land in the top bin.
    """
    num_bins = hist_pos.shape[-1]

    def cumulative(hist):
        sums = torch.cumsum(hist.to(torch.float64).flip(-1), -1)
        return torch.cat([sums.new_zeros(*sums.shape[:-1], 1), sums], -1)

    edges = torch.arange(num_bins, dtype=torch.float32, device=hist_pos.device).flip(0) / num_bins
    thresholds = torch.cat([torch.full((1,), float("inf"), device=hist_pos.device), edges])
    return cumulative(hist_pos), cumulative(hist_neg), thresholds


def _rate(counts: torch.Tensor) -> torch.Tensor:
    """``counts`` over their last entry (the class total); all zero where
    the total is 0."""
    total = counts[..., -1:]
    return counts / torch.where(total > 0, total, 1.0)


def histogram_roc(hist_pos: torch.Tensor, hist_neg: torch.Tensor):
    """(fpr, tpr, thresholds) from score histograms, descending thresholds.

    The (0, 0) origin (nothing classified positive) is included, so the
    curve is directly integrable; see :func:`_cum_counts_and_thresholds`
    for the threshold convention.
    """
    tps, fps, thresholds = _cum_counts_and_thresholds(hist_pos, hist_neg)
    return _rate(fps).float(), _rate(tps).float(), thresholds


def histogram_auroc(hist_pos: torch.Tensor, hist_neg: torch.Tensor) -> torch.Tensor:
    """AUROC from score histograms via the trapezoidal rule, NaN where a
    class is absent.

    Within-bin ties are treated as one ROC point (chord), matching the exact
    tie-corrected AUROC of scores quantized to the bin edges.

    Example:
        >>> histogram_auroc(*score_histograms(torch.tensor([0.1, 0.4, 0.35, 0.8]),
        ...                                   torch.tensor([False, False, True, True]), 4))
        tensor(0.8750)
    """
    tps, fps, _ = _cum_counts_and_thresholds(hist_pos, hist_neg)
    auc = torch.trapezoid(_rate(tps), _rate(fps), dim=-1)
    return torch.where((tps[..., -1] == 0) | (fps[..., -1] == 0), float("nan"), auc).float()


def _pr_points(hist_pos: torch.Tensor, hist_neg: torch.Tensor):
    """float64 (precision, recall) and float32 thresholds of the histogram
    PR curve; precision is 1 at the empty-positive point by convention."""
    tps, fps, thresholds = _cum_counts_and_thresholds(hist_pos, hist_neg)
    predicted = tps + fps
    precision = torch.where(predicted > 0, tps / torch.where(predicted > 0, predicted, 1.0), 1.0)
    return precision, _rate(tps), thresholds


def histogram_pr_curve(hist_pos: torch.Tensor, hist_neg: torch.Tensor):
    """(precision, recall, thresholds) from score histograms.

    Same threshold convention as :func:`histogram_roc`: point k classifies
    ``preds >= thresholds[k]`` positive, with ``thresholds[0] = +inf`` (the
    empty-positive point, precision defined as 1 there by convention).
    """
    precision, recall, thresholds = _pr_points(hist_pos, hist_neg)
    return precision.float(), recall.float(), thresholds


def histogram_average_precision(hist_pos: torch.Tensor, hist_neg: torch.Tensor) -> torch.Tensor:
    """Average precision ``sum((recall_k - recall_{k-1}) * precision_k)``,
    NaN where there is no positive."""
    precision, recall, _ = _pr_points(hist_pos, hist_neg)
    ap = torch.sum(torch.diff(recall, dim=-1) * precision[..., 1:], -1)
    return torch.where(recall[..., -1] == 0, float("nan"), ap).float()
