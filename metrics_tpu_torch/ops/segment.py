"""Grouped-query (retrieval) ranking: one stable sort, then integer scans.

Port of ``metrics_tpu/ops/segment.py``. Every query of an epoch is ranked
at once: one stable sort by ``(group asc, score desc)`` (ties keep their
input order), then the rank of each element within its group, the
within-group cumulative relevance and the per-group sums come from scans
and gathers at the group bounds. There is no per-query loop.

Where JAX sorts with one two-key ``lax.sort``, ``torch.sort`` takes one
key. The two formulations of the permutation are kept side by side
(:func:`_lex_order_two_pass`, :func:`_lex_order_packed`); they give the
same permutation, and :data:`_lex_order` names the one the H100
measured faster at the MS MARCO passage dev shape (``PERF.md``).

Ranks and cumulative counts are int32 cumsums, exact past 2^24 (JAX's
float32 ``cumsum`` is not). Per-group sums take differences of an int64
cumsum at the group ends, never a float scan or float atomics, so the same
inputs give the same bits on every run (PyTorch flags its float ``cumsum``
on CUDA as nondeterministic).
"""
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from metrics_tpu_torch.ops.auroc_kernel import _sortable_key


class RankedGroupStats(NamedTuple):
    """Per-element ranking plus per-group sufficient statistics.

    Element-wise arrays are in sorted order: ``group`` ascending, then score
    descending, ties in input order. The scores read the int32 fields as
    float only where they divide.
    """

    group: torch.Tensor  # (N,) int32 dense group id of each element
    relevant: torch.Tensor  # (N,) float32 0/1 relevance in sorted order
    rank: torch.Tensor  # (N,) int32 1-based rank within the group
    cum_relevant: torch.Tensor  # (N,) int32 within-group inclusive cumsum of relevance
    pos_per_group: torch.Tensor  # (G,) int32 number of relevant docs per group


def _rank_order(preds: torch.Tensor) -> torch.Tensor:
    """Stable permutation by descending score: ``-0.0`` and ``+0.0`` tie,
    NaN ranks last (the sortable key's order), ties keep input order."""
    return torch.sort(_sortable_key(preds), stable=True).indices


def _lex_order_two_pass(group: torch.Tensor, preds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(group_sorted, order)`` by two stable int32 sorts with a gather
    between them: score key first, then group."""
    by_score = _rank_order(preds)
    group_sorted, by_group = torch.sort(group.to(torch.int32)[by_score], stable=True)
    return group_sorted, by_score[by_group]


def _lex_order_packed(group: torch.Tensor, preds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(group_sorted, order)`` by one stable sort of an int64 composite
    key: the signed int32 group in the high word (monotone), the score key
    shifted to ``[0, 2^32)`` in the low word."""
    composite = group.to(torch.int64) * 2**32 + (_sortable_key(preds).to(torch.int64) + 2**31)
    composite_sorted, order = torch.sort(composite, stable=True)
    return torch.div(composite_sorted, 2**32, rounding_mode="floor").to(torch.int32), order


# the form kept: two int32 sorts beat the packed int64 sort on the H100 (PERF.md)
_lex_order = _lex_order_two_pass


def _group_bounds(group_sorted: torch.Tensor, num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(starts, ends)``, int64 ``(G,)``: group ``g`` is
    ``group_sorted[starts[g]:ends[g]]`` (empty when absent)."""
    groups = torch.arange(num_groups, dtype=torch.int32, device=group_sorted.device)
    return torch.searchsorted(group_sorted, groups), torch.searchsorted(group_sorted, groups, right=True)


def _group_sums(values: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Per-group sums of int64 ``values`` whose groups are contiguous runs:
    differences of one inclusive cumsum at the group bounds (exact)."""
    csum = F.pad(torch.cumsum(values, 0, dtype=torch.int64), (1, 0))
    return csum[ends] - csum[starts]


def _fixed_point_group_sums(values: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Per-group float64 sums of ``values`` in ``[0, 1]``, bit-reproducible:
    each value is rounded to a multiple of ``2^-s`` and summed as an int64,
    ``s = 62 - bits(N)`` so that no sum of N values can overflow. The
    rounding is below ``2^-40`` a value up to N = 2^21 and ``2^-33`` at
    N = 2^28."""
    scale = 2.0 ** (62 - values.shape[0].bit_length())
    fixed = torch.round(values.to(torch.float64) * scale).to(torch.int64)
    return _group_sums(fixed, starts, ends).to(torch.float64) / scale


def _stats_of_sorted(group_sorted: torch.Tensor, target_sorted: torch.Tensor, num_groups: int) -> RankedGroupStats:
    """The statistics of elements already in ``(group, score desc)`` order."""
    n = group_sorted.shape[0]
    rel = (target_sorted > 0).to(torch.int32)
    starts, ends = _group_bounds(group_sorted, num_groups)
    positions = torch.arange(n, device=group_sorted.device)
    rank = (positions - starts[group_sorted] + 1).to(torch.int32)
    # relevant elements before each position: the within-group count is the
    # inclusive count minus that at the group's start
    before = F.pad(torch.cumsum(rel, 0, dtype=torch.int32), (1, 0))
    cum_relevant = before[1:] - before[starts][group_sorted]
    pos_per_group = before[ends] - before[starts]
    return RankedGroupStats(group_sorted, rel.to(torch.float32), rank, cum_relevant, pos_per_group)


def ranked_group_stats(
    group: torch.Tensor, preds: torch.Tensor, target: torch.Tensor, num_groups: int
) -> RankedGroupStats:
    """Rank every element within its group by descending score.

    Args:
        group: (N,) dense int group ids in ``[0, num_groups)``.
        preds: (N,) float scores.
        target: (N,) 0/1 relevance labels.
        num_groups: the number of groups (absent ones get empty statistics).

    Example:
        >>> stats = ranked_group_stats(torch.tensor([1, 0, 1, 0]), torch.tensor([0.2, 0.9, 0.7, 0.1]),
        ...                            torch.tensor([1, 0, 0, 1]), num_groups=2)
        >>> stats.rank, stats.cum_relevant, stats.pos_per_group
        (tensor([1, 2, 1, 2], dtype=torch.int32), tensor([0, 1, 0, 1], dtype=torch.int32), tensor([1, 1], dtype=torch.int32))
    """
    group_sorted, order = _lex_order(group, preds)
    return _stats_of_sorted(group_sorted, target[order], num_groups)


def _ranked_query_stats(idx: torch.Tensor, preds: torch.Tensor, target: torch.Tensor) -> Optional[RankedGroupStats]:
    """:func:`ranked_group_stats` of raw int32 query ids, densified on the
    device: sorting by the raw ids puts each query's run in id order, and
    dense ids count the id changes (``q[1:] != q[:-1]``), so group ``g`` is
    the g-th smallest id, as ``np.unique`` numbers them. One host read (the
    number of queries); None when there is no element."""
    if idx.shape[0] == 0:
        return None
    q_sorted, order = _lex_order(idx, preds)
    dense = F.pad(torch.cumsum(q_sorted[1:] != q_sorted[:-1], 0, dtype=torch.int32), (1, 0))
    return _stats_of_sorted(dense, target[order], int(dense[-1]) + 1)


def hits_in_topk(stats: RankedGroupStats, k: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group int32 ``(relevant-in-top-k, group size)``.

    ``k=None`` means each group's own size (all of it). Shared by retrieval
    precision@k and recall@k, which differ only in the denominator. A hit
    count is the within-group cumulative relevance at rank ``min(k, size)``.
    """
    starts, ends = _group_bounds(stats.group, stats.pos_per_group.shape[0])
    sizes = ends - starts
    top = sizes if k is None else torch.clamp_max(sizes, k)
    cum = F.pad(stats.cum_relevant, (1, 0))
    hits = torch.where(top > 0, cum[starts + top], 0)
    return hits.to(torch.int32), sizes.to(torch.int32)
