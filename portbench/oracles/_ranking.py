"""Tie groups of score rows in float64: Mann-Whitney AUROC and average
precision, counted exactly in int64, in plain ``torch`` operations.

Each row's ``(score, relevance)`` pairs are sorted ascending by score (one
int64 key per pair: the score's order-preserving bits, then the
relevance); the runs of equal scores are the tie groups. AUROC is the
Mann-Whitney rank sum with each group's mid-rank; AP sums, over the groups
from the highest score down, the group's positives times the precision at
its threshold, divided by the positives.
"""
import torch

ROW_ELEMENTS = 1 << 26  # elements sorted per block of rows


def ordered_bits(scores: torch.Tensor) -> torch.Tensor:
    """int64 keys in ``[0, 2**32)`` of float32 scores whose ascending order
    is the scores' (``-0.0`` counted as ``+0.0``); NaN scores are refused."""
    s = scores.to(torch.float32) + 0.0
    if bool(torch.isnan(s).any()):
        raise ValueError("the reference takes no NaN score")
    bits = s.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(bits >= 2**31, 0xFFFFFFFF - bits, bits + 2**31)


def _rows(scores: torch.Tensor, rel: torch.Tensor):
    """``(auroc, ap)`` float64 of a block of ``(R, N)`` rows."""
    rows, n = scores.shape
    key, _ = torch.sort(ordered_bits(scores) * 2 + rel.to(torch.int64), dim=1)
    r = key & 1
    value = key >> 1
    del key
    first = torch.ones(rows, n, dtype=torch.bool, device=scores.device)
    first[:, 1:] = value[:, 1:] != value[:, :-1]
    del value
    last = torch.ones_like(first)
    last[:, :-1] = first[:, 1:]
    cum = torch.cumsum(r, dim=1).reshape(-1)
    fi = torch.nonzero(first.reshape(-1)).reshape(-1)
    li = torch.nonzero(last.reshape(-1)).reshape(-1)
    r = r.reshape(-1)
    below = cum[fi] - r[fi]  # positives below the group
    pos_in = cum[li] - below  # positives in the group
    row, f, l = fi // n, (fi % n).to(torch.float64), (li % n).to(torch.float64)
    p = cum.reshape(rows, n)[:, -1].to(torch.float64)
    neg = n - p
    pos_in, below = pos_in.to(torch.float64), below.to(torch.float64)
    midrank = (f + l) / 2.0 + 1.0
    rank_sum = torch.zeros(rows, dtype=torch.float64, device=scores.device).index_add_(0, row, pos_in * midrank)
    nan = torch.tensor(float("nan"), dtype=torch.float64, device=scores.device)
    auroc = torch.where(p * neg > 0, (rank_sum - p * (p + 1) / 2.0) / (p * neg), nan)
    tp_end = p[row] - below  # positives at or above the group's score
    fp_end = neg[row] - (f - below)  # negatives at or above it
    term = pos_in * tp_end / (tp_end + fp_end)
    ap_sum = torch.zeros(rows, dtype=torch.float64, device=scores.device).index_add_(0, row, term)
    ap = torch.where(p > 0, ap_sum / p, nan)
    return auroc, ap


def auroc_ap_rows(scores: torch.Tensor, rel: torch.Tensor):
    """``(auroc, ap)`` float64 tensors of ``(R, N)`` float32 score rows
    against ``(R, N)`` boolean relevance: NaN where a row lacks a class
    (AUROC) or its positives (AP). Rows are taken in blocks of about
    ``ROW_ELEMENTS`` elements."""
    scores = scores.reshape(-1, scores.shape[-1])
    rel = rel.reshape(scores.shape)
    block = max(1, ROW_ELEMENTS // max(scores.shape[1], 1))
    parts = [_rows(scores[i:i + block], rel[i:i + block]) for i in range(0, scores.shape[0], block)]
    return torch.cat([a for a, _ in parts]), torch.cat([b for _, b in parts])


def one_vs_rest(target: torch.Tensor, classes: int) -> torch.Tensor:
    """``(C, N)`` boolean relevance rows of ``(N,)`` labels."""
    return target.reshape(1, -1) == torch.arange(classes, device=target.device).reshape(-1, 1)
