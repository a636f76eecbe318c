"""Exact distributed AUROC / average precision: a splitter sample sort.

Port of the binary half of ``metrics_tpu/parallel/sample_sort.py`` (its
programs A and B) for the port's one process per device over
``torch.distributed``. Instead of gathering every rank's stream to every
rank, each rank

1. co-sorts its valid prefix ``[0, count)`` (no padding is ever built, so a
   valid NaN score, which has the largest key, needs no second sort key);
2. takes ``_R`` evenly spaced key samples; one ``all_gather`` of the
   samples gives the ``W - 1`` splitters;
3. cuts its sorted run at the splitters (``searchsorted(right=True)``, so
   equal keys, a tie group, always land in one bucket) and counts, per
   bucket, its elements and their class totals; one ``all_gather`` of that
   ``(W, 3)`` table, read to the host once, gives the split sizes and every
   bucket's lower-bucket class totals (its offsets);
4. sends bucket ``d`` to rank ``d`` in one ``all_to_all`` of the packed
   keys, payloads and (weighted) weights, with per-rank split sizes: no slot
   padding as JAX's static shapes needed;
5. sorts the received runs and runs the tie-scan kernel with the offsets
   (:func:`_tie_stats`, :func:`_tie_stats_w`); one ``all_gather`` of the
   ``(area, ap)`` partials, summed in rank order in float64 on the host,
   gives the same bits on every rank.

Exact because buckets are key ranges and a tie group is one key: bucket
``d`` is a contiguous segment of the global sorted stream, and its global
cumulants are its local ones plus the class totals of the lower buckets.
The offsets reach the kernel as float32, so past 2^24 they round in the AP
ratio (about 6e-8 relative), the bound the JAX package documents.
"""
from typing import Any, Optional, Tuple

import torch

from metrics_tpu_torch.ops.auroc_kernel import _co_sort, _INT32_MAX
from metrics_tpu_torch.ops.tie_scan import tie_group_reduce
from metrics_tpu_torch.parallel.backend import get_sync_backend

_R = 64  # key samples per rank; a bucket's balance error is about N/R


def _sample_idx(count: int, device: torch.device) -> torch.Tensor:
    """``(j * count) // _R`` for ``j`` in ``[0, _R)`` (int64: no overflow)."""
    return torch.arange(_R, device=device) * max(count, 1) // _R


def _tie_stats(key_s: torch.Tensor, pay_s: torch.Tensor, off_p: float, off_n: float):
    """Area/AP partial sums of one key-sorted run that is a contiguous
    segment of the global sorted stream: the kernel's offset form.

    ``off_p``/``off_n`` are the global positive/negative counts in all
    strictly-lower buckets. They shift the AP precision ratio inside the
    kernel; the area's offset term telescopes (Σ 0.5·(2·off_p)·ΔF =
    off_p·n_neg), so it is added here. Returns float64 0-d tensors
    ``(area, ap, n_pos, n_neg)``."""
    stats = tie_group_reduce(key_s, pay_s, offsets=(off_p, off_n)).double()
    return stats[0] + off_p * stats[3], stats[1], stats[2], stats[3]


def _tie_stats_w(key_s: torch.Tensor, pay_s: torch.Tensor, w_s: torch.Tensor, off_pw: float, off_nw: float):
    """Weighted :func:`_tie_stats`: the sums are weight sums and the offsets
    the weighted class totals of all strictly-lower buckets. Weights must be
    non-negative (the sharded metrics check at update)."""
    stats = tie_group_reduce(key_s, pay_s, offsets=(off_pw, off_nw), weights_s=w_s).double()
    return stats[0] + off_pw * stats[3], stats[1], stats[2], stats[3]


def sample_sort_auroc_ap(
    preds: torch.Tensor,
    target: torch.Tensor,
    count: int,
    pos_label: int = 1,
    weights: Optional[torch.Tensor] = None,
    group: Optional[Any] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact global (AUROC, AP) of a stream held one shard per rank.

    Every rank of ``group`` calls it with its own shard.

    Args:
        preds, target: this rank's 1-d score and label buffers.
        count: this rank's fill: ``[0, count)`` is valid.
        pos_label: the label that counts as positive.
        weights: optional 1-d non-negative per-sample weights.
        group: the process group (default: the world).

    Returns:
        ``(auroc, ap)`` float32 0-d tensors on ``preds``' device, bit-equal on
        every rank; NaN where a class total is 0.
    """
    backend = get_sync_backend()
    world, me = backend.size(group), backend.rank(group)
    device = preds.device
    count = min(int(count), preds.shape[0])
    rel = (target[:count] == pos_label).to(torch.float32)
    w = None if weights is None else weights[:count].to(torch.float32)
    streams = _co_sort(preds[:count], rel, None, w)  # (key_s, pay_s[, w_s])
    key_s, pay_s = streams[0], streams[1]

    # splitters from _R evenly spaced samples per rank; an empty rank
    # samples the largest key, so its samples only close the last bucket
    if count:
        samples = key_s[_sample_idx(count, device)]
    else:
        samples = torch.full((_R,), _INT32_MAX, dtype=torch.int32, device=device)
    all_samples = torch.sort(torch.cat(backend.gather(samples, group))).values
    splitters = all_samples[torch.arange(1, world, device=device) * _R]

    # per bucket: this rank's elements and their class totals, from prefix
    # sums at the bucket bounds (float64: exact for counts, fixed order for
    # weights)
    bounds = torch.cat([
        torch.zeros(1, dtype=torch.int64, device=device),
        torch.searchsorted(key_s, splitters, right=True),
        torch.full((1,), count, dtype=torch.int64, device=device),
    ])
    pos = (pay_s == 3.0).double()
    neg = (pay_s == 2.0).double()
    if w is not None:
        pos, neg = pos * streams[2].double(), neg * streams[2].double()
    zero = torch.zeros(1, dtype=torch.float64, device=device)
    csum = torch.stack([torch.cat([zero, torch.cumsum(x, 0)]) for x in (pos, neg)])[:, bounds]
    table = torch.cat([bounds.diff().double()[:, None], csum.diff(dim=1).T], 1)  # (W, 3)
    # the one read of the exchange's shape: [rank i][bucket d] = (n, pos, neg)
    tables = torch.stack(backend.gather(table, group)).tolist()
    send = [int(tables[me][d][0]) for d in range(world)]
    recv = [int(tables[i][me][0]) for i in range(world)]
    bucket_pos = [sum(tables[i][d][1] for i in range(world)) for d in range(world)]
    bucket_neg = [sum(tables[i][d][2] for i in range(world)) for d in range(world)]
    off_p, off_n = sum(bucket_pos[:me]), sum(bucket_neg[:me])

    packed = torch.stack([t.view(torch.int32) for t in streams], 1)
    received = backend.all_to_all(packed, send, recv, group)
    key_r, order = torch.sort(received[:, 0])
    pay_r = received[:, 1].view(torch.float32)[order]
    if w is None:
        area, ap, _, _ = _tie_stats(key_r, pay_r, off_p, off_n)
    else:
        area, ap, _, _ = _tie_stats_w(key_r, pay_r, received[:, 2].view(torch.float32)[order], off_p, off_n)

    partials = torch.stack(backend.gather(torch.stack([area, ap]), group)).tolist()
    area_total, ap_total = 0.0, 0.0
    for a, p in partials:  # rank order, on the host: every rank adds the same numbers alike
        area_total += a
        ap_total += p
    n_pos, n_neg = sum(bucket_pos), sum(bucket_neg)
    # degeneracy on each factor: a product of tiny weight totals underflows
    auroc = float("nan") if n_pos == 0 or n_neg == 0 else area_total / (n_pos * n_neg)
    ap_v = float("nan") if n_pos == 0 else ap_total / n_pos
    return (
        torch.tensor(auroc, dtype=torch.float32, device=device),
        torch.tensor(ap_v, dtype=torch.float32, device=device),
    )
