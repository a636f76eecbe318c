"""Drive the PyTorch/CUDA port (``metrics_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA device::

    python3 chip_smoke.py

It uses one card: the first one ``CUDA_VISIBLE_DEVICES`` names, card 0 when
that is unset. Phases (any failure exits non-zero before the result line):

1. build every CUDA kernel of ``metrics_tpu_torch/csrc`` with ``nvcc``, all
   sources at once;
2. hold each kernel against its plain PyTorch version on the card:

   a. the one-stream scan (``tie_scan``) at the shapes the binary path gives
      it and at the hazards (block edges, one tie group, masking, bucket
      offsets, a positive class above 2^24), and the 1M-element AUROC/AP
      against float64 numpy oracles;
   b. the class-batched scan (``tie_scan_rows``) at ``(1, 1)``,
      ``(3, 4097)``, ``(7, 32769)``, ``(80, 40504)`` and ``(1000, 50000)``,
      with a one-group row, a row without positives and a signed-zero row,
      and at ``(131073, 3)``, more rows than a grid's y dimension holds;
      every row must also equal the one-stream scan of that row, bit for
      bit;
   c. the weighted one-stream scan (``tie_scan_w``) at the edge sizes and at
      45,840,617 elements (the Criteo Display Advertising Challenge
      training set's rows), lognormal weights; zero weights against the
      masked unweighted scan, unit weights against the unweighted scan
      (within 1e-6), and tiny totals, which must not read as degenerate;
      10 more launches at 45,840,617 must give the same bits (the tiles'
      look-back windows differ from launch to launch);
   c′. the bucket-offset form on its path: a 1M stream cut into 4 key-range
      buckets at the sample sort's own splitter rule, ``_tie_stats`` /
      ``_tie_stats_w`` on each bucket with its lower-bucket class totals as
      offsets; the buckets must sum to the one-stream result within 1e-6;
   d. the weighted batched scan (``tie_scan_rows_w``) at the row shapes of
      b; every row must equal the weighted one-stream scan of that row, bit
      for bit, and 10 more launches at ``(1000, 50000)`` the same bits;

3. the binary main path: ``MetricCollection([Accuracy(), AUROC(pos_label=1)])``
   on ``cuda``, 10 forward batches of 100,000 seeded predictions, then
   ``compute()``, checked against numpy, with the kernel's launch count;
3b. the sharded binary path: ``MetricCollection([ShardedAUROC(...),
   ShardedAveragePrecision(...)])`` with ``capacity_per_device=45,840,617``
   and ``with_sample_weights=True`` on ``cuda``, seeded scores, labels with
   P(1) = score and lognormal weights appended in batches of 4,194,304 (the
   last short), then ``compute()``: against float64 numpy oracles, exactly
   one weighted launch per metric compute and no plain-version call on the
   card; the unweighted ``ShardedAUROC`` of the same stream equal to
   ``AUROC(pos_label=1)`` within 1e-6;
3c. the binary curves on phase 3's 1M predictions: ``ROC(pos_label=1)`` and
   ``PrecisionRecallCurve(pos_label=1)`` over the 10 batches, equal in
   length and thresholds to a float64 numpy oracle and within 1e-6 in
   their points, then ``AUC()`` of that ROC; ``AUROC(pos_label=1,
   max_fpr=0.1)`` against the McClish value of the oracle; functional
   ``auroc`` and ``average_precision`` with lognormal ``sample_weights``
   against the weighted oracle, one ``tie_scan_w`` launch each and no
   plain-version call; ``ShardedROC`` / ``ShardedPrecisionRecallCurve`` at
   world 1 equal to ``ROC`` / ``PrecisionRecallCurve``; the curve of phase
   2a's 20M stream (1,001 scores, the positive class above 2^24) with int32
   counts equal to numpy's int64 ones;
4. the multi-class main path at the ImageNet-1k validation shape (ILSVRC2012
   val: 50,000 images, 1,000 classes, 50 per class):
   ``MetricCollection([Accuracy(), AUROC(num_classes=1000),
   AveragePrecision(num_classes=1000)])`` on ``cuda``, 10 update batches of
   5,000 seeded softmax scores, then ``compute()``: Accuracy equal to
   numpy's, macro AUROC and every class's AP against float64 oracles, and
   exactly one batched launch per AUROC and per AP compute; then one
   ``forward``; then per-label AUROC at the MS-COCO 2014 val shape (40,504
   images, 80 labels) against the oracles;
4b. the sharded one-vs-rest path at the same shape and data with lognormal
   sample weights: ``ShardedAUROC`` and ``ShardedAveragePrecision`` with
   ``num_classes=1000``, ``capacity_per_device=50,000``,
   ``with_sample_weights=True`` and ``average="weighted"``; against float64
   oracles, exactly one weighted batched launch per metric compute;
4c. per-class curves on phase 4's data: ``ROC(num_classes=1000)`` and
   ``PrecisionRecallCurve(num_classes=1000)`` against the oracle for every
   class; weighted per-class ``auroc`` / ``average_precision``, one
   ``tie_scan_rows_w`` launch each; multi-label ``average="micro"`` AUROC
   at the MS-COCO shape, one ``tie_scan`` launch; the host
   synchronizations of one per-class curve compute, counted with
   ``torch.cuda.set_sync_debug_mode``, the same at C = 10 and C = 1000;
4d. the binned curves with 512 bins, binary at 1M and one-vs-rest at
   50,000 x 1,000, unweighted and weighted: histograms against numpy's
   counts (exact, or within 1e-5 relative weighted), values within 1e-6 of
   a float64 evaluation of the same histograms;
5. times on the card (CUDA events over launches queued behind a device
   sleep, so host overhead does not show, or the host clock ending in a
   synchronize for whole steps): the one-stream kernel, its plain version
   and both co-sort forms at 1M; the one-stream kernel at the 20M stream of
   phase 2a; the batched kernel, its plain version, the
   same rows as 1,000 one-stream launches and both co-sort forms at
   ``(1000, 50000)``; a forward batch and both compute steps; the weighted
   kernels and their plain versions at 45,840,617 and at ``(1000, 50000)``,
   the offset form at 1M, and both sharded compute steps; the curve family
   (host clock ending in a synchronize, one warm-up, median of 5): the ROC
   and PR-curve compute at 1M and at (1000, 50000), the ``max_fpr`` AUROC
   and the weighted functional AUROC at 1M, and one binned update at
   1M x 512 and at 50,000 x 1,000 x 512;
6. where the time goes: ``torch.profiler`` over a binary forward batch plus
   compute, over one multi-class compute, over one weighted sharded binary
   compute, over one per-class ROC compute at (1000, 50000), and over one
   call of each kernel entry (one stream at 1M,
   batched at ``(1000, 50000)``, and the two weighted ones at their paths'
   shapes), each of which must show one kernel and at most the memset of
   its scratch.

Prints the card's name and power limit (``nvidia-smi``), ``{"timings": ...}``
and ``{"profile": ...}`` lines, a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Exits with 1 and prints no result when no
CUDA device is available.
"""
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

SEED = 0
BATCHES = 10
BATCH = 100_000
MAIN_N = BATCHES * BATCH
TIE_HEAVY_N = 1_000_003
BIG_N = 20_000_000  # with 90% positives the positive class exceeds 2^24
EDGE_SIZES = (1, 7, 32767, 32768, 32769, BATCH)

# the class-batched scan: (rows, n) shapes, the last that of the multi-class
# main path, and a batch of more rows than a grid's y dimension (65535) holds
ROW_SHAPES = ((1, 1), (3, 4097), (7, 32769), (80, 40504), (1000, 50000))
CHUNKED_ROWS = (131_073, 3)
# the Criteo Display Advertising Challenge training set: 45,840,617 rows,
# held as one weighted evaluation stream, appended in batches of 2^22
CRITEO_N = 45_840_617
SHARDED_BATCH = 4_194_304
# ILSVRC2012 val: 50,000 images, 1,000 classes, 50 images per class
IMAGENET_N, IMAGENET_C = 50_000, 1_000
MC_BATCHES = 10
# launches of a weighted kernel that must repeat the first one's bits
REPEATS = 10
# MS-COCO 2014 val: 40,504 images, 80 labels
COCO_N, COCO_C = 40_504, 80

# H100 SXM data sheet: HBM bandwidth, and the float32 and float64 rates
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12

# kernel vs plain version: exact counts; the two sum the same f32 terms in
# f64 in other orders (and nvcc may contract to FMA), so the normalized
# AUROC and AP agree to well below one f32 ulp of 1
SCORE_TOL = 1e-6
# against the float64 numpy oracles: f32 scores and f32 terms
ORACLE_TOL = 1e-5
# curve points against the float64 oracle: rates of exact counts, each cast to f32 once
CURVE_TOL = 1e-6
# the binned curves' histogram resolution
NUM_BINS = 512


def _pin_one_card() -> str:
    """Make the run see one card, the first visible one; returns its
    ``nvidia-smi`` index (or UUID). Must run before CUDA initializes."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    first = "0" if visible is None else visible.split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = first
    return first


def _card_line(card: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", card, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _oracle_auroc(scores: np.ndarray, rel: np.ndarray) -> float:
    """Tie-corrected Mann-Whitney AUROC in float64."""
    s = scores.astype(np.float64)
    neg = np.sort(s[~rel])
    pos = s[rel]
    lo = np.searchsorted(neg, pos, side="left")
    hi = np.searchsorted(neg, pos, side="right")
    return (float(lo.sum()) + 0.5 * float((hi - lo).sum())) / (float(pos.size) * float(neg.size))


def _oracle_ap(scores: np.ndarray, rel: np.ndarray) -> float:
    """Tie-corrected average precision in float64 (one point per distinct score)."""
    s = scores.astype(np.float64)
    order = np.argsort(-s, kind="stable")
    s, r = s[order], rel[order]
    last = np.r_[s[1:] != s[:-1], True]
    tp = np.cumsum(r)[last].astype(np.float64)
    fp = np.cumsum(~r)[last].astype(np.float64)
    prev = np.r_[0.0, tp[:-1]]
    return float(np.sum((tp - prev) * (tp / (tp + fp))) / tp[-1])


def _oracle_weighted(scores: np.ndarray, rel: np.ndarray, weights: np.ndarray):
    """Tie-corrected weighted (AUROC, AP) in float64: one point per
    distinct score, as sklearn's ``sample_weight``."""
    s = scores.astype(np.float64)
    order = np.argsort(-s)
    s, r, w = s[order], rel[order], weights[order].astype(np.float64)
    last = np.r_[s[1:] != s[:-1], True]
    tp = np.cumsum(np.where(r, w, 0.0))[last]
    fp = np.cumsum(np.where(r, 0.0, w))[last]
    tp_prev, fp_prev = np.r_[0.0, tp[:-1]], np.r_[0.0, fp[:-1]]
    auroc = float(np.sum(0.5 * (tp + tp_prev) * (fp - fp_prev)) / (tp[-1] * fp[-1]))
    ap = float(np.sum((tp - tp_prev) * tp / np.maximum(tp + fp, 1e-300)) / tp[-1])
    return auroc, ap


def _oracle_points(scores: np.ndarray, rel: np.ndarray, weights=None):
    """One curve point per distinct score, descending: ``(fps, tps,
    thresholds)`` after a stable descending argsort, int64 counts (float64
    weight sums)."""
    order = np.argsort(-scores, kind="stable")
    s, r = scores[order], rel[order]
    last = np.r_[s[1:] != s[:-1], True]
    if weights is None:
        tps = np.cumsum(r, dtype=np.int64)
        fps = np.arange(1, s.size + 1, dtype=np.int64) - tps
    else:
        w = weights[order].astype(np.float64)
        tps, fps = np.cumsum(np.where(r, w, 0.0)), np.cumsum(np.where(r, 0.0, w))
    return fps[last], tps[last], s[last]


def _oracle_roc(scores: np.ndarray, rel: np.ndarray):
    """(fpr, tpr, thresholds) in float64 (thresholds in the scores' dtype),
    opened by the (0, 0) point at the top score plus one."""
    fps, tps, thr = _oracle_points(scores, rel)
    fpr = np.r_[0.0, fps / fps[-1]]
    tpr = np.r_[0.0, tps / tps[-1]]
    return fpr, tpr, np.r_[thr[:1] + thr.dtype.type(1), thr]


def _oracle_pr(scores: np.ndarray, rel: np.ndarray):
    """(precision, recall, thresholds): the points up to full recall in
    ascending threshold order, closed by (1, 0)."""
    fps, tps, thr = _oracle_points(scores, rel)
    stop = int(np.argmax(tps == tps[-1])) + 1
    precision = tps[:stop] / (tps[:stop] + fps[:stop])
    recall = tps[:stop] / tps[-1]
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0], thr[:stop][::-1]


def _trapezoid(y: np.ndarray, x: np.ndarray, axis: int = -1) -> np.ndarray:
    dx = np.diff(x, axis=axis)
    return np.sum(dx * (np.take(y, range(1, y.shape[axis]), axis) + np.take(y, range(y.shape[axis] - 1), axis)) / 2,
                  axis=axis)


def _oracle_partial_auroc(fpr: np.ndarray, tpr: np.ndarray, max_fpr: float) -> float:
    """McClish-standardized partial AUROC over [0, max_fpr] in float64."""
    stop = int(np.searchsorted(fpr, max_fpr, side="right"))
    weight = (max_fpr - fpr[stop - 1]) / (fpr[stop] - fpr[stop - 1])
    interp = tpr[stop - 1] + weight * (tpr[stop] - tpr[stop - 1])
    area = float(_trapezoid(np.r_[tpr[:stop], interp], np.r_[fpr[:stop], max_fpr]))
    min_area = 0.5 * max_fpr**2
    return 0.5 * (1 + (area - min_area) / (max_fpr - min_area))


def _oracle_histograms(scores: np.ndarray, rel: np.ndarray, num_bins: int, weights=None):
    """``(hist_pos, hist_neg)`` of ``(N,)`` or ``(N, C)`` f32 scores: numpy
    counts (float64 weight sums) of ``int(score * num_bins)`` clipped to the
    bins, one row per column."""
    columns = 1 if scores.ndim == 1 else scores.shape[1]
    bins = np.clip((scores * np.float32(num_bins)).astype(np.int64), 0, num_bins - 1)
    if scores.ndim == 2:
        bins = bins + num_bins * np.arange(columns)
    w = np.ones(scores.shape) if weights is None else np.broadcast_to(
        weights.astype(np.float64).reshape(-1, *([1] * (scores.ndim - 1))), scores.shape)
    pos = np.bincount(bins[rel], weights=w[rel], minlength=columns * num_bins).reshape(columns, num_bins)
    neg = np.bincount(bins[~rel], weights=w[~rel], minlength=columns * num_bins).reshape(columns, num_bins)
    return (pos[0], neg[0]) if scores.ndim == 1 else (pos, neg)


def _float64_binned(hist_pos: np.ndarray, hist_neg: np.ndarray):
    """(AUROC, AP, precision, recall) of histograms along the last axis,
    evaluated in float64, each class total divided out on its own."""
    zero = np.zeros((*hist_pos.shape[:-1], 1))
    tps = np.concatenate([zero, np.cumsum(hist_pos[..., ::-1].astype(np.float64), -1)], -1)
    fps = np.concatenate([zero, np.cumsum(hist_neg[..., ::-1].astype(np.float64), -1)], -1)
    tpr = tps / np.where(tps[..., -1:] > 0, tps[..., -1:], 1.0)
    fpr = fps / np.where(fps[..., -1:] > 0, fps[..., -1:], 1.0)
    auroc = np.where((tps[..., -1] == 0) | (fps[..., -1] == 0), np.nan, _trapezoid(tpr, fpr))
    predicted = tps + fps
    precision = np.where(predicted > 0, tps / np.where(predicted > 0, predicted, 1.0), 1.0)
    ap = np.where(tps[..., -1] == 0, np.nan, np.sum(np.diff(tpr, axis=-1) * precision[..., 1:], -1))
    return auroc, ap, precision, tpr


def _queued_ms(torch, fn, launches: int = 50, trials: int = 7) -> float:
    """Device time of one call: ``launches`` calls queued behind a device
    sleep (so they run back to back), timed with CUDA events; median of
    ``trials``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def _host_ms(torch, fn, trials: int = 5) -> float:
    times = []
    for _ in range(trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _bound(n_elements: int, groups: int, outputs: int, weighted: bool = False):
    """(bound ms, what bounds it) of one scan: 8 bytes read per element (12
    weighted) and 16 bytes written per output; 5 operations per element
    (compare, decode, prefix) and 10 per group start (the terms: f32, or
    f64 weighted)."""
    bytes_ms = ((12 if weighted else 8) * n_elements + 16 * outputs) / HBM_BYTES_PER_S * 1e3
    ops_ms = (5 * n_elements + 10 * groups) / (F64_OPS_PER_S if weighted else F32_OPS_PER_S) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _saved(collection) -> dict:
    """The collection's states as they are now: list states are copied, so
    later updates, which append to the live lists, do not reach them."""
    return {k: list(v) if isinstance(v, list) else v for k, v in collection.state_dict().items()}


def _device_ms_by_kernel(torch, prof, key: str) -> dict:
    return {
        e.key: getattr(e, key) / 1e3
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and getattr(e, key) > 0
    }


def main() -> int:
    card_index = _pin_one_card()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from metrics_tpu_torch import (
        AUC,
        AUROC,
        ROC,
        Accuracy,
        AveragePrecision,
        BinnedAUROC,
        BinnedAveragePrecision,
        BinnedPrecisionRecallCurve,
        MetricCollection,
        PrecisionRecallCurve,
        ShardedAUROC,
        ShardedAveragePrecision,
        ShardedPrecisionRecallCurve,
        ShardedROC,
    )
    from metrics_tpu_torch.functional import auroc as functional_auroc
    from metrics_tpu_torch.functional import average_precision as functional_average_precision
    from metrics_tpu_torch.functional.classification.precision_recall_curve import _binary_clf_curve
    from metrics_tpu_torch.ops import _native, tie_scan
    from metrics_tpu_torch.ops.auroc_kernel import (
        _co_sort,
        _co_sort_rows,
        _ovr_relevance,
        _payload,
        _sortable_key,
        binary_auroc,
        binary_average_precision,
        masked_binary_auroc,
    )
    from metrics_tpu_torch.parallel.sample_sort import _R, _sample_idx, _tie_stats, _tie_stats_w

    def zero_counts():
        for wrapper in (tie_scan.tie_group_reduce, tie_scan.tie_group_reduce_rows):
            wrapper.launches = wrapper.weighted_launches = 0
        tie_scan.tie_group_reduce.offset_launches = 0

    def counts():
        one, rows = tie_scan.tie_group_reduce, tie_scan.tie_group_reduce_rows
        return {"tie_scan": one.launches, "tie_scan_w": one.weighted_launches, "offsets": one.offset_launches,
                "tie_scan_rows": rows.launches, "tie_scan_rows_w": rows.weighted_launches}

    # calls of the plain version on the card (the main paths must make none)
    plain_on_card = {"calls": 0, "watch": False}
    scan_reference = tie_scan._scan_reference

    def watched_scan_reference(key, *args):
        if plain_on_card["watch"] and key.device.type == "cuda":
            plain_on_card["calls"] += 1
        return scan_reference(key, *args)

    tie_scan._scan_reference = watched_scan_reference

    dev = torch.device("cuda")
    if torch.cuda.device_count() != 1:
        raise AssertionError(f"expected one visible card, got {torch.cuda.device_count()}")
    card = _card_line(card_index)
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    built = _native.build()
    print(f"build: {sorted(built)} in {time.perf_counter() - t0:.2f} s")

    # ---- 2a. the one-stream kernel against its plain version --------------
    rng = np.random.default_rng(SEED)
    max_err = 0.0

    def hold(label, scores, rel, mask=None, offsets=None):
        nonlocal max_err
        preds = torch.from_numpy(scores).to(dev)
        rel_t = torch.from_numpy(rel.astype(np.float32)).to(dev)
        w = None if mask is None else torch.from_numpy(mask.astype(np.float32)).to(dev)
        key_s, pay_s = _co_sort(preds, rel_t, w)
        want = tie_scan.tie_group_reduce_reference(key_s, pay_s, offsets)
        got = tie_scan.tie_group_reduce(key_s, pay_s, offsets)
        torch.cuda.synchronize()
        g, w = got.tolist(), want.tolist()
        if g[2:] != w[2:]:
            raise AssertionError(f"{label}: counts {g[2:]} != plain {w[2:]}")
        err = [abs(g[i] - w[i]) / max(1.0, abs(w[i])) for i in (0, 1)]
        if max(err) > SCORE_TOL:
            raise AssertionError(f"{label}: area/ap {g[:2]} vs plain {w[:2]} (rel err {err})")
        ga, gp = (float(x) for x in tie_scan.auroc_ap_from_stats(got))
        wa, wp = (float(x) for x in tie_scan.auroc_ap_from_stats(want))
        for a, b in ((ga, wa), (gp, wp)):
            if np.isnan(a) != np.isnan(b) or (not np.isnan(a) and abs(a - b) > SCORE_TOL):
                raise AssertionError(f"{label}: scores ({ga}, {gp}) vs plain ({wa}, {wp})")
            if not np.isnan(a):
                max_err = max(max_err, abs(a - b))
        return want, key_s, pay_s

    for n in EDGE_SIZES:
        hold(f"n={n}", np.round(rng.standard_normal(n), 1).astype(np.float32), rng.random(n) < 0.5)
    hold("one tie group", np.zeros(40_000, np.float32), rng.random(40_000) < 0.5)
    hold("signed zeros", np.array([0.0, -0.0] * 20_000, np.float32), rng.random(40_000) < 0.5)
    scores = np.round(rng.random(TIE_HEAVY_N), 2).astype(np.float32)
    rel = rng.random(TIE_HEAVY_N) < scores
    hold("tie-heavy 1M", scores, rel)
    mask = rng.random(TIE_HEAVY_N) < 0.7
    garbage = np.where(mask, scores, np.float32(1e30)).astype(np.float32)
    hold("masked 1M", garbage, rel, mask)
    hold("offsets 1M", scores, rel, offsets=(1234.0, 777.0))
    big_scores = np.round(rng.random(BIG_N), 3).astype(np.float32)
    big_rel = rng.random(BIG_N) < 0.9
    big, big_key_s, big_pay_s = hold("20M", big_scores, big_rel)
    if not big[2].item() > 2**24:
        raise AssertionError(f"20M stream: positive count {big[2].item()} does not exceed 2^24")
    # masked elements are inert, whatever their scores
    m_t = torch.from_numpy(mask).to(dev)
    r_t = torch.from_numpy(rel.astype(np.int64)).to(dev)
    a1 = float(masked_binary_auroc(torch.from_numpy(garbage).to(dev), r_t, m_t))
    a2 = float(masked_binary_auroc(torch.from_numpy(scores).to(dev), r_t, m_t))
    # the masked-off elements move the valid ones across tiles, which only
    # reorders the sum of the same terms
    if abs(a1 - a2) > SCORE_TOL:
        raise AssertionError(f"masked AUROC moved with masked-off scores: {a1} != {a2}")
    # the 1M-element scores against float64 oracles
    s_t = torch.from_numpy(scores).to(dev)
    auroc_1m = float(binary_auroc(s_t, r_t))
    ap_1m = float(binary_average_precision(s_t, r_t))
    oracle_auroc, oracle_ap = _oracle_auroc(scores, rel), _oracle_ap(scores, rel)
    if abs(auroc_1m - oracle_auroc) > ORACLE_TOL or abs(ap_1m - oracle_ap) > ORACLE_TOL:
        raise AssertionError(f"1M: AUROC {auroc_1m} / AP {ap_1m} vs oracle {oracle_auroc} / {oracle_ap}")
    torch.cuda.synchronize()
    print(f"kernel vs plain: ok, max |d score| {max_err:.3g}; 1M AUROC {auroc_1m:.7f} (oracle {oracle_auroc:.7f}),"
          f" AP {ap_1m:.7f} (oracle {oracle_ap:.7f})")

    # ---- 2b. the class-batched kernel against its plain version ----------
    max_err_rows = 0.0

    def hold_rows(label, scores, rel):
        """Batched launch vs plain version (counts exact, area/AP and the
        scores within SCORE_TOL, NaN where the plain version has NaN) and
        vs one one-stream launch per row (bit for bit)."""
        nonlocal max_err_rows
        rows = scores.shape[0]
        preds = torch.from_numpy(scores).to(dev)
        rel_t = torch.from_numpy(rel.astype(np.float32)).to(dev)
        key_s, pay_s = _co_sort_rows(_sortable_key(preds), _payload(rel_t, None))
        want = tie_scan.tie_group_reduce_rows_reference(key_s, pay_s)
        got = tie_scan.tie_group_reduce_rows(key_s, pay_s)
        singles = torch.stack([tie_scan.tie_group_reduce(key_s[r], pay_s[r]) for r in range(rows)])
        torch.cuda.synchronize()
        bad = (got[:, 2:] != want[:, 2:]).any(1).nonzero().flatten()
        if bad.numel():
            r = int(bad[0])
            raise AssertionError(f"{label}: row {r} counts {got[r, 2:].tolist()} != plain {want[r, 2:].tolist()}")
        rel_err = (got[:, :2].double() - want[:, :2].double()).abs() / want[:, :2].double().abs().clamp_min(1.0)
        if float(rel_err.max()) > SCORE_TOL:
            raise AssertionError(f"{label}: area/ap rel err {float(rel_err.max())} > {SCORE_TOL}")
        for g, w in zip(tie_scan.auroc_ap_from_stats(got), tie_scan.auroc_ap_from_stats(want)):
            if not torch.equal(torch.isnan(g), torch.isnan(w)):
                raise AssertionError(f"{label}: NaN rows differ from the plain version's")
            d = (g - w).abs()[~torch.isnan(w)]
            if d.numel():
                if float(d.max()) > SCORE_TOL:
                    raise AssertionError(f"{label}: score diff {float(d.max())} > {SCORE_TOL}")
                max_err_rows = max(max_err_rows, float(d.max()))
        if not torch.equal(got, singles):
            r = int((got != singles).any(1).nonzero().flatten()[0])
            raise AssertionError(f"{label}: row {r} {got[r].tolist()} != one-stream launch {singles[r].tolist()}")
        return want

    def row_case(rows, n, gen=rng):
        """Seeded rows: tie-heavy (rounded) and tie-free rows alternate; rows
        0, 1 and 2 (where present) are one tie group, without positives, and
        signed zeros."""
        scores = gen.random((rows, n), dtype=np.float32)
        scores[::2] = np.round(scores[::2], 2)
        rel = gen.random((rows, n)) < 0.3
        if rows >= 3:
            scores[0] = 0.25
            rel[1] = False
            scores[2] = np.where(np.arange(n) % 2 == 0, np.float32(0.0), np.float32(-0.0))
        return scores, rel

    for rows, n in ROW_SHAPES:
        want = hold_rows(f"rows {rows}x{n}", *row_case(rows, n))
        if rows >= 3 and not (want[1, 2].item() == 0 and want[0, 3].item() > 0):
            raise AssertionError(f"rows {rows}x{n}: the special rows are not what they should be")
    hold_rows(f"rows {CHUNKED_ROWS[0]}x{CHUNKED_ROWS[1]} (past a grid's y dimension)", *row_case(*CHUNKED_ROWS))
    print(f"batched kernel vs plain and vs one-stream launches: ok at {list(ROW_SHAPES) + [CHUNKED_ROWS]},"
          f" max |d score| {max_err_rows:.3g}")

    # ---- 2c. the weighted one-stream kernel against its plain version -----
    # the phases this slice added draw from their own generator, so the
    # earlier phases keep their inputs
    rng_w = np.random.default_rng(SEED + 1)
    max_err_w = 0.0

    def check_stats(label, got, want, tol=SCORE_TOL):
        """Sums within tol relative; scores within tol, NaN where the plain
        version has NaN. Returns the largest score difference."""
        rel_err = float(((got.double() - want.double()).abs() / want.double().abs().clamp_min(1e-30)).max())
        if rel_err > tol:
            raise AssertionError(f"{label}: {got.tolist()} vs {want.tolist()} (rel err {rel_err})")
        worst = 0.0
        for g, w in zip(tie_scan.auroc_ap_from_stats(got), tie_scan.auroc_ap_from_stats(want)):
            if not torch.equal(torch.isnan(g), torch.isnan(w)):
                raise AssertionError(f"{label}: NaN scores differ")
            d = (g - w).abs()[~torch.isnan(w)]
            if d.numel():
                worst = max(worst, float(d.max()))
        if worst > tol:
            raise AssertionError(f"{label}: scores differ by {worst}")
        return worst

    def hold_weighted(label, scores, rel, weights, mask=None):
        nonlocal max_err_w
        m = None if mask is None else torch.from_numpy(mask.astype(np.float32)).to(dev)
        streams = _co_sort(torch.from_numpy(scores).to(dev), torch.from_numpy(rel.astype(np.float32)).to(dev), m,
                           torch.from_numpy(weights).to(dev))
        got = tie_scan.tie_group_reduce(*streams[:2], weights_s=streams[2])
        want = tie_scan.tie_group_reduce_reference(*streams[:2], None, streams[2])
        torch.cuda.synchronize()
        max_err_w = max(max_err_w, check_stats(label, got, want))
        return streams, got

    for n in EDGE_SIZES:
        hold_weighted(f"weighted n={n}", np.round(rng_w.standard_normal(n), 1).astype(np.float32), rng_w.random(n) < 0.5,
                      rng_w.lognormal(size=n).astype(np.float32))
    # the sharded binary path's stream: seeded scores, P(1) = score, lognormal weights
    cr_preds_np = rng_w.random(CRITEO_N, dtype=np.float32)
    cr_target_np = (rng_w.random(CRITEO_N) < cr_preds_np).astype(np.int32)
    cr_w_np = rng_w.lognormal(size=CRITEO_N).astype(np.float32)
    cr_streams, cr_stats = hold_weighted("weighted 45,840,617", cr_preds_np, cr_target_np.astype(bool), cr_w_np)
    cr_repeats = [tie_scan.tie_group_reduce(*cr_streams[:2], weights_s=cr_streams[2]) for _ in range(REPEATS)]
    torch.cuda.synchronize()
    if not all(torch.equal(r, cr_stats) for r in cr_repeats):
        raise AssertionError("weighted 45,840,617: a repeated launch gave other bits")
    w_mask = mask.astype(np.float32)
    hold_weighted("weighted masked 1M", garbage, rel, np.where(mask, rng_w.lognormal(size=TIE_HEAVY_N), 0.0)
                  .astype(np.float32), mask)
    # zero weights equal masking; unit weights equal no weights; tiny totals are not degenerate
    unit = np.ones(TIE_HEAVY_N, np.float32)
    s1, r1, m1 = (torch.from_numpy(x).to(dev) for x in (scores, rel.astype(np.float32), w_mask))
    zero_streams = _co_sort(s1, r1, None, m1)
    zero_w = tie_scan.tie_group_reduce(*zero_streams[:2], weights_s=zero_streams[2])
    masked_u = tie_scan.tie_group_reduce(*_co_sort(s1, r1, m1))
    max_err_w = max(max_err_w, check_stats("zero weights vs masking", zero_w, masked_u))
    unit_streams = _co_sort(s1, r1, None, torch.from_numpy(unit).to(dev))
    unit_w = tie_scan.tie_group_reduce(*unit_streams[:2], weights_s=unit_streams[2])
    plain_u = tie_scan.tie_group_reduce(*unit_streams[:2])
    max_err_w = max(max_err_w, check_stats("unit weights vs no weights", unit_w, plain_u))
    if not torch.equal(unit_w[2:], plain_u[2:]):
        raise AssertionError(f"unit weights: totals {unit_w[2:].tolist()} != counts {plain_u[2:].tolist()}")
    tiny = tie_scan.tie_group_reduce(*unit_streams[:2], weights_s=unit_streams[2] * 1e-26)
    tiny_auroc, tiny_ap = (float(x) for x in tie_scan.auroc_ap_from_stats(tiny))
    if np.isnan(tiny_auroc) or abs(tiny_ap - float(tie_scan.auroc_ap_from_stats(plain_u)[1])) > ORACLE_TOL:
        raise AssertionError(f"tiny totals {tiny[2:].tolist()}: AUROC {tiny_auroc}, AP {tiny_ap}")
    torch.cuda.synchronize()
    print(f"weighted kernel vs plain: ok at {list(EDGE_SIZES) + [CRITEO_N]}, masked, zero, unit and tiny weights;"
          f" max |d score| {max_err_w:.3g}; {REPEATS} repeats at {CRITEO_N} bit-equal")

    # ---- 2c′. the bucket-offset form, on the sample sort's bucket epilogue --
    zero_counts()
    off_w_t = torch.from_numpy(rng_w.lognormal(size=TIE_HEAVY_N).astype(np.float32)).to(dev)
    shards = s1.chunk(4)  # four ranks' shards; their samples give the splitters
    samples = torch.cat([torch.sort(_sortable_key(x)).values[_sample_idx(x.numel(), dev)] for x in shards])
    splitters = torch.sort(samples).values[torch.arange(1, 4, device=dev) * _R]
    max_err_off = 0.0
    bucket_sizes = []
    for weights in (None, off_w_t):
        streams = _co_sort(s1, r1, None, weights)
        bounds = [0, *torch.searchsorted(streams[0], splitters, right=True).tolist(), TIE_HEAVY_N]
        area = ap_sum = off_p = off_n = 0.0
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            part = [x[lo:hi] for x in streams]
            stats = _tie_stats(*part, off_p, off_n) if weights is None else _tie_stats_w(*part, off_p, off_n)
            plain = tie_scan.tie_group_reduce_reference(*part[:2], (off_p, off_n), *part[2:]).double()
            plain[0] += off_p * plain[3]  # the area's offset term, as _tie_stats adds it
            check_stats(f"bucket [{lo}, {hi}) vs plain", torch.stack(stats), plain)
            area, ap_sum = area + float(stats[0]), ap_sum + float(stats[1])
            off_p, off_n = off_p + float(stats[2]), off_n + float(stats[3])
        whole = tie_scan.tie_group_reduce(*streams[:2], weights_s=None if weights is None else streams[2]).double()
        buckets = (area / (off_p * off_n), ap_sum / off_p)
        one = (float(whole[0] / (whole[2] * whole[3])), float(whole[1] / whole[2]))
        max_err_off = max(max_err_off, *(abs(a - b) for a, b in zip(buckets, one)))
        if max_err_off > SCORE_TOL:
            raise AssertionError(f"buckets {buckets} vs one stream {one}")
        bucket_sizes.append(np.diff(bounds).tolist())
    torch.cuda.synchronize()
    offset_launches = counts()["offsets"]
    if offset_launches != 8:
        raise AssertionError(f"the bucket epilogue made {offset_launches} offset launches, want 8 (4 buckets x 2)")
    print(f"bucket-offset form: 4 buckets {bucket_sizes[0]} sum to the one-stream AUROC/AP within"
          f" {max_err_off:.3g}, weighted and not; {offset_launches} offset launches")

    # ---- 2d. the weighted class-batched kernel against its plain version ---
    max_err_rows_w = 0.0
    for rows, n in ROW_SHAPES:
        sc, rl = row_case(rows, n, rng_w)
        wt = torch.from_numpy(rng_w.lognormal(size=(rows, n)).astype(np.float32)).to(dev)
        key_s, pay_s, w_s = _co_sort_rows(_sortable_key(torch.from_numpy(sc).to(dev)),
                                          _payload(torch.from_numpy(rl.astype(np.float32)).to(dev), None), wt)
        got = tie_scan.tie_group_reduce_rows(key_s, pay_s, weights_s=w_s)
        want = tie_scan.tie_group_reduce_rows_reference(key_s, pay_s, None, w_s)
        singles = torch.stack([tie_scan.tie_group_reduce(key_s[r], pay_s[r], weights_s=w_s[r]) for r in range(rows)])
        torch.cuda.synchronize()
        max_err_rows_w = max(max_err_rows_w, check_stats(f"weighted rows {rows}x{n}", got, want))
        if not torch.equal(got, singles):
            r = int((got != singles).any(1).nonzero().flatten()[0])
            raise AssertionError(f"weighted rows {rows}x{n}: row {r} {got[r].tolist()} != {singles[r].tolist()}")
        if (rows, n) == ROW_SHAPES[-1]:
            repeats = [tie_scan.tie_group_reduce_rows(key_s, pay_s, weights_s=w_s) for _ in range(REPEATS)]
            torch.cuda.synchronize()
            if not all(torch.equal(r, got) for r in repeats):
                raise AssertionError(f"weighted rows {rows}x{n}: a repeated launch gave other bits")
    print(f"weighted batched kernel vs plain and vs one-stream launches: ok at {list(ROW_SHAPES)},"
          f" max |d score| {max_err_rows_w:.3g}; {REPEATS} repeats at {ROW_SHAPES[-1]} bit-equal")

    # ---- 3. the binary main path -----------------------------------------
    preds_np = rng.random(MAIN_N, dtype=np.float32)
    target_np = (rng.random(MAIN_N) < preds_np).astype(np.int64)
    preds = torch.from_numpy(preds_np).to(dev)
    target = torch.from_numpy(target_np).to(dev)
    collection = MetricCollection([Accuracy(), AUROC(pos_label=1)])
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for b in range(BATCHES):
        step = collection(preds[b * BATCH:(b + 1) * BATCH], target[b * BATCH:(b + 1) * BATCH])
    t_forward = time.perf_counter() - t0
    result = collection.compute()
    torch.cuda.synchronize()
    main_path_s = time.perf_counter() - t0
    launches = tie_scan.tie_group_reduce.launches
    if launches == 0:
        raise AssertionError("the binary main path never launched the tie_scan kernel")
    if tie_scan.tie_group_reduce_rows.launches != 0:
        raise AssertionError("the binary main path launched the class-batched kernel")
    values = {k: v.item() for k, v in result.items()}
    for k, v in list(values.items()) + [(k, v.item()) for k, v in step.items()]:
        if not np.isfinite(v):
            raise AssertionError(f"main path: {k} = {v} is not finite")
    rel_np = target_np.astype(bool)
    want_acc = float(np.float32(np.sum((preds_np >= 0.5) == rel_np)) / np.float32(MAIN_N))
    want_auroc = _oracle_auroc(preds_np, rel_np)
    if values["Accuracy"] != want_acc:
        raise AssertionError(f"main path: Accuracy {values['Accuracy']} != numpy {want_acc}")
    if abs(values["AUROC"] - want_auroc) > ORACLE_TOL:
        raise AssertionError(f"main path: AUROC {values['AUROC']} vs oracle {want_auroc}")
    print(f"binary main path: {values} (numpy: Accuracy {want_acc}, AUROC {want_auroc:.7f}),"
          f" tie_scan launches {launches}, {main_path_s:.3f} s including first calls")

    # ---- 3b. the sharded binary path: one weighted stream of Criteo's rows --
    cr_preds = torch.from_numpy(cr_preds_np).to(dev)
    cr_target = torch.from_numpy(cr_target_np).to(dev).long()
    cr_w = torch.from_numpy(cr_w_np).to(dev)
    cr_batches = [slice(b, b + SHARDED_BATCH) for b in range(0, CRITEO_N, SHARDED_BATCH)]

    def only(launched, **want):
        return all(v == want.get(k, 0) for k, v in launched.items())

    sharded = MetricCollection([
        ShardedAUROC(capacity_per_device=CRITEO_N, with_sample_weights=True),
        ShardedAveragePrecision(capacity_per_device=CRITEO_N, with_sample_weights=True),
    ])
    torch.cuda.synchronize()
    zero_counts()
    plain_on_card.update(calls=0, watch=True)
    t0 = time.perf_counter()
    for sl in cr_batches:
        sharded.update(cr_preds[sl], cr_target[sl], sample_weights=cr_w[sl])
    sh_result = sharded.compute()
    torch.cuda.synchronize()
    sharded_path_s = time.perf_counter() - t0
    plain_on_card["watch"] = False
    sh_launches = counts()
    if not only(sh_launches, tie_scan_w=2) or plain_on_card["calls"]:
        raise AssertionError(
            f"sharded binary path: launches {sh_launches}, {plain_on_card['calls']} plain-version calls on the"
            " card; want exactly one weighted launch per metric compute and no plain version"
        )
    sh_values = {k: v.item() for k, v in sh_result.items()}
    cr_oracle = _oracle_weighted(cr_preds_np, cr_target_np.astype(bool), cr_w_np)
    for k, want in zip(("ShardedAUROC", "ShardedAveragePrecision"), cr_oracle):
        if not abs(sh_values[k] - want) <= ORACLE_TOL:
            raise AssertionError(f"sharded binary path: {k} {sh_values[k]} vs float64 oracle {want}")
    # without weights, the sharded metric is AUROC of the same stream
    pair = MetricCollection([ShardedAUROC(capacity_per_device=CRITEO_N), AUROC(pos_label=1)])
    for sl in cr_batches:
        pair.update(cr_preds[sl], cr_target[sl])
    pair_values = {k: v.item() for k, v in pair.compute().items()}
    if not abs(pair_values["ShardedAUROC"] - pair_values["AUROC"]) <= SCORE_TOL:
        raise AssertionError(f"unweighted ShardedAUROC {pair_values['ShardedAUROC']} != AUROC {pair_values['AUROC']}")
    del pair
    print(f"sharded binary path at {CRITEO_N}: {sh_values} (float64 oracle {cr_oracle}), launches {sh_launches},"
          f" {sharded_path_s:.3f} s including first calls; unweighted ShardedAUROC {pair_values['ShardedAUROC']:.7f}"
          f" = AUROC {pair_values['AUROC']:.7f}")

    # ---- 3c. the binary curves at 1M ---------------------------------------
    rng_c = np.random.default_rng(SEED + 2)

    def check_curve(label, got, want, tol=CURVE_TOL):
        """Equal lengths and thresholds, the two value arrays within tol."""
        g = [x.cpu().numpy() for x in got]
        if [x.shape for x in g] != [np.shape(x) for x in want]:
            raise AssertionError(f"{label}: shapes {[x.shape for x in g]} != oracle {[np.shape(x) for x in want]}")
        if not np.array_equal(g[2], want[2]):
            raise AssertionError(f"{label}: thresholds differ from the oracle's")
        err = max(float(np.max(np.abs(a.astype(np.float64) - b), initial=0.0)) for a, b in zip(g[:2], want[:2]))
        if not err <= tol:
            raise AssertionError(f"{label}: points off the oracle by {err}")
        return err

    curves = MetricCollection([ROC(pos_label=1), PrecisionRecallCurve(pos_label=1)])
    sharded_curves = MetricCollection([ShardedROC(capacity_per_device=MAIN_N),
                                       ShardedPrecisionRecallCurve(capacity_per_device=MAIN_N)])
    partial = AUROC(pos_label=1, max_fpr=0.1)
    torch.cuda.synchronize()
    zero_counts()
    plain_on_card.update(calls=0, watch=True)
    t0 = time.perf_counter()
    for b in range(BATCHES):
        sl = slice(b * BATCH, (b + 1) * BATCH)
        for coll in (curves, sharded_curves, partial):
            coll.update(preds[sl], target[sl])
    curve_values = curves.compute()
    sharded_values = sharded_curves.compute()
    partial_value = partial.compute().item()
    area = AUC()
    area.update(*curve_values["ROC"][:2])
    area_value = area.compute().item()
    w_1m_np = rng_c.lognormal(size=MAIN_N).astype(np.float32)
    w_1m = torch.from_numpy(w_1m_np).to(dev)
    before = counts()
    w_auroc_1m = functional_auroc(preds, target, pos_label=1, sample_weights=w_1m).item()
    w_auroc_launches = {k: v - before[k] for k, v in counts().items()}
    before = counts()
    w_ap_1m = functional_average_precision(preds, target, pos_label=1, sample_weights=w_1m).item()
    w_ap_launches = {k: v - before[k] for k, v in counts().items()}
    torch.cuda.synchronize()
    curves_path_s = time.perf_counter() - t0
    plain_on_card["watch"] = False
    curve_launches = counts()
    if not only(w_auroc_launches, tie_scan_w=1) or not only(w_ap_launches, tie_scan_w=1) or plain_on_card["calls"]:
        raise AssertionError(
            f"weighted functional AUROC/AP: launches {w_auroc_launches} / {w_ap_launches},"
            f" {plain_on_card['calls']} plain-version calls on the card; want one tie_scan_w launch each"
        )
    curve_err = check_curve("ROC at 1M", curve_values["ROC"], _oracle_roc(preds_np, rel_np))
    curve_err = max(curve_err, check_curve("PrecisionRecallCurve at 1M", curve_values["PrecisionRecallCurve"],
                                           _oracle_pr(preds_np, rel_np)))
    for name, mine in (("ROC", "ShardedROC"), ("PrecisionRecallCurve", "ShardedPrecisionRecallCurve")):
        if not all(torch.equal(a, b) for a, b in zip(curve_values[name], sharded_values[mine])):
            raise AssertionError(f"{mine} at world 1 differs from {name}")
    if abs(area_value - want_auroc) > ORACLE_TOL:
        raise AssertionError(f"AUC of the 1M ROC {area_value} vs oracle AUROC {want_auroc}")
    oracle_fpr, oracle_tpr, _ = _oracle_roc(preds_np, rel_np)
    want_partial = _oracle_partial_auroc(oracle_fpr, oracle_tpr, 0.1)
    if abs(partial_value - want_partial) > ORACLE_TOL:
        raise AssertionError(f"AUROC(max_fpr=0.1) {partial_value} vs McClish oracle {want_partial}")
    w_oracle_1m = _oracle_weighted(preds_np, rel_np, w_1m_np)
    if abs(w_auroc_1m - w_oracle_1m[0]) > ORACLE_TOL or abs(w_ap_1m - w_oracle_1m[1]) > ORACLE_TOL:
        raise AssertionError(f"weighted 1M: AUROC {w_auroc_1m} / AP {w_ap_1m} vs float64 oracle {w_oracle_1m}")
    # the 20M stream of phase 2a (1,001 scores, the positive class above 2^24): exact int32 counts
    big_fps, big_tps, big_thr = _binary_clf_curve(torch.from_numpy(big_scores).to(dev),
                                                  torch.from_numpy(big_rel).to(dev))
    milli = np.rint(big_scores.astype(np.float64) * 1000).astype(np.int64)
    pos_per = np.bincount(milli[big_rel], minlength=1001)[::-1]
    all_per = np.bincount(milli, minlength=1001)[::-1]
    present = all_per > 0
    value_of = np.zeros(1001, np.float32)
    value_of[milli] = big_scores
    want_tps = np.cumsum(pos_per)[present]
    want_fps = np.cumsum(all_per - pos_per)[present]
    if big_tps.dtype != torch.int32 or not (np.array_equal(big_tps.cpu().numpy(), want_tps)
                                             and np.array_equal(big_fps.cpu().numpy(), want_fps)
                                             and np.array_equal(big_thr.cpu().numpy(), value_of[::-1][present])):
        raise AssertionError("20M stream: the curve's counts or thresholds differ from numpy's int64 counts")
    if not want_tps[-1] > 2**24:
        raise AssertionError(f"20M stream: positive count {want_tps[-1]} does not exceed 2^24")
    del big_scores, big_rel, milli
    print(f"binary curves at {MAIN_N}: ROC {len(curve_values['ROC'][0])} points and PR"
          f" {len(curve_values['PrecisionRecallCurve'][0])} points equal the float64 oracle (max |d| {curve_err:.3g}),"
          f" sharded curves equal; AUC {area_value:.7f}; AUROC(max_fpr=0.1) {partial_value:.7f} (McClish oracle"
          f" {want_partial:.7f}); weighted AUROC {w_auroc_1m:.7f} / AP {w_ap_1m:.7f} (oracle {w_oracle_1m[0]:.7f} /"
          f" {w_oracle_1m[1]:.7f}), one tie_scan_w launch each; 20M curve: {len(want_tps)} points, int32 counts exact"
          f" (positives {int(want_tps[-1])}); {curves_path_s:.3f} s including first calls")

    # ---- 4. the multi-class main path, ImageNet-1k val shape --------------
    mc_target_np = rng.permutation(np.repeat(np.arange(IMAGENET_C), IMAGENET_N // IMAGENET_C))
    logits = rng.standard_normal((IMAGENET_N, IMAGENET_C), dtype=np.float32)
    logits[np.arange(IMAGENET_N), mc_target_np] += np.float32(3.0)
    logits -= logits.max(axis=1, keepdims=True)
    np.exp(logits, out=logits)
    mc_scores_np = logits / logits.sum(axis=1, keepdims=True)
    del logits
    mc_preds = torch.from_numpy(mc_scores_np).to(dev)
    mc_target = torch.from_numpy(mc_target_np).to(dev)
    mc_batch = IMAGENET_N // MC_BATCHES

    def mc_collection():
        return MetricCollection(
            [Accuracy(), AUROC(num_classes=IMAGENET_C), AveragePrecision(num_classes=IMAGENET_C)]
        )

    mc = mc_collection()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for b in range(MC_BATCHES):
        mc.update(mc_preds[b * mc_batch:(b + 1) * mc_batch], mc_target[b * mc_batch:(b + 1) * mc_batch])
    mc_result = mc.compute()
    torch.cuda.synchronize()
    mc_path_s = time.perf_counter() - t0
    rows_launches = tie_scan.tie_group_reduce_rows.launches
    if rows_launches != 2 or tie_scan.tie_group_reduce.launches != 0:
        raise AssertionError(
            f"multi-class path: {rows_launches} batched and {tie_scan.tie_group_reduce.launches} one-stream"
            " launches; want exactly one batched launch per AUROC and per AP compute"
        )
    mc_acc = mc_result["Accuracy"].item()
    mc_auroc = mc_result["AUROC"].item()
    mc_ap = torch.stack(mc_result["AveragePrecision"]).cpu().numpy().astype(np.float64)
    want_mc_acc = float(
        np.float32(np.sum(np.argmax(mc_scores_np, axis=1) == mc_target_np)) / np.float32(IMAGENET_N)
    )
    if mc_acc != want_mc_acc:
        raise AssertionError(f"multi-class path: Accuracy {mc_acc} != numpy {want_mc_acc}")
    columns = np.ascontiguousarray(mc_scores_np.T)
    oracle_aurocs = np.array([_oracle_auroc(columns[c], mc_target_np == c) for c in range(IMAGENET_C)])
    oracle_aps = np.array([_oracle_ap(columns[c], mc_target_np == c) for c in range(IMAGENET_C)])
    if not np.isfinite(mc_auroc) or abs(mc_auroc - oracle_aurocs.mean()) > ORACLE_TOL:
        raise AssertionError(f"multi-class path: macro AUROC {mc_auroc} vs oracle {oracle_aurocs.mean()}")
    ap_err = np.abs(mc_ap - oracle_aps)
    if mc_ap.shape != (IMAGENET_C,) or not np.all(ap_err <= ORACLE_TOL):
        raise AssertionError(f"multi-class path: AP of class {int(np.nanargmax(ap_err))} off by {np.nanmax(ap_err)}")
    mc.persistent(True)
    mc_saved = _saved(mc)
    mc_step = mc(mc_preds[:mc_batch], mc_target[:mc_batch])  # a batch may lack classes: NaN is allowed
    torch.cuda.synchronize()
    if len(mc_step["AveragePrecision"]) != IMAGENET_C or mc_step["AUROC"].shape != ():
        raise AssertionError("multi-class forward: unexpected output shapes")
    print(f"multi-class main path: Accuracy {mc_acc} (numpy {want_mc_acc}), macro AUROC {mc_auroc:.7f}"
          f" (oracle {oracle_aurocs.mean():.7f}), mean AP {mc_ap.mean():.7f} (oracle {oracle_aps.mean():.7f}),"
          f" max |d AP| {ap_err.max():.3g}; tie_scan_rows launches {rows_launches}, {mc_path_s:.3f} s"
          " including first calls; one forward: ok")

    # multi-label, MS-COCO 2014 val shape: per-label AUROC against the oracle
    prevalence = rng.uniform(0.005, 0.2, COCO_C)
    ml_target_np = rng.random((COCO_N, COCO_C)) < prevalence
    ml_scores_np = (1.0 / (1.0 + np.exp(-(rng.standard_normal((COCO_N, COCO_C)) + 2.0 * ml_target_np)))).astype(
        np.float32
    )
    ml = functional_auroc(
        torch.from_numpy(ml_scores_np).to(dev), torch.from_numpy(ml_target_np.astype(np.int64)).to(dev),
        num_classes=COCO_C, average=None,
    )
    ml = torch.stack(ml).cpu().numpy().astype(np.float64)
    ml_oracle = np.array([_oracle_auroc(ml_scores_np[:, c], ml_target_np[:, c]) for c in range(COCO_C)])
    ml_err = np.abs(ml - ml_oracle)
    if not np.all(ml_err <= ORACLE_TOL):
        raise AssertionError(f"multi-label: AUROC of label {int(np.nanargmax(ml_err))} off by {np.nanmax(ml_err)}")
    print(f"multi-label {COCO_N}x{COCO_C}: per-label AUROC ok, max |d| {ml_err.max():.3g}")

    # ---- 4b. the sharded one-vs-rest path, weighted, at the same shape ----
    mc_w_np = rng_w.lognormal(size=IMAGENET_N).astype(np.float32)
    mc_w = torch.from_numpy(mc_w_np).to(dev)
    ovr_kwargs = dict(num_classes=IMAGENET_C, capacity_per_device=IMAGENET_N, with_sample_weights=True,
                      average="weighted")
    ovr = MetricCollection([ShardedAUROC(**ovr_kwargs), ShardedAveragePrecision(**ovr_kwargs)])
    torch.cuda.synchronize()
    zero_counts()
    plain_on_card.update(calls=0, watch=True)
    t0 = time.perf_counter()
    for b in range(MC_BATCHES):
        sl = slice(b * mc_batch, (b + 1) * mc_batch)
        ovr.update(mc_preds[sl], mc_target[sl], sample_weights=mc_w[sl])
    ovr_result = ovr.compute()
    torch.cuda.synchronize()
    ovr_path_s = time.perf_counter() - t0
    plain_on_card["watch"] = False
    ovr_launches = counts()
    if not only(ovr_launches, tie_scan_rows_w=2) or plain_on_card["calls"]:
        raise AssertionError(
            f"sharded one-vs-rest path: launches {ovr_launches}, {plain_on_card['calls']} plain-version calls on"
            " the card; want exactly one weighted batched launch per metric compute and no plain version"
        )
    ovr_values = {k: v.item() for k, v in ovr_result.items()}
    support = np.bincount(mc_target_np, weights=mc_w_np.astype(np.float64), minlength=IMAGENET_C)
    per_class = np.array([_oracle_weighted(columns[c], mc_target_np == c, mc_w_np) for c in range(IMAGENET_C)])
    ovr_oracle = (per_class * support[:, None]).sum(0) / support.sum()
    for k, want in zip(("ShardedAUROC", "ShardedAveragePrecision"), ovr_oracle):
        if not abs(ovr_values[k] - want) <= ORACLE_TOL:
            raise AssertionError(f"sharded one-vs-rest path: {k} {ovr_values[k]} vs float64 oracle {want}")
    print(f"sharded one-vs-rest path {IMAGENET_N}x{IMAGENET_C}, weighted average: {ovr_values} (float64 oracle"
          f" {ovr_oracle.tolist()}), launches {ovr_launches}, {ovr_path_s:.3f} s including first calls")

    # ---- 4c. per-class curves at the ImageNet-1k val shape -----------------
    def host_lists(values):
        """A per-class list of device tensors as host arrays, one copy."""
        lengths = [v.numel() for v in values]
        return np.split(torch.cat(values).cpu().numpy(), np.cumsum(lengths)[:-1])

    mc_curves = MetricCollection([ROC(num_classes=IMAGENET_C), PrecisionRecallCurve(num_classes=IMAGENET_C)])
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for b in range(MC_BATCHES):
        sl = slice(b * mc_batch, (b + 1) * mc_batch)
        mc_curves.update(mc_preds[sl], mc_target[sl])
    mc_curve_values = mc_curves.compute()
    torch.cuda.synchronize()
    mc_curves_s = time.perf_counter() - t0
    if any(counts().values()):
        raise AssertionError(f"per-class curves launched a scan kernel: {counts()}")
    roc_host = [host_lists(v) for v in mc_curve_values["ROC"]]
    pr_host = [host_lists(v) for v in mc_curve_values["PrecisionRecallCurve"]]
    mc_curve_err = 0.0
    for c in range(IMAGENET_C):
        rel_c = mc_target_np == c
        for label, got, want in (("ROC", roc_host, _oracle_roc(columns[c], rel_c)),
                                 ("PR", pr_host, _oracle_pr(columns[c], rel_c))):
            g = [x[c] for x in got]
            if [x.shape for x in g] != [x.shape for x in want] or not np.array_equal(g[2], want[2]):
                raise AssertionError(f"per-class {label} of class {c}: points or thresholds differ from the oracle's")
            mc_curve_err = max(mc_curve_err, *(float(np.max(np.abs(a - b))) for a, b in zip(g[:2], want[:2])))
    if not mc_curve_err <= CURVE_TOL:
        raise AssertionError(f"per-class curves: points off the oracle by {mc_curve_err}")
    # weighted per-class AUROC / AP: one weighted batched launch each, against 4b's oracles
    zero_counts()
    plain_on_card.update(calls=0, watch=True)
    mc_w_auroc = functional_auroc(mc_preds, mc_target, num_classes=IMAGENET_C, sample_weights=mc_w, average=None)
    mc_w_auroc_launches = counts()
    zero_counts()
    mc_w_ap = functional_average_precision(mc_preds, mc_target, num_classes=IMAGENET_C, sample_weights=mc_w)
    mc_w_ap_launches = counts()
    plain_on_card["watch"] = False
    if (not only(mc_w_auroc_launches, tie_scan_rows_w=1) or not only(mc_w_ap_launches, tie_scan_rows_w=1)
            or plain_on_card["calls"]):
        raise AssertionError(f"weighted per-class AUROC/AP: launches {mc_w_auroc_launches} / {mc_w_ap_launches},"
                             f" {plain_on_card['calls']} plain-version calls; want one tie_scan_rows_w launch each")
    mc_w_err = max(float(np.max(np.abs(torch.stack(mc_w_auroc).cpu().numpy() - per_class[:, 0]))),
                   float(np.max(np.abs(torch.stack(mc_w_ap).cpu().numpy() - per_class[:, 1]))))
    if not mc_w_err <= ORACLE_TOL:
        raise AssertionError(f"weighted per-class AUROC/AP off the float64 oracles by {mc_w_err}")
    # multi-label micro at the MS-COCO shape: one stream, one unweighted launch
    zero_counts()
    micro = functional_auroc(torch.from_numpy(ml_scores_np).to(dev), torch.from_numpy(ml_target_np.astype(np.int64))
                             .to(dev), num_classes=COCO_C, average="micro").item()
    micro_launches = counts()
    want_micro = _oracle_auroc(ml_scores_np.ravel(), ml_target_np.ravel())
    if not only(micro_launches, tie_scan=1) or abs(micro - want_micro) > ORACLE_TOL:
        raise AssertionError(f"micro AUROC {micro} (oracle {want_micro}), launches {micro_launches}; want one tie_scan")

    sync_sites = {}

    def curve_syncs(classes):
        """Device-to-host synchronizations of one per-class ROC and one PR
        curve compute over the first ``classes`` columns, after a first
        compute (first calls may synchronize once more)."""
        p, t = mc_preds[:, :classes].contiguous(), mc_target % classes
        found = {}
        for name, fn in (("roc", ROC), ("pr", PrecisionRecallCurve)):
            metric = fn(num_classes=classes)
            metric.update(p, t)
            metric.compute()
            metric._computed = None
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    metric.compute()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            sites = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]
            found[name] = len(sites)
            sync_sites[name] = sites
        return found

    curve_syncs(10)  # the process's first counted window may see one more, from PyTorch itself
    syncs = {c: curve_syncs(c) for c in (10, IMAGENET_C)}
    if syncs[10] != syncs[IMAGENET_C] or not all(syncs[10].values()):
        raise AssertionError(f"host synchronizations per curve compute grow with the classes: {syncs}")
    print(f"per-class curves {IMAGENET_N}x{IMAGENET_C}: every class's ROC and PR curve equals the float64 oracle"
          f" (max |d| {mc_curve_err:.3g}), {mc_curves_s:.3f} s for 10 updates and compute including first calls;"
          f" weighted per-class AUROC/AP within {mc_w_err:.3g} of the oracles, one tie_scan_rows_w launch each;"
          f" micro AUROC at {COCO_N}x{COCO_C} {micro:.7f} (oracle {want_micro:.7f}), one tie_scan launch;"
          f" synchronizations per compute at C=10 and C={IMAGENET_C}: {syncs}, at {sync_sites}")

    # ---- 4d. the binned curves, 512 bins ------------------------------------
    binned_err = {"hist": 0.0, "values": 0.0}

    def check_binned(label, metrics, scores_np, rel_np_, weights_np):
        auroc_m, ap_m, pr_m = metrics
        want_pos, want_neg = _oracle_histograms(scores_np, rel_np_, NUM_BINS, weights_np)
        got_pos, got_neg = auroc_m.hist_pos.cpu().numpy(), auroc_m.hist_neg.cpu().numpy()
        for got, want in ((got_pos, want_pos), (got_neg, want_neg)):
            if weights_np is None:
                if not np.array_equal(got, want):
                    raise AssertionError(f"binned {label}: histogram counts differ from numpy's")
            else:
                rel_err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
                binned_err["hist"] = max(binned_err["hist"], rel_err)
                if not rel_err <= 1e-5:
                    raise AssertionError(f"binned {label}: weighted histograms off numpy's by {rel_err} relative")
        want_auroc, want_ap, want_precision, want_recall = _float64_binned(got_pos, got_neg)
        if scores_np.ndim == 2:
            want_auroc, want_ap = want_auroc.mean(), want_ap.mean()
        precision, recall, _ = pr_m.compute()
        errs = [abs(auroc_m.compute().item() - want_auroc), abs(ap_m.compute().item() - want_ap),
                float(np.max(np.abs(precision.cpu().numpy() - want_precision))),
                float(np.max(np.abs(recall.cpu().numpy() - want_recall)))]
        binned_err["values"] = max(binned_err["values"], *errs)
        if not max(errs) <= CURVE_TOL:
            raise AssertionError(f"binned {label}: values off the float64 evaluation by {errs}")

    mc_onehot = mc_target_np[:, None] == np.arange(IMAGENET_C)
    for label, scores_np, t_dev, rel_host, w_np, kwargs in (
        (f"binary {MAIN_N}", preds_np, target, rel_np, None, {}),
        (f"binary {MAIN_N} weighted", preds_np, target, rel_np, w_1m_np, {}),
        (f"{IMAGENET_N}x{IMAGENET_C}", mc_scores_np, mc_target, mc_onehot, None, {"num_classes": IMAGENET_C}),
        (f"{IMAGENET_N}x{IMAGENET_C} weighted", mc_scores_np, mc_target, mc_onehot, mc_w_np,
         {"num_classes": IMAGENET_C}),
    ):
        metrics = [m(num_bins=NUM_BINS, **kwargs) for m in (BinnedAUROC, BinnedAveragePrecision,
                                                            BinnedPrecisionRecallCurve)]
        p_dev = preds if scores_np.ndim == 1 else mc_preds
        extra = {} if w_np is None else {"sample_weights": torch.from_numpy(w_np).to(dev)}
        for m in metrics:
            m.update(p_dev, t_dev, **extra)
        check_binned(label, metrics, scores_np, rel_host, w_np)
    del mc_onehot
    print(f"binned curves, {NUM_BINS} bins, binary at {MAIN_N} and {IMAGENET_N}x{IMAGENET_C}, unweighted and"
          f" weighted: counts exact, weighted histograms within {binned_err['hist']:.3g} relative, values within"
          f" {binned_err['values']:.3g} of the float64 evaluation")

    # ---- 5. times ---------------------------------------------------------
    all_preds = torch.cat(list(collection["AUROC"].preds))
    all_rel = (torch.cat(list(collection["AUROC"].target)) == 1).to(torch.float32)
    key = _sortable_key(all_preds)
    payload = _payload(all_rel, None)
    key_s, pay_s = _co_sort(all_preds, all_rel)
    groups = int((key_s[1:] != key_s[:-1]).sum()) + 1
    kernel_ms = _queued_ms(torch, lambda: tie_scan.tie_group_reduce(key_s, pay_s))
    plain_ms = _queued_ms(torch, lambda: tie_scan.tie_group_reduce_reference(key_s, pay_s))
    sort_gather_ms = _queued_ms(torch, lambda: payload[torch.sort(key)[1]])
    sort_packed_ms = _queued_ms(torch, lambda: torch.sort((key.long() << 2) | payload.long()).values)
    # the one-stream kernel on phase 2a's 20M stream, ~4,900 tiles in several waves
    big_groups = int((big_key_s[1:] != big_key_s[:-1]).sum()) + 1
    big_kernel_ms = _queued_ms(torch, lambda: tie_scan.tie_group_reduce(big_key_s, big_pay_s), launches=20, trials=5)

    # the multi-class compute's rows, (1000, 50000): its batches in order are the whole set
    rows_key = _sortable_key(mc_preds.T)
    rows_payload = _payload(_ovr_relevance(mc_target, IMAGENET_C), None)
    rows_key_s, rows_pay_s = _co_sort_rows(rows_key, rows_payload)
    rows_groups = int((rows_key_s[:, 1:] != rows_key_s[:, :-1]).sum()) + IMAGENET_C
    rows_kernel_ms = _queued_ms(torch, lambda: tie_scan.tie_group_reduce_rows(rows_key_s, rows_pay_s))
    rows_plain_ms = _queued_ms(
        torch, lambda: tie_scan.tie_group_reduce_rows_reference(rows_key_s, rows_pay_s), launches=2, trials=3
    )
    rows_single_ms = _queued_ms(
        torch, lambda: [tie_scan.tie_group_reduce(rows_key_s[r], rows_pay_s[r]) for r in range(IMAGENET_C)],
        launches=1, trials=5,
    )
    rows_sort_ms = _queued_ms(torch, lambda: _co_sort_rows(rows_key, rows_payload), launches=10)
    flat_key = (torch.arange(IMAGENET_C, device=dev)[:, None] << 32) | (rows_key.long() + 2**31)
    flat_payload = rows_payload.reshape(-1)
    rows_flat_sort_ms = _queued_ms(
        torch, lambda: flat_payload[torch.sort(flat_key.reshape(-1))[1]], launches=10
    )

    # the weighted kernels and their plain versions, at the sharded paths' shapes
    cr_key_s, cr_pay_s, cr_w_s = cr_streams
    cr_groups = int((cr_key_s[1:] != cr_key_s[:-1]).sum()) + 1
    w_kernel_ms = _queued_ms(torch, lambda: tie_scan.tie_group_reduce(cr_key_s, cr_pay_s, weights_s=cr_w_s),
                             launches=10, trials=5)
    w_plain_ms = _queued_ms(torch, lambda: tie_scan.tie_group_reduce_reference(cr_key_s, cr_pay_s, None, cr_w_s),
                            launches=1, trials=3)
    rows_w_key_s, rows_w_pay_s, rows_w_s = _co_sort_rows(rows_key, rows_payload, mc_w)
    w_rows_kernel_ms = _queued_ms(
        torch, lambda: tie_scan.tie_group_reduce_rows(rows_w_key_s, rows_w_pay_s, weights_s=rows_w_s), launches=20
    )
    w_rows_plain_ms = _queued_ms(
        torch, lambda: tie_scan.tie_group_reduce_rows_reference(rows_w_key_s, rows_w_pay_s, None, rows_w_s),
        launches=1, trials=3,
    )
    # the offset form at 1M
    offsets = (1234.0, 777.0)
    off_kernel_ms = _queued_ms(torch, lambda: tie_scan.tie_group_reduce(key_s, pay_s, offsets))
    off_plain_ms = _queued_ms(torch, lambda: tie_scan.tie_group_reduce_reference(key_s, pay_s, offsets),
                              launches=2, trials=3)

    def recompute_ms(coll, trials=5):
        """Host ms of compute() ending in a synchronize, the cached values
        dropped first; median of ``trials`` after one more call."""
        times = []
        for _ in range(trials + 1):
            for metric in coll.values():
                metric._computed = None
            torch.cuda.synchronize()
            t = time.perf_counter()
            coll.compute()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times[1:]))

    sharded_compute_ms = recompute_ms(sharded)
    ovr_compute_ms = recompute_ms(ovr)
    # the curve family: host clock ending in a synchronize, one warm-up, median of 5
    roc_1m_ms = recompute_ms(MetricCollection([curves["ROC"]]))
    pr_1m_ms = recompute_ms(MetricCollection([curves["PrecisionRecallCurve"]]))
    roc_mc_ms = recompute_ms(MetricCollection([mc_curves["ROC"]]))
    pr_mc_ms = recompute_ms(MetricCollection([mc_curves["PrecisionRecallCurve"]]))
    partial_ms = recompute_ms(MetricCollection([partial]))

    def warm_host_ms(fn):
        fn()
        return _host_ms(torch, fn)

    w_auroc_1m_ms = warm_host_ms(lambda: functional_auroc(preds, target, pos_label=1, sample_weights=w_1m))
    binned_1m = BinnedAUROC(num_bins=NUM_BINS)
    binned_mc = BinnedAUROC(num_bins=NUM_BINS, num_classes=IMAGENET_C)
    binned_update_1m_ms = warm_host_ms(lambda: binned_1m.update(preds, target))
    binned_update_mc_ms = warm_host_ms(lambda: binned_mc.update(mc_preds, mc_target))

    collection.persistent(True)
    saved = _saved(collection)

    def compute_fresh(make, state):
        # a collection restored from the saved states, so compute() has no cached value
        fresh = make()
        fresh.load_state_dict(state, strict=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fresh.compute()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    def binary_collection():
        return MetricCollection([Accuracy(), AUROC(pos_label=1)])

    compute_fresh(binary_collection, saved)
    compute_ms = float(np.median([compute_fresh(binary_collection, saved) for _ in range(5)]))
    compute_fresh(mc_collection, mc_saved)
    mc_compute_ms = float(np.median([compute_fresh(mc_collection, mc_saved) for _ in range(5)]))
    forward_ms = _host_ms(torch, lambda: collection(preds[:BATCH], target[:BATCH]))
    bound_ms, bound_by = _bound(key_s.numel(), groups, 1)
    big_bound_ms, _ = _bound(BIG_N, big_groups, 1)
    rows_bound_ms, rows_bound_by = _bound(rows_key_s.numel(), rows_groups, IMAGENET_C)
    w_bound_ms, w_bound_by = _bound(CRITEO_N, cr_groups, 1, weighted=True)
    w_rows_bound_ms, w_rows_bound_by = _bound(rows_w_key_s.numel(), rows_groups, IMAGENET_C, weighted=True)
    timings = {
        "n": key_s.numel(),
        "tie_groups": groups,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "co_sort_int32_sort_gather_ms": sort_gather_ms,
        "co_sort_packed_int64_ms": sort_packed_ms,
        "forward_batch_ms": forward_ms,
        "compute_step_ms": compute_ms,
        "forward_10_batches_first_run_s": t_forward,
        "kernel_bytes": 8 * key_s.numel() + 16,
        "bound_ms": bound_ms,
        "big_n": BIG_N,
        "big_tie_groups": big_groups,
        "big_kernel_ms": big_kernel_ms,
        "big_kernel_bytes": 8 * BIG_N + 16,
        "big_bound_ms": big_bound_ms,
        "rows_shape": list(rows_key_s.shape),
        "rows_tie_groups": rows_groups,
        "rows_kernel_ms": rows_kernel_ms,
        "rows_plain_ms": rows_plain_ms,
        "rows_as_1000_one_stream_launches_ms": rows_single_ms,
        "rows_co_sort_segmented_sort_gather_ms": rows_sort_ms,
        "rows_co_sort_flat_int64_sort_gather_ms": rows_flat_sort_ms,
        "rows_kernel_bytes": 8 * rows_key_s.numel() + 16 * IMAGENET_C,
        "rows_bound_ms": rows_bound_ms,
        "multiclass_compute_step_ms": mc_compute_ms,
        "multiclass_update_10_batches_and_compute_first_run_s": mc_path_s,
        "weighted_n": CRITEO_N,
        "weighted_tie_groups": cr_groups,
        "weighted_kernel_ms": w_kernel_ms,
        "weighted_plain_ms": w_plain_ms,
        "weighted_kernel_bytes": 12 * CRITEO_N + 16,
        "weighted_bound_ms": w_bound_ms,
        "weighted_rows_kernel_ms": w_rows_kernel_ms,
        "weighted_rows_plain_ms": w_rows_plain_ms,
        "weighted_rows_kernel_bytes": 12 * rows_w_key_s.numel() + 16 * IMAGENET_C,
        "weighted_rows_bound_ms": w_rows_bound_ms,
        "offsets_kernel_ms": off_kernel_ms,
        "offsets_plain_ms": off_plain_ms,
        "sharded_binary_compute_step_ms": sharded_compute_ms,
        "sharded_binary_updates_and_compute_first_run_s": sharded_path_s,
        "sharded_ovr_compute_step_ms": ovr_compute_ms,
        "sharded_ovr_updates_and_compute_first_run_s": ovr_path_s,
        "roc_compute_1m_ms": roc_1m_ms,
        "pr_curve_compute_1m_ms": pr_1m_ms,
        "roc_compute_1000x50000_ms": roc_mc_ms,
        "pr_curve_compute_1000x50000_ms": pr_mc_ms,
        "max_fpr_auroc_compute_1m_ms": partial_ms,
        "weighted_functional_auroc_1m_ms": w_auroc_1m_ms,
        "binned_update_1m_x512_ms": binned_update_1m_ms,
        "binned_update_50000x1000_x512_ms": binned_update_mc_ms,
        "binary_curves_first_run_s": curves_path_s,
        "per_class_curves_first_run_s": mc_curves_s,
        "curve_path_launches": {"weighted_auroc_1m": w_auroc_launches, "weighted_ap_1m": w_ap_launches,
                                "weighted_auroc_1000": mc_w_auroc_launches, "weighted_ap_1000": mc_w_ap_launches,
                                "micro_auroc_coco": micro_launches, "phase_3c_in_all": curve_launches},
        "per_class_curve_syncs": {str(k): v for k, v in syncs.items()},
        "per_class_curve_sync_sites": sync_sites,
        "card": card,
    }
    print(json.dumps({"timings": timings}))

    # ---- 6. where the time goes -------------------------------------------
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    fresh = binary_collection()
    fresh.load_state_dict(saved, strict=True)
    fresh(preds[:BATCH], target[:BATCH])  # first-call costs stay out of the window
    fresh.load_state_dict(saved, strict=True)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t = time.perf_counter()
        fresh(preds[:BATCH], target[:BATCH])
        fresh.compute()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t) * 1e3
    averages = prof.key_averages()
    sort_key = "self_device_time_total" if hasattr(averages[0], "self_device_time_total") else "self_cuda_time_total"
    device_ms = sum(_device_ms_by_kernel(torch, prof, sort_key).values())
    print(averages.table(sort_by=sort_key, row_limit=15, max_name_column_width=48))
    print(averages.table(sort_by="self_cpu_time_total", row_limit=15, max_name_column_width=48))
    # the plain version at 1M, by ATen kernel
    with profile(activities=activities) as prof_plain:
        tie_scan.tie_group_reduce_reference(key_s, pay_s)
        torch.cuda.synchronize()
    print(prof_plain.key_averages().table(sort_by=sort_key, row_limit=10, max_name_column_width=48))
    # one multi-class compute step, restored from the saved states
    fresh_mc = mc_collection()
    fresh_mc.load_state_dict(mc_saved, strict=True)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof_mc:
        t = time.perf_counter()
        fresh_mc.compute()
        torch.cuda.synchronize()
        mc_window_ms = (time.perf_counter() - t) * 1e3
    mc_split = _device_ms_by_kernel(torch, prof_mc, sort_key)
    print(prof_mc.key_averages().table(sort_by=sort_key, row_limit=15, max_name_column_width=48))
    # one weighted sharded binary compute (both metrics) at 45,840,617
    for metric in sharded.values():
        metric._computed = None
    torch.cuda.synchronize()
    with profile(activities=activities) as prof_sh:
        t = time.perf_counter()
        sharded.compute()
        torch.cuda.synchronize()
        sh_window_ms = (time.perf_counter() - t) * 1e3
    sh_split = _device_ms_by_kernel(torch, prof_sh, sort_key)
    print(prof_sh.key_averages().table(sort_by=sort_key, row_limit=15, max_name_column_width=48))
    # one per-class ROC compute at (1000, 50000)
    mc_curves["ROC"]._computed = None
    torch.cuda.synchronize()
    with profile(activities=activities) as prof_roc:
        t = time.perf_counter()
        mc_curves["ROC"].compute()
        torch.cuda.synchronize()
        roc_window_ms = (time.perf_counter() - t) * 1e3
    roc_split = _device_ms_by_kernel(torch, prof_roc, sort_key)
    print(prof_roc.key_averages().table(sort_by=sort_key, row_limit=15, max_name_column_width=48))
    # one call of each kernel entry: one launch and at most the memset of its scratch
    entry_splits = {}
    for label, kernel, call in (
        ("tie_scan", "::tie_scan_kernel(", lambda: tie_scan.tie_group_reduce(key_s, pay_s)),
        ("tie_scan_rows", "::tie_scan_kernel(", lambda: tie_scan.tie_group_reduce_rows(rows_key_s, rows_pay_s)),
        ("weighted", "::tie_scan_w_kernel(", lambda: tie_scan.tie_group_reduce(cr_key_s, cr_pay_s, weights_s=cr_w_s)),
        ("weighted_rows", "::tie_scan_w_kernel(",
         lambda: tie_scan.tie_group_reduce_rows(rows_w_key_s, rows_w_pay_s, weights_s=rows_w_s)),
    ):
        with profile(activities=activities) as prof_entry:
            call()
            torch.cuda.synchronize()
        split = _device_ms_by_kernel(torch, prof_entry, sort_key)
        others = [k for k in split if kernel not in k]
        if len(split) - len(others) != 1 or len(others) > 1 or any("Memset" not in k for k in others):
            raise AssertionError(f"one {label} call ran {sorted(split)}; want one kernel and at most its memset")
        entry_splits[label] = split
    print(json.dumps({"profile": {
        "window": "one forward batch of 100k + compute at 1.1M, under torch.profiler",
        "window_ms": window_ms,
        "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / window_ms,
        "multiclass_compute_window_ms": mc_window_ms,
        "multiclass_compute_device_ms": sum(mc_split.values()),
        "multiclass_compute_device_ms_by_kernel": dict(sorted(mc_split.items(), key=lambda kv: -kv[1])[:12]),
        "sharded_binary_compute_window_ms": sh_window_ms,
        "sharded_binary_compute_device_ms": sum(sh_split.values()),
        "sharded_binary_compute_device_ms_by_kernel": dict(sorted(sh_split.items(), key=lambda kv: -kv[1])[:12]),
        "per_class_roc_compute_window_ms": roc_window_ms,
        "per_class_roc_compute_device_ms": sum(roc_split.values()),
        "per_class_roc_compute_device_ms_by_kernel": dict(sorted(roc_split.items(), key=lambda kv: -kv[1])[:12]),
        "kernel_device_ms_by_kernel": entry_splits["tie_scan"],
        "rows_kernel_device_ms_by_kernel": entry_splits["tie_scan_rows"],
        "weighted_kernel_device_ms_by_kernel": entry_splits["weighted"],
        "weighted_rows_kernel_device_ms_by_kernel": entry_splits["weighted_rows"],
    }}))
    kernels = [
        {
            "name": "tie_scan",
            "route": "cuda",
            "source": "metrics_tpu_torch/csrc/tie_scan.cu",
            "replaces": "metrics_tpu/ops/tie_scan_pallas.py:80",
            "launches": launches,
            "max_abs_err": max_err,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        },
        {
            "name": "tie_scan_rows",
            "route": "cuda",
            "source": "metrics_tpu_torch/csrc/tie_scan.cu",
            "replaces": "metrics_tpu/ops/tie_scan_pallas.py:80",
            "launches": rows_launches,
            "max_abs_err": max_err_rows,
            "ms": rows_kernel_ms,
            "plain_ms": rows_plain_ms,
            "bound_ms": rows_bound_ms,
            "bound_by": rows_bound_by,
            "library_ms": None,
        },
        {
            "name": "tie_scan_w",
            "route": "cuda",
            "source": "metrics_tpu_torch/csrc/tie_scan.cu",
            "replaces": "metrics_tpu/ops/tie_scan_pallas.py:80",
            "launches": sh_launches["tie_scan_w"],
            "max_abs_err": max_err_w,
            "ms": w_kernel_ms,
            "plain_ms": w_plain_ms,
            "bound_ms": w_bound_ms,
            "bound_by": w_bound_by,
            "library_ms": None,
        },
        {
            "name": "tie_scan_rows_w",
            "route": "cuda",
            "source": "metrics_tpu_torch/csrc/tie_scan.cu",
            "replaces": "metrics_tpu/ops/tie_scan_pallas.py:80",
            "launches": ovr_launches["tie_scan_rows_w"],
            "max_abs_err": max_err_rows_w,
            "ms": w_rows_kernel_ms,
            "plain_ms": w_rows_plain_ms,
            "bound_ms": w_rows_bound_ms,
            "bound_by": w_rows_bound_by,
            "library_ms": None,
        },
        {
            # the sample sort's bucket epilogue (phase 2c′), its path on one card
            "name": "tie_scan offsets",
            "route": "cuda",
            "source": "metrics_tpu_torch/csrc/tie_scan.cu",
            "replaces": "metrics_tpu/ops/tie_scan_pallas.py:80",
            "launches": offset_launches,
            "max_abs_err": max_err_off,
            "ms": off_kernel_ms,
            "plain_ms": off_plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        },
    ]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the card check")
    print(json.dumps({"kernels": kernels}))
    # the run used one card (pinned above)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
