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
4e. the stat-score and confusion-matrix family (no scan kernel; counts in
   label space, ``label_bincount``): (a) the JAX bench's forward leg,
   ``MetricCollection([Accuracy(), Precision(num_classes=4,
   average="macro"), Recall(...), F1(...)])``, 10 forward batches of 100,000
   seeded 4-class probabilities, counts equal to numpy's and values within
   1e-6; (b) at the ImageNet-1k val shape, phase 4's data in 10 update
   batches: ``StatScores`` (macro), Precision/Recall/F1 macro and weighted,
   top-5 ``Precision``, ``ConfusionMatrix(normalize="true")``, quadratic
   ``CohenKappa``, ``MatthewsCorrcoef``, ``IoU``, ``HammingDistance``,
   Crammer-Singer ``Hinge`` and functional ``dice_score``, against float64
   oracles; (c) at the MS-COCO 2014 val shape, multi-label ``StatScores``
   (micro, macro), macro ``F1``, ``HammingDistance`` and the ``(80, 2, 2)``
   ``ConfusionMatrix``; (d) Cityscapes val, 500 images of 1024 x 2048
   pixels and 19 classes, made on the card 4 images a batch:
   ``ConfusionMatrix``, ``IoU``, macro ``StatScores`` (counts past 2^24,
   exact) and samplewise macro ``F1`` against numpy's int64 counts of
   ``target * 19 + argmax``; the host synchronizations of one update at
   C = 19 and C = 1,000 (equal), also with ``torch.bincount`` in place of
   ``label_bincount``; MCC's float32 gap to float64;
4f. the regression pack and metric arithmetic (no scan kernel), against
   float64 numpy/scipy oracles: (a) the JAX bench's regression forward leg
   (``bench.py:463-464, 535``), ``MetricCollection([MeanSquaredError(),
   MeanAbsoluteError(), R2Score(), PSNR(), ExplainedVariance()])``, 10
   forward batches of 100,000 seeded rows, every value within 1e-5
   relative, the shared moments computed once per batch and equal to each
   metric's own, 0 host synchronizations per update; functional
   ``mean_squared_log_error`` / ``mean_relative_error`` on the same rows and
   a 2-output adjusted ``R2Score``; (b) BASELINE config 4's 16 x 3 x 128 x
   128 images: ``psnr``, ``PSNR()`` over 4 batches, per-image ``PSNR`` and
   ``ssim`` (the banded blur); (c) the convolution blur: ``SSIM()`` over the
   Kodak PhotoCD set's shape (24 x 3 x 512 x 768, 6 batches of 4) and
   ``ssim`` over 4 x 3 x 1024 x 2048 frames. (b) and (c) run with TF32
   switched on globally (``cudnn.allow_tf32``,
   ``set_float32_matmul_precision("high")``); SSIM must stay within 1e-6 of
   float64 and the flags must read the same afterwards; one ``SSIM.update``
   causes 0 synchronizations. (d) ``MeanSquaredError() ** 0.5`` over (a),
   and ``(Precision + Recall) / 2`` (macro, 4 classes) forwarded over 4e's
   forward-leg batches, whose ``compute()`` must be the epoch's value;
4g. the retrieval family (no kernel of its own), against a float64 numpy
   oracle (a lexsort by query id, -score and position; per-query AP, RR,
   P@10, R@100; the mean over the queries with a relevant document): (a)
   BASELINE config 5, the JAX bench's retrieval leg (``bench.py:1455-1533``):
   1M rows, ids uniform over 10,000 queries, uniform scores, 5% relevant,
   ``MetricCollection([RetrievalMAP(), RetrievalMRR()])`` fed 10 batches of
   100,000, and the functional core (``ranked_group_stats``,
   ``_map_segments``, ``_mrr_segments``); (b) the host synchronizations
   and device-to-host bytes of one compute of MAP, MRR, P@10 and R@100 at
   100 and 10,000 queries over the same 1M rows (equal; a few scalars);
   (c) config 5's epoch at world 1 (``bench.py:246-270``): one update and
   one compute of Accuracy + F1, ``ShardedAUROC``, ``ShardedRetrievalMAP`` and
   ``ShardedRetrievalMRR``; (d) the MS MARCO passage ranking dev (small)
   set's shape, 6,980 queries x 1,000 candidates with 7,437 relevant rows,
   fed 100 queries a batch to MAP, MRR, P@10 and R@100, with the compute's
   peak memory, both forms of the ranking sort timed, and the functional
   forms on one query. Every value within 1e-5 of the oracle, the integers
   (relevant counts, first relevant ranks, hits in the top 10 and 100)
   equal to its, a second compute's bits equal, and the sharded metrics at
   world 1 equal to the unsharded ones bit for bit;
4h. the step engine (``MetricCollection(compiled=True)``: one CUDA graph per
   call signature; no scan kernel of its own): (a) 4e's forward leg, 10
   batches of 100,000 and the JAX bench's 1M x 4 batch, and (b) 4f's
   regression leg, each against the eager collection: values within 1e-6
   relative and counts exact every step and at the epoch, no demotion, one
   build, 0 host synchronizations in a replayed step, the forward batch ms of
   both, a replayed step's device time (steps queued behind a device sleep),
   the first step's warm-up and capture ms and the graph's pool; (c)
   the stat-score siblings' shared count: host synchronizations and device
   kernels of one eager forward of the four metrics in a collection (2
   syncs) and alone (4); (d) the binary step over phase 3's batches,
   Accuracy captured and AUROC eager (as in the JAX package: it does not
   opt into the fused forward), values equal to eager, one tie-scan launch
   per batch value and per compute; (e) a demotion: ``StatScores()`` on
   label inputs cannot infer its one-hot width inside a graph, is demoted
   with JAX's reason while Accuracy stays captured, and the card stays
   usable; (f) ``BootStrapper(Accuracy(), 20)`` with both samplers (host
   synchronizations of a draw: 0 multinomial, 1 Poisson),
   ``embedding_similarity`` at (512, 256) within 1e-5 of float64 under
   global TF32 flags (restored after), ``image_gradients`` over 4 x 3 x 1024
   x 2048 equal to numpy, ``bleu_score`` on the card equal to the CPU's;
4i. the multi-tenant cohort (``MetricCohort``: the step function vmapped over
   a tenant axis, one CUDA graph per call signature and capacity bucket; no
   scan kernel of its own): the JAX bench's cohort leg (``bench.py:539-663``:
   Accuracy + macro Precision / Recall / F1 at 4 classes, 64 rows a tenant)
   at 1, 64, 1,024 and 10,000 tenants (capacities 2, 64, 1,024, 16,384): the
   step ms, a replayed step's device time, the kernels of one graph replay
   (equal at capacities 64, 1,024 and 16,384: no per-tenant loop), the
   first step (warm-up and capture), the graph's pool and 0 host
   synchronizations a replayed step; 64 ``compiled=True`` collections
   stepped one after another on the same rows (the bench's ``COHORT_SEQ64``)
   and the two ratios; at 1,024 tenants with grid-valued rows, 3 steps with
   a ``remove_tenant`` / ``add_tenant`` and a grow to 2,048 slots between
   them: 16 sampled tenants' states and ``compute()`` equal to a compiled
   collection run alone on the same rows (counts exact, floats bit-equal),
   and the health accumulators' rows and updates equal numpy's counts; the
   regression pack as a cohort of 1,024 (states bit-equal, values within 8
   ulp); ``route_rows`` of a shuffled tagged stream of 10,000 x 64 rows
   equal to the dense layout; a cohort of ``AUROC`` refused with the
   engine's reason;
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
   1M x 512 and at 50,000 x 1,000 x 512; the stat-score family's forward
   batch, ImageNet compute, Cityscapes update and compute; the regression
   leg's forward batch (in the collection and unshared) and compute,
   functional ``r2score`` / ``mean_squared_error`` at 1M, ``psnr`` /
   ``ssim`` at 16 x 3 x 128 x 128, ``SSIM.compute()`` over Kodak, ``ssim``
   at 4 x 3 x 1024 x 2048, and both blur forms (banded product and
   depthwise convolution) at 128 x 128, 512 x 768 and 1024 x 2048; phase
   4h's forward batches, compiled and eager (host clock);
6. where the time goes: ``torch.profiler`` over a binary forward batch plus
   compute, over one multi-class compute, over one weighted sharded binary
   compute, over one per-class ROC compute at (1000, 50000), over one
   forward batch of phase 4e's forward leg and one Cityscapes update, over
   one forward batch of phase 4f's regression leg and one ``ssim`` at
   4 x 3 x 1024 x 2048, over one compiled forward batch of phase 4h's
   forward leg and regression leg (one graph replay each), over one MS MARCO
   compute of phase 4g (its sort share), and over one
   call of each kernel entry (one stream at 1M,
   batched at ``(1000, 50000)``, and the two weighted ones at their paths'
   shapes), each of which must show one kernel and at most the memset of
   its scratch.

Prints the card's name and power limit (``nvidia-smi``), ``{"timings": ...}``
and ``{"profile": ...}`` lines, a ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Exits with 1 and prints no result when no
CUDA device is available.
"""
import importlib
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
# the stat-score family: float32 ratios of exact counts against float64
RATIO_TOL = 1e-6
# Cityscapes val (semantic segmentation): 500 images of 1024 x 2048 pixels,
# 19 evaluation classes, fed 4 images a batch; the classes' pixel shares
# are skewed as a street scene's (road about a third, then halving)
CITY_IMAGES, CITY_BATCH, CITY_H, CITY_W, CITY_C = 500, 4, 1024, 2048, 19
CITY_SHARES = np.concatenate([[1 / 3], (2 / 3) * 0.62 ** np.arange(18) / np.sum(0.62 ** np.arange(18))])
# the regression pack (phase 4f): BASELINE.json config 4's images
# (bench.py:1458), the whole Kodak PhotoCD set's shape (24 images of
# 3 x 512 x 768, fed 4 a batch), and 4 frames of Cityscapes' 1024 x 2048
IMG_SHAPE = (16, 3, 128, 128)
KODAK_IMAGES, KODAK_BATCH, KODAK_H, KODAK_W = 24, 4, 512, 768
FRAMES = 4
# regression values against float64: float32 moment sums over 1M rows
REG_TOL = 1e-5
# the shared pass against each metric's own: the same float32 sums, added in another order
SHARE_TOL = 1e-6
# SSIM against float64 over the same VALID windows (a TF32 blur reads ~6e-5 off)
SSIM_TOL = 1e-6
# composites against float64 / the epoch's counts
COMP_TOL = 1e-6
# the banded and the convolution blur of one stack: float32 sums of the same taps in other orders
BLUR_TOL = 1e-5
# the retrieval family (phase 4g): BASELINE.json config 5, the JAX bench's
# retrieval leg (bench.py:1455-1533): 1M rows, query ids uniform over
# 10,000, uniform scores, 5% relevant; and the MS MARCO passage ranking dev
# (small) set's shape: 6,980 queries x 1,000 BM25 candidates, 7,437 relevant
# rows, 6,980 distinct query ids from [0, 1,102,000), 100 queries a batch,
# seeded noise scores with the relevant rows shifted up
RET_N, RET_Q, RET_REL = 1_000_000, 10_000, 0.05
MSMARCO_Q, MSMARCO_DOCS, MSMARCO_REL, MSMARCO_ID_SPACE = 6_980, 1_000, 7_437, 1_102_000
MSMARCO_BATCH_Q, MSMARCO_SHIFT = 100, 2.5
# retrieval means against the float64 oracle: float32 scores of exact integer ranks
RET_TOL = 1e-5
# the step engine (phase 4h): compiled against eager, the same float32 ops in the same order
ENGINE_TOL = 1e-6
# embedding_similarity against float64 at (512, 256) with TF32 switched on globally,
# relative to the largest entry (float32 sums of 256 products: ~1e-6)
EMB_TOL = 1e-5
# the multi-tenant cohort (phase 4i): the JAX bench's cohort leg (bench.py:539-663)
COHORT_SIZES = (1, 64, 1024, 10_000)
COHORT_ROWS = 64
COHORT_SEQ = 64
COHORT_CHECK = 1024
COHORT_SAMPLED = 16
# the regression values' allowance against a collection run alone (tests/bases/test_cohort.py:143)
COHORT_ULPS = 8


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


def _oracle_counts(confmat: np.ndarray):
    """int64 (tp, fp, tn, fn) per class of a confusion matrix (rows: target)."""
    tp = np.diag(confmat)
    fp, fn = confmat.sum(0) - tp, confmat.sum(1) - tp
    return tp, fp, confmat.sum() - tp - fp - fn, fn


def _safe_ratio(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    return np.where(den > 0, num / np.where(den > 0, den, 1), 0.0)


def _oracle_prf(tp, fp, fn, average: str = "macro"):
    """float64 (precision, recall, F1) averaged as the port averages them:
    0 where a denominator is 0; ``weighted`` by the support."""
    precision, recall = _safe_ratio(tp, tp + fp), _safe_ratio(tp, tp + fn)
    f1 = _safe_ratio(2 * precision * recall, precision + recall)
    if average == "weighted":
        w = (tp + fn) / np.sum(tp + fn)
        return tuple(float(np.sum(w * v)) for v in (precision, recall, f1))
    return tuple(float(np.mean(v)) for v in (precision, recall, f1))


def _oracle_mcc(confmat: np.ndarray) -> float:
    c = confmat.astype(np.float64)
    tk, pk, s = c.sum(0), c.sum(1), c.sum()
    return float((np.trace(c) * s - tk @ pk) / (np.sqrt(s**2 - pk @ pk) * np.sqrt(s**2 - tk @ tk)))


def _forward_leg_inputs(torch, dev):
    """The JAX bench's forward-leg batches (``bench.py:459-462``): 1M seeded
    4-class probabilities and labels, as numpy and on ``dev``."""
    rs = np.random.RandomState(SEED)
    p4_np = rs.rand(MAIN_N, 4).astype(np.float32)
    p4_np = p4_np / p4_np.sum(1, keepdims=True)
    t4_np = rs.randint(4, size=MAIN_N)
    return p4_np, t4_np, torch.from_numpy(p4_np).to(dev), torch.from_numpy(t4_np).to(dev)


def _regression_leg_inputs(torch, dev):
    """The JAX bench's regression-leg rows (``bench.py:463-464``; its
    generator draws the classification leg's batches first): 1M seeded
    ``(preds, target)``, as numpy and on ``dev``."""
    rs = np.random.RandomState(SEED)
    rs.rand(MAIN_N, 4)
    rs.randint(4, size=MAIN_N)
    t_np = (rs.randn(MAIN_N) * 3 + 1).astype(np.float32)
    p_np = t_np + rs.randn(MAIN_N).astype(np.float32)
    return p_np, t_np, torch.from_numpy(p_np).to(dev), torch.from_numpy(t_np).to(dev)


def _syncs(torch, fn):
    """The host synchronizations ``fn()`` causes, by site
    (``torch.cuda.set_sync_debug_mode("warn")``)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]


def _stat_score_phase(torch, dev, mc, ml):
    """Phase 4e: the stat-score and confusion-matrix family on the card.

    ``mc`` is phase 4's ImageNet-shaped ``(preds, target, scores_np,
    target_np)``, ``ml`` phase 4's MS-COCO-shaped ``(scores_np, target_np)``.
    Returns the phase's timings and what phase 6 profiles."""
    from metrics_tpu_torch import (
        F1,
        Accuracy,
        CohenKappa,
        ConfusionMatrix,
        HammingDistance,
        Hinge,
        IoU,
        MatthewsCorrcoef,
        MetricCollection,
        Precision,
        Recall,
        StatScores,
    )
    from metrics_tpu_torch.functional import dice_score
    from metrics_tpu_torch.functional.classification.matthews_corrcoef import _matthews_corrcoef_compute
    from metrics_tpu_torch.ops.histogram import label_bincount

    out = {}

    def check(label, got, want, tol):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        err = float(np.max(np.abs(got - want))) if got.size else 0.0
        if got.shape != want.shape or not np.all(np.isfinite(got)) or not err <= tol:
            raise AssertionError(f"{label}: {got.ravel()[:4]} vs oracle {want.ravel()[:4]} (max |d| {err})")
        return err

    def check_counts(label, metric, want):
        got = [getattr(metric, k).cpu().numpy() for k in ("tp", "fp", "tn", "fn")]
        for name, g, w in zip(("tp", "fp", "tn", "fn"), got, want):
            if g.dtype != np.int32 or not np.array_equal(g, w):
                raise AssertionError(f"{label}: {name} counts differ from numpy's")

    def computed_ms(coll, trials=5):
        """Host ms of compute() ending in a synchronize, cached values
        dropped; median of ``trials`` after one more call."""
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

    # a. the JAX bench's forward leg: Accuracy + macro Precision/Recall/F1 on 4 classes
    p4_np, t4_np, p4, t4 = _forward_leg_inputs(torch, dev)
    forward_leg = MetricCollection([Accuracy(), Precision(num_classes=4, average="macro"),
                                    Recall(num_classes=4, average="macro"), F1(num_classes=4, average="macro")])
    for b in range(BATCHES):
        forward_leg(p4[b * BATCH:(b + 1) * BATCH], t4[b * BATCH:(b + 1) * BATCH])
    leg = {k: v.item() for k, v in forward_leg.compute().items()}
    am4 = p4_np.argmax(1)
    counts4 = _oracle_counts(np.bincount(t4_np * 4 + am4, minlength=16).reshape(4, 4))
    for name in ("Precision", "Recall", "F1"):
        check_counts(f"forward leg {name}", forward_leg[name], counts4)
    want_leg = dict(zip(("Precision", "Recall", "F1"), _oracle_prf(counts4[0], counts4[1], counts4[3])))
    want_leg["Accuracy"] = float(np.sum(am4 == t4_np)) / MAIN_N
    leg_err = max(check(f"forward leg {k}", leg[k], v, RATIO_TOL) for k, v in want_leg.items())
    out["forward_leg_batch_ms"] = _host_ms(torch, lambda: forward_leg(p4[:BATCH], t4[:BATCH]))
    print(f"4e. forward leg (Accuracy + macro Precision/Recall/F1, 4 classes), {BATCHES} batches of {BATCH}:"
          f" {leg}, counts exact, max |d| {leg_err:.3g}; forward batch {out['forward_leg_batch_ms']:.3f} ms")

    # b. ImageNet-1k val, 50,000 x 1,000
    mc_preds, mc_target, scores_np, target_np = mc
    n, c = scores_np.shape
    mc_batch = n // MC_BATCHES
    imagenet = MetricCollection({
        "StatScores": StatScores(reduce="macro", num_classes=c),
        **{f"{cls.__name__}_{avg}": cls(num_classes=c, average=avg)
           for avg in ("macro", "weighted") for cls in (Precision, Recall, F1)},
        "Precision_top5": Precision(num_classes=c, top_k=5),
        "ConfusionMatrix": ConfusionMatrix(c, normalize="true"),
        "CohenKappa": CohenKappa(c, weights="quadratic"),
        "MatthewsCorrcoef": MatthewsCorrcoef(c),
        "IoU": IoU(c),
        "HammingDistance": HammingDistance(),
        "Hinge": Hinge(),
    })
    for b in range(MC_BATCHES):
        imagenet.update(mc_preds[b * mc_batch:(b + 1) * mc_batch], mc_target[b * mc_batch:(b + 1) * mc_batch])
    got = imagenet.compute()
    dice = dice_score(mc_preds, mc_target).item()
    am = scores_np.argmax(1)
    confmat = np.bincount(target_np * c + am, minlength=c * c).reshape(c, c)
    tp, fp, tn, fn = _oracle_counts(confmat)
    if not np.array_equal(got["StatScores"].cpu().numpy(), np.stack([tp, fp, tn, fn, tp + fn], 1)):
        raise AssertionError("ImageNet StatScores differ from numpy's counts")
    for avg in ("macro", "weighted"):
        want = _oracle_prf(tp, fp, fn, avg)
        for cls, w in zip(("Precision", "Recall", "F1"), want):
            check(f"ImageNet {cls} {avg}", got[f"{cls}_{avg}"].item(), w, RATIO_TOL)
    row = scores_np[np.arange(n), target_np]
    ahead = (scores_np > row[:, None]).sum(1) + ((scores_np == row[:, None]) & (np.arange(c) < target_np[:, None])).sum(1)
    check("ImageNet Precision top_k=5", got["Precision_top5"].item(), np.sum(ahead < 5) / (5 * n), RATIO_TOL)
    check("ImageNet ConfusionMatrix normalize='true'", got["ConfusionMatrix"].cpu().numpy(),
          confmat / confmat.sum(1, keepdims=True), RATIO_TOL)
    cmf = confmat.astype(np.float64)
    weights = (np.arange(c)[:, None] - np.arange(c)[None, :]) ** 2.0
    expected = np.outer(cmf.sum(1), cmf.sum(0)) / cmf.sum()
    check("ImageNet CohenKappa quadratic", got["CohenKappa"].item(),
          1 - np.sum(weights * cmf) / np.sum(weights * expected), ORACLE_TOL)
    mcc_gap_imagenet = abs(got["MatthewsCorrcoef"].item() - _oracle_mcc(confmat))
    if not np.isfinite(got["MatthewsCorrcoef"].item()):
        raise AssertionError("ImageNet MatthewsCorrcoef is not finite")
    check("ImageNet IoU", got["IoU"].item(), np.mean(_safe_ratio(tp, tp + fp + fn)), RATIO_TOL)
    check("ImageNet HammingDistance", got["HammingDistance"].item(), 2 * np.sum(am != target_np) / (n * c),
          RATIO_TOL)
    others = np.where(np.arange(c) == target_np[:, None], -np.inf, scores_np).max(1)
    check("ImageNet Hinge", got["Hinge"].item(), np.mean(np.maximum(0.0, 1.0 - (row - others))), ORACLE_TOL)
    check("ImageNet dice_score", dice, np.mean(np.where((tp + fn)[1:] > 0, _safe_ratio(2 * tp, 2 * tp + fp + fn)[1:],
                                                          0.0)), RATIO_TOL)
    out["imagenet_compute_ms"] = computed_ms(imagenet)
    print(f"4e. ImageNet {n}x{c}: StatScores counts exact; Precision/Recall/F1 macro and weighted, top-5 Precision,"
          f" normalized ConfusionMatrix, quadratic CohenKappa, IoU, HammingDistance, Hinge and dice_score equal the"
          f" float64 oracles; MatthewsCorrcoef {got['MatthewsCorrcoef'].item():.7f}, gap to float64"
          f" {mcc_gap_imagenet:.3g}; compute {out['imagenet_compute_ms']:.3f} ms")
    del imagenet, got

    # c. MS-COCO 2014 val multi-label, 40,504 x 80
    ml_scores_np, ml_target_np = ml
    ml_preds, ml_target = torch.from_numpy(ml_scores_np).to(dev), torch.from_numpy(ml_target_np.astype(np.int64)).to(dev)
    lc = ml_scores_np.shape[1]
    coco = MetricCollection({
        "StatScores_micro": StatScores(reduce="micro"),
        "StatScores_macro": StatScores(reduce="macro", num_classes=lc),
        "F1": F1(num_classes=lc, average="macro"),
        "HammingDistance": HammingDistance(),
        "ConfusionMatrix": ConfusionMatrix(lc, multilabel=True),
    })
    for rows in np.array_split(np.arange(ml_scores_np.shape[0]), 4):
        coco.update(ml_preds[rows[0]:rows[-1] + 1], ml_target[rows[0]:rows[-1] + 1])
    got = coco.compute()
    pb, tb = ml_scores_np >= 0.5, ml_target_np.astype(bool)
    ml_tp, ml_fp, ml_fn = (pb & tb).sum(0), (pb & ~tb).sum(0), (~pb & tb).sum(0)
    ml_tn = pb.shape[0] - ml_tp - ml_fp - ml_fn
    per_label = np.stack([ml_tp, ml_fp, ml_tn, ml_fn, ml_tp + ml_fn], 1)
    if not (np.array_equal(got["StatScores_macro"].cpu().numpy(), per_label)
            and np.array_equal(got["StatScores_micro"].cpu().numpy(), per_label.sum(0))):
        raise AssertionError("MS-COCO StatScores differ from numpy's counts")
    cells = np.stack([np.stack([ml_tn, ml_fp], 1), np.stack([ml_fn, ml_tp], 1)], 1)
    if not np.array_equal(got["ConfusionMatrix"].cpu().numpy(), cells.astype(np.float32)):
        raise AssertionError("MS-COCO multi-label ConfusionMatrix differs from numpy's (80, 2, 2) counts")
    check("MS-COCO F1 macro", got["F1"].item(), _oracle_prf(ml_tp, ml_fp, ml_fn)[2], RATIO_TOL)
    check("MS-COCO HammingDistance", got["HammingDistance"].item(), np.mean(pb != tb), RATIO_TOL)
    print(f"4e. MS-COCO {ml_scores_np.shape[0]}x{lc} multi-label: StatScores micro/macro and the (80, 2, 2)"
          f" ConfusionMatrix exact, F1 macro {got['F1'].item():.7f} and HammingDistance"
          f" {got['HammingDistance'].item():.7f} equal the oracles")
    del coco, ml_preds, ml_target

    # d. Cityscapes val, 500 x 1024 x 2048, 19 classes, 4 images a batch, made on the card
    def city_collection():
        return MetricCollection({
            "ConfusionMatrix": ConfusionMatrix(CITY_C),
            "IoU": IoU(CITY_C),
            "StatScores": StatScores(reduce="macro", num_classes=CITY_C, mdmc_reduce="global"),
            "F1": F1(num_classes=CITY_C, average="macro", mdmc_average="samplewise"),
        })

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cdf = torch.from_numpy(np.cumsum(CITY_SHARES)).to(dev, torch.float32)
    shape = (CITY_BATCH, CITY_H, CITY_W)

    def city_batch():
        target = torch.searchsorted(cdf, torch.rand(shape, generator=gen, device=dev)).clamp_(max=CITY_C - 1)
        logits = torch.randn((CITY_BATCH, CITY_C, CITY_H, CITY_W), generator=gen, device=dev)
        logits.scatter_add_(1, target[:, None], torch.full((CITY_BATCH, 1, CITY_H, CITY_W), 3.0, device=dev))
        return torch.softmax(logits, dim=1), target

    city = city_collection()
    per_image = np.zeros((CITY_IMAGES, CITY_C * CITY_C), np.int64)
    update_ms = []
    for b in range(CITY_IMAGES // CITY_BATCH):
        preds, target = city_batch()
        torch.cuda.synchronize()
        t = time.perf_counter()
        city.update(preds, target)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t) * 1e3)
        # the oracle: numpy counts of target * 19 + argmax from uint8 maps on the host
        argmax = torch.argmax(preds, dim=1).to(torch.uint8).cpu().numpy()
        index = target.to(torch.uint8).cpu().numpy().astype(np.int16) * np.int16(CITY_C) + argmax
        for i in range(CITY_BATCH):
            per_image[b * CITY_BATCH + i] = np.bincount(index[i].ravel(), minlength=CITY_C * CITY_C)
    t = time.perf_counter()
    got = city.compute()
    torch.cuda.synchronize()
    first_compute_ms = (time.perf_counter() - t) * 1e3
    confmat = per_image.sum(0).reshape(CITY_C, CITY_C)
    if not np.array_equal(city["ConfusionMatrix"].confmat.cpu().numpy(), confmat):
        raise AssertionError("Cityscapes ConfusionMatrix state differs from numpy's int64 counts")
    if not np.array_equal(got["ConfusionMatrix"].cpu().numpy(), confmat.astype(np.float32)):
        raise AssertionError("Cityscapes float32 ConfusionMatrix differs from the float32 rounding of numpy's counts")
    tp, fp, tn, fn = _oracle_counts(confmat)
    if not np.array_equal(got["StatScores"].cpu().numpy(), np.stack([tp, fp, tn, fn, tp + fn], 1)):
        raise AssertionError("Cityscapes macro StatScores differ from numpy's int64 counts")
    if not np.max(tn) > 2**24:
        raise AssertionError("Cityscapes: no per-class count passed 2^24")
    check("Cityscapes IoU", got["IoU"].item(), np.mean(_safe_ratio(tp, tp + fp + fn)), RATIO_TOL)
    img = per_image.reshape(CITY_IMAGES, CITY_C, CITY_C)
    img_tp = np.diagonal(img, axis1=1, axis2=2)
    img_prf = [_oracle_prf(img_tp[i], img[i].sum(0) - img_tp[i], img[i].sum(1) - img_tp[i]) for i in range(CITY_IMAGES)]
    check("Cityscapes F1 macro samplewise", got["F1"].item(), np.mean([x[2] for x in img_prf]), RATIO_TOL)
    city_mcc = _matthews_corrcoef_compute(city["ConfusionMatrix"].confmat).item()
    mcc_gap_city = abs(city_mcc - _oracle_mcc(confmat))
    out["cityscapes_update_ms"] = float(np.median(update_ms))
    out["cityscapes_compute_ms"] = computed_ms(city)
    out["cityscapes_first_compute_ms"] = first_compute_ms

    # host synchronizations of one update, per metric, at C = 19 and C = 1,000
    sync_sites = {}

    def update_syncs(classes, p, t):
        found = {}
        for name, make in (
            ("StatScores", lambda: StatScores(reduce="macro", num_classes=classes, mdmc_reduce="global")),
            ("F1", lambda: F1(num_classes=classes, average="macro", mdmc_average="global")),
            ("ConfusionMatrix", lambda: ConfusionMatrix(classes)),
            ("IoU", lambda: IoU(classes)),
        ):
            make().update(p, t)
            metric = make()
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    metric.update(p, t)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            sites = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]
            found[name] = len(sites)
            sync_sites[f"{name}@{classes}"] = sites
        return found

    shapes = {CITY_C: (preds, target), c: (mc_preds[:mc_batch], mc_target[:mc_batch])}
    update_syncs(CITY_C, *shapes[CITY_C])  # the first counted window may see one more, from PyTorch itself
    syncs = {k: update_syncs(k, *v) for k, v in shapes.items()}
    if syncs[CITY_C] != syncs[c] or not all(syncs[c].values()):
        raise AssertionError(f"host synchronizations per update grow with the classes: {syncs} at {sync_sites}")

    def bincount_by_size(indices, length, weights=None):
        """``label_bincount`` as it was: ``torch.bincount``, which sizes its
        output from the data's min and max (0/1 weights send a label to the
        spare bucket)."""
        idx = indices.reshape(-1).to(torch.int64).clamp_min(0)
        idx = torch.where(idx < length, idx, length)
        if weights is not None:
            idx = torch.where(weights.reshape(-1).to(torch.bool), idx, length)
        return torch.bincount(idx, minlength=length + 1)[:length]

    # the modules themselves: the package names their public functions alike
    stat_scores_module = importlib.import_module("metrics_tpu_torch.functional.classification.stat_scores")
    confmat_module = importlib.import_module("metrics_tpu_torch.functional.classification.confusion_matrix")
    stat_scores_module.label_bincount = confmat_module.label_bincount = bincount_by_size
    try:
        syncs_by_size = {k: update_syncs(k, *v) for k, v in shapes.items()}
    finally:
        stat_scores_module.label_bincount = confmat_module.label_bincount = label_bincount
    cells = target.reshape(-1) * CITY_C + torch.argmax(preds, dim=1).reshape(-1)
    if not torch.equal(label_bincount(cells, CITY_C**2), torch.bincount(cells, minlength=CITY_C**2)):
        raise AssertionError("label_bincount differs from torch.bincount on the Cityscapes cells")
    out["label_bincount_cells_ms"] = _host_ms(torch, lambda: label_bincount(cells, CITY_C**2))
    out["torch_bincount_cells_ms"] = _host_ms(torch, lambda: torch.bincount(cells, minlength=CITY_C**2))
    out.update(syncs_per_update=syncs, syncs_per_update_with_torch_bincount=syncs_by_size,
               sync_sites=sync_sites, mcc_gap_imagenet=mcc_gap_imagenet, mcc_gap_cityscapes=mcc_gap_city,
               cityscapes_mcc=city_mcc, cityscapes_max_tn=int(np.max(tn)))
    print(f"4e. Cityscapes {CITY_IMAGES}x{CITY_H}x{CITY_W}, {CITY_C} classes, {CITY_IMAGES // CITY_BATCH} batches of"
          f" {CITY_BATCH}: ConfusionMatrix and macro StatScores equal numpy's int64 counts (largest tn"
          f" {int(np.max(tn))}, above 2^24), the float32 matrix its float32 rounding; IoU {got['IoU'].item():.7f},"
          f" F1 samplewise {got['F1'].item():.7f} equal float64; MCC {city_mcc:.7f}, gap to float64 {mcc_gap_city:.3g};"
          f" update {out['cityscapes_update_ms']:.3f} ms (median), compute {out['cityscapes_compute_ms']:.3f} ms;"
          f" syncs per update {syncs} (with torch.bincount {syncs_by_size}); label_bincount"
          f" {out['label_bincount_cells_ms']:.3f} ms vs torch.bincount {out['torch_bincount_cells_ms']:.3f} ms on"
          f" {cells.numel()} cells")
    return out, (forward_leg, (p4[:BATCH], t4[:BATCH])), city_collection, (preds, target)


def _gauss64(k: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange((1 - k) / 2, (1 + k) / 2, 1.0) / sigma) ** 2) / 2)
    return g / g.sum()


def _oracle_ssim(preds: np.ndarray, target: np.ndarray, data_range: float, k: int = 11, sigma: float = 1.5,
                 k1: float = 0.01, k2: float = 0.03):
    """float64 (sum, count) of the SSIM index over the VALID k x k Gaussian
    windows of ``(B, C, H, W)`` images, image by image (the windows of
    ``tests/regression/test_ssim.py``'s oracle, without its padded ring)."""
    from scipy.ndimage import correlate1d

    g, pad = _gauss64(k, sigma), k // 2
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2

    def blur(x):
        x = correlate1d(x, g, axis=-2, mode="constant")[..., pad:-pad, :]
        return correlate1d(x, g, axis=-1, mode="constant")[..., pad:-pad]

    total, count = 0.0, 0
    for p, t in zip(preds, target):
        p, t = p.astype(np.float64), t.astype(np.float64)
        mu_p, mu_t, e_pp, e_tt, e_pt = (blur(x) for x in (p, t, p * p, t * t, p * t))
        index = ((2 * mu_p * mu_t + c1) * (2 * (e_pt - mu_p * mu_t) + c2)) / (
            (mu_p**2 + mu_t**2 + c1) * (e_pp - mu_p**2 + e_tt - mu_t**2 + c2))
        total, count = total + float(index.sum()), count + index.size
    return total, count


def _regression_phase(torch, dev, leg):
    """Phase 4f: the regression pack and metric arithmetic on the card.

    ``leg`` is phase 4e's forward-leg inputs ``(p4_np, t4_np, p4, t4)``.
    Returns the phase's timings and what phase 6 profiles."""
    import contextlib

    from metrics_tpu_torch import (
        PSNR,
        SSIM,
        ExplainedVariance,
        MeanAbsoluteError,
        MeanSquaredError,
        MetricCollection,
        Precision,
        R2Score,
        Recall,
    )
    from metrics_tpu_torch.functional import (
        mean_relative_error,
        mean_squared_error,
        mean_squared_log_error,
        psnr,
        r2score,
        ssim,
    )

    # the modules themselves: the package names its public functions alike
    sufficient_stats = importlib.import_module("metrics_tpu_torch.functional.regression.sufficient_stats")
    ssim_module = importlib.import_module("metrics_tpu_torch.functional.regression.ssim")
    out = {}

    def check(label, got, want, tol, relative=True):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        scale = np.maximum(np.abs(want), 1e-30) if relative else 1.0
        err = float(np.max(np.abs(got - want) / scale)) if got.size else 0.0
        if got.shape != want.shape or not np.all(np.isfinite(got)) or not err <= tol:
            raise AssertionError(f"{label}: {got.ravel()[:4]} vs oracle {want.ravel()[:4]} (max error {err})")
        return err

    def warm_ms(fn):
        fn()
        return _host_ms(torch, fn)

    def computed_ms(metrics, trials=5):
        """Host ms of compute() ending in a synchronize, cached values
        dropped; median of ``trials`` after one more call."""
        times = []
        for _ in range(trials + 1):
            for metric in metrics:
                metric._computed = None
            torch.cuda.synchronize()
            t = time.perf_counter()
            for metric in metrics:
                metric.compute()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times[1:]))

    # a. the JAX bench's regression forward leg (bench.py:463-464, :535)
    reg_p_np, reg_t_np, reg_p, reg_t = _regression_leg_inputs(torch, dev)

    def reg_collection():
        return MetricCollection([MeanSquaredError(), MeanAbsoluteError(), R2Score(), PSNR(), ExplainedVariance()])

    reg = reg_collection()
    alone = {name: type(m)() for name, m in reg.items()}  # the unshared path: each metric reads the batch
    stats_calls = []
    compute_stats = sufficient_stats._compute_stats
    sufficient_stats._compute_stats = lambda p, t: stats_calls.append(1) or compute_stats(p, t)
    share_err = 0.0
    try:
        for b in range(BATCHES):
            rows = slice(b * BATCH, (b + 1) * BATCH)
            step = reg(reg_p[rows], reg_t[rows])
            for name, metric in alone.items():
                share_err = max(share_err, check(f"shared step {name}", step[name].item(),
                                                 metric(reg_p[rows], reg_t[rows]).item(), SHARE_TOL))
    finally:
        sufficient_stats._compute_stats = compute_stats
    if len(stats_calls) != BATCHES:
        raise AssertionError(f"the collection computed the shared moments {len(stats_calls)} times in {BATCHES} batches")
    got = {k: v.item() for k, v in reg.compute().items()}
    for name, metric in alone.items():
        share_err = max(share_err, check(f"shared compute {name}", got[name], metric.compute().item(), SHARE_TOL))
    p64, t64 = reg_p_np.astype(np.float64), reg_t_np.astype(np.float64)
    d = t64 - p64
    mse = np.mean(d * d)
    data_range = max(t64.max(), 0.0) - min(t64.min(), 0.0)  # PSNR's running range starts at 0.0
    want = {
        "MeanSquaredError": mse,
        "MeanAbsoluteError": np.mean(np.abs(d)),
        "R2Score": 1 - np.sum(d * d) / np.sum((t64 - t64.mean()) ** 2),
        "PSNR": 10 * np.log10(data_range**2 / mse),
        "ExplainedVariance": 1 - np.var(d) / np.var(t64),
    }
    reg_err = max(check(f"regression leg {k}", got[k], v, REG_TOL) for k, v in want.items())
    msle = mean_squared_log_error(reg_p.abs(), reg_t.abs()).item()
    reg_err = max(reg_err, check("mean_squared_log_error", msle,
                                 np.mean((np.log1p(np.abs(p64)) - np.log1p(np.abs(t64))) ** 2), REG_TOL))
    mre = mean_relative_error(reg_p, reg_t).item()
    reg_err = max(reg_err, check("mean_relative_error", mre,
                                 np.mean(np.abs((p64 - t64) / np.where(t64 == 0, 1.0, t64))), REG_TOL))
    two = R2Score(num_outputs=2, multioutput="raw_values", adjusted=3)
    p2, t2 = reg_p.reshape(-1, 2), reg_t.reshape(-1, 2)
    for b in range(BATCHES):
        rows = slice(b * BATCH // 2, (b + 1) * BATCH // 2)
        two.update(p2[rows], t2[rows])
    d2, t2_64 = d.reshape(-1, 2), t64.reshape(-1, 2)
    n2 = d2.shape[0]
    r2_cols = 1 - np.sum(d2 * d2, 0) / np.sum((t2_64 - t2_64.mean(0)) ** 2, 0)
    two_value = two.compute().cpu().numpy()
    reg_err = max(reg_err, check("R2Score(num_outputs=2, adjusted=3)", two_value,
                                 1 - (1 - r2_cols) * (n2 - 1) / (n2 - 3 - 1), REG_TOL))
    fresh = reg_collection()
    _syncs(torch, lambda: fresh.update(reg_p[:BATCH], reg_t[:BATCH]))  # the first counted window may see one more
    update_sites = _syncs(torch, lambda: fresh.update(reg_p[:BATCH], reg_t[:BATCH]))
    forward_sites = _syncs(torch, lambda: fresh(reg_p[:BATCH], reg_t[:BATCH]))
    if update_sites:
        raise AssertionError(f"one regression collection update synchronized with the host at {update_sites}")
    print(f"4f. regression leg (MSE + MAE + R2 + PSNR + EV), {BATCHES} forward batches of {BATCH}: {got}, max"
          f" relative error {reg_err:.3g} against float64 (MSLE {msle:.7f}, relative error {mre:.5f}, 2-output"
          f" adjusted R2 {two_value}); shared pass {len(stats_calls)} times in {BATCHES} batches, equal to the"
          f" unshared values within {share_err:.3g}; syncs per update {len(update_sites)}, per forward"
          f" {len(forward_sites)} {forward_sites}")

    # b. BASELINE config 4's images (bench.py:1458, 1470-1471), under global TF32 flags
    flags = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")

    def flags_kept(label):
        if torch.get_float32_matmul_precision() != "high" or torch.backends.cudnn.allow_tf32 is not True:
            raise AssertionError(f"{label} changed the caller's TF32 flags")

    try:
        rs = np.random.RandomState(SEED + 4)
        img_t_np = rs.rand(*IMG_SHAPE).astype(np.float32)
        img_p_np = np.clip(img_t_np * 0.8 + 0.2 * rs.rand(*IMG_SHAPE), 0, 1).astype(np.float32)
        img_t, img_p = torch.from_numpy(img_t_np).to(dev), torch.from_numpy(img_p_np).to(dev)
        ip64, it64 = img_p_np.astype(np.float64), img_t_np.astype(np.float64)
        img_mse = np.mean((ip64 - it64) ** 2)
        img_err = check("psnr(data_range=1.0)", psnr(img_p, img_t, data_range=1.0).item(),
                        10 * np.log10(1.0 / img_mse), REG_TOL)
        psnr_module, psnr_images = PSNR(), PSNR(dim=(1, 2, 3), data_range=1.0, reduction="none")
        for rows in np.array_split(np.arange(IMG_SHAPE[0]), 4):
            psnr_module(img_p[rows[0]:rows[-1] + 1], img_t[rows[0]:rows[-1] + 1])
            psnr_images(img_p[rows[0]:rows[-1] + 1], img_t[rows[0]:rows[-1] + 1])
        img_range = max(it64.max(), 0.0) - min(it64.min(), 0.0)
        img_err = max(img_err, check("PSNR() over 4 batches", psnr_module.compute().item(),
                                     10 * np.log10(img_range**2 / img_mse), REG_TOL))
        img_err = max(img_err, check("PSNR(dim=(1, 2, 3), reduction='none')", psnr_images.compute().cpu().numpy(),
                                     10 * np.log10(1.0 / np.mean((ip64 - it64) ** 2, axis=(1, 2, 3))), REG_TOL))
        total, count = _oracle_ssim(img_p_np, img_t_np, 1.0)
        ssim_128 = ssim(img_p, img_t, data_range=1.0).item()
        flags_kept("ssim at 128 x 128")
        ssim_err = {"128x128": check("ssim at 16x3x128x128 (banded)", ssim_128, total / count, SSIM_TOL, False)}
        # the same blur with TF32 left on: what the gate keeps out
        full_float32 = ssim_module._full_float32
        ssim_module._full_float32 = contextlib.nullcontext
        try:
            out["ssim_128_err_with_tf32_blur"] = abs(ssim(img_p, img_t, data_range=1.0).item() - total / count)
        finally:
            ssim_module._full_float32 = full_float32
        print(f"4f. images {IMG_SHAPE}: psnr, PSNR() over 4 batches and per-image PSNR within {img_err:.3g} relative;"
              f" ssim {ssim_128:.8f}, {ssim_err['128x128']:.3g} from float64 (with a TF32 blur"
              f" {out['ssim_128_err_with_tf32_blur']:.3g})")

        # c. the convolution form: the Kodak set's shape through SSIM(), then 4 Cityscapes-size frames
        rs = np.random.RandomState(SEED + 5)
        kodak_shape = (KODAK_IMAGES, 3, KODAK_H, KODAK_W)
        kodak_t_np = rs.rand(*kodak_shape).astype(np.float32)
        kodak_p_np = np.clip(kodak_t_np * 0.8 + 0.2 * rs.rand(*kodak_shape), 0, 1).astype(np.float32)
        kodak_t, kodak_p = torch.from_numpy(kodak_t_np).to(dev), torch.from_numpy(kodak_p_np).to(dev)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # SSIM's buffer warning
            kodak = SSIM()
        for b in range(KODAK_IMAGES // KODAK_BATCH):
            kodak.update(kodak_p[b * KODAK_BATCH:(b + 1) * KODAK_BATCH], kodak_t[b * KODAK_BATCH:(b + 1) * KODAK_BATCH])
        ssim_kodak = kodak.compute().item()
        flags_kept("SSIM().compute() over Kodak")
        kodak_range = max(np.ptp(kodak_p_np.astype(np.float64)), np.ptp(kodak_t_np.astype(np.float64)))
        total, count = _oracle_ssim(kodak_p_np, kodak_t_np, kodak_range)
        ssim_err["512x768"] = check("SSIM() over Kodak (convolution)", ssim_kodak, total / count, SSIM_TOL, False)
        rs = np.random.RandomState(SEED + 6)
        frames_shape = (FRAMES, 3, CITY_H, CITY_W)
        frames_t_np = rs.rand(*frames_shape).astype(np.float32)
        frames_p_np = np.clip(frames_t_np * 0.8 + 0.2 * rs.rand(*frames_shape), 0, 1).astype(np.float32)
        frames_t, frames_p = torch.from_numpy(frames_t_np).to(dev), torch.from_numpy(frames_p_np).to(dev)
        ssim_frames = ssim(frames_p, frames_t, data_range=1.0).item()
        flags_kept(f"ssim at {frames_shape}")
        total, count = _oracle_ssim(frames_p_np, frames_t_np, 1.0)
        ssim_err["1024x2048"] = check(f"ssim at {frames_shape} (convolution)", ssim_frames, total / count,
                                      SSIM_TOL, False)
        print(f"4f. SSIM under TF32 flags: Kodak {kodak_shape} in {KODAK_IMAGES // KODAK_BATCH} batches"
              f" {ssim_kodak:.8f}, frames {frames_shape} {ssim_frames:.8f}; from float64: {ssim_err}; flags kept")
    finally:
        torch.set_float32_matmul_precision(flags[0])
        torch.backends.cudnn.allow_tf32 = flags[1]
    del kodak_t_np, kodak_p_np, frames_t_np, frames_p_np

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ssim_metric = SSIM()
    ssim_metric.update(img_p, img_t)
    ssim_sites = _syncs(torch, lambda: ssim_metric.update(img_p, img_t))
    if ssim_sites:
        raise AssertionError(f"one SSIM update synchronized with the host at {ssim_sites}")

    # d. metric arithmetic: forward keeps every operand's accumulation
    rmse = MeanSquaredError() ** 0.5
    for b in range(BATCHES):
        rmse(reg_p[b * BATCH:(b + 1) * BATCH], reg_t[b * BATCH:(b + 1) * BATCH])
    comp_err = check("MeanSquaredError() ** 0.5", rmse.compute().item(), got["MeanSquaredError"] ** 0.5, COMP_TOL)
    p4_np, t4_np, p4, t4 = leg
    mean_pr = (Precision(num_classes=4, average="macro") + Recall(num_classes=4, average="macro")) / 2
    for b in range(BATCHES):
        last_step = mean_pr(p4[b * BATCH:(b + 1) * BATCH], t4[b * BATCH:(b + 1) * BATCH]).item()
    counts4 = _oracle_counts(np.bincount(t4_np * 4 + p4_np.argmax(1), minlength=16).reshape(4, 4))
    precision, recall, _ = _oracle_prf(counts4[0], counts4[1], counts4[3])
    epoch_pr = mean_pr.compute().item()
    comp_err = max(comp_err, check("(Precision + Recall) / 2 after forward", epoch_pr, (precision + recall) / 2,
                                   COMP_TOL))
    print(f"4f. composition: RMSE {rmse.compute().item():.7f}; (Precision + Recall) / 2 {epoch_pr:.7f} (the epoch's;"
          f" last batch {last_step:.7f}), within {comp_err:.3g} of float64")

    # timings (phase 5): host clock ending in a synchronize, one warm-up, median of 5
    out["forward_batch_ms"] = warm_ms(lambda: reg(reg_p[:BATCH], reg_t[:BATCH]))
    out["compute_ms"] = computed_ms(list(reg.values()))
    out["forward_batch_unshared_ms"] = warm_ms(lambda: [m(reg_p[:BATCH], reg_t[:BATCH]) for m in alone.values()])
    out["r2score_1m_ms"] = warm_ms(lambda: r2score(reg_p, reg_t))
    out["mean_squared_error_1m_ms"] = warm_ms(lambda: mean_squared_error(reg_p, reg_t))
    out["psnr_16x3x128x128_ms"] = warm_ms(lambda: psnr(img_p, img_t, data_range=1.0))
    out["ssim_16x3x128x128_ms"] = warm_ms(lambda: ssim(img_p, img_t, data_range=1.0))
    out["ssim_compute_kodak_ms"] = computed_ms([kodak])
    out["ssim_4x3x1024x2048_ms"] = warm_ms(lambda: ssim(frames_p, frames_t, data_range=1.0))
    split = ssim_module._MATMUL_BLUR_MAX_DIM
    blur_diff = {}
    for label, (p, t) in (("128x128", (img_p, img_t)), ("512x768", (kodak_p, kodak_t)),
                          ("1024x2048", (frames_p, frames_t))):
        stack = torch.cat((p, t, p * p, t * t, p * t))
        blurred = {}
        for form, limit in (("banded", 1 << 30), ("conv", 0)):
            ssim_module._MATMUL_BLUR_MAX_DIM = limit
            try:
                out[f"blur_{form}_{label}_ms"] = warm_ms(
                    lambda: ssim_module._depthwise_blur(stack, (11, 11), (1.5, 1.5)))
                blurred[form] = ssim_module._depthwise_blur(stack, (11, 11), (1.5, 1.5))
            finally:
                ssim_module._MATMUL_BLUR_MAX_DIM = split
        blur_diff[label] = torch.max(torch.abs(blurred["banded"] - blurred["conv"])).item()
        del stack, blurred
    if not max(blur_diff.values()) <= BLUR_TOL:
        raise AssertionError(f"the banded and convolution blurs disagree: {blur_diff}")
    out.update(ssim_err=ssim_err, regression_max_rel_err=reg_err, shared_vs_unshared_max_rel_err=share_err,
               shared_pass_calls=len(stats_calls), syncs_per_update=len(update_sites),
               syncs_per_forward=len(forward_sites), forward_sync_sites=forward_sites,
               ssim_syncs_per_update=len(ssim_sites), composition_max_err=comp_err, blur_forms_max_abs_diff=blur_diff)
    print(f"4f. times: forward batch {out['forward_batch_ms']:.3f} ms (unshared {out['forward_batch_unshared_ms']:.3f}),"
          f" compute {out['compute_ms']:.3f} ms, ssim 128 {out['ssim_16x3x128x128_ms']:.3f} ms, Kodak compute"
          f" {out['ssim_compute_kodak_ms']:.3f} ms, frames {out['ssim_4x3x1024x2048_ms']:.3f} ms; blur banded/conv"
          + "".join(f" {k} {out[f'blur_banded_{k}_ms']:.3f}/{out[f'blur_conv_{k}_ms']:.3f}" for k in blur_diff)
          + f" ms (max |d| {max(blur_diff.values()):.3g})")
    del kodak, kodak_p, kodak_t
    return out, (reg, (reg_p[:BATCH], reg_t[:BATCH])), (frames_p, frames_t)


def _oracle_retrieval(idx: np.ndarray, preds: np.ndarray, target: np.ndarray, ks=(10, 100)) -> dict:
    """Per-query float64 oracle: a lexsort by (query id, -score, position),
    then each query's relevant count, first relevant rank, hits in the top
    k, AP, RR, P@k and R@k, and their means over the queries with a
    relevant document (``empty_target_action="skip"``)."""
    score = np.where(np.isnan(preds), -np.inf, preds.astype(np.float64))
    order = np.lexsort((np.arange(idx.size), -score, idx))
    q, rel = idx[order], target[order] > 0
    starts = np.flatnonzero(np.r_[True, q[1:] != q[:-1]])
    sizes = np.diff(np.r_[starts, q.size])
    rank = np.arange(q.size) - np.repeat(starts, sizes) + 1
    cum = np.cumsum(rel)
    within = cum - np.repeat((cum - rel)[starts], sizes)
    out = {"n_rel": np.add.reduceat(rel.astype(np.int64), starts),
           "first": np.add.reduceat(np.where(rel & (within == 1), rank, 0), starts)}
    n_rel = np.maximum(out["n_rel"], 1)
    ap = np.add.reduceat(np.where(rel, within / rank, 0.0), starts) / n_rel
    rr = np.where(out["first"] > 0, 1.0 / np.maximum(out["first"], 1), 0.0)
    kept = out["n_rel"] > 0
    out["RetrievalMAP"], out["RetrievalMRR"] = float(np.mean(ap[kept])), float(np.mean(rr[kept]))
    for k in ks:
        out[f"hits@{k}"] = np.add.reduceat((rel & (rank <= k)).astype(np.int64), starts)
        out[f"precision@{k}"] = float(np.mean(out[f"hits@{k}"][kept] / k))
        out[f"recall@{k}"] = float(np.mean(out[f"hits@{k}"][kept] / n_rel[kept]))
    out["query_ap_rr"] = (ap, rr)
    return out


def _dtoh_bytes(torch, fn, path: str):
    """(bytes, copies) of the device-to-host copies ``fn()`` makes, read
    from a ``torch.profiler`` trace written to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]
    if not copies or any("bytes" not in e.get("args", {}) for e in copies):
        raise AssertionError(f"the trace shows {len(copies)} device-to-host copies, not all with a byte count")
    return sum(int(e["args"]["bytes"]) for e in copies), len(copies)


def _retrieval_phase(torch, dev):
    """Phase 4g: the retrieval family on the card.

    Returns the phase's timings and what phase 6 profiles."""
    from metrics_tpu_torch import (
        F1,
        Accuracy,
        MetricCollection,
        RetrievalMAP,
        RetrievalMRR,
        RetrievalPrecision,
        RetrievalRecall,
        ShardedAUROC,
        ShardedRetrievalMAP,
        ShardedRetrievalMRR,
        ShardedRetrievalPrecision,
        ShardedRetrievalRecall,
    )
    from metrics_tpu_torch.functional import (
        retrieval_average_precision,
        retrieval_precision,
        retrieval_recall,
        retrieval_reciprocal_rank,
    )

    # the modules themselves: the package names their public functions alike
    segment = importlib.import_module("metrics_tpu_torch.ops.segment")
    map_module = importlib.import_module("metrics_tpu_torch.retrieval.mean_average_precision")
    mrr_module = importlib.import_module("metrics_tpu_torch.retrieval.mean_reciprocal_rank")
    trace_path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "retrieval_compute_trace.json")
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    out = {}

    def four(sharded_capacity=None):
        if sharded_capacity:
            return MetricCollection([ShardedRetrievalMAP(sharded_capacity), ShardedRetrievalMRR(sharded_capacity),
                                     ShardedRetrievalPrecision(sharded_capacity, k=10),
                                     ShardedRetrievalRecall(sharded_capacity, k=100)])
        return MetricCollection([RetrievalMAP(), RetrievalMRR(), RetrievalPrecision(k=10), RetrievalRecall(k=100)])

    def bits(collection):
        for metric in collection.values():
            metric._computed = None
        return {k.replace("Sharded", ""): v.cpu().numpy().tobytes() for k, v in collection.compute().items()}

    def computed_ms(collection, trials=5):
        times = []
        for _ in range(trials + 1):
            for metric in collection.values():
                metric._computed = None
            torch.cuda.synchronize()
            t = time.perf_counter()
            collection.compute()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times[1:]))

    def fed(collection, idx, preds, target, batch):
        """Update ``collection`` batch by batch; host ms of each update."""
        times = []
        for lo in range(0, idx.shape[0], batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            collection.update(idx[lo:lo + batch], preds[lo:lo + batch], target[lo:lo + batch])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return times

    def check(label, collection, oracle):
        """Every value within RET_TOL of the float64 oracle, the integer
        quantities equal to its, a second compute's bits equal."""
        names = {"RetrievalMAP": "RetrievalMAP", "RetrievalMRR": "RetrievalMRR",
                 "RetrievalPrecision": "precision@10", "RetrievalRecall": "recall@100"}
        got = {k.replace("Sharded", ""): v.item() for k, v in collection.compute().items()}
        err = {k: abs(v - oracle[names[k]]) for k, v in got.items()}
        if not all(np.isfinite(v) for v in got.values()) or not max(err.values()) <= RET_TOL:
            raise AssertionError(f"{label}: {got} vs the float64 oracle (errors {err})")
        first = bits(collection)
        if bits(collection) != first:
            raise AssertionError(f"{label}: a second compute over the same state gave other bits")
        return got, max(err.values()), first

    def check_counts(label, idx, preds, target, oracle):
        stats = segment._ranked_query_stats(idx, preds, target)
        got = {"n_rel": stats.pos_per_group, "first": mrr_module._first_relevant_ranks(stats),
               "hits@10": segment.hits_in_topk(stats, 10)[0], "hits@100": segment.hits_in_topk(stats, 100)[0]}
        bad = [k for k, v in got.items() if not np.array_equal(v.cpu().numpy().astype(np.int64), oracle[k])]
        if bad:
            raise AssertionError(f"{label}: {bad} differ from the oracle's integers")
        return int(stats.pos_per_group.shape[0])

    # a. BASELINE config 5, the JAX bench's retrieval leg (bench.py:1455-1533):
    # MAP + MRR in a collection, 10 update batches of 100,000
    idx = torch.randint(0, RET_Q, (RET_N,), generator=gen, device=dev, dtype=torch.int32)
    scores = torch.rand(RET_N, generator=gen, device=dev)
    rel = (torch.rand(RET_N, generator=gen, device=dev) < RET_REL).to(torch.int32)
    idx_np, scores_np, rel_np = idx.cpu().numpy(), scores.cpu().numpy(), rel.cpu().numpy()
    oracle = _oracle_retrieval(idx_np, scores_np, rel_np)
    leg = MetricCollection([RetrievalMAP(), RetrievalMRR()])
    leg_updates = fed(leg, idx, scores, rel, BATCH)
    leg_values, leg_err, leg_bits = check("config 5 MAP + MRR", leg, oracle)
    leg_queries = check_counts("config 5", idx, scores, rel, oracle)
    out["config5_update_batch_ms"] = float(np.median(leg_updates))
    out["config5_compute_ms"] = computed_ms(leg)

    def core():
        stats = segment.ranked_group_stats(idx, scores, rel, RET_Q)
        return map_module._map_segments(stats), mrr_module._mrr_segments(stats), stats.pos_per_group

    ap_q, rr_q, pos = core()
    kept = (pos > 0).cpu().numpy()
    core_err = max(abs(float(ap_q.double().cpu().numpy()[kept].mean()) - oracle["RetrievalMAP"]),
                   abs(float(rr_q.double().cpu().numpy()[kept].mean()) - oracle["RetrievalMRR"]))
    if not core_err <= RET_TOL:
        raise AssertionError(f"the functional core reads {core_err} off the float64 oracle")
    core()
    out["config5_functional_core_ms"] = _host_ms(torch, core)
    print(f"4g. config 5 (1M rows, {leg_queries} queries): MAP {leg_values['RetrievalMAP']:.7f}, MRR"
          f" {leg_values['RetrievalMRR']:.7f}, within {leg_err:.3g} of float64 (functional core {core_err:.3g});"
          f" integers exact; update {out['config5_update_batch_ms']:.3f} ms a batch, compute"
          f" {out['config5_compute_ms']:.3f} ms, functional core {out['config5_functional_core_ms']:.3f} ms")

    # b. host synchronizations and device-to-host bytes of one compute, at 100
    # and 10,000 queries over the same 1M rows
    syncs, dtoh = {}, {}
    for queries in (100, RET_Q):
        collection = four()
        collection.update(idx % queries, scores, rel)
        collection.compute()  # first calls may synchronize once more
        for metric in collection.values():
            metric._computed = None
        syncs[queries] = _syncs(torch, collection.compute)
        for metric in collection.values():
            metric._computed = None
        dtoh[queries] = _dtoh_bytes(torch, collection.compute, trace_path)
        del collection
    counts_of = {q: len(s) for q, s in syncs.items()}
    if len(set(counts_of.values())) != 1 or not counts_of[RET_Q]:
        raise AssertionError(f"host syncs per compute of the four metrics grow with the queries: {syncs}")
    if max(b for b, _ in dtoh.values()) > 4096 or dtoh[100][0] != dtoh[RET_Q][0]:
        raise AssertionError(f"a compute copied an O(N) array to the host: (bytes, copies) {dtoh}")
    out.update(syncs_per_compute=counts_of[RET_Q], sync_sites=syncs[RET_Q],
               dtoh_bytes_per_compute={str(q): v[0] for q, v in dtoh.items()},
               dtoh_copies_per_compute={str(q): v[1] for q, v in dtoh.items()})
    print(f"4g. host syncs per compute of MAP + MRR + P@10 + R@100 over 1M rows: {counts_of[100]} at 100 queries,"
          f" {counts_of[RET_Q]} at {RET_Q}; device-to-host bytes {dtoh[100][0]} / {dtoh[RET_Q][0]}")

    # c. BASELINE config 5's epoch at world 1 (bench.py:246-270): one update and
    # one compute of Accuracy + F1, ShardedAUROC, ShardedRetrievalMAP / MRR
    col = MetricCollection([Accuracy(), F1()])
    sa, sm, sr = ShardedAUROC(capacity_per_device=RET_N), ShardedRetrievalMAP(RET_N), ShardedRetrievalMRR(RET_N)

    def epoch():
        for metric in (*col.values(), sa, sm, sr):
            metric.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        col.update(scores, rel)
        sa.update(scores, rel)
        sm.update(idx, scores, rel)
        sr.update(idx, scores, rel)
        values = [*col.compute().values(), sa.compute(), sm.compute(), sr.compute()]
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, values

    epoch()
    epochs = [epoch()[0] for _ in range(5)]
    _, epoch_values = epoch()
    if {"RetrievalMAP": epoch_values[3].cpu().numpy().tobytes(),
            "RetrievalMRR": epoch_values[4].cpu().numpy().tobytes()} != leg_bits:
        raise AssertionError("ShardedRetrievalMAP / MRR at world 1 differ from RetrievalMAP / MRR in their bits")
    out["config5_epoch_ms"] = float(np.median(epochs))
    out["config5_epoch_ms_runs"] = epochs
    print(f"4g. config 5 epoch (Accuracy + F1, ShardedAUROC, ShardedRetrievalMAP / MRR, 1M rows):"
          f" {out['config5_epoch_ms']:.3f} ms; the sharded retrieval values equal the unsharded bits")

    # d. the MS MARCO passage ranking dev (small) shape: 6,980 queries x 1,000
    # candidates, 7,437 relevant rows, 70 batches of 100 queries
    ids = torch.randperm(MSMARCO_ID_SPACE, generator=gen, device=dev)[:MSMARCO_Q].to(torch.int32)
    first = torch.randint(0, MSMARCO_DOCS, (MSMARCO_Q,), generator=gen, device=dev)
    grid = torch.zeros(MSMARCO_Q, MSMARCO_DOCS, dtype=torch.int32, device=dev)
    grid[torch.arange(MSMARCO_Q, device=dev), first] = 1
    extra = torch.randperm(MSMARCO_Q, generator=gen, device=dev)[:MSMARCO_REL - MSMARCO_Q]
    shift = torch.randint(1, MSMARCO_DOCS, (extra.shape[0],), generator=gen, device=dev)
    grid[extra, (first[extra] + shift) % MSMARCO_DOCS] = 1
    ms_scores = (torch.randn(MSMARCO_Q, MSMARCO_DOCS, generator=gen, device=dev) + MSMARCO_SHIFT * grid).reshape(-1)
    ms_rel = grid.reshape(-1)
    ms_idx = ids[:, None].expand(MSMARCO_Q, MSMARCO_DOCS).reshape(-1).contiguous()
    if int(ms_rel.sum()) != MSMARCO_REL:
        raise AssertionError(f"the MS MARCO shape holds {int(ms_rel.sum())} relevant rows")
    ms_np = ms_idx.cpu().numpy(), ms_scores.cpu().numpy(), ms_rel.cpu().numpy()
    ms_oracle = _oracle_retrieval(*ms_np)
    ms = four()
    ms_updates = fed(ms, ms_idx, ms_scores, ms_rel, MSMARCO_BATCH_Q * MSMARCO_DOCS)
    ms_values, ms_err, ms_bits = check("MS MARCO", ms, ms_oracle)
    ms_queries = check_counts("MS MARCO", ms_idx, ms_scores, ms_rel, ms_oracle)
    ms_sharded = four(MSMARCO_Q * MSMARCO_DOCS)
    fed(ms_sharded, ms_idx, ms_scores, ms_rel, MSMARCO_BATCH_Q * MSMARCO_DOCS)
    if bits(ms_sharded) != ms_bits:
        raise AssertionError("the sharded metrics at world 1 differ from the unsharded ones in their bits")
    del ms_sharded
    out["msmarco_update_batch_ms"] = float(np.median(ms_updates))
    out["msmarco_compute_ms"] = computed_ms(ms)
    for metric in ms.values():
        metric._computed = None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms.compute()
    torch.cuda.synchronize()
    out["msmarco_compute_peak_bytes_above_state"] = torch.cuda.max_memory_allocated() - base
    out["msmarco_state_bytes"] = base
    # both formulations of the (query asc, score desc, position) permutation
    g_two, o_two = segment._lex_order_two_pass(ms_idx, ms_scores)
    g_packed, o_packed = segment._lex_order_packed(ms_idx, ms_scores)
    if not (torch.equal(g_two, g_packed) and torch.equal(o_two, o_packed)):
        raise AssertionError("the two sort forms give different permutations")
    del g_two, o_two, g_packed, o_packed
    out["msmarco_sort_two_pass_ms"] = _queued_ms(torch, lambda: segment._lex_order_two_pass(ms_idx, ms_scores), 10)
    out["msmarco_sort_packed_ms"] = _queued_ms(torch, lambda: segment._lex_order_packed(ms_idx, ms_scores), 10)
    out["sort_form_kept"] = segment._lex_order.__name__
    # the functional forms on the first query's 1,000 candidates
    q_ap, q_rr = ms_oracle["query_ap_rr"]
    q0 = int(torch.argmin(ids))  # the oracle's first query is the smallest id
    rows = slice(q0 * MSMARCO_DOCS, (q0 + 1) * MSMARCO_DOCS)
    p0, t0 = ms_scores[rows], ms_rel[rows]
    functional = {"ap": (retrieval_average_precision(p0, t0).item(), q_ap[0]),
                  "rr": (retrieval_reciprocal_rank(p0, t0).item(), q_rr[0]),
                  "p@10": (retrieval_precision(p0, t0, k=10).item(), ms_oracle["hits@10"][0] / 10),
                  "r@100": (retrieval_recall(p0, t0, k=100).item(),
                            ms_oracle["hits@100"][0] / ms_oracle["n_rel"][0])}
    fn_err = max(abs(a - b) for a, b in functional.values())
    if not fn_err <= RET_TOL:
        raise AssertionError(f"the functional forms read off the float64 oracle: {functional}")
    out.update(config5_values=leg_values, config5_max_err=leg_err, config5_core_max_err=core_err,
               msmarco_values=ms_values, msmarco_max_err=ms_err, functional_max_err=fn_err,
               msmarco_queries=ms_queries, config5_queries=leg_queries)
    print(f"4g. MS MARCO dev shape ({ms_queries} queries x {MSMARCO_DOCS}, {MSMARCO_REL} relevant):"
          + "".join(f" {k} {v:.7f}" for k, v in ms_values.items())
          + f", within {ms_err:.3g} of float64; integers exact; sharded bits equal; update"
          f" {out['msmarco_update_batch_ms']:.3f} ms a batch, compute {out['msmarco_compute_ms']:.3f} ms"
          f" (peak {out['msmarco_compute_peak_bytes_above_state'] / 2**20:.1f} MiB above the state); sorts: two"
          f" int32 {out['msmarco_sort_two_pass_ms']:.3f} ms, packed int64 {out['msmarco_sort_packed_ms']:.3f} ms")
    return out, ms


def _device_ops(torch, fn):
    """(kernels, copies and fills) the device runs for ``fn()``, counted in
    a ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = sum(e.count for e in ops if e.key.startswith(("Memcpy", "Memset")))
    return sum(e.count for e in ops) - copies, copies


def _engine_phase(torch, dev, binary):
    """Phase 4h: the step engine (``MetricCollection(compiled=True)``: one
    CUDA graph per call signature), the stat-score siblings' shared count,
    the wrapper and the functional extras on the card.

    ``binary`` is phase 3's ``(preds, target)`` on the card. Returns the
    phase's timings and what phase 6 profiles."""
    from metrics_tpu_torch import (
        AUROC,
        F1,
        PSNR,
        Accuracy,
        BootStrapper,
        ExplainedVariance,
        MeanAbsoluteError,
        MeanSquaredError,
        MetricCollection,
        Precision,
        R2Score,
        Recall,
        StatScores,
    )
    from metrics_tpu_torch.functional import bleu_score, embedding_similarity, image_gradients
    from metrics_tpu_torch.ops import tie_scan

    boot_module = importlib.import_module("metrics_tpu_torch.wrappers.bootstrapping")
    out = {}

    def forward_leg(compiled):
        return MetricCollection([Accuracy(), Precision(num_classes=4, average="macro"),
                                 Recall(num_classes=4, average="macro"), F1(num_classes=4, average="macro")],
                                compiled=compiled)

    def regression_leg(compiled):
        return MetricCollection([MeanSquaredError(), MeanAbsoluteError(), R2Score(), PSNR(), ExplainedVariance()],
                                compiled=compiled)

    def check_step(label, eager, compiled, ve, vc):
        """Values within ENGINE_TOL relative, integer states exact, float
        states within ENGINE_TOL relative."""
        worst = 0.0
        for k in ve:
            a, b = vc[k].double(), ve[k].double()
            err = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
            if not bool(torch.isfinite(a).all()) or not err <= ENGINE_TOL:
                raise AssertionError(f"{label}: compiled {k} {vc[k].tolist()} vs eager {ve[k].tolist()}")
            worst = max(worst, err)
        for name in eager.keys():
            for sname in eager[name]._defaults:
                a, b = getattr(compiled[name], sname), getattr(eager[name], sname)
                if a.is_floating_point():
                    err = float(((a.double() - b.double()).abs() / b.double().abs().clamp_min(1e-30)).max())
                    if not err <= ENGINE_TOL:
                        raise AssertionError(f"{label}: state {name}.{sname} off eager by {err} relative")
                elif not torch.equal(a, b):
                    raise AssertionError(f"{label}: count {name}.{sname} differs from eager's")
        return worst

    def leg(label, make, batches):
        """The eager and the compiled collection over ``batches``: equality
        every step, no demotion, 0 syncs per replayed step, forward batch
        ms of both, the first step's build, the graph's pool."""
        eager, compiled = make(False), make(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vc = compiled(*batches[0])
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        worst = check_step(f"{label} step 0", eager, compiled, eager(*batches[0]), vc)
        for b, batch in enumerate(batches[1:], 1):
            worst = max(worst, check_step(f"{label} step {b}", eager, compiled, eager(*batch), compiled(*batch)))
        for k, v in eager.compute().items():
            got = compiled.compute()[k]
            if not float(((got.double() - v.double()).abs() / v.double().abs().clamp_min(1e-30)).max()) <= ENGINE_TOL:
                raise AssertionError(f"{label}: epoch {k} {got.tolist()} vs eager {v.tolist()}")
        info = compiled._engine.cache_info()
        if info["eager_fallbacks"] or info["trace_count"] != 1:
            raise AssertionError(f"{label}: the engine demoted or rebuilt: {info}")
        sites = _syncs(torch, lambda: compiled(*batches[1]))
        if sites:
            raise AssertionError(f"{label}: a replayed step synchronized the host at {sites}")
        result = {
            "forward_batch_ms_compiled": _host_ms(torch, lambda: compiled(*batches[1])),
            "forward_batch_ms_eager": _host_ms(torch, lambda: eager(*batches[1])),
            # the replayed step's device time: steps queued behind a device sleep
            "replay_device_ms": _queued_ms(torch, lambda: compiled(*batches[1]), launches=20),
            "first_step_ms": first_ms,
            "warm_up_and_capture_ms": info["graph_build_ms"][0],
            "graph_pool_bytes": info["graph_pool_bytes"],
            "syncs_per_replayed_step": len(sites),
            "max_rel_err_vs_eager": worst,
        }
        print(f"4h. {label}: {len(batches)} batches compiled = eager (counts exact, max rel err {worst:.3g}),"
              f" no demotion, 0 syncs a replayed step; forward batch {result['forward_batch_ms_compiled']:.3f} ms"
              f" compiled ({result['replay_device_ms']:.3f} ms of device time) vs"
              f" {result['forward_batch_ms_eager']:.3f} ms eager; first step {first_ms:.1f} ms"
              f" (warm-up + capture {result['warm_up_and_capture_ms']:.1f} ms), graph pool"
              f" {info['graph_pool_bytes'] / 2**20:.1f} MiB")
        return result, compiled

    # a. the forward leg (phase 4e's data), then the JAX bench's 1M x 4 batch
    _, _, p4, t4 = _forward_leg_inputs(torch, dev)
    cls_batches = [(p4[b * BATCH:(b + 1) * BATCH], t4[b * BATCH:(b + 1) * BATCH]) for b in range(BATCHES)]
    out["forward_leg"], compiled_leg = leg(f"forward leg ({BATCHES} x {BATCH})", forward_leg, cls_batches)
    out["forward_leg_1m"], _ = leg(f"forward leg at {MAIN_N} x 4", forward_leg, [(p4, t4), (p4, t4)])

    # b. the regression leg (phase 4f's five metrics and rows)
    _, _, reg_p, reg_t = _regression_leg_inputs(torch, dev)
    reg_batches = [(reg_p[b * BATCH:(b + 1) * BATCH], reg_t[b * BATCH:(b + 1) * BATCH]) for b in range(BATCHES)]
    out["regression_leg"], compiled_reg = leg(f"regression leg ({BATCHES} x {BATCH})", regression_leg, reg_batches)

    # c. the stat-score siblings' count, eager: one forward of the collection
    # against the four metrics' own forwards (what the collection did before
    # the shared count)
    shared = forward_leg(False)
    alone = list(forward_leg(False).values())
    batch = cls_batches[0]
    shared(*batch)
    for m in alone:
        m(*batch)
    syncs_shared = _syncs(torch, lambda: shared(*batch))
    syncs_alone = _syncs(torch, lambda: [m(*batch) for m in alone])
    ops_shared, ops_alone = _device_ops(torch, lambda: shared(*batch)), _device_ops(torch, lambda: [m(*batch) for m in alone])
    if len(syncs_shared) != 2 or len(syncs_alone) != 4:
        raise AssertionError(f"stat-score siblings: syncs shared {syncs_shared}, alone {syncs_alone}; want 2 and 4")
    out["siblings"] = {"syncs_per_forward_shared": len(syncs_shared), "syncs_per_forward_unshared": len(syncs_alone),
                       "kernels_per_forward_shared": ops_shared[0], "kernels_per_forward_unshared": ops_alone[0],
                       "copies_per_forward_shared": ops_shared[1], "copies_per_forward_unshared": ops_alone[1],
                       "forward_batch_ms_shared": _host_ms(torch, lambda: shared(*batch)),
                       "forward_batch_ms_unshared": _host_ms(torch, lambda: [m(*batch) for m in alone])}
    print(f"4h. stat-score siblings, eager forward of 4 metrics: {out['siblings']}")

    # d. the binary step (phase 3's batches): Accuracy captured, AUROC eager
    preds, target = binary
    eager_bin = MetricCollection([Accuracy(), AUROC(pos_label=1)])
    compiled_bin = MetricCollection([Accuracy(), AUROC(pos_label=1)], compiled=True)
    for b in range(BATCHES):
        sl = slice(b * BATCH, (b + 1) * BATCH)
        ve = eager_bin(preds[sl], target[sl])
        before = tie_scan.tie_group_reduce.launches
        vc = compiled_bin(preds[sl], target[sl])
        if tie_scan.tie_group_reduce.launches != before + 1:
            raise AssertionError("binary step: AUROC's batch value did not launch the tie scan once")
        for k in ve:
            if not torch.equal(vc[k], ve[k]):
                raise AssertionError(f"binary step {b}: compiled {k} {vc[k].item()} != eager {ve[k].item()}")
    fallbacks = compiled_bin.eager_fallbacks
    if set(fallbacks) != {"AUROC"} or "does not opt into fused one-update forward" not in fallbacks["AUROC"]:
        raise AssertionError(f"binary step: eager fallbacks {fallbacks}; want AUROC alone, by its forward")
    before = tie_scan.tie_group_reduce.launches
    got = compiled_bin.compute()
    bin_launches = tie_scan.tie_group_reduce.launches - before
    want = eager_bin.compute()
    if bin_launches != 1 or any(not torch.equal(got[k], want[k]) for k in want):
        raise AssertionError(f"binary step: compute {got} vs eager {want}, {bin_launches} tie-scan launches")
    out["binary_step"] = {"eager_fallbacks": fallbacks, "compute_tie_scan_launches": bin_launches,
                          "forward_batch_ms_compiled": _host_ms(torch, lambda: compiled_bin(preds[:BATCH], target[:BATCH])),
                          "forward_batch_ms_eager": _host_ms(torch, lambda: eager_bin(preds[:BATCH], target[:BATCH]))}
    print(f"4h. binary step: Accuracy captured, {fallbacks}; values equal eager; one tie-scan launch per compute;"
          f" forward batch {out['binary_step']['forward_batch_ms_compiled']:.3f} ms compiled vs"
          f" {out['binary_step']['forward_batch_ms_eager']:.3f} ms eager")

    # e. a demotion on the card: StatScores() cannot infer the one-hot width
    # of label inputs inside a graph; Accuracy stays captured
    labels = [(t4[b * BATCH:(b + 1) * BATCH], t4[(b + 1) * BATCH:(b + 2) * BATCH].flip(0)) for b in range(3)]
    eager_dem = MetricCollection([Accuracy(), StatScores()])
    compiled_dem = MetricCollection([Accuracy(), StatScores()], compiled=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the engine's own fall-back warning
        for batch in labels:
            ve, vc = eager_dem(*batch), compiled_dem(*batch)
            for k in ve:
                if not torch.equal(vc[k], ve[k]):
                    raise AssertionError(f"demotion: compiled {k} {vc[k].tolist()} != eager {ve[k].tolist()}")
    torch.cuda.synchronize()  # no CUDA error was left behind
    reasons = compiled_dem.eager_fallbacks
    if set(reasons) != {"StatScores"} or "`num_classes` is required" not in reasons["StatScores"]:
        raise AssertionError(f"demotion: eager fallbacks {reasons}; want StatScores alone, by num_classes")
    step = compiled_dem(*labels[0])
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(v.float()).all()) for v in step.values()):
        raise AssertionError("demotion: the step after it is not finite")
    out["demotion"] = reasons
    print(f"4h. demotion: {reasons}; Accuracy captured, the card usable after it")

    # f. the wrapper and the extras
    boot_syncs = {}
    p1, t1 = cls_batches[0]
    plain = Accuracy()(p1, t1).item()
    for strategy in ("multinomial", "poisson"):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        boot = BootStrapper(Accuracy(), num_bootstraps=20, sampling_strategy=strategy, generator=gen, raw=True)
        boot.update(p1, t1)
        sampler = _syncs(torch, lambda: boot_module._bootstrap_sampler(BATCH, strategy, 20, gen, dev))
        update = _syncs(torch, lambda: boot.update(p1, t1))
        values = boot.compute()
        if len(sampler) != (0 if strategy == "multinomial" else 1):
            raise AssertionError(f"BootStrapper {strategy}: the sampler synchronized at {sampler}")
        if not abs(values["mean"].item() - plain) < 0.01 or values["raw"].shape != (20,):
            raise AssertionError(f"BootStrapper {strategy}: mean {values['mean'].item()} vs accuracy {plain}")
        boot_syncs[strategy] = {"sampler_syncs": len(sampler), "update_syncs": len(update),
                                "mean": values["mean"].item(), "std": values["std"].item()}
    rng = np.random.default_rng(SEED + 7)
    emb = torch.from_numpy(rng.standard_normal((512, 256)).astype(np.float32)).to(dev)
    flags = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    emb_err = 0.0
    try:
        for similarity in ("cosine", "dot"):
            for reduction in ("none", "sum", "mean"):
                got = embedding_similarity(emb, similarity, reduction).double()
                want = embedding_similarity(emb.double(), similarity, reduction)
                # relative to the output's largest entry: a TF32 product reads ~1e-3 off
                emb_err = max(emb_err, float((got - want).abs().max() / want.abs().max()))
        if torch.get_float32_matmul_precision() != "high" or torch.backends.cudnn.allow_tf32 is not True:
            raise AssertionError("embedding_similarity did not restore the caller's TF32 flags")
    finally:
        torch.set_float32_matmul_precision(flags[0])
        torch.backends.cudnn.allow_tf32 = flags[1]
    if not emb_err <= EMB_TOL:
        raise AssertionError(f"embedding_similarity under TF32 flags off float64 by {emb_err}")
    img_np = rng.standard_normal((FRAMES, 3, CITY_H, CITY_W), dtype=np.float32)
    dy, dx = image_gradients(torch.from_numpy(img_np).to(dev))
    want_dy = np.zeros_like(img_np)
    want_dy[..., :-1, :] = img_np[..., 1:, :] - img_np[..., :-1, :]
    want_dx = np.zeros_like(img_np)
    want_dx[..., :, :-1] = img_np[..., :, 1:] - img_np[..., :, :-1]
    if not (np.array_equal(dy.cpu().numpy(), want_dy) and np.array_equal(dx.cpu().numpy(), want_dx)):
        raise AssertionError("image_gradients differ from numpy's")
    frame = torch.from_numpy(img_np[:1]).to(dev)
    gradients_ms = _host_ms(torch, lambda: image_gradients(frame))
    translations = ["the cat is on the mat".split(), "there is a cat on the mat today".split()]
    references = [["there is a cat on the mat".split(), "a cat is on the mat".split()],
                  ["the cat is on the mat".split()]]
    bleu = {s: (bleu_score(translations, references, smooth=s).item(),
                bleu_score(translations, references, smooth=s, device="cpu").item()) for s in (False, True)}
    if any(a != b for a, b in bleu.values()):
        raise AssertionError(f"bleu_score on the card {bleu} differs from the CPU's")
    out["extras"] = {"bootstrapper_20": boot_syncs, "embedding_similarity_512x256_max_rel_err_tf32_on": emb_err,
                     "image_gradients_1x3x1024x2048_ms": gradients_ms, "bleu": bleu}
    print(f"4h. BootStrapper(Accuracy(), 20) host syncs {boot_syncs}; embedding_similarity (512, 256) under TF32"
          f" flags within {emb_err:.3g} of float64, flags restored; image_gradients at {FRAMES}x3x{CITY_H}x{CITY_W}"
          f" equal numpy; bleu_score on the card = CPU {bleu}")
    return out, {"forward_leg": (compiled_leg, cls_batches[1]), "regression_leg": (compiled_reg, reg_batches[1])}


def _cohort_replay_ops(torch, cohort):
    """(kernels, copies and fills) of one replay of the cohort's CUDA graph
    (its only program)."""
    (program,) = cohort._engine._compiled.values()
    return _device_ops(torch, program.graph.replay)


def _cohort_phase(torch, dev):
    """Phase 4i: the multi-tenant cohort (``MetricCohort``) on the card.
    Returns the phase's timings."""
    from metrics_tpu_torch import (
        AUROC,
        F1,
        PSNR,
        Accuracy,
        ExplainedVariance,
        MeanAbsoluteError,
        MeanSquaredError,
        MetricCohort,
        MetricCollection,
        Precision,
        R2Score,
        Recall,
    )
    from metrics_tpu_torch.cohort import route_rows

    def template(compiled=False):
        return MetricCollection([Accuracy(), Precision(num_classes=4, average="macro"),
                                 Recall(num_classes=4, average="macro"), F1(num_classes=4, average="macro")],
                                compiled=compiled)

    def regression(compiled=False):
        return MetricCollection([MeanSquaredError(), MeanAbsoluteError(), R2Score(), PSNR(), ExplainedVariance()],
                                compiled=compiled)

    def bench_rows(n, seed=SEED):
        """The JAX bench's rows (``bench.py:578-582``): probabilities over 4
        classes and labels, ``(n, 64, 4)`` and ``(n, 64)``."""
        rs = np.random.RandomState(seed)
        probs = rs.rand(n, COHORT_ROWS, 4).astype(np.float32)
        probs /= probs.sum(-1, keepdims=True)
        return torch.from_numpy(probs).to(dev), torch.from_numpy(rs.randint(4, size=(n, COHORT_ROWS))).to(dev)

    def grid_rows(n, seed):
        """Grid-valued rows (``tests/bases/test_cohort.py:46-66``): integer
        multinomials / 256 that sum to exactly 1, so every float sum is
        exact in any order."""
        rs = np.random.RandomState(seed)
        probs = (rs.multinomial(256, [0.25] * 4, size=(n, COHORT_ROWS)) / 256.0).astype(np.float32)
        return torch.from_numpy(probs).to(dev), torch.from_numpy(rs.randint(4, size=(n, COHORT_ROWS))).to(dev)

    out = {"sizes": {}}
    # a. the bench's sizes
    for n in COHORT_SIZES:
        cohort = MetricCohort(template(), tenants=n)
        p, t = bench_rows(n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        values = cohort(p, t)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        if any(v.shape != (n,) or not bool(torch.isfinite(v).all()) for v in values.values()):
            raise AssertionError(f"cohort of {n}: step values {[(k, tuple(v.shape)) for k, v in values.items()]}")
        sites = _syncs(torch, lambda: cohort(p, t))
        if sites:
            raise AssertionError(f"cohort of {n}: a replayed step synchronized the host at {sites}")
        kernels, copies = _cohort_replay_ops(torch, cohort)
        step_kernels, step_copies = _device_ops(torch, lambda: cohort(p, t))
        info = cohort.cache_info()
        if info["trace_count"] != 1 or info["eager_fallbacks"]:
            raise AssertionError(f"cohort of {n}: {info}")
        res = {
            "capacity": cohort.capacity,
            "step_ms": _host_ms(torch, lambda: cohort(p, t)),
            "replay_device_ms": _queued_ms(torch, lambda: cohort(p, t), launches=20),
            "kernels_per_replay": kernels,
            "copies_per_replay": copies,
            "kernels_per_step": step_kernels,
            "copies_per_step": step_copies,
            "first_step_ms": first_ms,
            "warm_up_and_capture_ms": info["graph_build_ms"][0],
            "graph_pool_bytes": info["graph_pool_bytes"],
            "syncs_per_replayed_step": len(sites),
        }
        out["sizes"][n] = res
        print(f"4i. cohort of {n} (capacity {cohort.capacity}): step {res['step_ms']:.3f} ms"
              f" ({res['replay_device_ms']:.3f} ms of device time), {kernels} kernels and {copies} copies a replay"
              f" ({step_kernels} and {step_copies} a step), first step {first_ms:.1f} ms (warm-up + capture"
              f" {res['warm_up_and_capture_ms']:.1f} ms), graph pool {res['graph_pool_bytes'] / 2**20:.1f} MiB,"
              " 0 syncs a replayed step")
        del cohort
    replay_kernels = {n: out["sizes"][n]["kernels_per_replay"] for n in COHORT_SIZES[1:]}
    if len(set(replay_kernels.values())) != 1:
        raise AssertionError(f"kernels per replay grow with the tenants: {replay_kernels}")

    # b. the displaced baseline: 64 compiled collections stepped one after another on the same rows
    p, t = bench_rows(COHORT_SEQ)
    cols = [template(compiled=True) for _ in range(COHORT_SEQ)]

    def seq_step():
        for i, col in enumerate(cols):
            col(p[i], t[i])

    seq_step()
    out["seq64_ms"] = _host_ms(torch, seq_step)
    out["speedup_64"] = out["seq64_ms"] / out["sizes"][COHORT_SEQ]["step_ms"]
    big, one = COHORT_SIZES[-1], COHORT_SIZES[0]
    out["sublinearity_10k"] = out["sizes"][big]["step_ms"] / (big * out["sizes"][one]["step_ms"])
    print(f"4i. {COHORT_SEQ} compiled collections one after another: {out['seq64_ms']:.3f} ms a step;"
          f" cohort speedup at {COHORT_SEQ} tenants {out['speedup_64']:.2f}x;"
          f" t_{big} / ({big} x t_{one}) = {out['sublinearity_10k']:.5f}")
    del cols

    # c. tenants equal to their collections run alone, through membership changes and a grow
    n = COHORT_CHECK
    rs = np.random.RandomState(SEED + 11)
    cohort = MetricCohort(template(), tenants=n, track_health=True)
    sampled = sorted(rs.choice(n, COHORT_SAMPLED - 1, replace=False).tolist())
    removed = sampled[0]
    alone = {s: template(compiled=True) for s in sampled}
    rows_seen = np.zeros(2 * n, np.int64)
    updates = np.zeros(2 * n, np.int64)

    def step(tenants, seed):
        p, t = grid_rows(tenants, seed)
        cohort(p, t)
        for s, col in alone.items():
            col(p[s], t[s])
        rows_seen[:tenants] += COHORT_ROWS
        updates[:tenants] += 1

    step(n, 1)
    cohort.remove_tenant(removed)
    if cohort.add_tenant() != removed:
        raise AssertionError("cohort: a freed slot was not reused")
    alone[removed] = template(compiled=True)
    rows_seen[removed] = updates[removed] = 0
    step(n, 2)
    grown = cohort.add_tenant()
    if grown != n or cohort.capacity != 2 * n:
        raise AssertionError(f"cohort: tenant {grown} at capacity {cohort.capacity}; want {n} at {2 * n}")
    alone[grown] = template(compiled=True)
    step(n + 1, 3)
    computed = cohort.compute()
    for s, col in alone.items():
        want = col.compute()
        for key, m in col.items():
            for sname in m._defaults:
                if not torch.equal(cohort._states[key][sname][s], getattr(m, sname)):
                    raise AssertionError(f"cohort tenant {s}: state {key}.{sname} differs from the collection's")
            if not torch.equal(computed[key][s], want[key]):
                raise AssertionError(f"cohort tenant {s}: {key} {computed[key][s].item()} vs {want[key].item()}")
    health = cohort.health()
    live = np.asarray(health["tenants"])
    if not (np.array_equal(health["rows_seen"], rows_seen[live]) and np.array_equal(health["updates"], updates[live])):
        raise AssertionError("cohort health: rows seen / updates differ from numpy's counts")
    out["tenants_equal_alone"] = {"sampled": len(alone), "tenants": len(cohort), "capacity": cohort.capacity,
                                  "builds": cohort.cache_info()["trace_count"]}
    print(f"4i. cohort of {n} -> {len(cohort)} tenants (capacity {cohort.capacity}), a slot freed and reused:"
          f" {len(alone)} sampled tenants' states and compute() bit-equal to compiled collections run alone;"
          " health rows / updates equal numpy's")
    del cohort, alone

    # d. the regression pack as a cohort
    cohort = MetricCohort(regression(), tenants=n)
    alone = {s: regression(compiled=True)
             for s in np.random.RandomState(SEED + 12).choice(n, COHORT_SAMPLED, replace=False).tolist()}
    worst_ulps = 0.0
    for seed in range(3):
        rs = np.random.RandomState(SEED + 20 + seed)
        p, t = (torch.from_numpy((rs.randint(0, 256, (n, COHORT_ROWS)) / 256.0).astype(np.float32)).to(dev)
                for _ in range(2))
        cohort(p, t)
        for s, col in alone.items():
            col(p[s], t[s])
    computed = cohort.compute()
    for s, col in alone.items():
        want = col.compute()
        for key, m in col.items():
            for sname in m._defaults:
                if not torch.equal(cohort._states[key][sname][s], getattr(m, sname)):
                    raise AssertionError(f"regression cohort tenant {s}: state {key}.{sname} differs")
            got, ref = np.float32(computed[key][s].item()), np.float32(want[key].item())
            ulps = abs(float(got) - float(ref)) / float(np.spacing(max(abs(got), abs(ref))))
            if not np.isfinite(got) or not ulps <= COHORT_ULPS:
                raise AssertionError(f"regression cohort tenant {s}: {key} {got} vs {ref}")
            worst_ulps = max(worst_ulps, ulps)
    out["regression_cohort_worst_ulps"] = worst_ulps
    print(f"4i. regression pack as a cohort of {n}: {len(alone)} sampled tenants' states bit-equal, values within"
          f" {worst_ulps:.2f} ulp of compiled collections run alone")
    del cohort, alone

    # e. route_rows of a shuffled tagged stream
    big = COHORT_SIZES[-1]
    rs = np.random.RandomState(SEED + 30)
    dense_p, dense_t = bench_rows(big, SEED + 31)
    ids = np.repeat(np.arange(big), COHORT_ROWS)[rs.permutation(big * COHORT_ROWS)]
    rank = np.empty_like(ids)
    rank[np.argsort(ids, kind="stable")] = np.arange(ids.size) % COHORT_ROWS  # each row's place in its tenant
    ids_t, rank_t = torch.from_numpy(ids).to(dev), torch.from_numpy(rank).to(dev)
    routed_p, routed_t = route_rows(ids_t, dense_p[ids_t, rank_t], dense_t[ids_t, rank_t], num_tenants=big)
    if not (torch.equal(routed_p, dense_p) and torch.equal(routed_t, dense_t)):
        raise AssertionError("route_rows: the routed stream differs from the dense layout")
    out["route_rows_ms"] = _host_ms(torch, lambda: route_rows(ids_t, dense_p[ids_t, rank_t], dense_t[ids_t, rank_t],
                                                              num_tenants=big))
    print(f"4i. route_rows of a shuffled {big} x {COHORT_ROWS} tagged stream equals the dense layout"
          f" ({out['route_rows_ms']:.3f} ms with its count check)")

    # f. an ineligible member
    try:
        MetricCohort(MetricCollection([AUROC(pos_label=1)]), tenants=2)
    except ValueError as err:
        if "engine-eligible" not in str(err) or "does not opt into fused one-update forward" not in str(err):
            raise
        out["auroc_refused"] = str(err)
    else:
        raise AssertionError("a cohort of AUROC was accepted")
    print(f"4i. a cohort of AUROC is refused: {out['auroc_refused']}")
    return out


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
    from metrics_tpu_torch.functional import ssim as functional_ssim
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

    # ---- 4e. the stat-score family ------------------------------------------
    zero_counts()
    t0 = time.perf_counter()
    stat_timings, stat_leg, city_collection, city_batch = _stat_score_phase(
        torch, dev, (mc_preds, mc_target, mc_scores_np, mc_target_np), (ml_scores_np, ml_target_np)
    )
    stat_timings["phase_s"] = time.perf_counter() - t0
    if any(counts().values()):
        raise AssertionError(f"the stat-score family launched a scan kernel: {counts()}")

    # ---- 4f. the regression pack and metric arithmetic ----------------------
    t0 = time.perf_counter()
    reg_timings, reg_profile, frames = _regression_phase(torch, dev, _forward_leg_inputs(torch, dev))
    reg_timings["phase_s"] = time.perf_counter() - t0
    if any(counts().values()):
        raise AssertionError(f"the regression pack launched a scan kernel: {counts()}")

    # ---- 4g. the retrieval family -----------------------------------------
    zero_counts()
    t0 = time.perf_counter()
    ret_timings, ms_collection = _retrieval_phase(torch, dev)
    ret_timings["phase_s"] = time.perf_counter() - t0
    ret_launches = counts()
    ret_timings["scan_launches"] = ret_launches
    if ret_launches["tie_scan"] < 1 or any(v for k, v in ret_launches.items() if k != "tie_scan"):
        raise AssertionError(f"phase 4g's scans: only the epoch's ShardedAUROC may launch one: {ret_launches}")

    # ---- 4h. the step engine, the shared count, the wrapper and extras ------
    t0 = time.perf_counter()
    engine_timings, engine_profile = _engine_phase(torch, dev, (preds, target))
    engine_timings["phase_s"] = time.perf_counter() - t0

    # ---- 4i. the multi-tenant cohort --------------------------------------
    zero_counts()
    t0 = time.perf_counter()
    cohort_timings = _cohort_phase(torch, dev)
    cohort_timings["phase_s"] = time.perf_counter() - t0
    if any(counts().values()):
        raise AssertionError(f"the cohort launched a scan kernel: {counts()}")

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
        "stat_score_family": stat_timings,
        "regression_pack": reg_timings,
        "retrieval": ret_timings,
        "step_engine": engine_timings,
        "cohort": cohort_timings,
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
    # one forward batch of the JAX bench's forward leg (Accuracy + macro Precision/Recall/F1 at 100k)
    leg, leg_batch = stat_leg
    leg(*leg_batch)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof_leg:
        t = time.perf_counter()
        leg(*leg_batch)
        torch.cuda.synchronize()
        leg_window_ms = (time.perf_counter() - t) * 1e3
    leg_split = _device_ms_by_kernel(torch, prof_leg, sort_key)
    print(prof_leg.key_averages().table(sort_by=sort_key, row_limit=15, max_name_column_width=48))
    print(prof_leg.key_averages().table(sort_by="self_cpu_time_total", row_limit=15, max_name_column_width=48))
    # one Cityscapes update of the stat-score collection (4 images, 19 classes)
    city = city_collection()
    city.update(*city_batch)
    city = city_collection()
    torch.cuda.synchronize()
    with profile(activities=activities) as prof_city:
        t = time.perf_counter()
        city.update(*city_batch)
        torch.cuda.synchronize()
        city_window_ms = (time.perf_counter() - t) * 1e3
    city_split = _device_ms_by_kernel(torch, prof_city, sort_key)
    print(prof_city.key_averages().table(sort_by=sort_key, row_limit=15, max_name_column_width=48))
    # one forward batch of the JAX bench's regression leg (5 metrics at 100k), and one ssim at 4 x 3 x 1024 x 2048
    reg_coll, reg_batch = reg_profile
    windows = {}
    for label, call in (("regression_forward_batch", lambda: reg_coll(*reg_batch)),
                        ("ssim_4x3x1024x2048", lambda: functional_ssim(*frames, data_range=1.0))):
        call()
        torch.cuda.synchronize()
        with profile(activities=activities) as prof_window:
            t = time.perf_counter()
            call()
            torch.cuda.synchronize()
            window = (time.perf_counter() - t) * 1e3
        split = _device_ms_by_kernel(torch, prof_window, sort_key)
        print(prof_window.key_averages().table(sort_by=sort_key, row_limit=12, max_name_column_width=48))
        windows[label] = {"window_ms": window, "device_ms": sum(split.values()),
                          "device_busy_share": sum(split.values()) / window,
                          "device_ms_by_kernel": dict(sorted(split.items(), key=lambda kv: -kv[1])[:12])}
    # one compiled forward batch of phase 4h's forward leg and regression leg: one graph replay each
    for label, (coll, batch) in engine_profile.items():
        coll(*batch)
        torch.cuda.synchronize()
        with profile(activities=activities) as prof_window:
            t = time.perf_counter()
            coll(*batch)
            torch.cuda.synchronize()
            window = (time.perf_counter() - t) * 1e3
        split = _device_ms_by_kernel(torch, prof_window, sort_key)
        print(prof_window.key_averages().table(sort_by=sort_key, row_limit=12, max_name_column_width=48))
        print(prof_window.key_averages().table(sort_by="self_cpu_time_total", row_limit=8, max_name_column_width=48))
        windows[f"compiled_{label}_batch"] = {
            "window_ms": window, "device_ms": sum(split.values()), "device_busy_share": sum(split.values()) / window,
            "device_ms_by_kernel": dict(sorted(split.items(), key=lambda kv: -kv[1])[:12])}
    # one compute of the MS MARCO collection (MAP, MRR, P@10, R@100 over 6,980,000 rows)
    for metric in ms_collection.values():
        metric._computed = None
    torch.cuda.synchronize()
    with profile(activities=activities) as prof_ret:
        t = time.perf_counter()
        ms_collection.compute()
        torch.cuda.synchronize()
        ret_window_ms = (time.perf_counter() - t) * 1e3
    ret_split = _device_ms_by_kernel(torch, prof_ret, sort_key)
    ret_sort_ms = sum(v for k, v in ret_split.items() if "sort" in k.lower())
    print(prof_ret.key_averages().table(sort_by=sort_key, row_limit=15, max_name_column_width=48))
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
        "forward_leg_batch_window_ms": leg_window_ms,
        "forward_leg_batch_device_ms": sum(leg_split.values()),
        "forward_leg_batch_device_ms_by_kernel": dict(sorted(leg_split.items(), key=lambda kv: -kv[1])[:12]),
        "cityscapes_update_window_ms": city_window_ms,
        "cityscapes_update_device_ms": sum(city_split.values()),
        "cityscapes_update_device_ms_by_kernel": dict(sorted(city_split.items(), key=lambda kv: -kv[1])[:12]),
        "regression_forward_batch": windows["regression_forward_batch"],
        "msmarco_compute_window_ms": ret_window_ms,
        "msmarco_compute_device_ms": sum(ret_split.values()),
        "msmarco_compute_device_busy_share": sum(ret_split.values()) / ret_window_ms,
        "msmarco_compute_sort_share": ret_sort_ms / max(sum(ret_split.values()), 1e-12),
        "msmarco_compute_device_ms_by_kernel": dict(sorted(ret_split.items(), key=lambda kv: -kv[1])[:12]),
        "ssim_4x3x1024x2048": windows["ssim_4x3x1024x2048"],
        "compiled_forward_leg_batch": windows["compiled_forward_leg_batch"],
        "compiled_regression_leg_batch": windows["compiled_regression_leg_batch"],
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
