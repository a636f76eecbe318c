"""Tests of the port that need a CUDA device: the tie-scan kernel (one stream
and class-batched, unweighted and weighted) against its plain PyTorch
version, and the GPU entry points (the exact scores, the weighted and
``micro`` routes with their launches, the curves and the binned curves)
against their CPU runs; the stat-score family's label-space counts against
the canonical path, ``label_bincount`` against ``torch.bincount``, the
synchronizations of an update at 19 and 1,000 classes, and counts past
2^24; the regression pack's SSIM at full float32 under global TF32 flags,
its collection update without host synchronizations, and its shared pass
equal to the unshared one; the retrieval family against its CPU run
(counts exact, means within 1e-6), the same bits over two computes, the
sharded metrics at world 1 equal to the unsharded ones, both sort forms
one permutation, and the host synchronizations of a compute independent
of the number of queries; the step engine's CUDA graphs (replays equal to
the eager collection, no synchronization in a replayed step, a demotion
that leaves the card usable, values that outlive the next step, reset and
restore between steps, the binary step with AUROC kept eager, host inputs
and the LRU's evictions); the multi-tenant cohort's graphs (one per
capacity bucket, tenants equal to their collections run alone, kernels per
replay equal at 64 and 4,096 tenants, no synchronization in a replayed
step, a ``compute()`` result that outlives later steps and ``reset()``, a
build failure that raises and demotes nothing); and the observability core on
the card (no synchronization and the same kernels per replay with every
recorder on, values bit-equal on and off, the engine counters equal to the
signature arithmetic, one watchdog verdict and one flight dump on a
shape-polymorphic loop, kernels attributed to the metric and engine
profiler ranges); and the sync tiers' codec on the card (int8 codes, scales,
bf16 payloads, residuals and the rank-order merge bit-equal to its CPU run,
no host synchronization in the codec, the quantized and hierarchical syncs
of a metric and a cohort under ``simulated_pods`` equal to their CPU runs);
and the reliability layer on the card (an exact sync of int32 states
keeping int32, flat and two-level; a guarded compiled step reading the host
once per replay, rolling a poisoned batch back bit for bit, and the
unguarded graph kept as it was); and serving on the card (the asynchronous
pipeline bit-equal to the blocking path on a compiled collection and a
1,024-tenant cohort, the caller's stream ordered after the worker's by
``drain()`` alone, inputs freed right after ``forward()`` not corrupted,
host reads on the serve loop that never raise, and the background writer's
envelope equal to the synchronous one); and the export surface on the card
(a forward that returns while a ``/metrics`` scrape waits on a cohort's
health event, and a reader racing a live pipeline that only ever sees whole
steps); and the elastic fleet on the card (a partial wave of 1, 3, half and
all but one of 5,000 tenants bit-equal to the full-shard dispatch; leased
shards that replicate, migrate and fail over with every state on the card
after adoption, promotion and ``restore()``; tenant envelope bytes through
``stream`` as a CUDA ``uint8`` tensor; a handoff from a served shard
while the serving worker's step is still queued, carrying the drained
state); and the fleet-protocol explorers with every shard's cohort on the
card (coverage equal to the CPU run's and the committed baseline's, the
fleet fixtures tripping exactly their rules with the CPU's minimal
counterexample); and the program audit's pass 4 on the card (80 seam budgets
equal to ``SEAM_BASELINE.json``'s, every engine-eligible family proven
double-buffer safe as on the CPU, the two-generation traces allocating
nothing and holding no hazard, and the traced verdict borne out by
``first_dispatch_hazards`` after a real CUDA-graph build and replay). Counts read off a ``torch.profiler`` trace read a trace
that a second trace of the same call agrees with (``_steady_profile``).

Every test here is marked ``cuda`` and skips without a card. This file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest`` because the suite's conftest pins JAX to the CPU).
"""
import contextlib
import gc
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from metrics_tpu_torch import (
    AUROC,
    F1,
    PSNR,
    ROC,
    SSIM,
    Accuracy,
    AveragePrecision,
    BinnedAUROC,
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    ConfusionMatrix,
    ExplainedVariance,
    MeanAbsoluteError,
    MeanSquaredError,
    MetricCohort,
    MetricCollection,
    Precision,
    PrecisionRecallCurve,
    R2Score,
    Recall,
    RetrievalMAP,
    RetrievalMRR,
    RetrievalPrecision,
    RetrievalRecall,
    ShardedRetrievalMAP,
    ShardedRetrievalMRR,
    ShardedRetrievalPrecision,
    ShardedRetrievalRecall,
    StatScores,
)
from metrics_tpu_torch.engine import CompiledStepEngine
from metrics_tpu_torch.functional import auroc, average_precision, precision_recall_curve, roc, ssim
from metrics_tpu_torch.ops import segment
from metrics_tpu_torch.functional.classification.stat_scores import _stat_scores_count, _stat_scores_fast_update
from metrics_tpu_torch.ops.auroc_kernel import (
    _co_sort,
    _co_sort_rows,
    _payload,
    _sortable_key,
    binary_auroc,
    binary_average_precision,
    masked_binary_auroc,
    masked_binary_average_precision,
    masked_weighted_binary_auroc,
    masked_weighted_binary_average_precision,
)
from metrics_tpu_torch.ops.tie_scan import (
    auroc_ap_from_stats,
    tie_group_reduce,
    tie_group_reduce_reference,
    tie_group_reduce_rows,
    tie_group_reduce_rows_reference,
)
from metrics_tpu_torch.ops.histogram import label_bincount
from metrics_tpu_torch.parallel.sample_sort import _tie_stats_w
from metrics_tpu_torch.utilities.checks import _input_format_classification

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tie-scan kernel has no CPU mode")
    return torch.device("cuda")


def _stream(n, seed, device, masked=False):
    rng = np.random.default_rng(seed)
    preds = torch.from_numpy(np.round(rng.random(n), 2).astype(np.float32)).to(device)
    rel = torch.from_numpy(rng.integers(0, 2, n).astype(np.float32)).to(device)
    w = torch.from_numpy((rng.random(n) < 0.8).astype(np.float32)).to(device) if masked else None
    return preds, rel, w


@pytest.mark.parametrize("n", [1, 7, 4095, 4096, 4097, 32769, 1_000_003])
def test_kernel_matches_plain_version(cuda_device, n):
    preds, rel, w = _stream(n, n, cuda_device, masked=True)
    key_s, pay_s = _co_sort(preds, rel, w)
    before = tie_group_reduce.launches
    got = tie_group_reduce(key_s, pay_s, offsets=(3.0, 4.0))
    assert tie_group_reduce.launches == before + 1
    want = tie_group_reduce_reference(key_s, pay_s, offsets=(3.0, 4.0))
    torch.cuda.synchronize()
    assert torch.equal(got[2:], want[2:])  # counts are exact
    # the same f32 terms summed in f64 in another order
    torch.testing.assert_close(got[:2], want[:2], rtol=1e-6, atol=0.0)


def test_kernel_is_deterministic(cuda_device):
    preds, rel, _ = _stream(2_000_000, 1, cuda_device)
    key_s, pay_s = _co_sort(preds, rel)
    first = tie_group_reduce(key_s, pay_s)
    for _ in range(3):
        assert torch.equal(tie_group_reduce(key_s, pay_s), first)


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    key = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        tie_group_reduce(key, torch.zeros(8, dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError):
        tie_group_reduce(key, torch.zeros(8))  # payload on the CPU
    with pytest.raises(ValueError):
        tie_group_reduce(key[::2], torch.zeros(4, device=cuda_device))  # not contiguous


@pytest.mark.parametrize(
    "fn, masked",
    [(binary_auroc, False), (binary_average_precision, False),
     (masked_binary_auroc, True), (masked_binary_average_precision, True)],
)
def test_gpu_scores_match_the_cpu_path(cuda_device, fn, masked):
    preds, rel, w = _stream(300_000, 7, cuda_device, masked=masked)
    target = rel.to(torch.int64)
    args = (preds, target) if not masked else (preds, target, w.bool())
    gpu = fn(*args)
    cpu = fn(*(a.cpu() for a in args))
    assert gpu.device.type == "cuda"
    assert abs(float(gpu) - float(cpu)) < 1e-5


def test_metrics_default_to_the_card(cuda_device):
    rng = np.random.default_rng(11)
    preds = torch.from_numpy(rng.random(50_000, dtype=np.float32))
    target = torch.from_numpy((rng.random(50_000) < preds.numpy()).astype(np.int64))
    on_card = MetricCollection([Accuracy(), AUROC(pos_label=1)])
    on_cpu = MetricCollection([Accuracy(device="cpu"), AUROC(pos_label=1, device="cpu")])
    for chunk in range(5):
        sl = slice(chunk * 10_000, (chunk + 1) * 10_000)
        on_card(preds[sl], target[sl])  # CPU inputs move to the metric's device
        on_cpu(preds[sl], target[sl])
    got, want = on_card.compute(), on_cpu.compute()
    assert on_card["Accuracy"].correct.device.type == "cuda"
    assert all(t.device.type == "cuda" for t in on_card["AUROC"].preds)
    assert float(got["Accuracy"]) == float(want["Accuracy"])
    assert abs(float(got["AUROC"]) - float(want["AUROC"])) < 1e-5


def _rows(rows, n, seed, device):
    """Co-sorted (rows, n) streams: tie-heavy and tie-free rows alternate;
    row 0 is one tie group and row 1 has no positive, where present."""
    rng = np.random.default_rng(seed)
    scores = rng.random((rows, n), dtype=np.float32)
    scores[::2] = np.round(scores[::2], 2)
    rel = rng.random((rows, n)) < 0.3
    if rows >= 2:
        scores[0] = 0.5
        rel[1] = False
    keys = _sortable_key(torch.from_numpy(scores).to(device))
    return _co_sort_rows(keys, _payload(torch.from_numpy(rel.astype(np.float32)).to(device), None))


# (rows, n): one row, tile edges, the ImageNet-1k val shape, and more rows
# than a grid's y dimension (65535) holds
ROW_SHAPES = [(1, 1), (2, 4096), (5, 4097), (3, 33000), (1000, 50000), (70_000, 2), (65_535, 5)]


@pytest.mark.parametrize("rows, n", ROW_SHAPES)
def test_batched_kernel_matches_plain_version(cuda_device, rows, n):
    key_s, pay_s = _rows(rows, n, rows + n, cuda_device)
    before = tie_group_reduce_rows.launches
    got = tie_group_reduce_rows(key_s, pay_s, offsets=(3.0, 4.0))
    assert tie_group_reduce_rows.launches == before + 1
    want = tie_group_reduce_rows_reference(key_s, pay_s, offsets=(3.0, 4.0))
    torch.cuda.synchronize()
    assert got.shape == (rows, 4)
    assert torch.equal(got[:, 2:], want[:, 2:])  # counts are exact
    torch.testing.assert_close(got[:, :2], want[:, :2], rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("rows, n", [(7, 32769), (70_000, 2)])
def test_batched_kernel_rows_equal_one_stream_launches(cuda_device, rows, n):
    key_s, pay_s = _rows(rows, n, 3, cuda_device)
    got = tie_group_reduce_rows(key_s, pay_s)
    picked = list(range(min(rows, 7))) + [65_534, 65_535, rows - 1] if rows > 65_535 else range(rows)
    for r in picked:
        # each row runs the same code on the same tiles in the same order
        assert torch.equal(got[r], tie_group_reduce(key_s[r], pay_s[r])), r


def test_batched_kernel_is_deterministic(cuda_device):
    key_s, pay_s = _rows(300, 40_000, 1, cuda_device)
    first = tie_group_reduce_rows(key_s, pay_s)
    for _ in range(3):
        assert torch.equal(tie_group_reduce_rows(key_s, pay_s), first)


def test_kernel_is_bit_stable_over_launches(cuda_device):
    # 20M elements are about 4,900 tiles, many more than the blocks resident
    # at once, so each tile's look-back window differs from launch to launch;
    # alternate repeats start behind a device sleep or run on a second stream
    # beside the first, which shifts the schedule further
    preds, rel, mask = _stream(20_000_000, 2, cuda_device, masked=True)
    key_s, pay_s = _co_sort(preds, rel, mask)
    first = tie_group_reduce(key_s, pay_s)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    repeats = []
    for i in range(20):
        if i % 2:
            with torch.cuda.stream(side):
                repeats.append(tie_group_reduce(key_s, pay_s))
        else:
            torch.cuda._sleep(1_000_000)
            repeats.append(tie_group_reduce(key_s, pay_s))
    torch.cuda.synchronize()
    for i, got in enumerate(repeats):
        assert torch.equal(got, first), i


def test_back_to_back_launches_reuse_their_scratch(cuda_device):
    # queued with no synchronize between them, the launches take the
    # scratch the previous one freed, which each must fill again
    preds, rel, _ = _stream(3_000_000, 9, cuda_device)
    key_s, pay_s = _co_sort(preds, rel)
    rows = _rows(300, 5_000, 9, cuda_device)
    want_one = tie_group_reduce(key_s, pay_s)
    want_rows = tie_group_reduce_rows(*rows)
    torch.cuda.synchronize()
    torch.cuda._sleep(10_000_000)
    got = [(tie_group_reduce(key_s, pay_s), tie_group_reduce_rows(*rows)) for _ in range(10)]
    torch.cuda.synchronize()
    for one, batch in got:
        assert torch.equal(one, want_one) and torch.equal(batch, want_rows)


@pytest.mark.parametrize("rows, n", [(1000, 50_000), (131_073, 3)])
def test_batched_rows_equal_one_stream_launches_at_path_shapes(cuda_device, rows, n):
    # the multi-class path's shape, and more rows than a grid's y dimension holds
    key_s, pay_s = _rows(rows, n, 5, cuda_device)
    got = tie_group_reduce_rows(key_s, pay_s)
    picked = list(range(rows)) if rows <= 1000 else list(range(7)) + [65_534, 65_535, rows - 1]
    singles = torch.stack([tie_group_reduce(key_s[r], pay_s[r]) for r in picked])
    assert torch.equal(got[picked], singles)


def test_kernel_takes_empty_and_misaligned_streams(cuda_device):
    # n = 0 gives zeros; a bucket slice at an odd offset starts off a
    # 16-byte boundary, so the tile's copies realign it
    empty = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    assert torch.equal(tie_group_reduce(empty, torch.zeros(0, device=cuda_device)),
                       torch.zeros(4, device=cuda_device))
    assert torch.equal(tie_group_reduce_rows(empty.reshape(3, 0), torch.zeros(3, 0, device=cuda_device)),
                       torch.zeros(3, 4, device=cuda_device))
    preds, rel, mask = _stream(100_003, 13, cuda_device, masked=True)
    key_s, pay_s = _co_sort(preds, rel, mask)
    for lo, hi in [(1, 4098), (3, 100_003), (4_097, 60_001), (50_001, 50_002)]:
        got = tie_group_reduce(key_s[lo:hi], pay_s[lo:hi], offsets=(5.0, 6.0))
        want = tie_group_reduce_reference(key_s[lo:hi], pay_s[lo:hi], offsets=(5.0, 6.0))
        torch.cuda.synchronize()
        assert torch.equal(got[2:], want[2:]), (lo, hi)
        torch.testing.assert_close(got[:2], want[:2], rtol=1e-6, atol=0.0)


def test_batched_kernel_rejects_what_it_does_not_take(cuda_device):
    key = torch.zeros(2, 8, dtype=torch.int32, device=cuda_device)
    pay = torch.zeros(2, 8, device=cuda_device)
    with pytest.raises(TypeError):
        tie_group_reduce_rows(key.float(), pay)
    with pytest.raises(TypeError):
        tie_group_reduce_rows(key, pay.double())
    with pytest.raises(ValueError):
        tie_group_reduce_rows(key, pay.cpu())  # payload on the CPU
    with pytest.raises(ValueError):
        tie_group_reduce_rows(key[0], pay[0])  # one stream: tie_group_reduce takes it
    with pytest.raises(ValueError):
        tie_group_reduce_rows(key, pay[:, :4])  # shapes differ
    with pytest.raises(ValueError):
        tie_group_reduce_rows(key.T, pay.T)  # not contiguous
    assert tie_group_reduce_rows(key[:0], pay[:0]).shape == (0, 4)


def _multiclass(n, c, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, c)).astype(np.float32)
    target = rng.integers(0, c, n)
    logits[np.arange(n), target] += 2.0
    e = np.exp(logits - logits.max(1, keepdims=True))
    return torch.from_numpy(e / e.sum(1, keepdims=True)), torch.from_numpy(target)


def test_gpu_multiclass_scores_match_the_cpu_path(cuda_device):
    preds, target = _multiclass(20_000, 37, 5)
    target[target == 3] = 4  # class 3 is absent: NaN on both paths
    for fn, kwargs in ((auroc, {"average": None}), (auroc, {"average": "weighted"}), (average_precision, {})):
        gpu = fn(preds.to(cuda_device), target.to(cuda_device), num_classes=37, **kwargs)
        cpu = fn(preds, target, num_classes=37, **kwargs)
        gpu = torch.stack(gpu).cpu() if isinstance(gpu, list) else gpu.cpu()
        cpu = torch.stack(cpu) if isinstance(cpu, list) else cpu
        torch.testing.assert_close(gpu, cpu, rtol=0.0, atol=1e-5, equal_nan=True)


def test_gpu_multilabel_auroc_matches_the_cpu_path(cuda_device):
    rng = np.random.default_rng(6)
    target = torch.from_numpy((rng.random((30_000, 12)) < 0.2).astype(np.int64))
    preds = torch.from_numpy(np.round(0.8 * rng.random((30_000, 12)), 3).astype(np.float32)) + 0.2 * target
    gpu = torch.stack(auroc(preds.to(cuda_device), target.to(cuda_device), num_classes=12, average=None))
    cpu = torch.stack(auroc(preds, target, num_classes=12, average=None))
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=0.0, atol=1e-5)


def test_multiclass_compute_launches_the_batched_kernel_once(cuda_device):
    preds, target = _multiclass(10_000, 50, 7)
    on_card = MetricCollection([AUROC(num_classes=50), AveragePrecision(num_classes=50)])
    on_cpu = MetricCollection([AUROC(num_classes=50, device="cpu"), AveragePrecision(num_classes=50, device="cpu")])
    for chunk in range(4):
        sl = slice(chunk * 2_500, (chunk + 1) * 2_500)
        on_card.update(preds[sl], target[sl])
        on_cpu.update(preds[sl], target[sl])
    before = tie_group_reduce_rows.launches
    got, want = on_card.compute(), on_cpu.compute()
    assert tie_group_reduce_rows.launches == before + 2  # one per metric, not one per class
    assert abs(float(got["AUROC"]) - float(want["AUROC"])) < 1e-5
    torch.testing.assert_close(torch.stack(got["AveragePrecision"]).cpu(), torch.stack(want["AveragePrecision"]),
                               rtol=0.0, atol=1e-5)


# ---- the weighted entries (tie_scan_w, tie_scan_rows_w) ----------------------


def _weighted_stream(n, seed, device):
    """Co-sorted tie-heavy stream with lognormal weights and 20% masked."""
    preds, rel, mask = _stream(n, seed, device, masked=True)
    rng = np.random.default_rng(seed + 1)
    w = torch.from_numpy(rng.lognormal(size=n).astype(np.float32)).to(device)
    return _co_sort(preds, rel, mask, torch.where(mask.bool(), w, 0.0))


def _assert_weighted_close(got, want):
    # the same f64 sums in other orders, each cast to f32 once
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("n", [1, 7, 4095, 4096, 4097, 32769, 1_000_003])
def test_weighted_kernel_matches_plain_version(cuda_device, n):
    key_s, pay_s, w_s = _weighted_stream(n, n, cuda_device)
    before = tie_group_reduce.weighted_launches
    got = tie_group_reduce(key_s, pay_s, offsets=(3.5, 4.25), weights_s=w_s)
    assert tie_group_reduce.weighted_launches == before + 1
    want = tie_group_reduce_reference(key_s, pay_s, offsets=(3.5, 4.25), weights_s=w_s)
    torch.cuda.synchronize()
    _assert_weighted_close(got, want)


def test_weighted_kernel_hazards(cuda_device):
    n = 300_000
    preds, rel, _ = _stream(n, 21, cuda_device)
    rng = np.random.default_rng(21)
    keep = torch.from_numpy(rng.random(n) < 0.6).to(cuda_device)
    # zero weights are inert: the stream with weight-0 elements equals the
    # unweighted masked stream of the kept ones
    key_s, pay_s, w_s = _co_sort(preds, rel, None, keep.float())
    key_m, pay_m = _co_sort(preds, rel, keep.float())
    torch.testing.assert_close(tie_group_reduce(key_s, pay_s, weights_s=w_s), tie_group_reduce(key_m, pay_m),
                               rtol=1e-6, atol=0.0)
    # unit weights give the unweighted result; integer weights give exact totals
    key_s, pay_s, w_s = _co_sort(preds, rel, None, torch.ones(n, device=cuda_device))
    unit, plain = tie_group_reduce(key_s, pay_s, weights_s=w_s), tie_group_reduce(key_s, pay_s)
    torch.testing.assert_close(unit, plain, rtol=1e-6, atol=0.0)
    assert torch.equal(unit[2:], plain[2:])
    # a NaN weight on a masked element is never read
    nan_w = torch.where(keep, 1.0, float("nan"))
    key_s, pay_s, w_s = _co_sort(preds, rel, keep.float(), nan_w)
    assert bool(torch.isfinite(tie_group_reduce(key_s, pay_s, weights_s=w_s)).all())
    # tiny totals are not degenerate, and they normalize to the unit-weight
    # scores: at 1e-22 per element the product of the class totals (~1e-34)
    # lies below any floor of 1e-30
    auroc_one, ap_one = auroc_ap_from_stats(plain)
    for tiny_weight in (1e-20, 1e-22):
        key_s, pay_s, w_s = _co_sort(preds, rel, None, torch.full((n,), tiny_weight, device=cuda_device))
        tiny = tie_group_reduce(key_s, pay_s, weights_s=w_s)
        assert float(tiny[2]) * float(tiny[3]) < 1e-30 or tiny_weight == 1e-20
        auroc_tiny, ap_tiny = auroc_ap_from_stats(tiny)
        assert abs(float(auroc_tiny) - float(auroc_one)) < 1e-5 and abs(float(ap_tiny) - float(ap_one)) < 1e-5


def test_weighted_kernel_is_deterministic(cuda_device):
    # 20M elements are about 4,900 tiles, many more than the blocks resident
    # at once, so each tile's look-back window differs from launch to launch;
    # alternate repeats start behind a device sleep or run on a second stream
    # beside the first, which shifts the schedule further
    key_s, pay_s, w_s = _weighted_stream(20_000_000, 2, cuda_device)
    first = tie_group_reduce(key_s, pay_s, weights_s=w_s)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    repeats = []
    for i in range(20):
        if i % 2:
            with torch.cuda.stream(side):
                repeats.append(tie_group_reduce(key_s, pay_s, weights_s=w_s))
        else:
            torch.cuda._sleep(1_000_000)
            repeats.append(tie_group_reduce(key_s, pay_s, weights_s=w_s))
    torch.cuda.synchronize()
    for i, got in enumerate(repeats):
        assert torch.equal(got, first), i


def _weighted_rows(rows, n, seed, device):
    key_s, pay_s = _rows(rows, n, seed, device)
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.lognormal(size=(rows, n)).astype(np.float32)).to(device)
    return key_s, pay_s, w


@pytest.mark.parametrize("rows, n", ROW_SHAPES)
def test_weighted_batched_kernel_matches_plain_version(cuda_device, rows, n):
    key_s, pay_s, w_s = _weighted_rows(rows, n, rows + n, cuda_device)
    before = tie_group_reduce_rows.weighted_launches
    got = tie_group_reduce_rows(key_s, pay_s, offsets=(3.0, 4.0), weights_s=w_s)
    assert tie_group_reduce_rows.weighted_launches == before + 1
    want = tie_group_reduce_rows_reference(key_s, pay_s, offsets=(3.0, 4.0), weights_s=w_s)
    torch.cuda.synchronize()
    assert got.shape == (rows, 4)
    _assert_weighted_close(got, want)


@pytest.mark.parametrize("rows, n", [(7, 32769), (70_000, 2)])
def test_weighted_batched_rows_equal_one_stream_launches(cuda_device, rows, n):
    key_s, pay_s, w_s = _weighted_rows(rows, n, 4, cuda_device)
    got = tie_group_reduce_rows(key_s, pay_s, weights_s=w_s)
    picked = list(range(min(rows, 7))) + [65_534, 65_535, rows - 1] if rows > 65_535 else range(rows)
    for r in picked:
        assert torch.equal(got[r], tie_group_reduce(key_s[r], pay_s[r], weights_s=w_s[r])), r


@pytest.mark.parametrize("rows, n", [(1000, 50_000), (131_073, 3)])
def test_weighted_batched_rows_equal_one_stream_launches_at_path_shapes(cuda_device, rows, n):
    # the one-vs-rest path's shape, and more rows than a grid's y dimension holds
    key_s, pay_s, w_s = _weighted_rows(rows, n, 5, cuda_device)
    got = tie_group_reduce_rows(key_s, pay_s, weights_s=w_s)
    picked = list(range(rows)) if rows <= 1000 else list(range(7)) + [65_534, 65_535, rows - 1]
    singles = torch.stack([tie_group_reduce(key_s[r], pay_s[r], weights_s=w_s[r]) for r in picked])
    assert torch.equal(got[picked], singles)


def test_weighted_back_to_back_launches_reuse_their_scratch(cuda_device):
    # queued with no synchronize between them, the launches take the
    # scratch the previous one freed, whose counters must be zeroed again
    key_s, pay_s, w_s = _weighted_stream(3_000_000, 9, cuda_device)
    rows = _weighted_rows(300, 5_000, 9, cuda_device)
    want_one = tie_group_reduce(key_s, pay_s, weights_s=w_s)
    want_rows = tie_group_reduce_rows(*rows[:2], weights_s=rows[2])
    torch.cuda.synchronize()
    torch.cuda._sleep(10_000_000)
    got = [(tie_group_reduce(key_s, pay_s, weights_s=w_s), tie_group_reduce_rows(*rows[:2], weights_s=rows[2]))
           for _ in range(10)]
    torch.cuda.synchronize()
    for one, batch in got:
        assert torch.equal(one, want_one) and torch.equal(batch, want_rows)


def test_weighted_offset_form_matches_plain_version(cuda_device):
    # the sample sort's bucket epilogue: buckets start mid-row (misaligned
    # for the copies) and carry the lower buckets' weighted class totals
    key_s, pay_s, w_s = _weighted_stream(1_000_003, 12, cuda_device)
    bounds = [0, 250_001, 500_002, 777_777, 1_000_003]
    off_p = off_n = 0.0
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        part = [x[lo:hi] for x in (key_s, pay_s, w_s)]
        before = tie_group_reduce.offset_launches
        got = torch.stack(_tie_stats_w(*part, off_p, off_n))
        assert tie_group_reduce.offset_launches == before + 1
        plain = tie_group_reduce_reference(*part[:2], (off_p, off_n), part[2]).double()
        plain[0] += off_p * plain[3]  # the area's offset term, as _tie_stats_w adds it
        torch.testing.assert_close(got, plain, rtol=1e-6, atol=0.0)
        off_p, off_n = off_p + float(got[2]), off_n + float(got[3])


def test_weighted_kernel_rejects_what_it_does_not_take(cuda_device):
    key = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    pay = torch.zeros(8, device=cuda_device)
    with pytest.raises(TypeError):
        tie_group_reduce(key, pay, weights_s=torch.ones(8, dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError):
        tie_group_reduce(key, pay, weights_s=torch.ones(8))  # weights on the CPU
    with pytest.raises(ValueError):
        tie_group_reduce(key, pay, weights_s=torch.ones(7, device=cuda_device))
    with pytest.raises(ValueError):
        tie_group_reduce_rows(key.reshape(2, 4), pay.reshape(2, 4), weights_s=torch.ones(4, 2, device=cuda_device).T)


@pytest.mark.parametrize("fn", [masked_weighted_binary_auroc, masked_weighted_binary_average_precision])
def test_gpu_weighted_scores_match_the_cpu_path(cuda_device, fn):
    preds, rel, mask = _stream(300_000, 8, cuda_device, masked=True)
    w = torch.from_numpy(np.random.default_rng(8).lognormal(size=300_000).astype(np.float32)).to(cuda_device)
    args = (preds, rel.to(torch.int64), mask.bool(), w)
    gpu = fn(*args)
    cpu = fn(*(a.cpu() for a in args))
    assert gpu.device.type == "cuda"
    assert abs(float(gpu) - float(cpu)) < 1e-6


# ---- the curve family: weighted and micro routes, curves, binned curves ------


def _launches():
    return (tie_group_reduce.launches, tie_group_reduce.weighted_launches, tie_group_reduce_rows.launches,
            tie_group_reduce_rows.weighted_launches)


def _one_more(before, index):
    want = list(before)
    want[index] += 1
    return tuple(want)


def test_weighted_and_micro_routes_launch_one_kernel_each(cuda_device):
    rng = np.random.default_rng(31)
    preds, target = _multiclass(20_000, 23, 31)
    w = torch.from_numpy(rng.lognormal(size=20_000).astype(np.float32))
    binary_p = preds[:, 0].contiguous()
    binary_t = (target == 0).to(torch.int64)
    ml_t = torch.from_numpy((rng.random((20_000, 23)) < 0.2).astype(np.int64))
    cases = [
        (auroc, (binary_p, binary_t), {"pos_label": 1, "sample_weights": w}, 1),
        (average_precision, (binary_p, binary_t), {"pos_label": 1, "sample_weights": w}, 1),
        (auroc, (preds, target), {"num_classes": 23, "sample_weights": w, "average": None}, 3),
        (average_precision, (preds, target), {"num_classes": 23, "sample_weights": w}, 3),
        (auroc, (preds, ml_t), {"num_classes": 23, "sample_weights": w, "average": "weighted"}, 3),
        (auroc, (preds, ml_t), {"num_classes": 23, "average": "micro"}, 0),
    ]
    for fn, args, kwargs, counter in cases:
        on_card = {k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v for k, v in kwargs.items()}
        before = _launches()
        gpu = fn(*(a.to(cuda_device) for a in args), **on_card)
        assert _launches() == _one_more(before, counter), (fn.__name__, kwargs)
        cpu = fn(*args, **kwargs)
        gpu = torch.stack(gpu).cpu() if isinstance(gpu, list) else gpu.cpu()
        cpu = torch.stack(cpu) if isinstance(cpu, list) else cpu
        torch.testing.assert_close(gpu, cpu, rtol=0.0, atol=1e-5, equal_nan=True)


def _assert_curves_equal(gpu, cpu):
    if isinstance(cpu[0], list):
        for c in range(len(cpu[0])):
            _assert_curves_equal([g[c] for g in gpu], [x[c] for x in cpu])
        return
    for g, c in zip(gpu[:2], cpu[:2]):
        assert g.device.type == "cuda" and g.shape == c.shape
        torch.testing.assert_close(g.cpu(), c, rtol=0.0, atol=1e-6, equal_nan=True)
    torch.testing.assert_close(gpu[2].cpu(), cpu[2], rtol=0.0, atol=0.0, equal_nan=True)


@pytest.mark.parametrize("weighted", [False, True])
def test_gpu_curves_match_the_cpu_path(cuda_device, weighted):
    rng = np.random.default_rng(32)
    scores = np.round(rng.random(300_000), 3).astype(np.float32)
    scores[::1000] = np.nan
    scores[1::997] = -0.0
    target = torch.from_numpy((rng.random(300_000) < 0.3).astype(np.int64))
    preds = torch.from_numpy(scores)
    w = torch.from_numpy(rng.lognormal(size=300_000).astype(np.float32)) if weighted else None
    mc_preds, mc_target = _multiclass(30_000, 17, 33)
    mc_w = torch.from_numpy(rng.lognormal(size=30_000).astype(np.float32)) if weighted else None
    for fn in (roc, precision_recall_curve):
        gpu = fn(preds.to(cuda_device), target.to(cuda_device), pos_label=1,
                 sample_weights=None if w is None else w.to(cuda_device))
        _assert_curves_equal(gpu, fn(preds, target, pos_label=1, sample_weights=w))
        gpu = fn(mc_preds.to(cuda_device), mc_target.to(cuda_device), num_classes=17,
                 sample_weights=None if mc_w is None else mc_w.to(cuda_device))
        _assert_curves_equal(gpu, fn(mc_preds, mc_target, num_classes=17, sample_weights=mc_w))


def test_curve_modules_and_max_fpr_on_the_card(cuda_device):
    preds, target = _multiclass(40_000, 9, 34)
    for module in (ROC, PrecisionRecallCurve):
        on_card, on_cpu = module(num_classes=9), module(num_classes=9, device="cpu")
        for chunk in range(4):
            sl = slice(chunk * 10_000, (chunk + 1) * 10_000)
            on_card.update(preds[sl], target[sl])
            on_cpu.update(preds[sl], target[sl])
        _assert_curves_equal(on_card.compute(), on_cpu.compute())
    binary_p, binary_t = preds[:, 0].contiguous(), (target == 0).to(torch.int64)
    gpu = auroc(binary_p.to(cuda_device), binary_t.to(cuda_device), pos_label=1, max_fpr=0.1)
    assert abs(float(gpu) - float(auroc(binary_p, binary_t, pos_label=1, max_fpr=0.1))) < 1e-6


def test_per_class_curve_syncs_do_not_grow_with_the_classes(cuda_device):
    def syncs(c):
        preds, target = _multiclass(5_000, c, 35)
        preds, target = preds.to(cuda_device), target.to(cuda_device)
        roc(preds, target, num_classes=c)  # first calls may synchronize once more
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                roc(preds, target, num_classes=c)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return sum("synchroniz" in str(w.message) for w in caught)

    syncs(10)  # the process's first counted window may see one more, from PyTorch itself
    assert syncs(10) == syncs(200) > 0


@pytest.mark.parametrize("weighted", [False, True])
def test_gpu_binned_curves_match_the_cpu_path(cuda_device, weighted):
    rng = np.random.default_rng(36)
    binary_p = torch.from_numpy(rng.random(200_000, dtype=np.float32))
    binary_t = torch.from_numpy((rng.random(200_000) < binary_p.numpy()).astype(np.int64))
    mc_p, mc_t = _multiclass(20_000, 50, 36)
    w = torch.from_numpy(rng.lognormal(size=200_000).astype(np.float32)) if weighted else None
    for metric in (BinnedAUROC, BinnedAveragePrecision, BinnedPrecisionRecallCurve):
        for kwargs, (p, t) in (({}, (binary_p, binary_t)), ({"num_classes": 50}, (mc_p, mc_t))):
            on_card, on_cpu = metric(num_bins=512, **kwargs), metric(num_bins=512, device="cpu", **kwargs)
            extra = {} if w is None else {"sample_weights": w[:p.shape[0]]}
            on_card.update(p, t, **extra)
            on_cpu.update(p, t, **extra)
            if weighted:
                torch.testing.assert_close(on_card.hist_pos.cpu(), on_cpu.hist_pos, rtol=1e-5, atol=0.0)
            else:
                assert torch.equal(on_card.hist_pos.cpu(), on_cpu.hist_pos)
                assert torch.equal(on_card.hist_neg.cpu(), on_cpu.hist_neg)
            got, want = on_card.compute(), on_cpu.compute()
            for g, c in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
                torch.testing.assert_close(g.cpu(), c, rtol=0.0, atol=1e-6, equal_nan=True)


# ---- the stat-score / confusion-matrix family -----------------------------------


def _update_syncs(metric_fn, preds, target):
    """Host synchronizations of one ``update`` of a fresh metric, after a
    first update (first calls may synchronize once more)."""
    metric_fn().update(preds, target)
    torch.cuda.synchronize()
    metric = metric_fn()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            metric.update(preds, target)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.parametrize("kwargs", [
    {"reduce": "macro"}, {"reduce": "micro", "ignore_index": 3}, {"reduce": "samples", "top_k": 2},
    {"reduce": "macro", "top_k": 5, "ignore_index": 0},
])
def test_gpu_label_space_counts_equal_the_canonical_path(cuda_device, kwargs):
    preds, target = _multiclass(20_000, 17, 37)
    # ties inside and at the edge of the top k
    preds = (torch.round(preds * 20) + 1) / (torch.round(preds * 20) + 1).sum(1, keepdim=True)
    p, t = preds.to(cuda_device), target.to(cuda_device)
    options = dict(reduce="micro", mdmc_reduce=None, num_classes=17, top_k=None, threshold=0.5,
                   is_multiclass=None, ignore_index=None)
    options.update(kwargs)
    fast = _stat_scores_fast_update(p, t, **options)
    pc, tc, _ = _input_format_classification(p, t, num_classes=17, top_k=options["top_k"])
    canonical = _stat_scores_count(pc, tc, options["reduce"], None, options["ignore_index"])
    on_cpu = _stat_scores_fast_update(preds, target, **options)
    for got, want, cpu in zip(fast, canonical, on_cpu):
        assert got.device.type == "cuda" and torch.equal(got, want) and torch.equal(got.cpu(), cpu)


def test_label_bincount_is_bit_equal_to_torch_bincount(cuda_device):
    rng = np.random.default_rng(38)
    for n, length in ((1, 1), (1_000_003, 19), (8_388_608, 361), (5_000_000, 1_000_000)):
        idx = torch.from_numpy(rng.integers(0, length, n)).to(cuda_device)
        got = label_bincount(idx, length)
        assert got.dtype == torch.int64 and torch.equal(got, torch.bincount(idx, minlength=length))
    # the out-of-range contract: negatives count in bucket 0, labels >= length nowhere
    idx = torch.tensor([-3, 0, 2, 5, 9], device=cuda_device)
    assert label_bincount(idx, 5).tolist() == [2, 0, 1, 0, 0]


def test_stat_score_update_syncs_do_not_grow_with_the_classes(cuda_device):
    counts = {}
    for c in (19, 1000):
        preds, target = _multiclass(5_000, c, 39)
        p, t = preds.to(cuda_device), target.to(cuda_device)
        counts[c] = [
            _update_syncs(lambda: StatScores(reduce="macro", num_classes=c), p, t),
            _update_syncs(lambda: F1(num_classes=c, average="macro"), p, t),
            _update_syncs(lambda: ConfusionMatrix(num_classes=c), p, t),
        ]
    assert counts[19] == counts[1000] == [1, 1, 1], counts  # the value probe's read, and nothing else


def test_per_class_counts_past_2_24_are_exact(cuda_device):
    """A class holding 20M of 20,000,003 positions: its support, tp and tn
    pass 2^24 (where a float32 count would stop) and equal numpy's int64
    counts; the confusion matrix's int32 state holds them too."""
    n = 20_000_003
    rng = np.random.default_rng(40)
    target = np.where(rng.random(n) < 0.999, 2, rng.integers(0, 4, n))
    preds = np.where(rng.random(n) < 0.99, target, rng.integers(0, 4, n))
    t, p = torch.from_numpy(target).to(cuda_device), torch.from_numpy(preds).to(cuda_device)
    stats = StatScores(reduce="macro", num_classes=4)
    stats.update(p, t)
    confmat = ConfusionMatrix(num_classes=4)
    confmat.update(p, t)
    want = np.bincount(target * 4 + preds, minlength=16).reshape(4, 4)
    assert np.array_equal(confmat.confmat.cpu().numpy(), want)
    tp = np.diag(want)
    fp, fn = want.sum(0) - tp, want.sum(1) - tp
    want_stats = np.stack([tp, fp, n - tp - fp - fn, fn, tp + fn], 1)
    assert want_stats[2, 0] > 2**24 and want_stats[0, 2] > 2**24
    assert np.array_equal(stats.compute().cpu().numpy(), want_stats)


# ---- the regression pack ------------------------------------------------------


def _images(shape, seed):
    rng = np.random.default_rng(seed)
    target = rng.random(shape, dtype=np.float32)
    preds = np.clip(0.8 * target + 0.2 * rng.random(shape, dtype=np.float32), 0, 1).astype(np.float32)
    return torch.from_numpy(preds), torch.from_numpy(target)


@pytest.mark.parametrize("shape", [(4, 3, 128, 128), (2, 3, 512, 768)], ids=["banded", "convolution"])
def test_ssim_under_global_tf32_flags_stays_at_full_float32(cuda_device, shape):
    """With TF32 switched on for cuDNN and matmuls, the blur still runs at
    full float32: within 1e-6 of the float64 evaluation (a TF32 blur reads
    ~6e-5 off), and the caller's flags read the same afterwards."""
    preds, target = _images(shape, 41)
    want = ssim(preds.double(), target.double(), data_range=1.0).item()
    flags = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        got = ssim(preds.to(cuda_device), target.to(cuda_device), data_range=1.0).item()
        metric = SSIM()
        metric.update(preds.to(cuda_device), target.to(cuda_device))
        module = metric.compute().item()
        assert torch.get_float32_matmul_precision() == "high" and torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.set_float32_matmul_precision(flags[0])
        torch.backends.cudnn.allow_tf32 = flags[1]
    assert abs(got - want) <= 1e-6 and abs(module - want) <= 1e-6, (got, module, want)


def _regression_collection():
    return MetricCollection([MeanSquaredError(), MeanAbsoluteError(), R2Score(), PSNR(), ExplainedVariance()])


def test_regression_collection_update_does_not_synchronize(cuda_device):
    rng = np.random.default_rng(42)
    target = torch.from_numpy((rng.standard_normal(100_000) * 3 + 1).astype(np.float32)).to(cuda_device)
    preds = target + torch.from_numpy(rng.standard_normal(100_000).astype(np.float32)).to(cuda_device)
    assert _update_syncs(_regression_collection, preds, target) == 0
    images = _images((4, 3, 64, 64), 43)
    assert _update_syncs(lambda: SSIM(data_range=1.0), *(x.to(cuda_device) for x in images)) == 0


def test_shared_pass_on_the_card_equals_the_unshared_one(cuda_device):
    rng = np.random.default_rng(44)
    for shape in ((50_000,), (20_000, 3), (8, 3, 32, 32)):
        shared = _regression_collection() if len(shape) < 3 else MetricCollection(
            [MeanSquaredError(), MeanAbsoluteError(), PSNR()])
        alone = {name: type(m)() for name, m in shared.items()}
        for _ in range(3):
            target = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda_device)
            preds = target + torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda_device)
            step = shared(preds, target)
            for name, metric in alone.items():
                torch.testing.assert_close(step[name], metric(preds, target), rtol=1e-6, atol=0.0)
        got = shared.compute()
        for name, metric in alone.items():
            torch.testing.assert_close(got[name], metric.compute(), rtol=1e-6, atol=0.0)


# ---- the retrieval family ---------------------------------------------------------------------


def _retrieval(n, queries, seed):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(-queries, queries, n).astype(np.int32) * 7)
    preds = torch.from_numpy(np.round(rng.random(n), 3).astype(np.float32))  # ties
    target = torch.from_numpy((rng.random(n) < 0.05).astype(np.int32))
    target[::97] = -100
    return idx, preds, target


def _retrieval_collection(device, sharded=False, capacity=0):
    if sharded:
        return MetricCollection([ShardedRetrievalMAP(capacity, device=device), ShardedRetrievalMRR(capacity, device=device),
                                 ShardedRetrievalPrecision(capacity, k=10, device=device),
                                 ShardedRetrievalRecall(capacity, k=100, device=device)])
    return MetricCollection([RetrievalMAP(device=device), RetrievalMRR(device=device),
                             RetrievalPrecision(k=10, device=device), RetrievalRecall(k=100, device=device)])


def test_gpu_retrieval_matches_the_cpu_path(cuda_device):
    idx, preds, target = _retrieval(300_000, 2_000, 50)
    values = {}
    for device in (torch.device("cpu"), cuda_device):
        collection = _retrieval_collection(device)
        for lo in range(0, idx.shape[0], 100_000):
            collection.update(idx[lo:lo + 100_000], preds[lo:lo + 100_000], target[lo:lo + 100_000])
        values[device.type] = {k: float(v) for k, v in collection.compute().items()}
    assert all(abs(values["cuda"][k] - values["cpu"][k]) <= 1e-6 for k in values["cpu"]), values
    keep = target != -100
    dense = torch.unique(idx[keep], return_inverse=True)[1].to(torch.int32)
    args = (dense, preds[keep], target[keep], int(dense.max()) + 1)
    cpu = segment.ranked_group_stats(*args)
    gpu = segment.ranked_group_stats(*(a.to(cuda_device) if torch.is_tensor(a) else a for a in args))
    for field in cpu._fields:
        assert torch.equal(getattr(gpu, field).cpu(), getattr(cpu, field)), field
    for k in (None, 10, 100):
        for g, c in zip(segment.hits_in_topk(gpu, k), segment.hits_in_topk(cpu, k)):
            assert torch.equal(g.cpu(), c)


def test_retrieval_compute_bits_repeat_and_sharded_world_1_is_equal(cuda_device):
    idx, preds, target = (x.to(cuda_device) for x in _retrieval(500_000, 5_000, 51))
    plain, sharded = _retrieval_collection(cuda_device), _retrieval_collection(cuda_device, True, 500_000)
    for collection in (plain, sharded):
        collection.update(idx, preds, target)
    first = {k: v.cpu().numpy().tobytes() for k, v in plain.compute().items()}
    for metric in plain.values():
        metric._computed = None
    again = {k: v.cpu().numpy().tobytes() for k, v in plain.compute().items()}
    shard = {k.replace("Sharded", ""): v.cpu().numpy().tobytes() for k, v in sharded.compute().items()}
    assert first == again == shard


def test_both_sort_forms_give_one_permutation_on_the_card(cuda_device):
    idx, preds, _ = (x.to(cuda_device) for x in _retrieval(1_000_003, 10_000, 52))
    g2, o2 = segment._lex_order_two_pass(idx, preds)
    gp, op = segment._lex_order_packed(idx, preds)
    assert torch.equal(g2, gp) and torch.equal(o2, op)


def _compute_syncs(collection):
    for metric in collection.values():
        metric._computed = None
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            collection.compute()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def test_retrieval_compute_syncs_do_not_grow_with_the_queries(cuda_device):
    def syncs(queries):
        idx, preds, target = (x.to(cuda_device) for x in _retrieval(200_000, queries, 53))
        collection = _retrieval_collection(cuda_device)
        collection.update(idx, preds, target)
        collection.compute()  # first calls may synchronize once more
        return _compute_syncs(collection)

    syncs(100)
    assert syncs(50) == syncs(5_000) > 0


# ---- the step engine: one CUDA graph per call signature ---------------------------


def _forward_leg(compiled):
    return MetricCollection([Accuracy(), Precision(num_classes=4, average="macro"),
                             Recall(num_classes=4, average="macro"), F1(num_classes=4, average="macro")],
                            compiled=compiled)


def _engine_batches(family, steps, device, n=20_000):
    rng = np.random.default_rng(50)
    out = []
    for _ in range(steps):
        if family == "classification":
            p = rng.random((n, 4), dtype=np.float32)
            out.append((p / p.sum(1, keepdims=True), rng.integers(0, 4, n)))
        elif family == "regression":
            t = (rng.standard_normal(n) * 3 + 1).astype(np.float32)
            out.append(((t + rng.standard_normal(n)).astype(np.float32), t))
        else:  # binned, weighted
            p = rng.random(n, dtype=np.float32)
            out.append((p, (rng.random(n) < p).astype(np.int64), rng.lognormal(size=n).astype(np.float32)))
    return [tuple(torch.from_numpy(x).to(device) for x in b) for b in out]


_ENGINE_FAMILIES = {
    "classification": _forward_leg,
    "regression": lambda compiled: MetricCollection(
        [MeanSquaredError(), MeanAbsoluteError(), R2Score(), PSNR(), ExplainedVariance()], compiled=compiled),
    "binned": lambda compiled: MetricCollection([BinnedAUROC(num_bins=64), BinnedAveragePrecision(num_bins=64)],
                                                compiled=compiled),
}


def _call(collection, batch):
    return collection(*batch[:2], **({"sample_weights": batch[2]} if len(batch) == 3 else {}))


def _assert_engine_equal(eager, compiled, ve, vc):
    for k in ve:
        torch.testing.assert_close(vc[k], ve[k], rtol=1e-6, atol=1e-7)
    for name in eager.keys():
        for s in eager[name]._defaults:
            a, b = getattr(compiled[name], s), getattr(eager[name], s)
            if a.is_floating_point():
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
            else:
                assert torch.equal(a, b), f"{name}.{s}"


@pytest.mark.parametrize("family", sorted(_ENGINE_FAMILIES))
def test_engine_graph_replay_equals_eager(cuda_device, family):
    """Every member captured; values and states equal the eager collection's
    step by step (counts exact) and at the epoch; one capture."""
    eager, compiled = _ENGINE_FAMILIES[family](False), _ENGINE_FAMILIES[family](True)
    for batch in _engine_batches(family, 4, cuda_device):
        ve, vc = _call(eager, batch), _call(compiled, batch)
        _assert_engine_equal(eager, compiled, ve, vc)
    for k, v in eager.compute().items():
        torch.testing.assert_close(compiled.compute()[k], v, rtol=1e-6, atol=1e-7)
    info = compiled._engine.cache_info()
    assert info["eager_fallbacks"] == {} and info["trace_count"] == 1 and info["graph_pool_bytes"] >= 0, info


@pytest.mark.parametrize("family", sorted(_ENGINE_FAMILIES))
def test_engine_replayed_step_does_not_synchronize(cuda_device, family):
    compiled = _ENGINE_FAMILIES[family](True)
    batches = _engine_batches(family, 2, cuda_device)
    _call(compiled, batches[0])
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _call(compiled, batches[1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert not [w for w in caught if "synchroniz" in str(w.message)], [str(w.message) for w in caught]
    assert compiled.eager_fallbacks == {}


def test_engine_demotion_leaves_the_card_usable(cuda_device):
    """StatScores without num_classes on label inputs cannot infer the
    one-hot width inside a graph: it is demoted with that reason, Accuracy
    stays captured, and the card keeps working."""
    rng = np.random.default_rng(51)
    batches = [(torch.from_numpy(rng.integers(0, 5, 10_000)).to(cuda_device),
                torch.from_numpy(rng.integers(0, 5, 10_000)).to(cuda_device)) for _ in range(3)]
    eager = MetricCollection([Accuracy(), StatScores()])
    compiled = MetricCollection([Accuracy(), StatScores()], compiled=True)
    for batch in batches:
        ve, vc = eager(*batch), compiled(*batch)
        for k in ve:
            assert torch.equal(vc[k], ve[k]), k
    assert set(compiled.eager_fallbacks) == {"StatScores"}
    assert "`num_classes` is required" in compiled.eager_fallbacks["StatScores"]
    torch.cuda.synchronize()
    assert compiled._engine.trace_count == 2  # the failed group, then Accuracy alone
    for k, v in eager.compute().items():
        assert torch.equal(compiled.compute()[k], v), k


def test_engine_values_outlive_the_next_step(cuda_device):
    compiled = _forward_leg(True)
    b1, b2 = _engine_batches("classification", 2, cuda_device)
    first = compiled(*b1)
    kept = {k: v.clone() for k, v in first.items()}
    compiled(*b2)
    for k in kept:
        assert torch.equal(first[k], kept[k]), k


def test_engine_compute_result_outlives_later_steps(cuda_device):
    """``ConfusionMatrix(normalize=None).compute()`` returns its state
    tensor: a matrix read after one step keeps its counts through a later
    step, and through ``reset()`` and the step after it."""
    b1, b2, b3 = _engine_batches("classification", 3, cuda_device)
    compiled = MetricCollection([ConfusionMatrix(num_classes=4)], compiled=True)
    eager = MetricCollection([ConfusionMatrix(num_classes=4)])
    compiled(*b1), eager(*b1)
    cm = compiled.compute()["ConfusionMatrix"]
    kept = cm.clone()
    compiled(*b2)
    compiled.reset()
    compiled(*b3)
    torch.cuda.synchronize()
    assert torch.equal(cm, kept) and torch.equal(kept, eager.compute()["ConfusionMatrix"])
    assert compiled.eager_fallbacks == {}


def test_engine_reset_and_restore_between_steps(cuda_device):
    """After ``reset()`` the next step starts from the defaults (which the
    engine never aliases); after ``load_state_dict`` it continues from the
    loaded states."""
    b1, b2, b3 = _engine_batches("classification", 3, cuda_device)
    compiled, eager = _forward_leg(True), _forward_leg(False)
    compiled(*b1)
    compiled.reset()
    for m in compiled.values():
        for s, default in m._defaults.items():
            assert not torch.any(default != 0), s
    _assert_engine_equal(eager, compiled, eager(*b2), compiled(*b2))
    compiled.persistent(True)
    saved = {k: v.clone() for k, v in compiled.state_dict().items()}
    compiled(*b3)
    compiled.load_state_dict(saved)
    eager.persistent(True)
    eager.load_state_dict(saved)
    _assert_engine_equal(eager, compiled, eager(*b3), compiled(*b3))


def test_engine_binary_step_keeps_auroc_eager(cuda_device):
    """Accuracy + AUROC: Accuracy is captured, AUROC runs eager, and its
    compute still launches the tie scan once."""
    rng = np.random.default_rng(52)
    p = rng.random(50_000, dtype=np.float32)
    t = (rng.random(50_000) < p).astype(np.int64)
    p, t = torch.from_numpy(p).to(cuda_device), torch.from_numpy(t).to(cuda_device)
    eager = MetricCollection([Accuracy(), AUROC(pos_label=1)])
    compiled = MetricCollection([Accuracy(), AUROC(pos_label=1)], compiled=True)
    for sl in (slice(0, 25_000), slice(25_000, 50_000)):
        ve, vc = eager(p[sl], t[sl]), compiled(p[sl], t[sl])
        for k in ve:
            assert torch.equal(vc[k], ve[k]), k
    assert set(compiled.eager_fallbacks) == {"AUROC"}
    # AUROC keeps list states and never opted into the fused forward: the
    # engine reads the second, as the JAX package's does
    assert "does not opt into fused one-update forward" in compiled.eager_fallbacks["AUROC"]
    before = tie_group_reduce.launches
    got = compiled.compute()
    assert tie_group_reduce.launches == before + 1
    for k, v in eager.compute().items():
        assert torch.equal(got[k], v), k


def test_engine_takes_host_inputs_and_evicts_graphs(cuda_device):
    """Inputs on the host are copied into the graph's static inputs (as an
    eager metric moves them); past ``cache_size`` signatures the oldest
    graph is dropped and rebuilt when its shape returns, the values still
    equal eager's."""
    eager, compiled = _forward_leg(False), _forward_leg(True)
    batches = _engine_batches("classification", 1, torch.device("cpu"), n=4_000)[0]
    sizes = (1_000, 2_000, 3_000, 1_000)
    for step, n in enumerate(sizes):
        batch = (batches[0][:n], batches[1][:n])
        ve, vc = eager(*batch), compiled(*batch)
        if step == 0:
            compiled._engine._cache_size = 2
        _assert_engine_equal(eager, compiled, ve, vc)
    info = compiled._engine.cache_info()
    assert info["compiled_signatures"] == 2 and info["trace_count"] == 4, info


# ---- the multi-tenant cohort: one CUDA graph per call signature and capacity bucket ------


def _cohort_rows(n, seed, device):
    """Grid-valued rows: probabilities are integer multinomials / 256, so
    every float sum is exact in any order."""
    rs = np.random.RandomState(seed)
    probs = (rs.multinomial(256, [0.25] * 4, size=(n, 64)) / 256.0).astype(np.float32)
    return torch.from_numpy(probs).to(device), torch.from_numpy(rs.randint(4, size=(n, 64))).to(device)


def _steady_profile(fn, most=8):
    """A ``torch.profiler`` trace of ``fn()`` whose count of device records
    another non-empty trace of the same call agrees on (at most ``most``
    traces, then the median non-empty one). CUPTI has dropped records from
    a trace on the card (empty traces too) and once showed one record more
    than its twin; a real extra kernel shows in every trace, so a check on
    the agreed trace is as strict as on a complete one."""
    from torch.profiler import ProfilerActivity, profile

    traces = []
    lost = 0
    for _ in range(most):
        pad = 0.02 * 2 ** lost  # an idle card before, host time around the call; wider after a lost trace
        torch.cuda.synchronize()
        time.sleep(pad)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        if not n:
            lost += 1
            continue
        if any(m == n for m, _ in traces):
            return prof
        traces.append((n, prof))
    return sorted(traces, key=lambda t: t[0])[len(traces) // 2][1] if traces else prof


def _replay_kernels(cohort):
    """Kernels of one replay of the cohort's newest graph, by name (copies
    and fills not counted), from an agreed trace."""
    program = list(cohort._engine._compiled.values())[-1]
    prof = _steady_profile(program.graph.replay)
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.key.lower().startswith(("memcpy", "memset"))}


def test_cohort_captures_one_graph_per_bucket_and_equals_collections_alone(cuda_device):
    """Two buckets (capacity 2, then 4 after a third tenant joins), one graph
    each; every tenant's states and ``compute()`` equal its compiled
    collection run alone on the same rows (counts exact, floats bit-equal)."""
    cohort = MetricCohort(_forward_leg(False), tenants=2)
    alone = [_forward_leg(True) for _ in range(3)]
    for tenants, seed in ((2, 0), (2, 1), (3, 2), (3, 3)):
        if tenants > len(cohort):
            cohort.add_tenant()
        p, t = _cohort_rows(tenants, seed, cuda_device)
        values = cohort(p, t)
        for i in range(tenants):
            step = alone[i](p[i], t[i])
            for k in step:
                assert torch.equal(values[k][i], step[k]), (seed, i, k)
    info = cohort.cache_info()
    assert info["trace_count"] == 2 and info["compiled_signatures"] == 2 and len(info["graph_build_ms"]) == 2, info
    computed = cohort.compute()
    for i, col in enumerate(alone):
        for key, m in col.items():
            for s in m._defaults:
                assert torch.equal(cohort._states[key][s][i], getattr(m, s)), (i, key, s)
            assert torch.equal(computed[key][i], col.compute()[key]), (i, key)


def test_cohort_kernels_per_replay_do_not_grow_with_the_tenants(cuda_device):
    """The count primitives' batching rule: one kernel per operation at any
    capacity, so a replay at 4,096 tenants runs as many kernels as at 64."""
    counts = {}
    for capacity in (64, 4096):
        cohort = MetricCohort(_forward_leg(False), tenants=capacity)
        cohort(*_cohort_rows(capacity, 4, cuda_device))
        counts[capacity] = _replay_kernels(cohort)
    assert sum(counts[64].values()) == sum(counts[4096].values()) > 0, counts


def test_cohort_replayed_step_does_not_synchronize(cuda_device):
    cohort = MetricCohort(_forward_leg(False), tenants=100, track_health=True)
    batch = _cohort_rows(100, 5, cuda_device)
    cohort(*batch)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            cohort(*batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert not [w for w in caught if "synchroniz" in str(w.message)], [str(w.message) for w in caught]
    assert cohort.health()["updates"].tolist() == [2] * 100


def test_cohort_compute_result_outlives_later_steps_and_reset(cuda_device):
    cohort = MetricCohort(ConfusionMatrix(num_classes=4), tenants=3)
    cohort(*_cohort_rows(3, 6, cuda_device))
    first = cohort.compute()
    kept = first.clone()
    cohort(*_cohort_rows(3, 7, cuda_device))
    cohort.reset()
    cohort(*_cohort_rows(3, 8, cuda_device))
    assert torch.equal(first, kept) and int(kept.sum()) == 3 * 64


def test_cohort_build_failure_raises_drops_the_program_and_demotes_nothing(cuda_device):
    """A member that reads the host in its update cannot run batched or in a
    graph: the cohort raises (it has no eager fallback), keeps no program,
    demotes nothing, and the card stays usable."""

    class HostRead(MeanSquaredError):
        def update(self, preds, target):
            float(preds.sum())
            super().update(preds, target)

    cohort = MetricCohort(MetricCollection({"mse": HostRead()}), tenants=2)
    p = torch.rand(2, 8, device=cuda_device)
    with pytest.raises(RuntimeError):
        cohort(p, p)
    info = cohort.cache_info()
    assert info["compiled_signatures"] == 0 and info["trace_count"] == 1 and info["eager_fallbacks"] == {}, info
    torch.cuda.synchronize()
    usable = MetricCohort(MeanSquaredError(), tenants=2)
    assert torch.equal(usable(p, p), torch.zeros(2, device=cuda_device))


# ---- the observability core on the card ------------------------------------


@pytest.fixture
def recorders_off():
    """The port's recorders are process-global: off and empty before and
    after."""
    import metrics_tpu_torch.observability as obs

    def pristine():
        obs.disable()
        obs.get().reset()
        obs.disable_tracing()
        obs.get_tracer().reset()
        obs.disable_flight()

    pristine()
    yield obs
    pristine()


# the names of the port's profiler ranges: on the device timeline a range is
# an annotation spanning the kernels launched inside it, not a kernel
_RANGES = ("metrics_tpu.", "engine[")


def _device_events(fn):
    """``(kernels by name, profile)`` of the device work ``fn()`` runs
    (copies, fills and range annotations not counted)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.lower().startswith(("memcpy", "memset")) and not e.key.startswith(_RANGES)}
    return kernels, prof


def _range_kernels(prof, name):
    """Names of the device events that run inside the device-side span of
    every ``torch.profiler`` range called ``name`` (the kernels launched in
    the range, through ATen, a ctypes entry or a graph replay alike)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    spans = [e for e in events if e.name == name]
    return [e.name for s in spans for e in events
            if not e.name.startswith(_RANGES)
            and s.time_range.start <= e.time_range.start and e.time_range.end <= s.time_range.end]


def _syncs_in(fn):
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [str(w.message) for w in caught if "synchroniz" in str(w.message)]


def test_observability_keeps_replays_sync_free_and_their_kernels(cuda_device, recorders_off, tmp_path):
    """With telemetry, tracing and the flight recorder on, a replayed
    compiled step and a replayed cohort step make no host synchronization
    and run the kernels they run with every recorder off; values and states
    are bit-equal on and off (the warm-up, under sync debug mode "error",
    ran the hooks). The cohort's health is pinned off: with telemetry on it
    would otherwise ride a second program."""
    obs = recorders_off
    batches = _engine_batches("classification", 3, cuda_device)
    rows = _cohort_rows(64, 9, cuda_device)
    runs = {}
    for on in (False, True):
        if on:
            obs.enable()
            obs.enable_tracing()
            obs.enable_flight(tmp_path)
        compiled, cohort = _forward_leg(True), MetricCohort(_forward_leg(False), tenants=64, track_health=False)
        values = [compiled(*b) for b in batches] + [cohort(*rows), cohort(*rows)]
        syncs = _syncs_in(lambda: (compiled(*batches[1]), cohort(*rows)))
        kernels = (_device_events(lambda: compiled(*batches[1]))[0], _device_events(lambda: cohort(*rows))[0])
        states = [getattr(compiled[k], s) for k in compiled.keys() for s in compiled[k]._defaults]
        states += [v for d in cohort._states.values() for v in d.values()]
        runs[on] = (values, states, syncs, kernels)
    (v_off, s_off, sync_off, k_off), (v_on, s_on, sync_on, k_on) = runs[False], runs[True]
    assert sync_on == [] and sync_off == []
    assert k_on == k_off and sum(k_on[0].values()) > 0 and sum(k_on[1].values()) > 0
    for a, b in zip(v_off, v_on):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert all(torch.equal(a, b) for a, b in zip(s_off, s_on))
    assert obs.get().counters["engine.dispatches"] == 5 + 4  # 3 + 1 + 1 compiled steps, 2 + 1 + 1 cohort steps
    assert obs.get_flight().dumps == 0


def test_engine_counters_are_the_signature_arithmetic_on_the_card(cuda_device, recorders_off):
    """Two signatures: 2 misses, 3 hits, 5 dispatches; a member's update
    counts once per build (the warm-up), which is the engine's trace_count;
    the watchdog reads 0 at steady state."""
    obs = recorders_off
    obs.enable()
    col = MetricCollection([MeanSquaredError()], compiled=True)
    a, b = torch.rand(64, device=cuda_device), torch.rand(96, device=cuda_device)
    for x in (a, a, b, b, a):
        col(x, x)
    c = obs.get().counters
    assert (c["engine.cache_misses"], c["engine.cache_hits"], c["engine.dispatches"]) == (2, 3, 5), c
    assert c["metric.MeanSquaredError.update_calls"] == col._engine.trace_count == 2
    assert col._engine.cache_info()["seen_signatures"] == 2
    assert c["trace.engine[MeanSquaredError]"] == 2 and obs.get().watchdog.retrace_count() == 0
    for _ in range(8):
        col(a, a)
    assert obs.get().watchdog.retrace_count() == 0 and obs.get().counters["engine.cache_misses"] == 2


def test_polymorphic_loop_fires_one_verdict_and_one_dump_on_the_card(cuda_device, recorders_off, tmp_path):
    import json

    obs = recorders_off
    obs.enable()
    obs.enable_flight(tmp_path)
    col = MetricCollection([MeanSquaredError()], compiled=True)
    col(torch.rand(2, device=cuda_device), torch.rand(2, device=cuda_device))
    col._engine._cache_size = 4
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for n in range(4, 28, 2):  # 12 shapes
            x = torch.rand(n, device=cuda_device)
            col(x, x)
    fired = [w for w in caught if "recompilation watchdog" in str(w.message)]
    assert len(fired) == 1 and [e["kind"] for e in obs.get().events].count("retrace") == 1
    (path,) = obs.get_flight().dump_paths
    dump = json.loads(open(path).read())
    assert dump["reason"] == "watchdog_retrace" and dump["identity"]["rank"] == 0
    assert dump["identity"]["world_size"] == 1 and dump["context"]["key"] == "engine[MeanSquaredError]"


def test_profile_attributes_kernels_to_the_metric_and_engine_ranges(cuda_device, recorders_off):
    """Under ``torch.profiler`` with telemetry on, an eager AUROC compute's
    co-sort and tie-scan kernel fall inside ``metrics_tpu.AUROC.compute``,
    and a compiled replay's kernels inside the engine's range."""
    obs = recorders_off
    obs.enable()
    preds = torch.rand(100_000, device=cuda_device)
    target = (torch.rand(100_000, device=cuda_device) < preds).long()
    m = AUROC(pos_label=1)
    m.update(preds, target)
    m.compute()  # builds the kernel
    m._computed = None
    kernels, prof = _device_events(m.compute)
    inside = _range_kernels(prof, "metrics_tpu.AUROC.compute")
    assert any("tie_scan" in k for k in inside), (inside, kernels)
    assert any("sort" in k.lower() for k in inside), inside
    col = _forward_leg(True)
    batch = _engine_batches("classification", 1, cuda_device)[0]
    col(*batch)
    # the copies in and the clones out run outside the replay, every kernel inside it
    kernels, prof = _device_events(lambda: col(*batch))
    inside = [k for k in _range_kernels(prof, col._engine._watch_key) if not k.lower().startswith(("memcpy", "memset"))]
    assert len(inside) == sum(kernels.values()) > 0, (len(inside), kernels)


def test_hooks_run_inside_a_capture_and_under_vmap_at_10000_tenants(cuda_device, recorders_off):
    """A hook touches no device value: a metric scope, a span, the counters
    and a byte count from tensor metadata run inside a CUDA graph capture
    (the graph then replays), and a 10,000-tenant cohort built with every
    recorder on runs its members' hooks once, under ``torch.func.vmap``."""
    from metrics_tpu_torch.observability import telemetry, trace

    obs = recorders_off
    obs.enable()
    obs.enable_tracing()
    m = MeanSquaredError()
    x = torch.rand(1024, device=cuda_device)
    y = torch.empty_like(x)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y.copy_(x * 2)  # warm the kernel outside the capture
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        with telemetry.metric_scope(m, "update"), trace.span("drill", phase="other"):
            y.copy_(x * 2)
            obs.get().count("drill.bytes", telemetry.array_nbytes(x))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, x * 2) and obs.get().counters["drill.bytes"] == 4096
    assert obs.get().counters["metric.MeanSquaredError.update_calls"] == 1
    cohort = MetricCohort(_forward_leg(False), tenants=10_000, track_health=False)
    rows = _cohort_rows(10_000, 10, cuda_device)
    for _ in range(3):
        cohort(*rows)
    c = obs.get().counters
    assert c["metric.Accuracy.update_calls"] == c["metric.F1.compute_calls"] == cohort._engine.trace_count == 1
    assert c["cohort.dispatch_tenants"] == 30_000


# ----------------------------------------------------------------------
# the sync tiers' codec on the card
# ----------------------------------------------------------------------
_CODEC_SHAPES = [(), (7, 13), (512,), (1000, 512), (1000, 1000)]


@pytest.mark.parametrize("shape", _CODEC_SHAPES, ids=["x".join(map(str, s)) or "scalar" for s in _CODEC_SHAPES])
def test_codec_on_the_card_is_bit_equal_to_its_cpu_run(cuda_device, shape):
    """int8 codes and scales, bf16 payloads, the residual of error feedback
    and the rank-order merge of four payloads (an int32 state re-rounded),
    on the card and on the CPU: the same bits."""
    from metrics_tpu_torch.parallel import quantize as q

    rng = np.random.default_rng(31)
    x = torch.from_numpy(np.asarray(rng.standard_normal(shape) * 50, dtype=np.float32))
    x.reshape(-1)[: x.numel() // 3] = 0.0  # all-zero blocks take scale 1
    r = torch.from_numpy(np.asarray(rng.standard_normal(shape) * 0.1, dtype=np.float32))
    for precision in ("int8", "bf16"):
        cpu_pay, cpu_res = q.compensate_and_quantize(x, r, precision)
        gpu_pay, gpu_res = q.compensate_and_quantize(x.to(cuda_device), r.to(cuda_device), precision)
        for k in cpu_pay:
            assert torch.equal(gpu_pay[k].cpu(), cpu_pay[k]), (precision, k)
        assert torch.equal(gpu_res.cpu(), cpu_res), precision
        counts = [torch.from_numpy(rng.integers(0, 1000, shape).astype(np.int32)) for _ in range(4)]
        for dtype, rows in ((torch.float32, [x * (i + 1) for i in range(4)]), (torch.int32, counts)):
            cpu_m = q.merge_dequantized([q.quantize_payload(v, precision) for v in rows], x.shape, dtype)
            gpu_m = q.merge_dequantized([q.quantize_payload(v.to(cuda_device), precision) for v in rows], x.shape, dtype)
            assert gpu_m.dtype == dtype and torch.equal(gpu_m.cpu(), cpu_m), (precision, dtype)


def test_codec_on_the_card_does_not_synchronize(cuda_device):
    from metrics_tpu_torch.parallel import quantize as q

    x = torch.rand(1000, 512, device=cuda_device)
    r = torch.zeros_like(x)
    q.compensate_and_quantize(x, r, "int8")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for precision in ("int8", "bf16"):
            pay, res = q.compensate_and_quantize(x, r, precision)
            q.merge_dequantized([pay, pay], x.shape, torch.int32)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_quantized_and_hierarchical_syncs_on_the_card_equal_their_cpu_runs(cuda_device):
    """``ConfusionMatrix(1000)`` and a 64-tenant regression cohort synced
    under ``simulated_pods(2, 4)`` at each tier, healthy and with a dropped
    slice: the card's states, residuals and values equal the CPU's."""
    import warnings as _w

    from metrics_tpu_torch import reliability
    from metrics_tpu_torch.reliability import faultinject as fi

    rng = np.random.default_rng(32)
    preds = torch.from_numpy(rng.integers(0, 1000, 20_000))
    target = torch.from_numpy(rng.integers(0, 1000, 20_000))
    p = torch.from_numpy((rng.integers(0, 256, (64, 32)) / 256.0).astype(np.float32))
    t = torch.from_numpy((rng.integers(0, 256, (64, 32)) / 256.0).astype(np.float32))

    def run(device, precision, drop):
        with fi.simulated_pods(2, 4):
            cm = ConfusionMatrix(num_classes=1000, device=device)
            cohort = MetricCohort(MetricCollection([MeanSquaredError(device=device)]), tenants=64)
            if precision != "exact":
                cm.set_sync_precision(precision)
                cohort = MetricCohort(MetricCollection([MeanSquaredError(device=device)], sync_precision=precision),
                                      tenants=64)
            cm.update(preds.to(device), target.to(device))
            cohort(p.to(device), t.to(device))
            with _w.catch_warnings():
                _w.simplefilter("ignore")
                if drop:
                    with fi.pod_dropout(1), reliability.sync_policy_scope(max_retries=0, degraded_ok=True):
                        values = (cm.compute(), cohort.compute()["MeanSquaredError"])
                else:
                    values = (cm.compute(), cohort.compute()["MeanSquaredError"])
        states = [getattr(cm, r) for r in cm._sync_residual_names()]
        states += [v for k, v in cohort._states["MeanSquaredError"].items() if k.endswith("__qres")]
        return [v.cpu() for v in values], [v.cpu() for v in states]

    for precision in ("exact", "bf16", "int8"):
        for drop in (False, True):
            gpu_values, gpu_states = run(cuda_device, precision, drop)
            cpu_values, cpu_states = run("cpu", precision, drop)
            for a, b in zip(gpu_values + gpu_states, cpu_values + cpu_states):
                assert torch.equal(a, b), (precision, drop)


def _host_reads(fn):
    """Synchronizing CUDA calls in ``fn()`` (PyTorch's sync debug mode)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def test_exact_integer_sync_and_the_guarded_replay_on_the_card(cuda_device):
    """An exact sync of a ``ConfusionMatrix`` keeps its int32 counts, flat
    over a 4-rank mirror world and two-level under ``simulated_pods(2, 2)``
    (4x the local counts); a compiled collection under a quarantine guard
    reads the host once per replayed step (the stacked finite flags), rolls
    a poisoned batch back to the bits before it, and switching the guard
    off replays the unguarded graph, which reads the host 0 times."""
    from metrics_tpu_torch import MeanAbsoluteError, MeanSquaredError
    from metrics_tpu_torch.parallel.backend import set_sync_backend
    from metrics_tpu_torch.reliability import faultinject as fi
    from metrics_tpu_torch.reliability import guard_scope

    preds, target = _multiclass(4_096, 5, 61)
    for layout in ("flat", "two_level"):
        m = ConfusionMatrix(num_classes=5)
        m.update(preds.to(cuda_device), target.to(cuda_device))
        local = m.confmat.clone()
        prev = set_sync_backend(fi._MirrorBackend(4) if layout == "flat" else None)
        try:
            with (fi.simulated_pods(2, 2) if layout == "two_level" else contextlib.nullcontext()):
                m._sync_dist()
        finally:
            set_sync_backend(prev)
        assert m.confmat.dtype == torch.int32 and torch.equal(m.confmat, 4 * local), layout

    rng = np.random.default_rng(62)
    batches = [tuple(torch.from_numpy(rng.random(100_000, dtype=np.float32)).to(cuda_device) for _ in range(2))
               for _ in range(4)]
    col = MetricCollection([MeanSquaredError(), MeanAbsoluteError()], compiled=True)
    col(*batches[0])  # the unguarded graph
    assert _host_reads(lambda: col(*batches[1])) == 0
    with guard_scope("quarantine") as guard:
        col(*batches[2])  # builds the guarded graph
        assert _host_reads(lambda: col(*batches[2])) == 1
        before = {(k, s): getattr(m, s).clone() for k, m in col.items() for s in m._defaults}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            col(fi.poison(batches[3][0], "nan"), batches[3][1])
        for (k, s), v in before.items():
            assert torch.equal(getattr(col[k], s), v), (k, s)
    assert guard.stats["quarantined"] == 2 and guard.stats["checks"] == 6
    assert _host_reads(lambda: col(*batches[3])) == 0
    info = col._engine.cache_info()
    assert info["compiled_signatures"] == 2 and info["trace_count"] == 2 and info["eager_fallbacks"] == {}


# ----------------------------------------------------------------------
# serving: the asynchronous pipeline's streams and the background writer
# ----------------------------------------------------------------------
def _serving_leg():
    return MetricCollection(
        [Accuracy(), Precision(num_classes=4, average="macro"), Recall(num_classes=4, average="macro"),
         F1(num_classes=4, average="macro")],
        compiled=True,
    )


def _serving_batches(device, n=6, rows=100_000, seed=70):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = rng.random((rows, 4), dtype=np.float32)
        p /= p.sum(1, keepdims=True)
        out.append((torch.from_numpy(p).to(device), torch.from_numpy(rng.integers(0, 4, rows)).to(device)))
    return out


def _slowed_worker(pipe, cycles=20_000_000):
    """Queue a device sleep on the dispatching thread's stream before each
    dispatch, and note which stream that was."""
    streams = []
    real = pipe._dispatch

    def slow(args, kwargs):
        streams.append(torch.cuda.current_stream())
        torch.cuda._sleep(cycles)
        return real(args, kwargs)

    pipe._dispatch = slow
    return streams


@pytest.mark.parametrize("target", ["collection", "cohort_1024"])
def test_serving_async_is_bit_equal_to_blocking_on_the_card(cuda_device, target):
    from metrics_tpu_torch.serving import AsyncServingEngine

    if target == "collection":
        batches = _serving_batches(cuda_device)
        make = _serving_leg
    else:
        rng = np.random.default_rng(71)
        batches = []
        for _ in range(5):
            p = rng.random((1024, 64, 4), dtype=np.float32)
            p /= p.sum(-1, keepdims=True)
            batches.append((torch.from_numpy(p).to(cuda_device),
                            torch.from_numpy(rng.integers(0, 4, (1024, 64))).to(cuda_device)))

        def make():
            return MetricCohort(MetricCollection([Accuracy(), Precision(num_classes=4, average="macro")]),
                                tenants=1024)

    blocking = make()
    for b in batches:
        blocking(*b)
    served = make()
    pipe = AsyncServingEngine(served)
    assert pipe.is_async, pipe.refusal_reason
    for b in batches:
        pipe.forward(*b)
    got, want = pipe.compute(), blocking.compute()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert pipe.stats["dispatches"] == len(batches) and pipe.stats["inline_steps"] == 1
    pipe.close()


def test_serving_drain_orders_the_callers_stream_after_the_worker(cuda_device):
    """With a device sleep ahead of every worker dispatch, drain() returns
    while the worker's kernels are still queued; states read on the caller's
    stream (no torch.cuda.synchronize()) are the final ones, and the worker
    stepped on the pipeline's own stream."""
    from metrics_tpu_torch.serving import AsyncServingEngine

    batches = _serving_batches(cuda_device, seed=72)
    blocking = _serving_leg()
    for b in batches:
        blocking(*b)
    want = {(k, s): getattr(m, s).cpu() for k, m in blocking.items() for s in m._defaults}
    served = _serving_leg()
    pipe = AsyncServingEngine(served)
    pipe.forward(*batches[0])
    streams = _slowed_worker(pipe)
    for b in batches[1:]:
        pipe.forward(*b)
    pipe.drain()
    got = {(k, s): getattr(m, s).clone().cpu() for k, m in served.items() for s in m._defaults}
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert streams and all(s == pipe._stream for s in streams)
    assert pipe._stream != torch.cuda.default_stream() and pipe._stream != torch.cuda.current_stream()
    pipe.close()


def test_serving_input_freed_after_forward_is_not_corrupted(cuda_device):
    """The caller drops its inputs right after forward() and writes new
    tensors of the same size while the worker's copy is still queued behind
    a device sleep: the allocator must not hand the inputs' blocks back."""
    from metrics_tpu_torch.serving import AsyncServingEngine

    batches = _serving_batches(cuda_device, seed=73)
    blocking = _serving_leg()
    for b in batches:
        blocking(*b)
    served = _serving_leg()
    pipe = AsyncServingEngine(served)
    pipe.forward(*[x.clone() for x in batches[0]])
    _slowed_worker(pipe, cycles=50_000_000)
    garbage = []
    for b in batches[1:]:
        p, t = b[0].clone(), b[1].clone()
        pipe.forward(p, t)
        del p, t
        for _ in range(4):  # new blocks of the inputs' sizes, written on the caller's stream
            garbage.append((torch.full_like(b[0], 7.0), torch.full_like(b[1], 3)))
    got = pipe.compute()
    for k, v in blocking.compute().items():
        assert torch.equal(got[k], v), k
    del garbage
    pipe.close()


def test_serving_loop_reads_the_host_while_the_worker_replays(cuda_device):
    """Synchronizing calls on the serve loop never raise: a signature warms
    up (sync debug mode "error", process-global) only on the caller thread,
    after the worker went idle."""
    from metrics_tpu_torch.serving import AsyncServingEngine

    batches = _serving_batches(cuda_device, n=3, seed=74)
    short = tuple(x[:50_000] for x in batches[0])
    served = _serving_leg()
    pipe = AsyncServingEngine(served)
    reference = _serving_leg()
    sequence = [batches[i % 3] if i != 10 else short for i in range(20)]
    for b in sequence:
        pipe.forward(*b)
        assert int(b[1][0].item()) >= 0  # a host read while the worker holds a batch
        reference(*b)
    got = pipe.compute()
    for k, v in reference.compute().items():
        assert torch.equal(got[k], v), k
    assert pipe.stats["inline_steps"] == 2 and pipe.stats["errors"] == 0
    assert served._engine.trace_count == 2
    pipe.close()


@pytest.mark.parametrize("target", ["guarded_collection", "cohort_1024"])
def test_serving_forward_returns_while_the_worker_holds_a_batch(cuda_device, target):
    """Back-to-back forwards: a batch staged while the worker is inside a
    step (the engine's lock held) returns at once, and the serve loop's next
    allocation and launch (its model's work) do not wait either. Under a
    guard the worker holds the lock until the card has run its step (the
    flags' read), here behind a device sleep of about half a second; the
    cohort's worker is held on the host for as long."""
    from metrics_tpu_torch.reliability import guard_scope
    from metrics_tpu_torch.serving import AsyncServingEngine

    if target == "guarded_collection":
        batches = _serving_batches(cuda_device, n=4, seed=76)
        make = _serving_leg
    else:
        rng = np.random.default_rng(77)
        batches = []
        for _ in range(4):
            p = rng.random((1024, 64, 4), dtype=np.float32)
            p /= p.sum(-1, keepdims=True)
            batches.append((torch.from_numpy(p).to(cuda_device),
                            torch.from_numpy(rng.integers(0, 4, (1024, 64))).to(cuda_device)))

        def make():
            return MetricCohort(MetricCollection([Accuracy(), Precision(num_classes=4, average="macro")]),
                                tenants=1024)

    with guard_scope("quarantine") if target == "guarded_collection" else contextlib.nullcontext():
        reference = make()
        for b in batches:
            reference(*b)
        served = make()
        pipe = AsyncServingEngine(served)
        assert pipe.is_async, pipe.refusal_reason
        pipe.forward(*batches[0])  # built on the caller
        engine = served._engine
        step_done = []
        real_dispatch = pipe._dispatch

        def timed(args, kwargs):
            if target == "guarded_collection":
                torch.cuda._sleep(1_000_000_000)
            out = real_dispatch(args, kwargs)
            step_done.append(time.perf_counter())
            return out

        pipe._dispatch = timed
        if target == "cohort_1024":
            real_run = engine._run

            def held(*args, **kwargs):
                if threading.current_thread() is pipe._worker:
                    time.sleep(0.5)
                return real_run(*args, **kwargs)

            engine._run = held
        pipe.forward(*batches[1])
        deadline = time.perf_counter() + 10.0
        while not engine._lock.locked() and time.perf_counter() < deadline:
            time.sleep(0.0005)
        assert engine._lock.locked(), "the worker never entered its step"
        time.sleep(0.02)  # the worker is now waiting inside its step
        staged = []

        def serve_loop_step():
            pipe.forward(*batches[2])
            torch.ones(1 << 20, device=cuda_device).add_(1)  # the model's next allocation and launch
            staged.append(time.perf_counter())

        stager = threading.Thread(target=serve_loop_step, daemon=True)
        stager.start()
        stager.join(30.0)
        assert staged, "forward() hung"
        pipe.drain(timeout_s=30.0)
        assert step_done, "the worker's step did not end"
        assert staged[0] + 0.05 < step_done[0], (
            f"forward() and a launch returned {(staged[0] - step_done[0]) * 1e3:+.1f} ms after the worker's step ended"
        )
        pipe.forward(*batches[3])
        got = pipe.compute()
        for k, v in reference.compute().items():
            assert torch.equal(got[k], v), k
        assert pipe.stats["dispatches"] == 4 and pipe.stats["inline_steps"] == 1 and pipe.stats["errors"] == 0
        pipe.close()


def test_serving_background_envelope_equals_the_synchronous_one(cuda_device, tmp_path):
    from metrics_tpu_torch.reliability import EvalSession, read_envelope, save_envelope

    rng = np.random.default_rng(75)
    batches = [(torch.from_numpy(rng.random(200_000, dtype=np.float32)).to(cuda_device),
                torch.from_numpy(rng.integers(0, 2, 200_000)).to(cuda_device)) for _ in range(4)]
    session = EvalSession(MetricCollection([Accuracy(), AUROC(pos_label=1)]), tmp_path / "j", checkpoint_every=2,
                          background_checkpoints=True)
    for i, b in enumerate(batches):
        session.step(i, *b)
    session.flush_checkpoints()
    record = session.journal.records()[-1]
    written = read_envelope(session.journal._gen_path(int(record["generation"])))
    sync = save_envelope(session.metric)
    assert record["cursor"] == 3 and written["checksum"] == sync["checksum"] and written["spec"] == sync["spec"]
    assert session._bg.stats["errors"] == 0
    session.close()


def test_serving_forward_returns_while_a_scrape_waits_on_the_health_read(cuda_device):
    """A ``/metrics`` scrape of a health-armed cohort waits, behind the
    worker's step (a device sleep of about half a second ahead of it), on
    the event that step recorded, reading into the cohort's pinned mirror on
    its own stream: the serve loop's next forward, allocation and launch
    return meanwhile (a wait in a pageable copy, or a device allocation on a
    new stream, would stall them until the card reached it), and the scrape
    reads the step it waited on."""
    import urllib.request

    import metrics_tpu_torch.observability as obs
    from metrics_tpu_torch.engine import _HostMirror
    from metrics_tpu_torch.serving import AsyncServingEngine

    tenants = 64
    batches = [_cohort_rows(tenants, 80 + i, cuda_device) for i in range(3)]
    reference = MetricCohort(_forward_leg(False), tenants=tenants, track_health=True)
    for b in batches:
        reference(*b)
    cohort = MetricCohort(_forward_leg(False), tenants=tenants, track_health=True)
    pipe = AsyncServingEngine(cohort)
    assert pipe.is_async, pipe.refusal_reason
    real_read = _HostMirror.read
    reading = threading.Event()

    def watched_read(mirror, tensors, ready):
        if mirror is cohort._health_mirror:
            reading.set()
        return real_read(mirror, tensors, ready)

    _HostMirror.read = watched_read
    try:
        with obs.exporter_scope(0) as ex:
            pipe.forward(*batches[0])  # built on the caller
            pipe.drain(timeout_s=30.0)
            dispatched = threading.Event()
            real_dispatch = pipe._dispatch

            def held(args, kwargs):
                torch.cuda._sleep(1_000_000_000)
                out = real_dispatch(args, kwargs)
                dispatched.set()
                return out

            pipe._dispatch = held
            pipe.forward(*batches[1])
            assert dispatched.wait(30.0), "the worker never dispatched"  # its health and event are installed
            scraped = []

            def scrape():
                with urllib.request.urlopen(f"http://127.0.0.1:{ex.port}/metrics", timeout=30) as r:
                    text = r.read().decode()
                scraped.append((time.perf_counter(), text))

            scraper = threading.Thread(target=scrape, daemon=True)
            scraper.start()
            assert reading.wait(30.0), "the scrape never read the health"
            time.sleep(0.02)  # the scrape now waits on the worker's event
            pipe.forward(*batches[2])
            torch.ones(1 << 20, device=cuda_device).add_(1)  # the serve loop's next allocation and launch
            t_launched = time.perf_counter()
            scraper.join(30.0)
            assert scraped, "the scrape hung"
            pipe.drain(timeout_s=30.0)
    finally:
        _HostMirror.read = real_read
        pipe.close()
    t_scraped, text = scraped[0]
    assert t_launched + 0.05 < t_scraped, f"the serve loop returned {(t_launched - t_scraped) * 1e3:+.1f} ms after the scrape"
    samples = obs.parse_prometheus_text(text)
    cid = str(cohort._exporter_id)
    for family, want in (("updates", 2), ("rows_seen", 2 * 64), ("last_step", 2), ("nonfinite", 0)):
        got = [v for labels, v in samples[f"metrics_tpu_cohort_tenant_{family}"] if labels["cohort"] == cid]
        assert got == [want] * tenants, (family, got)
    for key, m in reference.items():
        for s in m._defaults:
            assert torch.equal(cohort._states[key][s], reference._states[key][s]), (key, s)


def test_serving_scrape_loop_never_reads_a_torn_health_row(cuda_device):
    """A thread reading ``health()`` as fast as it can beside a live
    serving pipeline (each step behind a short device sleep, so the card
    lags the host) only ever sees whole steps: every tenant has the same
    update count u, u * 64 rows and last step u, and u never goes back."""
    from metrics_tpu_torch.serving import AsyncServingEngine

    tenants, steps = 1024, 40
    cohort = MetricCohort(_forward_leg(False), tenants=tenants, track_health=True)
    pipe = AsyncServingEngine(cohort)
    batch = _cohort_rows(tenants, 90, cuda_device)
    pipe.forward(*batch)  # built on the caller
    real_dispatch = pipe._dispatch

    def lagging(args, kwargs):
        torch.cuda._sleep(2_000_000)
        return real_dispatch(args, kwargs)

    pipe._dispatch = lagging
    stop = threading.Event()
    seen, errors = [], []

    def reader():
        try:
            while not stop.is_set():
                h = cohort.health()
                seen.append((h["updates"].copy(), h["rows_seen"].copy(), h["last_step"].copy(), h["nonfinite"].copy()))
        except Exception as err:  # noqa: BLE001 - surfaced in the assert
            errors.append(err)

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    try:
        for _ in range(steps):
            pipe.forward(*batch)
        pipe.drain(timeout_s=60.0)
    finally:
        stop.set()
        th.join(30.0)
        pipe.close()
    assert not th.is_alive() and not errors, errors
    assert len(seen) >= 5, len(seen)
    last_u = 0
    for updates, rows, last, nonfinite in seen:
        u = int(updates[0])
        assert (updates == u).all() and (rows == 64 * u).all() and (last == u).all() and not nonfinite.any(), (
            updates[:4], rows[:4], last[:4])
        assert u >= last_u
        last_u = u
    assert cohort.health()["updates"].tolist() == [steps + 1] * tenants



# ----------------------------------------------------------------------
# the elastic fleet: every shard's cohort on the card
# ----------------------------------------------------------------------
_FLEET_N = 5_000


def _fleet_wave(keys, step):
    """2 rows x 8 features a tenant, distinct per tenant and step."""
    base = np.asarray(keys, dtype=np.float64)[:, None, None]
    preds = (base * 1e-4 + step * 0.125 + np.arange(8) * 0.01).astype(np.float32)
    preds = np.broadcast_to(preds, (len(keys), 2, 8)).copy()
    preds[:, 1] *= 0.75
    target = np.broadcast_to((base * 2e-4).astype(np.float32), preds.shape).copy()
    return preds, target


def _fleet_states(shards, keys):
    """Each key's states, from whichever shard holds it (exactly one)."""
    out = {}
    for k in keys:
        (sh,) = [s for s in shards if s.has_tenant(k)]
        for member, d in sh.cohort._states.items():
            for sname, v in d.items():
                out[(k, f"{member}.{sname}")] = v[sh.slot_of(k)]
    return out


def _on_card(shards):
    return all(v.is_cuda for sh in shards for d in sh.cohort._states.values() for v in d.values())


@pytest.mark.parametrize("size", [1, 3, _FLEET_N // 2, _FLEET_N - 1], ids=["1", "3", "half", "all_but_one"])
def test_fleet_partial_wave_is_bit_identical_to_the_full_dispatch_on_the_card(cuda_device, tmp_path, size):
    from metrics_tpu_torch.fleet import FleetShard

    keys = list(range(_FLEET_N))
    part, full = (FleetShard(nm, MeanSquaredError(), tmp_path / nm) for nm in ("part", "full"))
    for sh in (part, full):
        sh.add_tenants(keys)
        sh.submit_wave(0, keys, *_fleet_wave(keys, 0))
    subset = sorted(np.random.RandomState(size).choice(_FLEET_N, size, replace=False).tolist())
    rest = sorted(set(keys) - set(subset))
    part.submit_wave(1, subset[::-1], *_fleet_wave(subset[::-1], 1))
    part.submit_wave(1, rest, *_fleet_wave(rest, 1))
    full.submit_wave(1, keys, *_fleet_wave(keys, 1))
    for sh in (part, full):  # a full wave replayed after the partial ones reads their rows
        sh.submit_wave(2, keys, *_fleet_wave(keys, 2))
    assert _on_card([part, full]) and part.cohort.capacity == full.cohort.capacity == 8192
    live = torch.as_tensor(full.cohort.tenant_ids(), device=cuda_device)  # padding slots are inert by design
    for name, d in full.cohort._states.items():
        for sname, v in d.items():
            assert torch.equal(part.cohort._states[name][sname][live], v[live]), f"{name}.{sname}"


def test_fleet_migration_and_failover_keep_every_cohort_on_the_card(cuda_device, tmp_path):
    """Leased shards replicate, migrate and fail over with every state
    tensor on the card after adoption, after the promotion and after a
    ``restore()``, and every tenant equal to a never-failed twin."""
    from metrics_tpu_torch.fleet import (
        FleetPlacement,
        FleetRebalancer,
        FleetShard,
        LeaseAuthority,
        MigrationCoordinator,
        ShardReplicator,
    )

    names, n = ["s0", "s1", "s2"], 600
    placement = FleetPlacement(names)
    shards = {nm: FleetShard(nm, MeanSquaredError(), tmp_path / nm) for nm in names}
    twin = {nm: FleetShard(nm, MeanSquaredError(), tmp_path / "twin" / nm) for nm in names}
    for k in range(n):
        shards[placement.assign(k)].add_tenant(k)
        twin[placement.assign(k)].add_tenant(k)
    coord = MigrationCoordinator(placement, shards.values())
    auth = LeaseAuthority(ttl_s=3600.0)
    for sh in shards.values():
        sh.attach_lease(auth)
    rep = ShardReplicator(coord, authority=auth)

    def feed(fleet, steps):
        for step in steps:
            for sh in fleet.values():
                ks = list(sh.tenants())
                sh.submit_wave(step, ks, *_fleet_wave(ks, step))

    feed(shards, range(2))
    feed(twin, range(4))
    for sh in shards.values():
        sh.checkpoint()
        rep.replicate(sh)
    moved = list(shards["s1"].tenants())[:4]
    for k in moved:
        coord.migrate(k, "s0")
    assert all(shards["s0"].has_tenant(k) for k in moved) and _on_card(shards.values())
    feed(shards, [2])
    for sh in shards.values():
        sh.checkpoint()
        rep.replicate(sh)
    dead_keys = list(shards["s0"].tenants())
    assert FleetRebalancer(coord, replicator=rep, authority=auth).failover("s0") == len(dead_keys)
    assert "s0" not in coord.shards and _on_card(coord.shards.values())
    feed(coord.shards, range(4))  # the promoted tenants fold step 3 in partial waves
    survivors = list(coord.shards.values())
    got, want = _fleet_states(survivors, range(n)), _fleet_states(twin.values(), range(n))
    assert all(torch.equal(got[k], want[k]) for k in want)
    for sh in survivors:
        sh.checkpoint()
    restored = [FleetShard(sh.name, MeanSquaredError(), tmp_path / sh.name) for sh in survivors]
    assert all(r.restore() for r in restored) and _on_card(restored)
    got = _fleet_states(restored, range(n))
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_fleet_envelope_round_trip_through_stream_as_a_cuda_tensor(cuda_device, tmp_path):
    """The bytes cross ``backend.stream`` as a ``torch.uint8`` tensor on the
    card, come back through ``.cpu()``, and the far side's checksum holds:
    a migration through a backend that sees only CUDA tensors, and an eager
    AUROC tenant's envelope through the same wire."""
    from metrics_tpu_torch.fleet import FleetPlacement, FleetShard, MigrationCoordinator, adopt_into, tenant_envelope
    from metrics_tpu_torch.parallel.backend import SingleProcessBackend
    from metrics_tpu_torch.reliability.checkpoint import envelope_from_bytes, envelope_to_bytes

    class CardOnly(SingleProcessBackend):
        def __init__(self):
            self.streamed = []

        def stream(self, x, source=0, group=None):
            assert x.is_cuda and x.dtype == torch.uint8
            self.streamed.append(x.numel())
            return super().stream(x, source=source, group=group)

    backend = CardOnly()
    src, dst = (FleetShard(nm, MeanSquaredError(), tmp_path / nm) for nm in ("src", "dst"))
    src.add_tenants(range(3))
    src.submit_wave(0, [0, 1, 2], *_fleet_wave([0, 1, 2], 0))
    before = _fleet_states([src], [1])
    coord = MigrationCoordinator(FleetPlacement(["src", "dst"]), [src, dst], backend=backend)
    coord.migrate(1, "dst")
    assert len(backend.streamed) == 1 and dst.has_tenant(1) and _on_card([dst])
    after = _fleet_states([dst], [1])
    assert all(torch.equal(after[k], before[k]) for k in before)

    rng = np.random.RandomState(3)
    home = AUROC(pos_label=1)
    p = torch.from_numpy(rng.rand(4096).astype(np.float32)).to(cuda_device)
    home.update(p, (torch.from_numpy(rng.rand(4096).astype(np.float32)).to(cuda_device) < p).to(torch.int32))
    blob = envelope_to_bytes(tenant_envelope(home, 9, cursor=0))
    wire = backend.stream(torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(cuda_device))
    moved = AUROC(pos_label=1)
    assert adopt_into(moved, envelope_from_bytes(wire.cpu().numpy().tobytes())) == 0
    assert all(t.is_cuda for t in moved.preds) and torch.equal(moved.compute(), home.compute())


def test_fleet_migrate_behind_a_queued_serving_step_holds_the_drained_state_on_the_card(cuda_device, tmp_path):
    """A shard cohort served by an ``AsyncServingEngine`` whose worker stream
    holds a device sleep ahead of the step: a tenant migrated while that step
    is still queued on the card carries the state after ``drain()`` (the
    verb's reads are ordered after the worker's stream), equal to a twin
    stepped in order; so does the source's committed generation."""
    from metrics_tpu_torch.fleet import FleetPlacement, FleetShard, MigrationCoordinator
    from metrics_tpu_torch.serving import AsyncServingEngine

    keys = list(range(64))
    src, dst, twin = (FleetShard(nm, MeanSquaredError(), tmp_path / nm) for nm in ("src", "dst", "twin"))
    for sh in (src, twin):
        sh.add_tenants(keys)
        sh.submit_wave(0, keys, *_fleet_wave(keys, 0))
    coord = MigrationCoordinator(FleetPlacement(["src", "dst"]), [src, dst])
    pipe = AsyncServingEngine(src.cohort)
    try:
        for step in (1, 2):
            wave = [torch.from_numpy(a).to(cuda_device) for a in _fleet_wave(keys, step)]
            if step == 2:  # the worker's step waits behind about 150 ms of card time
                with torch.cuda.stream(pipe._worker_stream()):
                    torch.cuda._sleep(300_000_000)
            pipe.forward(*wave)
            twin.cohort(*wave)
        assert pipe.stats["inline_steps"] == 1
        deadline = time.monotonic() + 30.0
        while pipe._outstanding and time.monotonic() < deadline:  # the step is enqueued, not run
            time.sleep(0.001)
        assert not pipe._last_done.query(), "the worker's step finished before the handoff began"
        coord.migrate(0, "dst")
    finally:
        pipe.close()
    assert dst.has_tenant(0) and not src.has_tenant(0) and _on_card([src, dst])
    want = _fleet_states([twin], keys)
    got = _fleet_states([src, dst], keys)
    assert all(torch.equal(got[k], want[k]) for k in want)
    restored = FleetShard("src", MeanSquaredError(), tmp_path / "src")
    assert restored.restore() and _on_card([restored])
    got = _fleet_states([restored], keys[1:])
    assert all(torch.equal(got[k], want[k]) for k in got)


# ---------------------------------------------------------------------------
# the fleet-protocol explorers with every shard's cohort on the card
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _reopened_on(device_type):
    """Count the shards the explorers rebuild and check each one's cohort
    lies on ``device_type``."""
    from metrics_tpu_torch.analysis import protocol

    real, seen = protocol._reopen, {"shards": 0, "off": 0}

    def reopen(*args, **kwargs):
        shards = real(*args, **kwargs)
        for sh in shards.values():
            seen["shards"] += 1
            seen["off"] += sum(v.device.type != device_type for d in sh.cohort._states.values() for v in d.values())
        return shards

    protocol._reopen = reopen
    try:
        yield seen
    finally:
        protocol._reopen = real


def test_protocol_explorers_on_the_card_equal_the_cpu_coverage(cuda_device):
    from metrics_tpu_torch.analysis.protocol import (
        build_protocol_entry,
        explore_crash_consistency,
        explore_fencing,
        load_protocol_baseline,
    )

    with _reopened_on("cuda") as seen:
        crash, crash_findings = explore_crash_consistency(device="cuda")
        fence, fence_findings = explore_fencing(device="cuda")
    assert crash_findings == [] and fence_findings == []
    assert seen["shards"] > 0 and seen["off"] == 0
    cpu_crash, _ = explore_crash_consistency(device="cpu")
    cpu_fence, _ = explore_fencing(device="cpu")
    entries = load_protocol_baseline()["entries"]
    for card, cpu, name in ((crash, cpu_crash, "crash_consistency"), (fence, cpu_fence, "fencing")):
        assert build_protocol_entry(card) == build_protocol_entry(cpu) == entries[name]
    assert crash["crash_points"] == cpu_crash["crash_points"]


def test_protocol_fixtures_on_the_card_trip_exactly_their_rules(cuda_device):
    from metrics_tpu_torch.analysis import fixtures as fx
    from metrics_tpu_torch.analysis.program import hint_for_watch_key
    from metrics_tpu_torch.analysis.protocol import (
        counterexample_report,
        explore_crash_consistency,
        explore_fencing,
        load_protocol_baseline,
    )

    entries = load_protocol_baseline()["entries"]
    runs = {
        "GcBeforeDurableCoordinator": lambda device: explore_crash_consistency(
            coordinator_cls=fx.GcBeforeDurableCoordinator, device=device),
        "UnfencedCheckpointShard": lambda device: explore_fencing(shard_cls=fx.UnfencedCheckpointShard, device=device),
    }
    for name, run in runs.items():
        _, cpu = run("cpu")
        _, card = run("cuda")
        assert {f.rule for f in card} == {entries[name]["expected_rule"]}
        assert len(card) == len(cpu) >= entries[name]["min_violations"]
        assert counterexample_report(card).split("\n[1]")[0] == counterexample_report(cpu).split("\n[1]")[0]
        assert entries[name]["expected_rule"] in hint_for_watch_key(name)


# ---------------------------------------------------------------------------
# the program audit and the distributed-equivalence pass on the card
# ---------------------------------------------------------------------------
def _abstract_families(device):
    rng = np.random.RandomState(0x7B0)
    probs = rng.rand(32, 4).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    mc = (torch.from_numpy(probs).to(device), torch.from_numpy(rng.randint(4, size=32)).to(device))
    binary = (mc[0][:, 1].contiguous(), torch.from_numpy(rng.randint(2, size=32)).to(device))
    reg = (torch.from_numpy(rng.rand(32).astype(np.float32)).to(device),) * 2
    return [
        (MeanSquaredError(device=device), reg),
        (Precision(num_classes=4, average="macro", device=device), mc),
        (BinnedAUROC(num_bins=16, device=device), binary),
    ]


def test_abstract_steps_on_the_card_launch_and_allocate_nothing(cuda_device):
    """``abstract_step`` and ``abstract_cohort_step`` on card metrics trace
    fake tensors of the card: no kernel, no copy (an agreed trace of the
    call beside one marker kernel holds the marker alone), no device
    allocation, no signature built."""
    marker = torch.zeros(1, device=cuda_device)

    def ops(fn):
        prof = _steady_profile(lambda: (marker.add_(1), fn()))
        names = [e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        return sum(1 for n in names if n.lower().startswith(("memcpy", "memset"))), len(names)

    alone = ops(lambda: None)
    for metric, args in _abstract_families(cuda_device):
        engine = CompiledStepEngine(metric)
        for trace in (lambda: engine.abstract_step(*args), lambda: engine.abstract_cohort_step(*args, capacity=4)):
            trace()  # a first trace: lazy imports and registrations
            gc.collect()  # other tests' garbage: no free of it may count
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            gc.disable()
            try:
                graph, out, n = trace()
            finally:
                gc.enable()
            assert torch.cuda.memory_allocated() == before == torch.cuda.max_memory_allocated()
            assert ops(trace) == alone, type(metric).__name__
            assert all(v.device.type == "cuda" for v in out[0]["metric"].values())
        assert engine.cache_info()["compiled_signatures"] == 0 and engine.trace_count == 0


def _registry_verdicts(report):
    def rules(entry, bucket):
        return sorted((f["rule"], f["subject"]) for f in entry[bucket])

    return {
        fam: (
            e["engine_eligible"],
            rules(e, "findings"),
            rules(e, "suppressed"),
            None if e["distributed"] is None else (
                e["distributed"]["replicas"],
                e["distributed"]["bit_identical"],
                (e["distributed"].get("topology") or {}).get("bit_identical"),
            ),
            report["fingerprints"].get(fam),
        )
        for fam, e in report["families"].items()
    }


_REPORTS = {}


def _registry_reports():
    """The registry audit on the card and on the CPU, run once for the
    tests that read them."""
    from metrics_tpu_torch.analysis import audit_registry

    if not _REPORTS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for device in ("cuda", "cpu"):
                _REPORTS[device] = audit_registry(device=device, quantized=True, cohort=True, fingerprints=True)
    return _REPORTS["cuda"], _REPORTS["cpu"]


def test_audit_registry_on_the_card_equals_the_cpu(cuda_device):
    card, cpu = _registry_reports()
    assert card["summary"] == cpu["summary"] and card["summary"]["findings"] == 0
    assert card["summary"]["families"] == 89
    card_v, cpu_v = _registry_verdicts(card), _registry_verdicts(cpu)
    assert sorted(card_v) == sorted(cpu_v)
    differ = {}
    for fam, got in card_v.items():
        want = cpu_v[fam]
        if got == want:
            continue
        # log1p sums: the bit-identity verdicts may need the 8-ulp allowance on one device only
        ulp_only = (fam.split("@")[0] == "MeanSquaredLogError" and got[:3] + got[4:] == want[:3] + want[4:]
                    and got[3][0] == want[3][0])
        if not ulp_only:
            differ[fam] = (got, want)
    assert not differ, differ


def test_pass4_evidence_on_the_card_equals_the_baseline(cuda_device):
    """The card's seam budgets are the committed ``SEAM_BASELINE.json``'s,
    family by family (80: 20 bases, 20 @cohort, 20 @int8, 20 @bf16), and
    every engine-eligible family is proven double-buffer safe, as on the
    CPU."""
    from metrics_tpu_torch.analysis import flatten_seam_budget, load_seam_baseline

    card, cpu = _registry_reports()
    baseline = load_seam_baseline()
    seams = {f: e["evidence"]["host_seam"] for f, e in card["families"].items() if e["evidence"].get("host_seam")}
    assert len(seams) == 80
    for fam, seam in seams.items():
        assert flatten_seam_budget(seam) == baseline[fam]["budget"] and seam["states"] == baseline[fam]["states"], fam
        db, cpu_db = card["families"][fam]["evidence"]["double_buffer"], cpu["families"][fam]["evidence"]["double_buffer"]
        assert db == cpu_db and db["safe"] is True and db["hazards"] == [], fam
        assert cpu["families"][fam]["evidence"]["host_seam"] == seam, fam
    assert all(set(e["evidence"]) == {"numerics"} for e in card["families"].values() if not e["engine_eligible"])
    assert card["host_seam_sites"] == cpu["host_seam_sites"]


def test_pass5_evidence_on_the_card_equals_the_cpu(cuda_device):
    """Pass 5 on the card: every entry's horizons, cancellation sites,
    float64 verdict, skipped probes and equivariance verdict are the CPU
    twin's; the horizons equal ``NUMERICS_BASELINE.json``'s, and every
    measured budget is at or under its committed one (R2Score's, whose
    allow records why, excepted)."""
    from metrics_tpu_torch.analysis.numerics import load_numerics_baseline

    card, cpu = _registry_reports()
    base = load_numerics_baseline()
    for fam, entry in card["families"].items():
        ev, twin = entry["evidence"]["numerics"], cpu["families"][fam]["evidence"]["numerics"]
        assert ev["horizons"] == twin["horizons"], fam
        assert ev["equivariance"] == twin["equivariance"], fam
        got, want = ev["cancellation"], twin["cancellation"]
        assert got["sites"] == want["sites"], fam
        assert got.get("float64") == want.get("float64") and got.get("skipped") == want.get("skipped"), fam
        assert (got["budget"] is None) == (want["budget"] is None), fam
        for state, h in base[fam]["horizons"].items():
            assert (ev["horizons"][state]["kind"], ev["horizons"][state]["rows"]) == (h["kind"], h["rows"]), fam
        if got["budget"] is not None and fam.split("@")[0] != "R2Score":
            assert got["budget"] <= base[fam]["error_budget"], (fam, got["budget"])
    assert card["summary"] == {"families": 89, "findings": 0, "suppressed": 100}


def test_float64_oracle_leg_runs_in_float64_on_the_card(cuda_device):
    """The oracle leg's states and value are float64 on the card too, and
    the measured budgets are the CPU's: f32-epsilon scale for a plain sum
    (the card's rounding differs), every digit lost for the cancellation."""
    from metrics_tpu_torch.analysis import numerics as num

    x = np.linspace(0.0, 1.0, 8).astype(np.float32)
    for name in ("SeamRegressor", "CancellingVariance"):
        from metrics_tpu_torch.analysis import fixtures as fx

        probe = (torch.from_numpy(x).to(cuda_device, torch.float64),)
        value = num._float64_leg(getattr(fx, name)(device=cuda_device), probe)
        assert value.dtype == torch.float64 and value.device.type == "cuda", name
        card = num.measure_error_budget(getattr(fx, name)(device=cuda_device), (torch.from_numpy(x).to(cuda_device),))
        cpu = num.measure_error_budget(getattr(fx, name)(device="cpu"), (torch.from_numpy(x),))
        assert card["float64"] is cpu["float64"] is True and "skipped" not in card, name
        if name == "SeamRegressor":
            assert card["budget"] < 1e-5 and cpu["budget"] < 1e-5
        else:
            assert card["budget"] == cpu["budget"] == 1.0


def test_numerics_fixtures_on_the_card(cuda_device):
    """``Int32RowCounter``'s lifted row count is a point on the card (its
    horizon is 2^31 - 1 rows), and ``EpsilonThresholdAUROC`` is bit-stable
    at 0.5 and not at 2^-10 there."""
    from metrics_tpu_torch.analysis import audit_metric
    from metrics_tpu_torch.analysis import fixtures as fx
    from metrics_tpu_torch.analysis.numerics import state_horizons

    x = (torch.linspace(0.0, 1.0, 8, device=cuda_device),)
    assert state_horizons(fx.Int32RowCounter(device=cuda_device), x, {})["rows"]["rows"] == 2.0 ** 31 - 1
    result = audit_metric(fx.EpsilonThresholdAUROC(device=cuda_device), x)
    assert {f.rule for f in result.findings} == {"MTA012"}
    scales = {s["scale"]: s["bit_stable"] for s in result.evidence["numerics"]["equivariance"]["scales"]}
    assert scales == {0.5: True, 2.0 ** -10: False}


def test_two_generation_traces_on_the_card_hold_no_hazard(cuda_device):
    """``abstract_double_buffer_step`` and the cohort's
    ``abstract_double_buffer`` on card metrics: fake tensors of the card,
    no device allocation, no signature built, and no hazard in the
    two-generation graph."""
    from metrics_tpu_torch import MetricCohort
    from metrics_tpu_torch.analysis import composed_generation_hazards

    for metric, args in _abstract_families(cuda_device):
        engine = CompiledStepEngine(metric)
        cohort = MetricCohort(metric.clone(), tenants=4)
        for trace in (lambda: engine.abstract_double_buffer_step(*args), lambda: cohort.abstract_double_buffer(*args)):
            trace()  # a first trace: lazy imports and registrations
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            gc.disable()
            try:
                graph, out, n_donated, n_state = trace()
            finally:
                gc.enable()
            assert torch.cuda.memory_allocated() == before == torch.cuda.max_memory_allocated()
            assert composed_generation_hazards(graph, n_donated, n_state) == [], type(metric).__name__
            assert n_state == n_donated and all(v.device.type == "cuda" for v in out[2]["metric"].values())
        assert engine.cache_info()["compiled_signatures"] == 0 and engine.trace_count == 0
        assert cohort.cache_info()["compiled_signatures"] == 0


def test_traced_double_buffer_verdict_holds_after_a_real_replay(cuda_device):
    """What the prover says of the step graph holds of a real CUDA graph:
    after its build and after a replay, the installed states share no
    storage with the graph's static buffers, the defaults, each other or
    the returned value."""
    from metrics_tpu_torch.analysis import concurrency as conc

    for metric, args in _abstract_families(cuda_device):
        engine = CompiledStepEngine(metric, observe=False)
        defaults = {conc._storage(d) for d in metric._defaults.values()} - {None}
        for _ in range(2):
            value = engine(*args)
            states = [(s, getattr(metric, s)) for s in metric._defaults]
            assert conc.first_dispatch_hazards(states, conc.engine_owned(engine), defaults, value) == []
        assert len(engine.cache_info()["graph_build_ms"]) == 1, type(metric).__name__


def test_analysis_fixtures_on_the_card_trip_their_rules(cuda_device):
    from metrics_tpu_torch.analysis import audit_metric, hint_for_watch_key
    from metrics_tpu_torch.analysis import fixtures as fx

    x = np.linspace(0.0, 1.0, 8).astype(np.float32)
    for name in ("NarrowAccumulator", "SuppressedNarrowAccumulator", "CallbackInJit", "HostSyncUpdate",
                 "DonatedAlias", "NonCommutativeMerge", "MeanWithoutCount", "UnscaledInt8Psum",
                 "ReplicaDependentCount", "NonIdentityReset", "ComputeMutatesState", "OrphanResidual",
                 "UntouchedStatePassthrough", "UnownedLoader", "StaleSuppression", "SeamRegressor",
                 "DoubleBufferAliaser", "HostReadOfDonated", "Int32RowCounter", "CancellingVariance",
                 "EpsilonThresholdAUROC", "BlockScaledQuantizedSync"):
        results = [audit_metric(getattr(fx, name)(device=d), (torch.from_numpy(x).to(d),)) for d in ("cpu", "cuda")]
        cpu, card = ({(f.rule, f.subject, f.suppressed) for f in r.findings + r.suppressed} for r in results)
        # the quantized probe's positive control trips nothing
        assert card == cpu and bool(card) == (name != "BlockScaledQuantizedSync"), name
    engine = CompiledStepEngine(fx.NarrowAccumulator(device=cuda_device))
    audit_metric(fx.NarrowAccumulator(device=cuda_device), (torch.from_numpy(x).to(cuda_device),))
    assert "MTA001" in hint_for_watch_key(engine._watch_key)


# ---------------------------------------------------------------------------
# MetricSan on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def san_disarmed_after():
    from metrics_tpu_torch.analysis.sanitizer import disable_san
    from metrics_tpu_torch.metric import Metric

    yield
    disable_san()
    assert "__setattr__" not in Metric.__dict__


def test_metricsan_reset_probe_survives_the_first_build_on_the_card(cuda_device, san_disarmed_after):
    """Armed before the first build of a compiled collection holding a
    non-identity reset: the resets inside the warm-up (sync debug mode
    "error") and the capture are not probed and leave the class unprobed,
    the replays equal an unarmed twin's, and the first eager ``reset()``
    still reports its one MTA006."""
    from metrics_tpu_torch.analysis import fixtures as fx
    from metrics_tpu_torch.analysis import san_scope

    class FusedNonIdentityReset(fx.NonIdentityReset):
        _fused_forward = True  # engine-eligible: its resets run inside the build

    x = torch.linspace(0.0, 1.0, 64, device=cuda_device)

    def run(col):
        outs = [col(x * (i + 1))["bad"] for i in range(3)]
        return outs, col.compute()["bad"]

    twin = run(MetricCollection({"bad": FusedNonIdentityReset(device=cuda_device)}, compiled=True))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with san_scope() as san:
            col = MetricCollection({"bad": FusedNonIdentityReset(device=cuda_device)}, compiled=True)
            armed = run(col)
            assert col._engine.trace_count == 1 and not col._engine.eager_fallbacks
            assert san.violations == []
            col.reset()
    assert [(v["rule"], v["check"], v["subject"]) for v in san.violations] == [
        ("MTA006", "non_identity_reset", "FusedNonIdentityReset.acc")
    ]
    for a, b in zip(armed[0] + [armed[1]], twin[0] + [twin[1]]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("form", ["free", "graph"])
def test_metricsan_donation_injectors_on_the_card(cuda_device, san_disarmed_after, tmp_path, form):
    """Each form of ``donation_unsafe_engine`` on a CUDA graph: exactly one
    MTA007 and one flight dump; a healthy replay before it none."""
    import glob
    import json

    from metrics_tpu_torch import MeanSquaredError
    from metrics_tpu_torch.analysis import san_scope
    from metrics_tpu_torch.observability import flight
    from metrics_tpu_torch.reliability import faultinject

    x = torch.linspace(0.0, 1.0, 64, device=cuda_device)
    with flight.flight_scope(tmp_path), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with san_scope() as san:
            m = MeanSquaredError(device=cuda_device)
            engine = CompiledStepEngine(m)
            engine.step(x, x * 0.5)
            engine.step(x, x * 0.5)
            assert engine.trace_count == 1 and san.violations == []
            with faultinject.donation_unsafe_engine(form):
                engine.step(x, x * 0.5)
            torch.cuda.synchronize()
    assert [(v["rule"], v["subject"]) for v in san.violations] == [("MTA007", "MeanSquaredError")]
    assert ("captured graph" in san.violations[0]["message"]) == (form == "graph")
    dumps = glob.glob(str(tmp_path / "flight-*.json"))
    assert len(dumps) == 1
    payload = json.loads(open(dumps[0]).read())
    assert payload["reason"] == "metricsan_use_after_donate" and "MTA007" in payload["hint"]


def test_lint_gate_on_the_card_matches_the_committed_fingerprints(cuda_device, tmp_path):
    """``scripts/torch_lint_metrics.py --device cuda --skip-protocol``: green
    under ``--strict``, and its digests equal ``FINGERPRINTS_TORCH.json``
    (written on the CPU: the digests carry no device)."""
    import importlib.util
    import json
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("torch_lint_metrics_on_card",
                                                  os.path.join(repo, "scripts", "torch_lint_metrics.py"))
    lm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lm)
    report = tmp_path / "ANALYSIS_TORCH.json"
    rc = lm.main(["--device", "cuda", "--skip-protocol", "--strict", "--diff-fingerprints", "--json", str(report)])
    out = json.loads(report.read_text())
    assert rc == 0 and out["summary"] == {"unsuppressed_findings": 0}
    with open(os.path.join(repo, "FINGERPRINTS_TORCH.json")) as fh:
        assert out["fingerprints"] == json.load(fh)["fingerprints"]
    assert out["fingerprint_drift"] == 0
