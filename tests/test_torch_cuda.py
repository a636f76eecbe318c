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
build failure that raises and demotes nothing).

Every test here is marked ``cuda`` and skips without a card. This file
imports neither JAX nor the JAX package, so it also runs on a machine that
has only PyTorch: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest`` because the suite's conftest pins JAX to the CPU).
"""
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


def _replay_kernels(cohort):
    """Kernels of one replay of the cohort's newest graph, by name (copies
    and fills not counted)."""
    from torch.profiler import ProfilerActivity, profile

    program = list(cohort._engine._compiled.values())[-1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        program.graph.replay()
        torch.cuda.synchronize()
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
