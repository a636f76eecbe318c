"""The port's binned curve metrics (``BinnedAUROC``, ``BinnedAveragePrecision``,
``BinnedPrecisionRecallCurve``) against the JAX package's, on the CPU.

The same seeded numpy batches go through both packages, binary and
one-vs-rest, unweighted and weighted. Unweighted histograms are equal
exactly; weighted ones within 1e-5 relative (the JAX package sums in
float32, the port in float64). Values within 1e-6.

Weighted totals below 1 are a deliberate difference: the JAX package
divides by ``max(total, 1)`` and the port by the total itself, so there the
port is held against a float64 evaluation of the histograms instead (and
weights scaled by 0.1 give the unit-weight value). Errors are compared
message for message.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
from metrics_tpu_torch import BinnedAUROC, BinnedAveragePrecision, BinnedPrecisionRecallCurve
from metrics_tpu_torch.interop import state_from_jax
from metrics_tpu_torch.ops.histogram import histogram_roc, score_histograms

CPU = "cpu"
TOL = 1e-6
HIST_RTOL = 1e-5
METRICS = [
    (BinnedAUROC, jm.BinnedAUROC),
    (BinnedAveragePrecision, jm.BinnedAveragePrecision),
    (BinnedPrecisionRecallCurve, jm.BinnedPrecisionRecallCurve),
]
IDS = ["auroc", "ap", "pr_curve"]


def _tt(a):
    return torch.from_numpy(np.array(a))


def _error(fn, *args, **kwargs):
    with pytest.raises(Exception) as info:
        fn(*args, **kwargs)
    return type(info.value).__name__, str(info.value)


def _binary_batches(seed, n=200, batches=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        p = rng.random(n).astype(np.float32)
        p[:3] = [0.0, 1.0, 0.5]  # the edge bins
        out.append((p, (rng.random(n) < p).astype(np.int64), (1.0 + rng.lognormal(size=n)).astype(np.float32)))
    return out


def _ovr_batches(seed, c=4, n=150, batches=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        logits = rng.standard_normal((n, c))
        p = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
        out.append((p, rng.integers(0, c, n), (1.0 + rng.lognormal(size=n)).astype(np.float32)))
    return out


def _assert_values(got, want, tol=TOL):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol, equal_nan=True)


def _run(ours, ref, batches, weighted, forward=False):
    steps = []
    for p, t, w in batches:
        kw, jkw = ({"sample_weights": _tt(w)}, {"sample_weights": jnp.asarray(w)}) if weighted else ({}, {})
        if forward:
            steps.append((ours(_tt(p), _tt(t), **kw), ref(jnp.asarray(p), jnp.asarray(t), **jkw)))
        else:
            ours.update(_tt(p), _tt(t), **kw)
            ref.update(jnp.asarray(p), jnp.asarray(t), **jkw)
    return steps


def _assert_histograms(ours, ref, weighted):
    for name in ("hist_pos", "hist_neg"):
        got, want = getattr(ours, name).numpy(), np.asarray(getattr(ref, name))
        if weighted:
            np.testing.assert_allclose(got, want, rtol=HIST_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("num_bins", [4, 64, 512])
@pytest.mark.parametrize("metric, jax_metric", METRICS, ids=IDS)
def test_binary_matches_jax(metric, jax_metric, num_bins, weighted):
    ours, ref = metric(num_bins=num_bins, device=CPU), jax_metric(num_bins=num_bins)
    steps = _run(ours, ref, _binary_batches(num_bins), weighted, forward=True)
    for got, want in steps:
        _assert_values(got, want)
    _assert_histograms(ours, ref, weighted)
    _assert_values(ours.compute(), ref.compute())


OVR_CASES = [(m, j, a) for m, j in METRICS[:2] for a in ("macro", "weighted", None)] + [(*METRICS[2], "macro")]


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("metric, jax_metric, average", OVR_CASES,
                         ids=[f"{i}-{a}" for i in IDS[:2] for a in ("macro", "weighted", None)] + ["pr_curve"])
def test_one_vs_rest_matches_jax(metric, jax_metric, average, weighted):
    kwargs = {"num_bins": 32, "num_classes": 4, "average": average}
    ours, ref = metric(device=CPU, **kwargs), jax_metric(**kwargs)
    _run(ours, ref, _ovr_batches(5), weighted)
    assert ours.hist_pos.shape == (4, 32)
    _assert_histograms(ours, ref, weighted)
    got, want = ours.compute(), ref.compute()
    _assert_values(got, want)


@pytest.mark.parametrize("metric, jax_metric", METRICS[:2], ids=IDS[:2])
def test_forward_with_absent_classes_matches_jax(metric, jax_metric):
    """A batch that lacks a class gives the batch-local average over the
    classes it holds, as in the JAX package; the epoch then has them all."""
    batches = _ovr_batches(6, c=4, n=40)
    for p, t, _ in batches[:2]:
        t[t == 3] = 2
    ours, ref = metric(num_bins=16, num_classes=4, device=CPU), jax_metric(num_bins=16, num_classes=4)
    for got, want in _run(ours, ref, batches, weighted=False, forward=True):
        _assert_values(got, want)
    _assert_values(ours.compute(), ref.compute())


def _float64_scores(hist_pos, hist_neg):
    """(AUROC, AP, precision, recall) of histograms, evaluated in float64."""
    tps = np.r_[0.0, np.cumsum(hist_pos[::-1].astype(np.float64))]
    fps = np.r_[0.0, np.cumsum(hist_neg[::-1].astype(np.float64))]
    tpr, fpr = tps / tps[-1], fps / fps[-1]
    precision = np.where(tps + fps > 0, tps / np.maximum(tps + fps, 1e-300), 1.0)
    return np.trapezoid(tpr, fpr), np.sum(np.diff(tpr) * precision[1:]), precision, tpr


def test_weight_totals_below_one_normalize_by_the_totals():
    """The deliberate difference: weights of 0.1 give the unit-weight values
    (JAX's BinnedAUROC reads 0.035 here, the unit-weight value is 0.875)."""
    p, t = np.array([0.1, 0.4, 0.35, 0.8], np.float32), np.array([0, 0, 1, 1])
    tenth = np.full(4, 0.1, np.float32)
    ours = BinnedAUROC(num_bins=4, device=CPU)
    ours.update(_tt(p), _tt(t), sample_weights=_tt(tenth))
    assert abs(float(ours.compute()) - 0.875) < TOL
    ref = jm.BinnedAUROC(num_bins=4)
    ref.update(jnp.asarray(p), jnp.asarray(t), sample_weights=jnp.asarray(tenth))
    assert abs(float(ref.compute()) - 0.035) < TOL
    # a whole stream with small weights, against a float64 evaluation of its histograms
    rng = np.random.default_rng(7)
    preds = rng.random(500).astype(np.float32)
    target = (rng.random(500) < preds).astype(np.int64)
    w = (1e-3 * rng.lognormal(size=500)).astype(np.float32)
    metrics = [m(num_bins=64, device=CPU) for m in (BinnedAUROC, BinnedAveragePrecision, BinnedPrecisionRecallCurve)]
    for m in metrics:
        m.update(_tt(preds), _tt(target), sample_weights=_tt(w))
    want_auroc, want_ap, want_precision, want_recall = _float64_scores(metrics[0].hist_pos.numpy(),
                                                                       metrics[0].hist_neg.numpy())
    assert abs(float(metrics[0].compute()) - want_auroc) < TOL
    assert abs(float(metrics[1].compute()) - want_ap) < TOL
    precision, recall, _ = metrics[2].compute()
    np.testing.assert_allclose(precision.numpy(), want_precision, rtol=0, atol=TOL)
    np.testing.assert_allclose(recall.numpy(), want_recall, rtol=0, atol=TOL)
    # and the same stream at 1000 times the weights gives the same values
    scaled = BinnedAUROC(num_bins=64, device=CPU)
    scaled.update(_tt(preds), _tt(target), sample_weights=_tt(w * 1000))
    assert abs(float(scaled.compute()) - float(metrics[0].compute())) < TOL


def test_histograms_match_numpy_counts():
    rng = np.random.default_rng(8)
    p = rng.random((300, 5)).astype(np.float32)
    t = rng.integers(0, 5, 300)
    w = rng.lognormal(size=300).astype(np.float32)
    bins = np.clip((p * np.float32(128)).astype(np.int64), 0, 127)
    rel = t[:, None] == np.arange(5)
    for weights in (None, w):
        hist_pos, hist_neg = score_histograms(_tt(p), _tt(rel), 128, None if weights is None else _tt(weights))
        ww = np.ones(300) if weights is None else weights.astype(np.float64)
        for c in range(5):
            want_pos = np.bincount(bins[rel[:, c], c], weights=ww[rel[:, c]], minlength=128)
            want_neg = np.bincount(bins[~rel[:, c], c], weights=ww[~rel[:, c]], minlength=128)
            np.testing.assert_allclose(hist_pos[c].numpy(), want_pos, rtol=HIST_RTOL if weights is not None else 0)
            np.testing.assert_allclose(hist_neg[c].numpy(), want_neg, rtol=HIST_RTOL if weights is not None else 0)


def test_histogram_roc_matches_jax():
    from metrics_tpu.ops.histogram import histogram_roc as jax_histogram_roc

    rng = np.random.default_rng(10)
    hist_pos = np.round(rng.random((3, 64)) * 10).astype(np.float32)
    hist_neg = np.round(rng.random((3, 64)) * 10).astype(np.float32)
    for c in range(3):
        got = histogram_roc(_tt(hist_pos[c]), _tt(hist_neg[c]))
        _assert_values(got, jax_histogram_roc(jnp.asarray(hist_pos[c]), jnp.asarray(hist_neg[c])))
    # rows at once, as the one-vs-rest metrics hold them
    rows = histogram_roc(_tt(hist_pos), _tt(hist_neg))
    assert rows[0].shape == (3, 65) and rows[2].shape == (65,)


def test_degenerate_streams_give_nan_like_jax():
    p = np.array([0.2, 0.7, 0.9], np.float32)
    for t in (np.zeros(3, np.int64), np.ones(3, np.int64)):
        for metric, jax_metric in METRICS[:2]:
            ours, ref = metric(num_bins=8, device=CPU), jax_metric(num_bins=8)
            ours.update(_tt(p), _tt(t))
            ref.update(jnp.asarray(p), jnp.asarray(t))
            _assert_values(ours.compute(), ref.compute())


@pytest.mark.parametrize(
    "kwargs, preds, target, update_kwargs",
    [
        ({"num_bins": 1}, None, None, {}),
        ({"num_bins": 8, "average": "micro"}, None, None, {}),
        ({"num_bins": 8}, np.array([0.1, 1.2], np.float32), np.array([0, 1]), {}),
        ({"num_bins": 8}, np.array([0.1, 0.2], np.float32), np.array([0, 2]), {}),
        ({"num_bins": 8}, np.array([0.1, 0.2], np.float32), np.array([0.0, 1.0], np.float32), {}),
        ({"num_bins": 8}, np.array([0.1, 0.2, 0.3], np.float32), np.array([0, 1]), {}),
        ({"num_bins": 8}, np.array([0.1, 0.2], np.float32), np.array([0, 1]), {"sample_weights": [1.0, 2.0, 3.0]}),
        ({"num_bins": 8}, np.array([0.1, 0.2], np.float32), np.array([0, 1]), {"sample_weights": [1.0, -2.0]}),
        ({"num_bins": 8, "num_classes": 3}, np.full((2, 3), 1 / 3, np.float32), np.array([0, 3]), {}),
        ({"num_bins": 8, "num_classes": 3}, np.full((2, 2), 0.5, np.float32), np.array([0, 1]), {}),
        ({"num_bins": 8, "num_classes": 3}, np.full((2, 3), 1.5, np.float32), np.array([0, 1]), {}),
    ],
    ids=["num-bins", "average", "not-probabilities", "target-not-binary", "float-target", "shapes-differ",
         "weights-size", "negative-weight", "label-out-of-range", "ovr-shape", "ovr-not-probabilities"],
)
def test_validation_errors_match_jax(kwargs, preds, target, update_kwargs):
    if preds is None:
        assert _error(BinnedAUROC, device=CPU, **kwargs) == _error(jm.BinnedAUROC, **kwargs)
        return
    ours, ref = BinnedAUROC(device=CPU, **kwargs), jm.BinnedAUROC(**kwargs)
    jax_kwargs = {k: jnp.asarray(v, jnp.float32) for k, v in update_kwargs.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _error(ref.update, jnp.asarray(preds), jnp.asarray(target), **jax_kwargs)
    assert _error(ours.update, _tt(preds), _tt(target), **update_kwargs) == want


@pytest.mark.parametrize("num_classes", [None, 3], ids=["binary", "ovr"])
def test_state_from_jax_restores_the_histograms(num_classes):
    batches = _binary_batches(9, batches=2) if num_classes is None else _ovr_batches(9, c=3, batches=2)
    ref = jm.BinnedAveragePrecision(num_bins=32, num_classes=num_classes)
    for p, t, w in batches:
        ref.update(jnp.asarray(p), jnp.asarray(t), sample_weights=jnp.asarray(w))
    ref.persistent(True)
    ours = BinnedAveragePrecision(num_bins=32, num_classes=num_classes, device=CPU)
    ours.load_state_dict(state_from_jax({k: np.asarray(v) for k, v in ref.state_dict().items()}), strict=True)
    _assert_values(ours.compute(), ref.compute())
