"""The port's curve family against the JAX package, on the CPU.

``auc``, ``roc``, ``precision_recall_curve`` (functional and modules), the
AUROC/AP branches the JAX package computes on its curve path (``max_fpr``,
``sample_weights``, multi-label ``micro``, the curve canonicalization's
errors) and the normalization at tiny weight totals. The same seeded numpy
inputs (a few hundred rows, at most 5 classes) go through both packages;
the JAX package runs its CPU path.

Tolerances: unweighted curves have equal lengths and thresholds and values
within 1e-6; weighted ones within 1e-5 (the JAX package sums weights in
float32, the port in float64); scalars within 1e-5. Errors are compared
message for message.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
from metrics_tpu.functional import auc as jax_auc
from metrics_tpu.functional import auroc as jax_auroc
from metrics_tpu.functional import average_precision as jax_average_precision
from metrics_tpu.functional import precision_recall_curve as jax_precision_recall_curve
from metrics_tpu.functional import roc as jax_roc
from metrics_tpu_torch import AUC, ROC, PrecisionRecallCurve
from metrics_tpu_torch.functional import auc, auroc, average_precision, precision_recall_curve, roc
from metrics_tpu_torch.functional.classification.precision_recall_curve import _binary_clf_curve
from metrics_tpu_torch.interop import state_from_jax
from metrics_tpu_torch.ops.tie_scan import auroc_ap_from_stats, tie_group_reduce
from metrics_tpu_torch.ops.auroc_kernel import _co_sort

CPU = "cpu"
CURVE_TOL = 1e-6
WEIGHTED_TOL = 1e-5
SCALAR_TOL = 1e-5


def _tt(a):
    return torch.from_numpy(np.array(a))


def _error(fn, *args, **kwargs):
    with pytest.raises(Exception) as info:
        fn(*args, **kwargs)
    return type(info.value).__name__, str(info.value)


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


def _assert_curve(got, want, tol):
    """One curve, or per-class lists of them: ``(a, b, thresholds)``; equal
    lengths and thresholds, the two value arrays within ``tol``."""
    assert len(got) == len(want) == 3
    if isinstance(want[0], list):
        assert all(isinstance(g, list) and len(g) == len(w) for g, w in zip(got, want))
        for c in range(len(want[0])):
            _assert_curve([g[c] for g in got], [w[c] for w in want], tol)
        return
    for g, w in zip(got[:2], want[:2]):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol, equal_nan=True)
    # equal thresholds; float64 scores (which the JAX package, without x64,
    # holds in float32) round the ROC's opening ``top + 1`` otherwise
    rtol = 1e-7 if got[2].dtype == torch.float64 else 0
    np.testing.assert_allclose(got[2].double().numpy(), np.asarray(want[2], np.float64), rtol=rtol, atol=0,
                               equal_nan=True)


def _binary(n, seed, kind="random"):
    rng = np.random.default_rng(seed)
    preds = rng.random(n).astype(np.float32)
    if kind == "ties":
        preds = np.round(preds * 8) / 8
    target = (rng.random(n) < preds).astype(np.int64)
    if kind == "signed_zeros":
        preds[::3] = np.where(np.arange(len(preds[::3])) % 2, np.float32(0.0), np.float32(-0.0))
    if kind == "nan":
        preds[::11] = np.nan
        preds[5::13] = np.inf
    if kind == "int":
        preds = np.round(preds * 6).astype(np.int64)
    if kind == "f64":
        preds = preds.astype(np.float64)  # f32 values: the JAX package (no x64) reads the same scores
    return preds.astype(preds.dtype), target


def _multiclass(n, c, seed):
    rng = np.random.default_rng(seed)
    logits = np.round(rng.standard_normal((n, c)), 1)
    e = np.exp(logits - logits.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32), rng.integers(0, c, n)


def _multilabel(n, c, seed):
    rng = np.random.default_rng(seed)
    target = rng.integers(0, 2, (n, c))
    target[:2] = [[0] * c, [1] * c]  # every label has both classes
    return np.round(rng.random((n, c)) + 0.3 * target, 2).astype(np.float32), target


def _weights(n, seed):
    return np.random.default_rng(seed).lognormal(size=n).astype(np.float32)


# ---- auc ---------------------------------------------------------------------


@pytest.mark.parametrize(
    "x, y, reorder",
    [([0, 1, 2, 3], [0, 1, 2, 2], False), ([3, 2, 1, 0], [2, 2, 1, 0], False),
     ([0.0, 0.5, 0.5, 1.0], [0.1, 0.2, 0.7, 0.9], False), ([2, 0, 3, 1], [1, 0, 3, 1], True),
     ([0.3, 0.1, 0.1, 0.9, 0.5], [0.2, 0.4, 0.1, 0.8, 0.5], True)],
    ids=["increasing", "decreasing", "vertical-step", "reorder-int", "reorder-ties"],
)
def test_auc_matches_jax(x, y, reorder):
    x, y = np.asarray(x), np.asarray(y)
    got = auc(_tt(x), _tt(y), reorder=reorder)
    want = jax_auc(jnp.asarray(x), jnp.asarray(y), reorder=reorder)
    assert got.shape == ()
    assert abs(float(got) - float(want)) < SCALAR_TOL


@pytest.mark.parametrize(
    "x, y",
    [(np.zeros((2, 2)), np.zeros(4)), (np.arange(4), np.arange(5)), (np.array([0, 2, 1, 3]), np.arange(4))],
    ids=["not-1d", "sizes-differ", "not-monotone"],
)
def test_auc_errors_match_jax(x, y):
    assert _error(auc, _tt(x), _tt(y)) == _error(jax_auc, jnp.asarray(x), jnp.asarray(y))


def test_auc_reorder_integrates_every_point():
    """A deliberate difference: the JAX package's stable sort keeps its
    first 2049 points, so over 3,000 points it reads 2048.0; the port sorts
    every point and equals numpy's trapezoid."""
    x = np.random.default_rng(1).permutation(3000).astype(np.float32)
    y = np.ones(3000, np.float32)
    got = float(auc(_tt(x), _tt(y), reorder=True))
    order = np.argsort(x, kind="stable")
    assert got == float(np.trapezoid(y[order], x[order])) == 2999.0
    assert float(jax_auc(jnp.asarray(x), jnp.asarray(y), reorder=True)) == 2048.0


def test_auc_module_over_batches_matches_jax():
    rng = np.random.default_rng(2)
    x = np.sort(rng.random(120)).astype(np.float32)
    y = rng.random(120).astype(np.float32)
    ours, ref = AUC(device=CPU), jm.AUC()
    for sl in (slice(0, 50), slice(50, 90), slice(90, 120)):
        step, want_step = ours(_tt(x[sl]), _tt(y[sl])), ref(jnp.asarray(x[sl]), jnp.asarray(y[sl]))
        assert abs(float(step) - float(want_step)) < SCALAR_TOL
    assert abs(float(ours.compute()) - float(ref.compute())) < SCALAR_TOL


# ---- roc / precision_recall_curve --------------------------------------------

BINARY_KINDS = ["random", "ties", "signed_zeros", "nan", "int", "f64"]


@pytest.mark.parametrize("kind", BINARY_KINDS)
@pytest.mark.parametrize("curve", ["roc", "prc"])
def test_binary_curve_matches_jax(curve, kind):
    preds, target = _binary(300, seed=len(kind), kind=kind)
    ours, ref = (roc, jax_roc) if curve == "roc" else (precision_recall_curve, jax_precision_recall_curve)
    got = _quiet(ours, _tt(preds), _tt(target), pos_label=1)
    want = _quiet(ref, jnp.asarray(preds), jnp.asarray(target), pos_label=1)
    _assert_curve(got, want, CURVE_TOL)
    assert got[2].dtype == _tt(preds).dtype  # thresholds keep the scores' dtype


@pytest.mark.parametrize("kind", ["random", "ties", "nan"])
@pytest.mark.parametrize("curve", ["roc", "prc"])
def test_weighted_binary_curve_matches_jax(curve, kind):
    preds, target = _binary(300, seed=7 + len(kind), kind=kind)
    w = _weights(300, 3)
    w[::7] = 0.0  # zero weights are inert
    ours, ref = (roc, jax_roc) if curve == "roc" else (precision_recall_curve, jax_precision_recall_curve)
    got = ours(_tt(preds), _tt(target), pos_label=1, sample_weights=_tt(w))
    want = ref(jnp.asarray(preds), jnp.asarray(target), pos_label=1, sample_weights=jnp.asarray(w))
    _assert_curve(got, want, WEIGHTED_TOL)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("curve", ["roc", "prc"])
def test_multiclass_curves_match_jax(curve, weighted):
    preds, target = _multiclass(240, 5, seed=11)
    w = _weights(240, 12) if weighted else None
    ours, ref = (roc, jax_roc) if curve == "roc" else (precision_recall_curve, jax_precision_recall_curve)
    got = ours(_tt(preds), _tt(target), num_classes=5, sample_weights=None if w is None else _tt(w))
    want = ref(jnp.asarray(preds), jnp.asarray(target), num_classes=5,
               sample_weights=None if w is None else jnp.asarray(w))
    _assert_curve(got, want, WEIGHTED_TOL if weighted else CURVE_TOL)


def test_multilabel_and_multidim_roc_match_jax():
    preds, target = _multilabel(200, 4, seed=13)
    _assert_curve(roc(_tt(preds), _tt(target), num_classes=4),
                  jax_roc(jnp.asarray(preds), jnp.asarray(target), num_classes=4), CURVE_TOL)
    rng = np.random.default_rng(14)
    mdmc = rng.random((30, 3, 6)).astype(np.float32)
    mdmc_t = rng.integers(0, 3, (30, 6))
    _assert_curve(roc(_tt(mdmc), _tt(mdmc_t), num_classes=3),
                  jax_roc(jnp.asarray(mdmc), jnp.asarray(mdmc_t), num_classes=3), CURVE_TOL)
    _assert_curve(precision_recall_curve(_tt(mdmc), _tt(mdmc_t), num_classes=3),
                  jax_precision_recall_curve(jnp.asarray(mdmc), jnp.asarray(mdmc_t), num_classes=3), CURVE_TOL)


@pytest.mark.parametrize(
    "fn, preds, target, kwargs",
    [
        ("roc", np.ones(8, np.float32), np.ones(8, np.int64), {}),
        ("roc", np.ones(8, np.float32), np.zeros(8, np.int64), {}),
        ("roc", *_multiclass(60, 4, seed=15), {}),
        ("roc", *_multiclass(60, 4, seed=15), {"num_classes": 3}),
        ("prc", *_multilabel(60, 4, seed=16), {"num_classes": 4}),
        ("roc", np.ones((2, 3, 4), np.float32), np.ones(2, np.int64), {}),
        ("roc", np.linspace(0, 1, 8).astype(np.float32), np.array([0, 1] * 4), {"sample_weights": [1.0] * 7}),
    ],
    ids=["no-negatives", "no-positives", "mc-num-classes-unset", "mc-num-classes-differs", "prc-multilabel",
         "bad-ndim", "weights-shape"],
)
def test_curve_errors_match_jax(fn, preds, target, kwargs):
    ours, ref = (roc, jax_roc) if fn == "roc" else (precision_recall_curve, jax_precision_recall_curve)
    got = _quiet(_error, ours, _tt(preds), _tt(target), **kwargs)
    if "sample_weights" in kwargs:
        # the JAX package reads past the weights it was given; the port refuses them
        assert got == ("ValueError", "expected 1-d sample_weights of shape (8,), got (7,)")
        return
    assert got == _quiet(_error, ref, jnp.asarray(preds), jnp.asarray(target), **kwargs)


def test_weighted_class_without_weight_raises_like_jax():
    preds, target = _binary(40, seed=17)
    w = np.where(target == 1, 0.0, 1.0).astype(np.float32)  # positives weigh nothing
    assert _error(roc, _tt(preds), _tt(target), pos_label=1, sample_weights=_tt(w)) == _error(
        jax_roc, jnp.asarray(preds), jnp.asarray(target), pos_label=1, sample_weights=jnp.asarray(w))


def test_binary_clf_curve_counts_are_int32_and_exact():
    preds, target = _binary(500, seed=18, kind="ties")
    fps, tps, thresholds = _binary_clf_curve(_tt(preds), _tt(target))
    assert fps.dtype == tps.dtype == torch.int32
    order = np.argsort(-preds, kind="stable")
    last = np.r_[preds[order][1:] != preds[order][:-1], True]
    np.testing.assert_array_equal(tps.numpy(), np.cumsum(target[order])[last])
    np.testing.assert_array_equal(fps.numpy(), np.cumsum(1 - target[order])[last])
    np.testing.assert_array_equal(thresholds.numpy(), preds[order][last])


@pytest.mark.parametrize(
    "module, jax_module, case",
    [(ROC, jm.ROC, "binary"), (ROC, jm.ROC, "multiclass"), (ROC, jm.ROC, "multilabel"),
     (PrecisionRecallCurve, jm.PrecisionRecallCurve, "binary"),
     (PrecisionRecallCurve, jm.PrecisionRecallCurve, "multiclass")],
    ids=["roc-binary", "roc-multiclass", "roc-multilabel", "prc-binary", "prc-multiclass"],
)
def test_curve_modules_over_batches_and_restore_match_jax(module, jax_module, case):
    if case == "binary":
        batches = [_binary(80, seed=20 + i) for i in range(3)]
        kwargs = {"pos_label": 1}
    elif case == "multiclass":
        batches = [_multiclass(80, 4, seed=30 + i) for i in range(3)]
        kwargs = {"num_classes": 4}
    else:
        batches = [_multilabel(80, 3, seed=40 + i) for i in range(3)]
        kwargs = {"num_classes": 3}
    ours, ref = _quiet(module, device=CPU, **kwargs), _quiet(jax_module, **kwargs)
    for p, t in batches:
        _assert_curve(_quiet(ours, _tt(p), _tt(t)), _quiet(ref, jnp.asarray(p), jnp.asarray(t)), CURVE_TOL)
    want = ref.compute()
    _assert_curve(ours.compute(), want, CURVE_TOL)
    # a JAX checkpoint restores here, num_classes and pos_label re-derived
    ref.persistent(True)
    state = {k: [np.asarray(x) for x in v] for k, v in ref.state_dict().items()}
    restore_kwargs = {} if case == "binary" else kwargs
    restored = _quiet(module, device=CPU, **restore_kwargs)
    restored.load_state_dict(state_from_jax(state), strict=True)
    jax_restored = _quiet(jax_module, **restore_kwargs)
    jax_restored.load_state_dict({k: [jnp.asarray(x) for x in v] for k, v in state.items()})
    assert (restored.num_classes, restored.pos_label) == (jax_restored.num_classes, jax_restored.pos_label)
    _assert_curve(restored.compute(), want, CURVE_TOL)


# ---- AUROC / AP branches on the JAX package's curve path --------------------

_MC_PREDS, _MC_TARGET = _multiclass(60, 4, seed=50)
_ML_PREDS, _ML_TARGET = _multilabel(60, 4, seed=51)
_BIN_PREDS, _BIN_TARGET = _binary(120, seed=52, kind="ties")
_W60 = _weights(60, 53)
_W120 = _weights(120, 54)


def _scores(x):
    return np.array([float(v) for v in x]) if isinstance(x, list) else np.atleast_1d(np.asarray(x, np.float64))


@pytest.mark.parametrize(
    "fn, preds, target, kwargs",
    [
        ("auroc", _BIN_PREDS, _BIN_TARGET, {"max_fpr": 0.1}),
        ("auroc", _BIN_PREDS, _BIN_TARGET, {"max_fpr": 0.35, "pos_label": 1}),
        ("auroc", _BIN_PREDS, _BIN_TARGET, {"max_fpr": 1.0}),
        ("auroc", _BIN_PREDS, _BIN_TARGET, {"max_fpr": 0.5, "sample_weights": _W120}),
        ("auroc", _BIN_PREDS, _BIN_TARGET, {"sample_weights": _W120}),
        ("auroc", _BIN_PREDS, 1 - _BIN_TARGET, {"pos_label": 0, "sample_weights": _W120}),
        ("auroc", _MC_PREDS, _MC_TARGET, {"num_classes": 4, "sample_weights": _W60}),
        ("auroc", _MC_PREDS, _MC_TARGET, {"num_classes": 4, "sample_weights": _W60, "average": "weighted"}),
        ("auroc", _MC_PREDS, _MC_TARGET, {"num_classes": 4, "sample_weights": _W60, "average": None}),
        ("auroc", _ML_PREDS, _ML_TARGET, {"num_classes": 4, "sample_weights": _W60, "average": "weighted"}),
        ("auroc", _ML_PREDS, _ML_TARGET, {"num_classes": 4, "average": "micro"}),
        ("ap", _BIN_PREDS, _BIN_TARGET, {"pos_label": 1, "sample_weights": _W120}),
        ("ap", _MC_PREDS, _MC_TARGET, {"num_classes": 4, "sample_weights": _W60}),
        ("auroc", _MC_PREDS, _MC_TARGET, {"num_classes": 4, "max_fpr": 0.5}),
        ("auroc", _BIN_PREDS, _BIN_TARGET, {"max_fpr": 0}),
    ],
    ids=["max-fpr-0.1", "max-fpr-0.35", "max-fpr-1", "max-fpr-weighted", "weighted", "weighted-pos-label-0",
         "mc-weighted", "mc-weighted-average", "mc-weighted-none", "ml-weighted", "ml-micro", "ap-weighted",
         "ap-mc-weighted", "mc-max-fpr", "max-fpr-0"],
)
def test_curve_path_branches_match_jax(fn, preds, target, kwargs):
    ours, ref = (auroc, jax_auroc) if fn == "auroc" else (average_precision, jax_average_precision)
    jax_kwargs = {k: jnp.asarray(v) if k == "sample_weights" else v for k, v in kwargs.items()}
    torch_kwargs = {k: _tt(v) if k == "sample_weights" else v for k, v in kwargs.items()}
    try:
        want = _quiet(ref, jnp.asarray(preds), jnp.asarray(target), **jax_kwargs)
    except ValueError as err:
        assert _quiet(_error, ours, _tt(preds), _tt(target), **torch_kwargs) == ("ValueError", str(err))
        return
    got = _quiet(ours, _tt(preds), _tt(target), **torch_kwargs)
    assert type(got) is type(want) if isinstance(want, list) else isinstance(got, torch.Tensor)
    np.testing.assert_allclose(_scores(got), _scores(want), rtol=0, atol=SCALAR_TOL, equal_nan=True)


def test_weighted_auroc_at_unit_weights_equals_the_unweighted_path():
    got = auroc(_tt(_MC_PREDS), _tt(_MC_TARGET), num_classes=4, sample_weights=torch.ones(60))
    assert abs(float(got) - float(auroc(_tt(_MC_PREDS), _tt(_MC_TARGET), num_classes=4))) < 1e-6


@pytest.mark.parametrize("bad", [-1.0, np.nan, np.inf])
def test_functional_weights_are_validated(bad):
    """A deliberate difference: the JAX package's functional path returns a
    value for negative or non-finite weights; the port raises."""
    w = np.ones(120, np.float32)
    w[3] = bad
    for fn in (auroc, average_precision, roc):
        with pytest.raises(ValueError, match="sample_weights must be non-negative finite"):
            fn(_tt(_BIN_PREDS), _tt(_BIN_TARGET), pos_label=1, sample_weights=_tt(w))


# ---- the normalization at tiny weight totals ---------------------------------


def _oracle_weighted_auroc(preds, rel, w):
    """Tie-corrected weighted AUROC in float64."""
    order = np.argsort(-preds, kind="stable")
    s, r, w = preds[order].astype(np.float64), rel[order], w[order].astype(np.float64)
    last = np.r_[s[1:] != s[:-1], True]
    tp, fp = np.cumsum(np.where(r, w, 0.0))[last], np.cumsum(np.where(r, 0.0, w))[last]
    tp_prev, fp_prev = np.r_[0.0, tp[:-1]], np.r_[0.0, fp[:-1]]
    return float(np.sum(0.5 * (tp + tp_prev) * (fp - fp_prev)) / tp[-1] / fp[-1])


@pytest.mark.parametrize("weight, tol", [(1e-16, 1e-6), (1e-20, 1e-5)])
def test_tiny_weight_totals_normalize_to_the_oracle_and_jax(weight, tol):
    preds = np.array([0.9, 0.1, 0.6, 0.3], np.float32)
    target = np.array([1, 0, 0, 1])
    w = np.full(4, weight, np.float32)
    oracle = _oracle_weighted_auroc(preds, target == 1, w)
    assert oracle == 0.75
    key_s, payload_s, weights_s = _co_sort(_tt(preds), _tt(target).float(), None, _tt(w))
    stats = tie_group_reduce(key_s, payload_s, weights_s=weights_s)
    assert abs(float(auroc_ap_from_stats(stats)[0]) - oracle) < tol
    got = auroc(_tt(preds), _tt(target), pos_label=1, sample_weights=_tt(w))
    assert abs(float(got) - oracle) < tol
    assert abs(float(got) - float(jax_auroc(jnp.asarray(preds), jnp.asarray(target), pos_label=1,
                                            sample_weights=jnp.asarray(w)))) < tol
