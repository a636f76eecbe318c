"""The port's stat-score family against the JAX package, on the CPU.

Inputs are made with numpy from a seed (the shapes of
``tests/classification/inputs.py``) and go through the JAX package (its CPU
path) and the port with ``device="cpu"``:

* ``stat_scores`` over binary, binary-prob, multi-label (and multi-dim),
  multi-class (labels and probabilities) and multi-dim multi-class inputs,
  crossed with ``reduce`` × ``mdmc_reduce`` × ``ignore_index`` × ``top_k`` ×
  ``threshold`` where the JAX package branches on them: counts exact;
* the label-space path against the canonical path on the same inputs,
  ``ignore_index`` and ``top_k`` (with ties in the top k) included: counts
  exact;
* ``precision``, ``recall``, ``fbeta`` / ``f1`` and their modules under every
  ``average`` × ``mdmc_average``, with and without ``ignore_index``: float32
  ratios within 1e-6; ``hamming_distance`` and ``dice_score`` within 1e-6;
* every bad argument and bad input raises the JAX package's error; a
  module's fused ``forward`` equals ``update`` + ``compute``; list states
  under ``samples`` / ``samplewise``; ``state_from_jax`` of each metric's JAX
  ``state_dict``; a 2-process gloo world syncing a sum-state and a list-state
  ``StatScores`` to the one-process value.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.functional as jf
from metrics_tpu.functional.classification.dice import _stat_scores as jax_dice_stat_scores
from metrics_tpu_torch import F1, FBeta, HammingDistance, Precision, Recall, StatScores
from metrics_tpu_torch.functional import (
    dice_score,
    f1,
    fbeta,
    hamming_distance,
    precision,
    precision_recall,
    recall,
    stat_scores,
)
from metrics_tpu_torch.functional.classification.dice import _stat_scores as dice_stat_scores
from metrics_tpu_torch.functional.classification.hamming_distance import _hamming_distance_update
from metrics_tpu_torch.functional.classification.stat_scores import (
    _stat_scores,
    _stat_scores_count,
    _stat_scores_fast_update,
)
from metrics_tpu_torch.interop import state_from_jax
from metrics_tpu_torch.ops.histogram import label_bincount
from metrics_tpu_torch.utilities.checks import _input_format_classification
from metrics_tpu_torch.utilities import env
from tests.classification import inputs
from tests.torch_workers import run_world, stat_scores_world

CPU = "cpu"
RATIO_TOL = 1e-6  # float32 ratios of exact counts: the same f32 divisions, summed in other orders
NUM_CLASSES = 5

CASES = {
    "binary_prob": inputs._input_binary_prob,
    "binary": inputs._input_binary,
    "multilabel_prob": inputs._input_multilabel_prob,
    "multilabel": inputs._input_multilabel,
    "mlmd_prob": inputs._input_multilabel_multidim_prob,
    "multiclass_prob": inputs._input_multiclass_prob,
    "multiclass": inputs._input_multiclass,
    "mdmc_prob": inputs._input_multidim_multiclass_prob,
    "mdmc": inputs._input_multidim_multiclass,
}


def _tt(a):
    return torch.from_numpy(np.array(a))


def _outcome(fn, *args, **kwargs):
    """``("ok", value)`` or ``("error", type name, message)``."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return ("ok", fn(*args, **kwargs))
    except Exception as err:  # compared with the other package's outcome
        return ("error", type(err).__name__, str(err))


def _assert_same(ours, ref, tol=0.0):
    """Both outcomes raise the same error, or give values equal within ``tol``
    (exactly when ``tol`` is 0), NaN where the JAX package has NaN."""
    if ref[0] == "error" or ours[0] == "error":
        assert ours == ref
        return
    got, want = np.asarray(ours[1]), np.asarray(ref[1])
    assert got.shape == want.shape
    if tol == 0:
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _batch(case, i=0):
    data = CASES[case]
    return data.preds[i], data.target[i]


# ---- stat_scores against the JAX package ------------------------------------

STAT_CASES = [
    # (case, kwargs) — each branch of the JAX package's counting
    ("binary_prob", {"reduce": "micro"}),
    ("binary_prob", {"reduce": "samples", "threshold": 0.3}),
    ("binary_prob", {"reduce": "macro", "num_classes": 1}),
    ("binary_prob", {"reduce": "micro", "ignore_index": 0}),
    ("binary", {"reduce": "macro", "num_classes": 2}),
    ("binary", {"reduce": "micro"}),
    ("multilabel_prob", {"reduce": "micro"}),
    ("multilabel_prob", {"reduce": "macro", "num_classes": NUM_CLASSES}),
    ("multilabel_prob", {"reduce": "samples", "threshold": 0.7}),
    ("multilabel_prob", {"reduce": "macro", "num_classes": NUM_CLASSES, "ignore_index": 1}),
    ("multilabel_prob", {"reduce": "micro", "ignore_index": 3}),
    ("multilabel_prob", {"reduce": "samples", "ignore_index": 0}),
    ("multilabel_prob", {"reduce": "micro", "top_k": 2}),
    ("multilabel", {"reduce": "micro", "mdmc_reduce": "global"}),
    ("mlmd_prob", {"reduce": "macro", "num_classes": NUM_CLASSES * 3}),
    ("mlmd_prob", {"reduce": "samples"}),
    ("multiclass_prob", {"reduce": "micro"}),
    ("multiclass_prob", {"reduce": "macro", "num_classes": NUM_CLASSES}),
    ("multiclass_prob", {"reduce": "samples"}),
    ("multiclass_prob", {"reduce": "macro", "num_classes": NUM_CLASSES, "top_k": 2}),
    ("multiclass_prob", {"reduce": "micro", "top_k": 3, "ignore_index": 2}),
    ("multiclass_prob", {"reduce": "samples", "top_k": 2, "ignore_index": 4}),
    ("multiclass_prob", {"reduce": "macro", "num_classes": NUM_CLASSES, "ignore_index": 0}),
    ("multiclass_prob", {"reduce": "macro", "num_classes": NUM_CLASSES, "is_multiclass": True}),
    ("multiclass", {"reduce": "micro"}),
    ("multiclass", {"reduce": "macro", "num_classes": NUM_CLASSES}),
    ("multiclass", {"reduce": "samples", "num_classes": NUM_CLASSES, "ignore_index": 1}),
    ("multiclass", {"reduce": "micro", "num_classes": NUM_CLASSES, "ignore_index": 2}),
    ("mdmc_prob", {"reduce": "micro", "mdmc_reduce": "global"}),
    ("mdmc_prob", {"reduce": "macro", "mdmc_reduce": "global", "num_classes": NUM_CLASSES}),
    ("mdmc_prob", {"reduce": "samples", "mdmc_reduce": "global"}),
    ("mdmc_prob", {"reduce": "micro", "mdmc_reduce": "samplewise"}),
    ("mdmc_prob", {"reduce": "macro", "mdmc_reduce": "samplewise", "num_classes": NUM_CLASSES}),
    ("mdmc_prob", {"reduce": "samples", "mdmc_reduce": "samplewise", "ignore_index": 1}),
    ("mdmc_prob", {"reduce": "macro", "mdmc_reduce": "samplewise", "num_classes": NUM_CLASSES, "top_k": 2,
                   "ignore_index": 3}),
    ("mdmc_prob", {"reduce": "micro", "mdmc_reduce": "global", "top_k": 2, "ignore_index": 0}),
    ("mdmc_prob", {"reduce": "micro"}),
    ("mdmc", {"reduce": "macro", "mdmc_reduce": "global", "num_classes": NUM_CLASSES}),
    ("mdmc", {"reduce": "micro", "mdmc_reduce": "samplewise", "num_classes": NUM_CLASSES, "ignore_index": 4}),
    ("mdmc", {"reduce": "samples", "mdmc_reduce": "samplewise"}),
]


@pytest.mark.parametrize("case, kwargs", STAT_CASES, ids=[f"{c}-{k}" for c, k in STAT_CASES])
def test_stat_scores_matches_jax(case, kwargs):
    p, t = _batch(case)
    ours = _outcome(stat_scores, _tt(p), _tt(t), **kwargs)
    ref = _outcome(jf.stat_scores, jnp.asarray(p), jnp.asarray(t), **kwargs)
    if ours[0] == "ok":
        ours = ("ok", ours[1].numpy())
    _assert_same(ours, ref)


# ---- the label-space path against the canonical path -----------------------


def _tied_scores(n, c, x=None, seed=0):
    """Probabilities rounded to one decimal and renormalized exactly in
    float32 steps: many ties inside and at the edge of the top k."""
    rng = np.random.default_rng(seed)
    shape = (n, c) if x is None else (n, c, x)
    raw = rng.integers(1, 4, size=shape).astype(np.float32)
    return raw / raw.sum(axis=1, keepdims=True)


LABEL_SPACE_CASES = [
    ("multiclass_prob", {"reduce": "macro", "num_classes": NUM_CLASSES}),
    ("multiclass_prob", {"reduce": "micro", "ignore_index": 1}),
    ("multiclass_prob", {"reduce": "samples", "top_k": 2, "ignore_index": 0}),
    ("multiclass", {"reduce": "macro", "num_classes": NUM_CLASSES, "ignore_index": 3}),
    ("mdmc_prob", {"reduce": "macro", "mdmc_reduce": "samplewise", "top_k": 3, "num_classes": NUM_CLASSES}),
    ("mdmc_prob", {"reduce": "micro", "mdmc_reduce": "global", "ignore_index": 2}),
    ("mdmc", {"reduce": "samples", "mdmc_reduce": "samplewise", "num_classes": NUM_CLASSES}),
    ("multilabel_prob", {"reduce": "micro", "ignore_index": 4}),
    ("binary_prob", {"reduce": "samples"}),
    ("tied", {"reduce": "macro", "top_k": 2, "num_classes": NUM_CLASSES}),
    ("tied", {"reduce": "samples", "top_k": 3, "ignore_index": 1}),
    ("tied_mdmc", {"reduce": "macro", "mdmc_reduce": "samplewise", "top_k": 2, "ignore_index": 0,
                   "num_classes": NUM_CLASSES}),
]


def _label_space_inputs(case):
    if case == "tied":
        return _tied_scores(64, NUM_CLASSES, seed=1), np.random.default_rng(2).integers(0, NUM_CLASSES, 64)
    if case == "tied_mdmc":
        return _tied_scores(16, NUM_CLASSES, 6, seed=3), np.random.default_rng(4).integers(0, NUM_CLASSES, (16, 6))
    return _batch(case)


@pytest.mark.parametrize("case, kwargs", LABEL_SPACE_CASES, ids=[f"{c}-{k}" for c, k in LABEL_SPACE_CASES])
def test_label_space_counts_equal_the_canonical_path(case, kwargs):
    p, t = (_tt(a) for a in _label_space_inputs(case))
    options = dict(reduce="micro", mdmc_reduce=None, num_classes=None, top_k=None, threshold=0.5,
                   is_multiclass=None, ignore_index=None)
    options.update(kwargs)
    fast = _stat_scores_fast_update(p, t, **options)
    assert fast is not None  # the case takes the label-space path
    pc, tc, _ = _input_format_classification(
        p, t, threshold=options["threshold"], num_classes=options["num_classes"], top_k=options["top_k"]
    )
    canonical = _stat_scores_count(pc, tc, options["reduce"], options["mdmc_reduce"], options["ignore_index"])
    for got, want in zip(fast, canonical):
        assert got.dtype == want.dtype == torch.int32
        assert torch.equal(got, want)
    # and the JAX package's counts (its top_k keeps the lower index on ties)
    want = jf.stat_scores(jnp.asarray(p.numpy()), jnp.asarray(t.numpy()), **kwargs)
    assert np.array_equal(stat_scores(p, t, **kwargs).numpy(), np.asarray(want))


def test_top_k_ties_keep_the_lower_index():
    """Three classes tied for the top two: the lower two indices are taken,
    as ``lax.top_k`` takes them."""
    p = torch.tensor([[0.3, 0.3, 0.3, 0.1]])
    got = stat_scores(p, torch.tensor([2]), reduce="macro", num_classes=4, top_k=2)
    want = jf.stat_scores(jnp.asarray(p.numpy()), jnp.asarray([2]), reduce="macro", num_classes=4, top_k=2)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got[:, 0].tolist() == [0, 0, 0, 0]  # class 2 is not in the top 2: a miss
    assert got[:, 1].tolist() == [1, 1, 0, 0]


@pytest.mark.parametrize("n, length", [(5000, 32), (2**20 + 3, 361), (2**20 + 3, 5000)])
def test_label_bincount_keeps_the_out_of_range_contract(n, length):
    """One buffer, and (2^20 labels and more, 4,096 buckets or fewer) 512
    copies summed: both equal numpy's counts."""
    rng = np.random.default_rng(n + length)
    idx = rng.integers(-5, length + 8, n)
    w = rng.random(n) < 0.4
    for weights in (None, w):
        want = np.bincount(np.clip(idx, 0, None), weights=weights, minlength=length + 8)[:length].astype(np.int64)
        got = label_bincount(_tt(idx), length, None if weights is None else _tt(weights))
        assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)


def test_stat_scores_debug_assertion(monkeypatch):
    """The 0/1 precondition of ``_stat_scores`` is asserted under
    ``METRICS_TPU_DEBUG``; without it, non-indicator inputs pass unchecked.
    The flag is parsed once (``utilities/env.py``): ``refresh()`` re-reads it."""
    bad = torch.tensor([[0, 2], [1, 0]], dtype=torch.int32)
    ok = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)
    _stat_scores(bad, ok)
    monkeypatch.setenv("METRICS_TPU_DEBUG", "1")
    _stat_scores(bad, ok)  # cached at import: still off
    env.refresh()
    try:
        with pytest.raises(AssertionError, match="preds has non-indicator values"):
            _stat_scores(bad, ok)
        _stat_scores(ok, ok)
    finally:
        monkeypatch.undo()
        env.refresh()


# ---- precision / recall / fbeta / f1 ----------------------------------------

AVERAGE_CASES = [
    ("multiclass_prob", {"average": "micro"}),
    ("multiclass_prob", {"average": "macro", "num_classes": NUM_CLASSES}),
    ("multiclass_prob", {"average": "weighted", "num_classes": NUM_CLASSES}),
    ("multiclass_prob", {"average": "none", "num_classes": NUM_CLASSES}),
    ("multiclass_prob", {"average": None, "num_classes": NUM_CLASSES, "ignore_index": 2}),
    ("multiclass_prob", {"average": "samples"}),
    ("multiclass_prob", {"average": "macro", "num_classes": NUM_CLASSES, "ignore_index": 0}),
    ("multiclass_prob", {"average": "weighted", "num_classes": NUM_CLASSES, "ignore_index": 4, "top_k": 2}),
    ("multiclass_prob", {"average": "micro", "ignore_index": 1}),
    ("multiclass", {"average": "macro", "num_classes": NUM_CLASSES}),
    ("multilabel_prob", {"average": "macro", "num_classes": NUM_CLASSES, "threshold": 0.3}),
    ("multilabel_prob", {"average": "samples"}),
    ("binary_prob", {"average": "micro"}),
    ("binary_prob", {"average": "macro", "num_classes": 1}),
    ("mdmc_prob", {"average": "micro", "mdmc_average": "global"}),
    ("mdmc_prob", {"average": "macro", "mdmc_average": "global", "num_classes": NUM_CLASSES}),
    ("mdmc_prob", {"average": "macro", "mdmc_average": "samplewise", "num_classes": NUM_CLASSES}),
    ("mdmc_prob", {"average": "weighted", "mdmc_average": "samplewise", "num_classes": NUM_CLASSES,
                   "ignore_index": 1}),
    ("mdmc_prob", {"average": "micro", "mdmc_average": "samplewise", "ignore_index": 2}),
    ("mdmc_prob", {"average": "samples", "mdmc_average": "samplewise"}),
    ("mdmc_prob", {"average": "none", "mdmc_average": "samplewise", "num_classes": NUM_CLASSES, "ignore_index": 0}),
    ("mdmc", {"average": "macro", "mdmc_average": "global", "num_classes": NUM_CLASSES, "ignore_index": 3}),
]

FUNCTIONALS = {
    "precision": (precision, jf.precision),
    "recall": (recall, jf.recall),
    "fbeta": (lambda p, t, **kw: fbeta(p, t, beta=0.5, **kw), lambda p, t, **kw: jf.fbeta(p, t, beta=0.5, **kw)),
    "f1": (f1, jf.f1),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONALS))
@pytest.mark.parametrize("case, kwargs", AVERAGE_CASES, ids=[f"{c}-{k}" for c, k in AVERAGE_CASES])
def test_ratio_functionals_match_jax(name, case, kwargs):
    ours_fn, jax_fn = FUNCTIONALS[name]
    p, t = _batch(case)
    ours = _outcome(ours_fn, _tt(p), _tt(t), **kwargs)
    ref = _outcome(jax_fn, jnp.asarray(p), jnp.asarray(t), **kwargs)
    _assert_same(ours, ref, RATIO_TOL)


def test_precision_recall_pair_matches_jax():
    p, t = _batch("multiclass_prob")
    got = precision_recall(_tt(p), _tt(t), average="macro", num_classes=NUM_CLASSES)
    want = jf.precision_recall(jnp.asarray(p), jnp.asarray(t), average="macro", num_classes=NUM_CLASSES)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=RATIO_TOL)


MODULES = {
    "StatScores": (StatScores, jm.StatScores),
    "Precision": (Precision, jm.Precision),
    "Recall": (Recall, jm.Recall),
    "FBeta": (FBeta, jm.FBeta),
    "F1": (F1, jm.F1),
}

MODULE_CASES = [
    ("StatScores", "multiclass_prob", {"reduce": "macro", "num_classes": NUM_CLASSES}),
    ("StatScores", "mdmc_prob", {"reduce": "samples", "mdmc_reduce": "samplewise"}),
    ("StatScores", "multilabel_prob", {"reduce": "samples"}),
    ("StatScores", "mdmc_prob", {"reduce": "macro", "mdmc_reduce": "samplewise", "num_classes": NUM_CLASSES,
                                 "ignore_index": 2}),
    ("Precision", "multiclass_prob", {"average": "macro", "num_classes": NUM_CLASSES, "top_k": 2}),
    ("Recall", "mdmc_prob", {"average": "weighted", "mdmc_average": "samplewise", "num_classes": NUM_CLASSES}),
    ("FBeta", "multilabel_prob", {"average": "samples", "beta": 2.0}),
    ("F1", "multiclass", {"average": "macro", "num_classes": NUM_CLASSES, "ignore_index": 1}),
    ("F1", "binary_prob", {"average": "micro"}),
]


@pytest.mark.parametrize("name, case, kwargs", MODULE_CASES, ids=[f"{n}-{c}-{k}" for n, c, k in MODULE_CASES])
def test_modules_match_jax_and_forward_equals_update_compute(name, case, kwargs):
    """Every batch through the module: the fused forward's step values and
    the epoch value equal the JAX module's (counts exact, ratios within
    1e-6), and equal a second instance fed by ``update`` alone."""
    ours_cls, jax_cls = MODULES[name]
    data = CASES[case]
    ours, plain, ref = ours_cls(device=CPU, **kwargs), ours_cls(device=CPU, **kwargs), jax_cls(**kwargs)
    tol = 0.0 if name == "StatScores" else RATIO_TOL
    for p, t in zip(data.preds, data.target):
        step = ours(_tt(p), _tt(t))
        want_step = ref(jnp.asarray(p), jnp.asarray(t))
        _assert_same(("ok", step.numpy()), ("ok", want_step), tol)
        plain.update(_tt(p), _tt(t))
    _assert_same(("ok", ours.compute().numpy()), ("ok", ref.compute()), tol)
    assert torch.equal(plain.compute(), ours.compute())
    list_state = ours.reduce == "samples" or ours.mdmc_reduce == "samplewise"
    assert isinstance(ours.tp, list) == list_state
    if list_state:
        assert len(ours.tp) == len(data.preds)


@pytest.mark.parametrize("name, case, kwargs", MODULE_CASES[:6], ids=[f"{n}-{c}" for n, c, _ in MODULE_CASES[:6]])
def test_state_from_jax_loads_and_computes_the_same(name, case, kwargs):
    ours_cls, jax_cls = MODULES[name]
    data = CASES[case]
    ref = jax_cls(**kwargs)
    ref.persistent(True)
    for p, t in zip(data.preds[:3], data.target[:3]):
        ref.update(jnp.asarray(p), jnp.asarray(t))
    state = {k: [np.asarray(x) for x in v] if isinstance(v, list) else np.asarray(v)
             for k, v in ref.state_dict().items()}
    ours = ours_cls(device=CPU, **kwargs)
    ours.load_state_dict(state_from_jax(state), strict=True)
    for key, value in state.items():
        mine = getattr(ours, key)
        if isinstance(value, list):
            assert [m.dtype for m in mine] == [torch.int32] * len(value)
        else:
            assert mine.dtype == torch.int32 and np.array_equal(mine.numpy(), value)
    _assert_same(("ok", ours.compute().numpy()), ("ok", ref.compute()), 0.0 if name == "StatScores" else RATIO_TOL)


# ---- hamming distance and dice ---------------------------------------------

HAMMING_CASES = ["binary_prob", "binary", "multilabel_prob", "multilabel", "mlmd_prob", "multiclass_prob",
                 "multiclass", "mdmc_prob", "mdmc"]


@pytest.mark.parametrize("case", HAMMING_CASES)
def test_hamming_distance_matches_jax(case):
    data = CASES[case]
    p, t = _batch(case)
    _assert_same(_outcome(hamming_distance, _tt(p), _tt(t), threshold=0.4),
                 _outcome(jf.hamming_distance, jnp.asarray(p), jnp.asarray(t), threshold=0.4), RATIO_TOL)
    ours, ref = HammingDistance(device=CPU), jm.HammingDistance()
    ref.persistent(True)
    for p, t in zip(data.preds[:3], data.target[:3]):
        np.testing.assert_allclose(ours(_tt(p), _tt(t)).numpy(), np.asarray(ref(jnp.asarray(p), jnp.asarray(t))),
                                   rtol=0, atol=RATIO_TOL)
    np.testing.assert_allclose(ours.compute().numpy(), np.asarray(ref.compute()), rtol=0, atol=RATIO_TOL)
    loaded = HammingDistance(device=CPU)
    loaded.load_state_dict(state_from_jax({k: np.asarray(v) for k, v in ref.state_dict().items()}), strict=True)
    assert loaded.correct.dtype == loaded.total.dtype == torch.float32  # f32 states, dtype for dtype
    assert torch.equal(loaded.correct, ours.correct) and torch.equal(loaded.total, ours.total)


def test_hamming_label_count_equals_the_canonical_one_hot_count():
    """``correct = total - 2 * misses`` on label pairs equals the count over
    the canonical one-hot, whose width comes from the data maximum."""
    for p, t in ((_tt([0, 3, 1, 1, 2]), _tt([0, 1, 1, 2, 2])), (_tt(_batch("mdmc_prob")[0]), _tt(_batch("mdmc_prob")[1]))):
        pc, tc, _ = _input_format_classification(p, t)
        correct, total = _hamming_distance_update(p, t)
        assert int(correct) == int((pc == tc).sum()) and total == pc.numel()


DICE_CASES = [
    ({}, "multiclass_prob"),
    ({"bg": True}, "multiclass_prob"),
    ({"reduction": "none", "no_fg_score": 0.5}, "mdmc_prob"),
    ({"reduction": "sum", "nan_score": 0.25, "bg": True}, "mdmc_prob"),
    ({}, "labels"),
]


@pytest.mark.parametrize("kwargs, case", DICE_CASES, ids=[f"{c}-{k}" for k, c in DICE_CASES])
def test_dice_score_matches_jax(kwargs, case):
    if case == "labels":
        rng = np.random.default_rng(5)
        p, t = rng.integers(0, 7, (40, 6)), rng.integers(0, 6, (40, 6))  # classes absent and extra labels
    else:
        p, t = _batch(case)
    _assert_same(_outcome(dice_score, _tt(p), _tt(t), **kwargs),
                 _outcome(jf.dice_score, jnp.asarray(p), jnp.asarray(t), **kwargs), RATIO_TOL)


def test_dice_legacy_per_class_helper_matches_jax():
    p, t = _batch("multiclass_prob")
    for c in range(NUM_CLASSES):
        got = dice_stat_scores(_tt(p), _tt(t), class_index=c)
        want = jax_dice_stat_scores(jnp.asarray(p), jnp.asarray(t), class_index=c)
        assert [int(g) for g in got] == [int(w) for w in want]
        assert all(g.dtype == torch.int32 for g in got)


# ---- errors -----------------------------------------------------------------

_mc_p, _mc_t = _batch("multiclass_prob")
_md_p, _md_t = _batch("mdmc_prob")
_bp_p, _bp_t = _batch("binary_prob")

ERROR_CASES = [
    ("stat_scores", (_mc_p, _mc_t), {"reduce": "bad"}),
    ("stat_scores", (_mc_p, _mc_t), {"mdmc_reduce": "bad"}),
    ("stat_scores", (_mc_p, _mc_t), {"reduce": "macro"}),
    ("stat_scores", (_mc_p, _mc_t), {"num_classes": NUM_CLASSES, "ignore_index": NUM_CLASSES}),
    ("stat_scores", (_mc_p, _mc_t), {"ignore_index": 9}),
    ("stat_scores", (_bp_p, _bp_t), {"ignore_index": 0, "num_classes": 1}),
    ("stat_scores", (_md_p, _md_t), {}),
    ("stat_scores", (_mc_p, _mc_t), {"top_k": 0}),
    ("stat_scores", (_mc_p, _mc_t), {"top_k": NUM_CLASSES}),
    ("stat_scores", (_bp_p, _bp_t), {"top_k": 1}),
    ("stat_scores", (_mc_p, _mc_t), {"threshold": 1.5}),
    ("stat_scores", (_mc_p, _mc_t.astype(np.float32)), {}),
    ("stat_scores", (_mc_p, _mc_t[:-1]), {}),
    ("stat_scores", (_mc_p * 2, _mc_t), {}),
    ("stat_scores", (_mc_p, _mc_t + NUM_CLASSES), {}),
    ("stat_scores", (_mc_p, -_mc_t - 1), {}),
    ("stat_scores", (np.array([3, 1, 4]), np.array([0, 1, 2])), {"num_classes": 3}),
    ("stat_scores", (_mc_p, _mc_t), {"num_classes": 3}),
    ("stat_scores", (_mc_p, _mc_t), {"is_multiclass": False}),
    ("precision", (_mc_p, _mc_t), {"average": "bad"}),
    ("precision", (_mc_p, _mc_t), {"mdmc_average": "bad"}),
    ("recall", (_mc_p, _mc_t), {"average": "macro"}),
    ("fbeta", (_mc_p, _mc_t), {"average": "weighted", "num_classes": NUM_CLASSES, "ignore_index": -1}),
    ("f1", (_md_p, _md_t), {"average": "macro", "num_classes": NUM_CLASSES}),
    ("hamming_distance", (_mc_p, _mc_t.astype(np.float32)), {}),
    ("hamming_distance", (_bp_p, _bp_t), {"threshold": 0.0}),
    ("hamming_distance", (_mc_p[:, :2] * 0.9, _mc_t), {}),
]


@pytest.mark.parametrize("name, args, kwargs", ERROR_CASES, ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(ERROR_CASES)])
def test_bad_inputs_raise_the_jax_errors(name, args, kwargs):
    ours = _outcome(globals()[name], *(_tt(a) for a in args), **kwargs)
    ref = _outcome(getattr(jf, name), *(jnp.asarray(a) for a in args), **kwargs)
    assert ref[0] == "error"
    assert ours == ref


CONSTRUCTOR_ERRORS = [
    ("StatScores", {"threshold": 0.0}),
    ("StatScores", {"reduce": "bad"}),
    ("StatScores", {"mdmc_reduce": "bad"}),
    ("StatScores", {"reduce": "macro"}),
    ("StatScores", {"num_classes": 1, "ignore_index": 0}),
    ("Precision", {"average": "bad"}),
    ("Recall", {"average": "macro"}),
    ("FBeta", {"average": "weighted", "num_classes": 3, "ignore_index": 3}),
    ("F1", {"average": "bad"}),
]


@pytest.mark.parametrize("name, kwargs", CONSTRUCTOR_ERRORS, ids=[f"{n}-{k}" for n, k in CONSTRUCTOR_ERRORS])
def test_bad_arguments_raise_the_jax_errors(name, kwargs):
    ours_cls, jax_cls = MODULES[name]
    ref = _outcome(jax_cls, **kwargs)
    assert ref[0] == "error"
    assert _outcome(ours_cls, device=CPU, **kwargs) == ref


def test_hamming_module_rejects_a_bad_threshold():
    assert _outcome(HammingDistance, threshold=1.0, device=CPU) == _outcome(jm.HammingDistance, threshold=1.0)


# ---- a 2-process gloo world --------------------------------------------------


def test_gloo_world_syncs_sum_and_list_states_to_the_one_process_value():
    payload = {"batches": [(np.array(p), np.array(t)) for p, t in zip(*CASES["mdmc_prob"])][:4],
               "num_classes": NUM_CLASSES}
    ranks = run_world(2, stat_scores_world, payload)
    one = stat_scores_world(0, 1, torch.device(CPU), payload)
    for r in (0, 1):
        for name, value in one.items():
            assert np.array_equal(ranks[r][name], value), (r, name)
    # one row per position of the four batches, in the one-process order
    assert one["samples"].shape == (4 * np.prod(CASES["mdmc_prob"].target.shape[1:]), 5)
