"""The port's confusion-matrix family and hinge loss against the JAX package, on the CPU.

Inputs are made with numpy from a seed (the shapes of
``tests/classification/inputs.py``) and go through the JAX package (its CPU
path) and the port with ``device="cpu"``:

* ``confusion_matrix`` / ``ConfusionMatrix`` over binary, multi-label
  (``multilabel=True`` giving ``(C, 2, 2)``, and without it), multi-class
  (labels and probabilities) and multi-dim multi-class inputs, under every
  ``normalize``: counts exact (float32 of exact ints), normalized cells
  within 1e-6;
* ``cohen_kappa`` (no / linear / quadratic weights), ``matthews_corrcoef``
  and ``hinge`` (binary, Crammer-Singer, one-vs-all, ``squared``, a single
  score column) within 1e-5; ``iou`` (``ignore_index``, ``absent_score``,
  every ``reduction``) within 1e-6;
* the label path (argmax or threshold, then count) against the canonical
  path (one-hot, then argmax back): identical counts;
* every bad argument and bad input raises the JAX package's error, the
  out-of-range label included; a module's fused ``forward`` equals
  ``update`` + ``compute``; ``state_from_jax`` of each metric's JAX
  ``state_dict``; the NaN-cell warning of a normalized matrix.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.functional as jf
from metrics_tpu_torch import CohenKappa, ConfusionMatrix, Hinge, IoU, MatthewsCorrcoef
from metrics_tpu_torch.functional import cohen_kappa, confusion_matrix, hinge, iou, matthews_corrcoef
from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _confmat_count,
    _confmat_fast_update,
    _confusion_matrix_update,
)
from metrics_tpu_torch.interop import state_from_jax
from metrics_tpu_torch.utilities.checks import _input_format_classification
from metrics_tpu_torch.utilities.enums import DataType
from tests.classification import inputs

CPU = "cpu"
COUNT_TOL = 0.0  # counts: exact
RATIO_TOL = 1e-6  # normalized cells and IoU: float32 ratios of exact counts
STAT_TOL = 1e-5  # kappa, MCC, hinge: float32 sums of products in other orders
NUM_CLASSES = 5

CASES = {
    "binary_prob": inputs._input_binary_prob,
    "binary": inputs._input_binary,
    "multilabel_prob": inputs._input_multilabel_prob,
    "multiclass_prob": inputs._input_multiclass_prob,
    "multiclass": inputs._input_multiclass,
    "mdmc_prob": inputs._input_multidim_multiclass_prob,
    "mdmc": inputs._input_multidim_multiclass,
}
# (case, num_classes, extra kwargs)
CONFMAT_CASES = [
    ("binary_prob", 2, {}),
    ("binary_prob", 2, {"threshold": 0.3}),
    ("binary", 2, {}),
    ("multilabel_prob", NUM_CLASSES, {"multilabel": True}),
    ("multilabel_prob", 2, {}),
    ("multiclass_prob", NUM_CLASSES, {}),
    ("multiclass", NUM_CLASSES, {}),
    ("mdmc_prob", NUM_CLASSES, {}),
    ("mdmc", NUM_CLASSES, {}),
]


def _tt(a):
    return torch.from_numpy(np.array(a))


def _outcome(fn, *args, **kwargs):
    """``("ok", value as numpy)`` or ``("error", type name, message)``."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return ("ok", np.asarray(fn(*args, **kwargs)))
    except Exception as err:  # compared with the other package's outcome
        return ("error", type(err).__name__, str(err))


def _assert_same(ours, ref, tol):
    if ref[0] == "error" or ours[0] == "error":
        assert ours == ref
        return
    assert ours[1].shape == ref[1].shape and ours[1].dtype == ref[1].dtype
    if tol == 0:
        np.testing.assert_array_equal(ours[1], ref[1])
    else:
        np.testing.assert_allclose(ours[1], ref[1], rtol=0, atol=tol)


def _batch(case, i=0):
    return CASES[case].preds[i], CASES[case].target[i]


def _both(ours_fn, jax_fn, p, t, tol, **kwargs):
    _assert_same(_outcome(ours_fn, _tt(p), _tt(t), **kwargs), _outcome(jax_fn, jnp.asarray(p), jnp.asarray(t), **kwargs),
                 tol)


# ---- functional values -----------------------------------------------------


@pytest.mark.parametrize("normalize", [None, "true", "pred", "all"])
@pytest.mark.parametrize("case, num_classes, kwargs", CONFMAT_CASES, ids=[f"{c}-{n}-{k}" for c, n, k in CONFMAT_CASES])
def test_confusion_matrix_matches_jax(case, num_classes, kwargs, normalize):
    p, t = _batch(case)
    _both(confusion_matrix, jf.confusion_matrix, p, t, COUNT_TOL if normalize is None else RATIO_TOL,
          num_classes=num_classes, normalize=normalize, **kwargs)


KAPPA_CASES = [(c, n, k) for c, n, k in CONFMAT_CASES if not k.get("multilabel")]


@pytest.mark.parametrize("weights", [None, "linear", "quadratic"])
@pytest.mark.parametrize("case, num_classes, kwargs", KAPPA_CASES, ids=[c for c, _, _ in KAPPA_CASES])
def test_cohen_kappa_matches_jax(case, num_classes, kwargs, weights):
    p, t = _batch(case)
    _both(cohen_kappa, jf.cohen_kappa, p, t, STAT_TOL, num_classes=num_classes, weights=weights, **kwargs)


@pytest.mark.parametrize("case, num_classes, kwargs", KAPPA_CASES, ids=[c for c, _, _ in KAPPA_CASES])
def test_matthews_corrcoef_matches_jax(case, num_classes, kwargs):
    p, t = _batch(case)
    _both(matthews_corrcoef, jf.matthews_corrcoef, p, t, STAT_TOL, num_classes=num_classes, **kwargs)


IOU_CASES = [
    ("multiclass", {}),
    ("multiclass", {"num_classes": NUM_CLASSES + 2, "absent_score": 0.5}),
    ("multiclass_prob", {"ignore_index": 0}),
    ("multiclass_prob", {"ignore_index": 9, "reduction": "sum"}),
    ("mdmc_prob", {"reduction": "none"}),
    ("mdmc", {"ignore_index": 2, "reduction": "none"}),
    ("binary_prob", {"num_classes": 2}),
]


@pytest.mark.parametrize("case, kwargs", IOU_CASES, ids=[f"{c}-{k}" for c, k in IOU_CASES])
def test_iou_matches_jax(case, kwargs):
    p, t = _batch(case)
    if case == "binary_prob":
        # labels from the scores: the functional infers classes from label maxima
        p = (p >= 0.5).astype(np.int64)
    _both(iou, jf.iou, p, t, RATIO_TOL, **kwargs)


def _hinge_inputs(kind):
    rng = np.random.default_rng({"binary": 1, "multiclass": 2, "one_column": 3, "one_sample": 4}[kind])
    if kind == "binary":
        return rng.standard_normal(64).astype(np.float32), rng.integers(0, 2, 64)
    if kind == "one_column":  # a single score column broadcasts against the two-class one-hot
        return rng.standard_normal((64, 1)).astype(np.float32), rng.integers(0, 2, 64)
    if kind == "one_sample":
        return rng.standard_normal((1, NUM_CLASSES)).astype(np.float32), rng.integers(0, NUM_CLASSES, 1)
    return rng.standard_normal((64, NUM_CLASSES)).astype(np.float32), rng.integers(0, NUM_CLASSES, 64)


HINGE_CASES = [
    ("binary", {}),
    ("binary", {"squared": True}),
    ("multiclass", {}),
    ("multiclass", {"squared": True}),
    ("multiclass", {"multiclass_mode": "one-vs-all"}),
    ("multiclass", {"multiclass_mode": "one-vs-all", "squared": True}),
    ("one_column", {}),
    ("one_column", {"multiclass_mode": "one-vs-all"}),
    ("one_sample", {}),
    ("multiclass", {"multiclass_mode": "bad"}),
]


@pytest.mark.parametrize("kind, kwargs", HINGE_CASES, ids=[f"{c}-{k}" for c, k in HINGE_CASES])
def test_hinge_matches_jax(kind, kwargs):
    p, t = _hinge_inputs(kind)
    _both(hinge, jf.hinge, p, t, STAT_TOL, **kwargs)


# ---- the label path against the canonical path ------------------------------


@pytest.mark.parametrize("case, num_classes, kwargs", CONFMAT_CASES, ids=[f"{c}-{n}-{k}" for c, n, k in CONFMAT_CASES])
def test_label_counts_equal_the_canonical_path(case, num_classes, kwargs):
    p, t = (_tt(a) for a in _batch(case))
    threshold, multilabel = kwargs.get("threshold", 0.5), kwargs.get("multilabel", False)
    fast = _confmat_fast_update(p, t, num_classes, threshold, multilabel)
    assert fast is not None
    pc, tc, mode = _input_format_classification(p, t, threshold)
    if mode not in (DataType.BINARY, DataType.MULTILABEL):
        pc, tc = torch.argmax(pc, dim=1), torch.argmax(tc, dim=1)
    canonical = _confmat_count(pc.to(torch.int64), tc, num_classes, multilabel)
    assert fast.dtype == canonical.dtype == torch.int32
    assert torch.equal(fast, canonical)


# ---- modules -----------------------------------------------------------------

MODULES = {
    "ConfusionMatrix": (ConfusionMatrix, jm.ConfusionMatrix),
    "CohenKappa": (CohenKappa, jm.CohenKappa),
    "MatthewsCorrcoef": (MatthewsCorrcoef, jm.MatthewsCorrcoef),
    "IoU": (IoU, jm.IoU),
    "Hinge": (Hinge, jm.Hinge),
}
MODULE_CASES = [
    ("ConfusionMatrix", "mdmc_prob", {"num_classes": NUM_CLASSES, "normalize": "true"}, RATIO_TOL),
    ("ConfusionMatrix", "multilabel_prob", {"num_classes": NUM_CLASSES, "multilabel": True}, COUNT_TOL),
    ("CohenKappa", "multiclass_prob", {"num_classes": NUM_CLASSES, "weights": "quadratic"}, STAT_TOL),
    ("MatthewsCorrcoef", "multiclass", {"num_classes": NUM_CLASSES}, STAT_TOL),
    ("IoU", "mdmc", {"num_classes": NUM_CLASSES, "ignore_index": 1}, RATIO_TOL),
    ("Hinge", "hinge_multiclass", {"multiclass_mode": "one-vs-all"}, STAT_TOL),
]


def _module_batches(case):
    if case == "hinge_multiclass":
        p, t = _hinge_inputs("multiclass")
        return [(p[i::4], t[i::4]) for i in range(4)]
    data = CASES[case]
    return list(zip(data.preds[:4], data.target[:4]))


@pytest.mark.parametrize("name, case, kwargs, tol", MODULE_CASES, ids=[n for n, *_ in MODULE_CASES])
def test_modules_match_jax_and_forward_equals_update_compute(name, case, kwargs, tol):
    ours_cls, jax_cls = MODULES[name]
    ours, plain, ref = ours_cls(device=CPU, **kwargs), ours_cls(device=CPU, **kwargs), jax_cls(**kwargs)
    for p, t in _module_batches(case):
        _assert_same(("ok", ours(_tt(p), _tt(t)).numpy()), ("ok", np.asarray(ref(jnp.asarray(p), jnp.asarray(t)))),
                     tol)
        plain.update(_tt(p), _tt(t))
    _assert_same(("ok", ours.compute().numpy()), ("ok", np.asarray(ref.compute())), tol)
    assert torch.equal(plain.compute(), ours.compute())


@pytest.mark.parametrize("name, case, kwargs, tol", MODULE_CASES, ids=[n for n, *_ in MODULE_CASES])
def test_state_from_jax_loads_and_computes_the_same(name, case, kwargs, tol):
    ours_cls, jax_cls = MODULES[name]
    ref = jax_cls(**kwargs)
    ref.persistent(True)
    for p, t in _module_batches(case)[:3]:
        ref.update(jnp.asarray(p), jnp.asarray(t))
    state = {k: np.asarray(v) for k, v in ref.state_dict().items()}
    ours = ours_cls(device=CPU, **kwargs)
    ours.load_state_dict(state_from_jax(state), strict=True)
    for key, value in state.items():
        assert getattr(ours, key).dtype == torch.from_numpy(value).dtype  # dtype for dtype
        assert np.array_equal(getattr(ours, key).numpy(), value)
    _assert_same(("ok", ours.compute().numpy()), ("ok", np.asarray(ref.compute())), tol)


def test_confmat_state_is_int32_and_sums():
    m = ConfusionMatrix(num_classes=NUM_CLASSES, device=CPU)
    for p, t in _module_batches("multiclass"):
        m.update(_tt(p), _tt(t))
    assert m.confmat.dtype == torch.int32
    want = sum(np.bincount(t * NUM_CLASSES + p, minlength=NUM_CLASSES**2) for p, t in _module_batches("multiclass"))
    assert np.array_equal(m.confmat.numpy().ravel(), want)


def test_normalized_nan_cells_warn_and_read_zero():
    p, t = np.array([0, 0, 1]), np.array([0, 0, 1])  # class 2 never occurs
    with pytest.warns(UserWarning, match="3 nan values found in confusion matrix"):
        got = confusion_matrix(_tt(p), _tt(t), num_classes=3, normalize="true")
    want = jf.confusion_matrix(jnp.asarray(p), jnp.asarray(t), num_classes=3, normalize="true")
    assert np.array_equal(got.numpy(), np.asarray(want))


# ---- errors -------------------------------------------------------------------

_mc_p, _mc_t = _batch("multiclass_prob")
_l_p, _l_t = _batch("multiclass")
ERROR_CASES = [
    ("confusion_matrix", (_l_p, _l_t), {"num_classes": 3}),  # labels up to 4: out of range
    ("confusion_matrix", (_mc_p, _mc_t), {"num_classes": 3}),  # argmax labels out of range
    ("confusion_matrix", (_mc_p, _mc_t.astype(np.float32)), {"num_classes": NUM_CLASSES}),
    ("confusion_matrix", (_mc_p * 3, _mc_t), {"num_classes": NUM_CLASSES}),
    ("confusion_matrix", (_mc_p, _mc_t), {"num_classes": NUM_CLASSES, "threshold": 2.0}),
    ("confusion_matrix", (_mc_p, _mc_t), {"num_classes": NUM_CLASSES, "normalize": "bad"}),
    ("confusion_matrix", (_l_p, -_l_t - 1), {"num_classes": NUM_CLASSES}),
    ("cohen_kappa", (_l_p, _l_t), {"num_classes": NUM_CLASSES, "weights": "cubic"}),
    ("cohen_kappa", (_l_p, _l_t), {"num_classes": 2}),
    ("matthews_corrcoef", (_mc_p, _mc_t[:-2]), {"num_classes": NUM_CLASSES}),
    ("hinge", (_mc_p, np.stack([_mc_t, _mc_t], 1)), {}),
    ("hinge", (_mc_p[:, 0], _mc_t[:-1]), {}),
    ("hinge", (_mc_p, _mc_t[:-1]), {}),
    ("hinge", (np.stack([_mc_p, _mc_p], 2), _mc_t), {"multiclass_mode": "one-vs-all"}),
]


@pytest.mark.parametrize("name, args, kwargs", ERROR_CASES, ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(ERROR_CASES)])
def test_bad_inputs_raise_the_jax_errors(name, args, kwargs):
    ours = _outcome(globals()[name], *(_tt(a) for a in args), **kwargs)
    ref = _outcome(getattr(jf, name), *(jnp.asarray(a) for a in args), **kwargs)
    assert ref[0] == "error"
    assert ours == ref


CONSTRUCTOR_ERRORS = [
    ("ConfusionMatrix", {"num_classes": 3, "normalize": "bad"}),
    ("CohenKappa", {"num_classes": 3, "weights": "bad"}),
    ("Hinge", {"multiclass_mode": "bad"}),
]


@pytest.mark.parametrize("name, kwargs", CONSTRUCTOR_ERRORS, ids=[n for n, _ in CONSTRUCTOR_ERRORS])
def test_bad_arguments_raise_the_jax_errors(name, kwargs):
    ours_cls, jax_cls = MODULES[name]
    ref = _outcome(jax_cls, **kwargs)
    assert ref[0] == "error"
    assert _outcome(ours_cls, device=CPU, **kwargs) == ref


def test_update_rejects_an_out_of_range_label_and_keeps_the_state():
    m = ConfusionMatrix(num_classes=3, device=CPU)
    m.update(_tt([0, 1, 2]), _tt([0, 1, 2]))
    with pytest.raises(ValueError, match="Detected class label 3"):
        m(_tt([0, 3, 2]), _tt([0, 1, 2]))
    assert torch.equal(m.confmat, torch.eye(3, dtype=torch.int32))
    assert torch.equal(_confusion_matrix_update(_tt([0, 1, 2]), _tt([0, 1, 2]), 3), torch.eye(3, dtype=torch.int32))
