"""The port's multi-class / multi-label slice against the JAX package, on the CPU.

Inputs are made with numpy from a seed and go through both packages:

* the batched tie scan's plain version (``tie_group_reduce_rows_reference``)
  against ``jax.vmap`` of the Pallas kernel in interpret mode on the same
  sorted rows: exact counts, area/AP to 1e-6 relative (both sum the same
  f32 terms in other orders);
* ``multiclass_auroc_ovr`` and functional/module ``auroc`` against the JAX
  package (which runs its CPU path here) and sklearn, to 1e-5 (the JAX
  suite's AUROC tolerance);
* multi-class ``average_precision`` per-class lists against the JAX
  package, to 2e-5 (the JAX suite's AP tolerance);
* the errors of the degenerate branches, the branches the JAX package runs
  on its curve path (value or error), ``label_bincount`` and
  ``state_from_jax`` of the new metrics.

The batched CUDA kernel itself is held against the plain version on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from sklearn.metrics import average_precision_score, roc_auc_score

import metrics_tpu as jm
from metrics_tpu.functional import auroc as jax_auroc
from metrics_tpu.functional import average_precision as jax_average_precision
from metrics_tpu.functional.classification.precision_recall_curve import (
    _precision_recall_curve_update as jax_prc_update,
)
from metrics_tpu.ops.auroc_kernel import _descending_key as jax_descending_key
from metrics_tpu.ops.auroc_kernel import multiclass_auroc_ovr as jax_multiclass_auroc_ovr
from metrics_tpu.ops.histogram import label_bincount as jax_label_bincount
from metrics_tpu.ops.tie_scan_pallas import tie_group_reduce as jax_tie_group_reduce
from metrics_tpu_torch import AUROC, AveragePrecision
from metrics_tpu_torch.functional import auroc, average_precision
from metrics_tpu_torch.functional.classification.precision_recall_curve import _precision_recall_curve_update
from metrics_tpu_torch.interop import state_from_jax
from metrics_tpu_torch.ops.auroc_kernel import (
    _co_sort_rows,
    _payload,
    _sortable_key,
    multiclass_auroc_ovr,
    multiclass_average_precision,
    multilabel_auroc,
)
from metrics_tpu_torch.ops.histogram import label_bincount
from metrics_tpu_torch.ops.tie_scan import (
    auroc_ap_from_stats,
    tie_group_reduce,
    tie_group_reduce_reference,
    tie_group_reduce_rows,
    tie_group_reduce_rows_reference,
)
from tests.classification.inputs import _input_binary_prob
from tests.classification.inputs import _input_multiclass_prob as _input_mcls_prob
from tests.classification.inputs import _input_multidim_multiclass_prob as _input_mdmc_prob
from tests.classification.inputs import _input_multilabel_multidim_prob as _input_mlmd_prob
from tests.classification.inputs import _input_multilabel_prob as _input_mlb_prob
from tests.helpers.testers import NUM_CLASSES

CPU = "cpu"
STATS_RTOL = 1e-6  # area/AP sums of the plain version vs the Pallas kernel
AUROC_TOL = 1e-5  # the JAX suite's AUROC tolerance
AP_TOL = 2e-5  # the JAX suite's AP tolerance


def _tt(a):
    return torch.from_numpy(np.array(a))


def _softmax(x):
    e = np.exp(x - x.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def _error(fn, *args, **kwargs):
    with pytest.raises(Exception) as info:
        fn(*args, **kwargs)
    return type(info.value).__name__, str(info.value)


def _assert_scores_close(ours, ref, tol):
    """Per-class scores (tensors, arrays or lists of 0-d values) equal within
    ``tol``, NaN exactly where the reference has NaN."""
    ours = np.array([float(x) for x in ours]) if isinstance(ours, list) else np.asarray(ours, np.float64)
    ref = np.array([float(x) for x in ref]) if isinstance(ref, list) else np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    np.testing.assert_allclose(ours[~np.isnan(ref)], ref[~np.isnan(ref)], rtol=0, atol=tol)


# ---- the batched tie scan vs jax.vmap of the Pallas kernel -------------------


def _jax_sorted_rows(scores, rel):
    """Row-wise co-sort in the JAX package: (C, N) u32 keys and payloads."""
    keys = jax.vmap(jax_descending_key)(jnp.asarray(scores))
    sort = jax.vmap(lambda k, p: lax.sort((k, p), num_keys=1, is_stable=False))
    key_s, pay_s = sort(keys, jnp.asarray(rel, jnp.float32) + 2.0)
    return np.array(key_s), np.array(pay_s)


def _tie_heavy_rows(rows, n, seed):
    rng = np.random.default_rng(seed)
    scores = np.round(rng.standard_normal((rows, n)), 1).astype(np.float32)
    rel = rng.random((rows, n)) < 0.4
    scores[0] = 0.5  # one tie group spanning the whole row
    rel[-1] = False  # a row without positives
    return scores, rel


@pytest.mark.parametrize("rows, n", [(3, 2000), (4, 33000)])
def test_rows_reference_matches_vmapped_pallas_kernel(rows, n):
    scores, rel = _tie_heavy_rows(rows, n, seed=rows * n)
    key_s, pay_s = _jax_sorted_rows(scores, rel)
    want = np.asarray(
        jax.vmap(lambda k, p: jax_tie_group_reduce(k, p, interpret=True))(jnp.asarray(key_s), jnp.asarray(pay_s))
    )
    got = tie_group_reduce_rows_reference(torch.from_numpy(key_s), torch.from_numpy(pay_s))
    assert got.shape == (rows, 4) and got.dtype == torch.float32
    np.testing.assert_array_equal(got[:, 2:].numpy(), want[:, 2:])  # exact counts
    np.testing.assert_allclose(got[:, :2].numpy(), want[:, :2], rtol=STATS_RTOL, atol=0)
    # on CPU tensors the wrapper is the plain version
    assert torch.equal(tie_group_reduce_rows(torch.from_numpy(key_s), torch.from_numpy(pay_s)), got)
    # the row without positives gives NaN, as the JAX normalization does
    auroc_t, ap_t = auroc_ap_from_stats(got)
    assert torch.isnan(auroc_t[-1]) and torch.isnan(ap_t[-1])


def test_rows_reference_rows_equal_one_stream_reference():
    scores, rel = _tie_heavy_rows(5, 3000, seed=4)
    key_s, pay_s = _jax_sorted_rows(scores, rel)
    rows = tie_group_reduce_rows_reference(torch.from_numpy(key_s), torch.from_numpy(pay_s), offsets=(7.0, 3.0))
    for r in range(5):
        one = tie_group_reduce(torch.from_numpy(key_s[r]), torch.from_numpy(pay_s[r]), offsets=(7.0, 3.0))
        assert torch.equal(rows[r], one)
        assert torch.equal(one, tie_group_reduce_reference(torch.from_numpy(key_s[r]), torch.from_numpy(pay_s[r]),
                                                          offsets=(7.0, 3.0)))


def test_segmented_co_sort_sorts_each_row_like_jax():
    scores, rel = _tie_heavy_rows(4, 5000, seed=5)
    want_keys, _ = _jax_sorted_rows(scores, rel)
    key_s, pay_s = _co_sort_rows(_sortable_key(torch.from_numpy(scores)), _payload(torch.from_numpy(rel).float(), None))
    # the int32 key is the uint32 key with its sign bit flipped
    np.testing.assert_array_equal((key_s.numpy().view(np.uint32) ^ np.uint32(2**31)), want_keys)
    # the payload rides along: each row keeps its class counts
    np.testing.assert_array_equal((pay_s == 3.0).sum(1).numpy(), rel.sum(1))


def test_empty_rows_give_zero_stats():
    assert torch.equal(tie_group_reduce_rows(torch.zeros(3, 0, dtype=torch.int32), torch.zeros(3, 0)),
                       torch.zeros(3, 4))


# ---- multiclass_auroc_ovr / per-class AP / per-label AUROC ------------------


def _multiclass_case(n, c, seed, ties=False, absent=None):
    rng = np.random.default_rng(seed)
    preds = _softmax(rng.standard_normal((n, c)) + 2.0 * np.eye(c)[rng.integers(0, c, n)])
    if ties:
        preds = np.round(preds, 2).astype(np.float32)
    target = rng.integers(0, c, n)
    if absent is not None:
        target[target == absent] = (absent + 1) % c
    return preds, target


@pytest.mark.parametrize("n, c, ties", [(300, 4, False), (2000, 7, True), (5000, 10, True)])
def test_multiclass_auroc_ovr_matches_jax_and_sklearn(n, c, ties):
    preds, target = _multiclass_case(n, c, seed=n + c, ties=ties)
    got = multiclass_auroc_ovr(_tt(preds), _tt(target))
    assert got.shape == (c,) and got.dtype == torch.float32
    _assert_scores_close(got, jax_multiclass_auroc_ovr(jnp.asarray(preds), jnp.asarray(target)), AUROC_TOL)
    _assert_scores_close(got, [roc_auc_score(target == k, preds[:, k]) for k in range(c)], AUROC_TOL)


@pytest.mark.parametrize("n, c, ties", [(300, 4, False), (2000, 7, True)])
def test_multiclass_average_precision_matches_sklearn(n, c, ties):
    preds, target = _multiclass_case(n, c, seed=n * c, ties=ties)
    got = multiclass_average_precision(_tt(preds), _tt(target))
    _assert_scores_close(got, [average_precision_score(target == k, preds[:, k]) for k in range(c)], AP_TOL)


def test_multilabel_auroc_matches_sklearn():
    rng = np.random.default_rng(6)
    target = rng.random((1500, 6)) < 0.3
    preds = np.round(rng.random((1500, 6)) + 0.3 * target, 2).astype(np.float32)
    got = multilabel_auroc(_tt(preds), _tt(target.astype(np.int64)))
    _assert_scores_close(got, [roc_auc_score(target[:, k], preds[:, k]) for k in range(6)], AUROC_TOL)


def test_absent_or_whole_class_is_nan_like_jax():
    preds, target = _multiclass_case(400, 5, seed=7, absent=2)
    got_auroc = multiclass_auroc_ovr(_tt(preds), _tt(target))
    got_ap = multiclass_average_precision(_tt(preds), _tt(target))
    want = np.asarray(jax_multiclass_auroc_ovr(jnp.asarray(preds), jnp.asarray(target)))
    assert np.isnan(want[2]) and torch.isnan(got_auroc[2]) and torch.isnan(got_ap[2])
    _assert_scores_close(got_auroc, want, AUROC_TOL)
    _assert_scores_close(got_ap, jax_average_precision(jnp.asarray(preds), jnp.asarray(target), num_classes=5),
                         AP_TOL)
    # a class that covers every sample has no negatives: AUROC is NaN
    whole = np.zeros(50, np.int64)
    p = _softmax(np.random.default_rng(8).standard_normal((50, 3)))
    got = multiclass_auroc_ovr(_tt(p), _tt(whole))
    assert torch.isnan(got).all()
    _assert_scores_close(got, jax_multiclass_auroc_ovr(jnp.asarray(p), jnp.asarray(whole)), AUROC_TOL)


# ---- functional auroc over the JAX suite's five input kinds ------------------

INPUT_KINDS = [
    ("binary", _input_binary_prob, 1),
    ("multiclass", _input_mcls_prob, NUM_CLASSES),
    ("multidim_multiclass", _input_mdmc_prob, NUM_CLASSES),
    ("multilabel", _input_mlb_prob, NUM_CLASSES),
    ("multilabel_multidim", _input_mlmd_prob, NUM_CLASSES),
]


@pytest.mark.parametrize("kind, inputs, num_classes", INPUT_KINDS, ids=[k[0] for k in INPUT_KINDS])
@pytest.mark.parametrize("average", ["macro", "weighted", None])
def test_functional_auroc_matches_jax(kind, inputs, num_classes, average):
    preds, target = inputs.preds[0], inputs.target[0]
    got = auroc(_tt(preds), _tt(target), num_classes=num_classes, average=average)
    want = jax_auroc(jnp.asarray(preds), jnp.asarray(target), num_classes=num_classes, average=average)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want) and all(g.ndim == 0 for g in got)
    else:
        assert isinstance(got, torch.Tensor) and got.shape == ()
        got, want = [got], [want]
    _assert_scores_close(got, want, AUROC_TOL)


@pytest.mark.parametrize("kind, inputs, num_classes", INPUT_KINDS[1:], ids=[k[0] for k in INPUT_KINDS[1:]])
@pytest.mark.parametrize("average", ["macro", "weighted"])
def test_module_auroc_over_batches_matches_jax(kind, inputs, num_classes, average):
    ours = AUROC(num_classes=num_classes, average=average, device=CPU)
    ref = jm.AUROC(num_classes=num_classes, average=average)
    for i in range(4):
        p, t = inputs.preds[i], inputs.target[i]
        step, want_step = ours(_tt(p), _tt(t)), ref(jnp.asarray(p), jnp.asarray(t))
        _assert_scores_close([step], [want_step], AUROC_TOL)
    _assert_scores_close([ours.compute()], [ref.compute()], AUROC_TOL)


def test_multiclass_weighted_support_is_the_label_count():
    preds, target = _multiclass_case(600, 4, seed=9)
    per_class = multiclass_auroc_ovr(_tt(preds), _tt(target))
    support = np.bincount(target, minlength=4)
    want = float(np.sum(per_class.numpy() * support / support.sum()))
    assert abs(float(auroc(_tt(preds), _tt(target), num_classes=4, average="weighted")) - want) < 1e-6


# ---- average precision -----------------------------------------------------


@pytest.mark.parametrize("n, c, ties", [(200, 3, False), (3000, NUM_CLASSES, True), (1000, 12, True)])
def test_multiclass_average_precision_list_matches_jax(n, c, ties):
    preds, target = _multiclass_case(n, c, seed=n + 3 * c, ties=ties)
    got = average_precision(_tt(preds), _tt(target), num_classes=c)
    want = jax_average_precision(jnp.asarray(preds), jnp.asarray(target), num_classes=c)
    assert isinstance(got, list) and len(got) == c
    _assert_scores_close(got, want, AP_TOL)


def test_binary_average_precision_matches_jax():
    p, t = _input_binary_prob.preds[1], _input_binary_prob.target[1]
    got = average_precision(_tt(p), _tt(t), pos_label=1)
    assert got.shape == ()
    _assert_scores_close([got], [jax_average_precision(jnp.asarray(p), jnp.asarray(t), pos_label=1)], AP_TOL)


@pytest.mark.parametrize(
    "kind, inputs, num_classes, pos_label",
    [("binary", _input_binary_prob, None, 1), ("multiclass", _input_mcls_prob, NUM_CLASSES, None),
     ("multidim_multiclass", _input_mdmc_prob, NUM_CLASSES, None)],
    ids=["binary", "multiclass", "multidim_multiclass"],
)
def test_module_average_precision_over_batches_matches_jax(kind, inputs, num_classes, pos_label):
    ours = AveragePrecision(num_classes=num_classes, pos_label=pos_label, device=CPU)
    ref = jm.AveragePrecision(num_classes=num_classes, pos_label=pos_label)
    for i in range(4):
        p, t = inputs.preds[i], inputs.target[i]
        step = ours(_tt(p), _tt(t))
        want_step = ref(jnp.asarray(p), jnp.asarray(t))
        _assert_scores_close(step if isinstance(step, list) else [step],
                             want_step if isinstance(want_step, list) else [want_step], AP_TOL)
    got, want = ours.compute(), ref.compute()
    _assert_scores_close(got if isinstance(got, list) else [got], want if isinstance(want, list) else [want], AP_TOL)
    assert (ours.num_classes, ours.pos_label) == (ref.num_classes, ref.pos_label)


@pytest.mark.parametrize(
    "preds, target, kwargs",
    [
        (np.random.default_rng(1).random((5, 3)).astype(np.float32), np.zeros(5, np.int64), {}),
        (np.random.default_rng(1).random((5, 3, 2)).astype(np.float32), np.zeros((5, 2), np.int64),
         {"num_classes": 3, "pos_label": 2}),
        (np.random.default_rng(1).random((4, 3)).astype(np.float32), np.ones((4, 3), np.int64), {"num_classes": 2}),
        (np.random.default_rng(1).random((4, 3, 2)).astype(np.float32), np.ones((4, 3, 2), np.int64),
         {"num_classes": 3}),
        (np.random.default_rng(1).random(6).astype(np.float32), np.ones(6, np.int64), {}),
        (np.random.default_rng(1).random((2, 3, 4)).astype(np.float32), np.ones(2, np.int64), {}),
    ],
    ids=["mc-no-num-classes", "mdmc-pos-label", "ml-wrong-num-classes", "mlmd", "binary", "bad-ndim"],
)
def test_precision_recall_curve_update_matches_jax(preds, target, kwargs):
    try:
        want = jax_prc_update(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    except Exception as err:  # noqa: BLE001 - the same error must come out of the port
        assert _error(_precision_recall_curve_update, _tt(preds), _tt(target), **kwargs) == (
            type(err).__name__, str(err))
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = _precision_recall_curve_update(_tt(preds), _tt(target), **kwargs)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2:] == tuple(want[2:])


# ---- errors ------------------------------------------------------------------


@pytest.mark.parametrize("column", ["all positive", "all negative"])
def test_degenerate_label_column_raises_like_jax(column):
    rng = np.random.default_rng(10)
    p = rng.random((20, 3)).astype(np.float32)
    t = rng.integers(0, 2, (20, 3))
    t[:2, :2] = [[1, 0], [0, 1]]  # columns 0 and 1 carry both classes
    t[:, 2] = 1 if column == "all positive" else 0
    assert _error(auroc, _tt(p), _tt(t), num_classes=3) == _error(jax_auroc, jnp.asarray(p), jnp.asarray(t),
                                                                  num_classes=3)


def test_micro_average_on_multiclass_raises_like_jax():
    preds, target = _multiclass_case(100, 4, seed=11)
    assert _error(auroc, _tt(preds), _tt(target), num_classes=4, average="micro") == _error(
        jax_auroc, jnp.asarray(preds), jnp.asarray(target), num_classes=4, average="micro")


def test_max_fpr_on_multiclass_raises_like_jax():
    preds, target = _multiclass_case(100, 4, seed=12)
    assert _error(auroc, _tt(preds), _tt(target), num_classes=4, max_fpr=0.5) == _error(
        jax_auroc, jnp.asarray(preds), jnp.asarray(target), num_classes=4, max_fpr=0.5)


_MC_PREDS, _MC_TARGET = _multiclass_case(60, 4, seed=13)
_ML_TARGET = np.random.default_rng(14).integers(0, 2, (60, 4))
_ML_TARGET[:2] = [[0, 0, 0, 0], [1, 1, 1, 1]]


@pytest.mark.parametrize(
    "fn, preds, target, kwargs",
    [
        (auroc, _MC_PREDS, _MC_TARGET, {}),
        (auroc, _MC_PREDS, _MC_TARGET, {"num_classes": 3}),
        (auroc, _MC_PREDS, _MC_TARGET, {"num_classes": 4, "sample_weights": [1.0] * 60}),
        (auroc, _MC_PREDS, _ML_TARGET, {"num_classes": 4, "average": "micro"}),
        (auroc, _MC_PREDS, _ML_TARGET, {"num_classes": 4, "sample_weights": [1.0] * 60}),
        (auroc, _MC_PREDS[:, 0], (_MC_TARGET == 0).astype(np.int64), {"max_fpr": 0.5}),
        (average_precision, _MC_PREDS, _ML_TARGET, {"num_classes": 4}),
        (average_precision, _MC_PREDS, _MC_TARGET, {"num_classes": 4, "sample_weights": [1.0] * 60}),
    ],
    ids=["mc-num-classes-unset", "mc-num-classes-differs", "mc-sample-weights", "ml-micro", "ml-sample-weights",
         "binary-max-fpr", "ap-multilabel", "ap-sample-weights"],
)
def test_curve_path_branches_raise_not_implemented(fn, preds, target, kwargs):
    """The branches the JAX package runs on its curve path, once left for a
    later slice, now give JAX's value (within the AUROC/AP tolerance) or
    raise JAX's ``ValueError``, message for message."""
    ref = jax_auroc if fn is auroc else jax_average_precision
    tol = AUROC_TOL if fn is auroc else AP_TOL
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = ref(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    except ValueError as err:
        assert _error(fn, _tt(preds), _tt(target), **kwargs) == ("ValueError", str(err))
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = fn(_tt(preds), _tt(target), **kwargs)
    _assert_scores_close(got if isinstance(got, list) else [got], want if isinstance(want, list) else [want], tol)


# ---- label_bincount, state_from_jax ----------------------------------------


@pytest.mark.parametrize("length", [1, 4, 40])
def test_label_bincount_matches_jax_out_of_range_contract(length):
    labels = np.random.default_rng(length).integers(-5, length + 5, 500).astype(np.int32)
    got = label_bincount(_tt(labels), length=length)
    want = np.asarray(jax_label_bincount(jnp.asarray(labels), length=length))
    assert got.shape == (length,)
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_state(metric):
    metric.persistent(True)
    return {k: [np.asarray(x) for x in v] if isinstance(v, list) else np.asarray(v)
            for k, v in metric.state_dict().items()}


def test_state_from_jax_carries_multiclass_auroc_and_ap():
    batches = [_multiclass_case(150, 5, seed=20 + i) for i in range(3)]
    ref_auroc, ref_ap = jm.AUROC(num_classes=5), jm.AveragePrecision(num_classes=5)
    for p, t in batches:
        ref_auroc.update(jnp.asarray(p), jnp.asarray(t))
        ref_ap.update(jnp.asarray(p), jnp.asarray(t))
    ours_auroc = AUROC(num_classes=5, device=CPU)
    ours_auroc.load_state_dict(state_from_jax(_jax_state(ref_auroc)), strict=True)
    assert ours_auroc.mode == "multi-class"
    _assert_scores_close([ours_auroc.compute()], [ref_auroc.compute()], AUROC_TOL)
    ours_ap = AveragePrecision(num_classes=5, device=CPU)
    ours_ap.load_state_dict(state_from_jax(_jax_state(ref_ap)), strict=True)
    _assert_scores_close(ours_ap.compute(), ref_ap.compute(), AP_TOL)
    # without num_classes, the re-derivation refuses multi-class state as JAX's does
    carried = state_from_jax(_jax_state(ref_ap))
    assert _error(AveragePrecision(device=CPU).load_state_dict, carried) == _error(
        jm.AveragePrecision().load_state_dict, {k: [jnp.asarray(x) for x in v] for k, v in _jax_state(ref_ap).items()})


def test_state_from_jax_rederives_binary_average_precision_settings():
    ref = jm.AveragePrecision(pos_label=1)
    for i in range(2):
        p, t = _input_binary_prob.preds[i], _input_binary_prob.target[i]
        ref.update(jnp.asarray(p), jnp.asarray(t))
    ours = AveragePrecision(device=CPU)
    ours.load_state_dict(state_from_jax(_jax_state(ref)), strict=True)
    assert (ours.num_classes, ours.pos_label) == (1, 1)
    _assert_scores_close([ours.compute()], [ref.compute()], AP_TOL)


def test_state_from_jax_carries_multilabel_auroc():
    rng = np.random.default_rng(30)
    ref = jm.AUROC(num_classes=3, average=None)
    for _ in range(2):
        ref.update(jnp.asarray(rng.random((80, 3)).astype(np.float32)), jnp.asarray(rng.integers(0, 2, (80, 3))))
    ours = AUROC(num_classes=3, average=None, device=CPU)
    ours.load_state_dict(state_from_jax(_jax_state(ref)), strict=True)
    assert ours.mode == "multi-label"
    _assert_scores_close(ours.compute(), ref.compute(), AUROC_TOL)
