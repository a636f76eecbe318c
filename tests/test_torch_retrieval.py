"""The port's retrieval family against the JAX package's, on the CPU.

The same seeded numpy inputs go through JAX (on the CPU) and the port
(``device="cpu"``): the functional forms (values within 1e-6, every error
text equal), ``ranked_group_stats`` (its five arrays equal element for
element: ranks and counts exact), and the modules under every
``empty_target_action``, ``k`` in {None, 1, 3, larger than every group} and
``exclude``, held against JAX's module value and against JAX's per-query
oracle (``tests/retrieval/helpers.py``). The hazards: ``-0.0``/``+0.0``
ties, NaN scores, tied scores in input order, negative and sparse query
ids, one-element groups, a query whose every document is excluded, every
query empty under ``"skip"``. Then the modules' behaviour (``forward``,
``MetricCollection``, ``reset``, pickle, ``state_dict``), a JAX epoch carried
in by ``interop.state_from_jax``, and the ``_metric`` fallback of a user
subclass, as JAX's ``tests/retrieval/test_user_subclass.py`` drives it.
"""
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.functional as jf
from metrics_tpu.ops.segment import ranked_group_stats as jax_ranked_group_stats
from metrics_tpu.utilities.data import get_group_indexes as jax_get_group_indexes
from metrics_tpu_torch import (
    MetricCollection,
    RetrievalMAP,
    RetrievalMRR,
    RetrievalPrecision,
    RetrievalRecall,
)
from metrics_tpu_torch import functional as tf
from metrics_tpu_torch.interop import state_from_jax
from metrics_tpu_torch.ops import segment
from metrics_tpu_torch.retrieval import RetrievalMetric
from metrics_tpu_torch.utilities.data import get_group_indexes
from tests.retrieval.helpers import _compute_sklearn_metric

TOL = 1e-6
CPU = torch.device("cpu")

_FUNCTIONAL = {
    "ap": (jf.retrieval_average_precision, tf.retrieval_average_precision),
    "rr": (jf.retrieval_reciprocal_rank, tf.retrieval_reciprocal_rank),
    "precision": (jf.retrieval_precision, tf.retrieval_precision),
    "recall": (jf.retrieval_recall, tf.retrieval_recall),
}
_MODULES = {
    "map": (jm.RetrievalMAP, RetrievalMAP),
    "mrr": (jm.RetrievalMRR, RetrievalMRR),
    "precision": (jm.RetrievalPrecision, RetrievalPrecision),
    "recall": (jm.RetrievalRecall, RetrievalRecall),
}


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


# ---- per-query oracles (float64 numpy), the ranking of a stable sort by descending score ----


def _order(preds):
    key = np.where(np.isnan(preds), -np.inf, preds.astype(np.float64))
    return np.argsort(-key, kind="stable")


def _oracle_ap(target, preds):
    rel = target[_order(preds)] > 0
    ranks = np.flatnonzero(rel) + 1
    return float(np.mean(np.arange(1, len(ranks) + 1) / ranks))


def _oracle_rr(target, preds):
    return 1.0 / (np.flatnonzero(target[_order(preds)] > 0)[0] + 1)


def _oracle_precision(target, preds, k=None):
    k = len(preds) if k is None else k
    return float(np.sum(target[_order(preds)][:k] > 0)) / k


def _oracle_recall(target, preds, k=None):
    k = len(preds) if k is None else k
    return float(np.sum(target[_order(preds)][:k] > 0)) / np.sum(target > 0)


_ORACLES = {"map": _oracle_ap, "mrr": _oracle_rr, "precision": _oracle_precision, "recall": _oracle_recall}


# ---- inputs ------------------------------------------------------------------------


def _query(n, seed, special=None):
    rng = np.random.default_rng(seed)
    preds = rng.random(n).astype(np.float32)
    target = (rng.random(n) < 0.4).astype(np.int32)
    if special == "ties":
        preds = (rng.integers(0, 3, n) / 3).astype(np.float32)
    elif special == "signed_zeros":
        preds = np.where(rng.random(n) < 0.5, 0.0, -0.0).astype(np.float32)
    elif special == "nan":
        preds[::3] = np.nan
    elif special == "none_relevant":
        target[:] = 0
    elif special == "bool":
        target = target.astype(bool)
    return preds, target


QUERIES = [(1, 0, None), (7, 1, None), (40, 2, None), (40, 3, "ties"), (12, 4, "signed_zeros"),
           (20, 5, "nan"), (9, 6, "none_relevant"), (15, 7, "bool")]


FUNCTIONAL_K = [("ap", None), ("rr", None)] + [(name, k) for name in ("precision", "recall") for k in (None, 1, 3, 100)]


@pytest.mark.parametrize("name, k", FUNCTIONAL_K)
@pytest.mark.parametrize("n, seed, special", QUERIES)
def test_functional_matches_jax(name, k, n, seed, special):
    preds, target = _query(n, seed, special)
    jax_fn, port_fn = _FUNCTIONAL[name]
    kwargs = {} if k is None else {"k": k}
    want = float(jax_fn(*_j(preds, target), **kwargs))
    got = port_fn(*_t(preds, target), **kwargs)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= TOL, (float(got), want)


def _raised(fn, *args, **kwargs):
    with pytest.raises(ValueError) as info:
        fn(*args, **kwargs)
    return str(info.value)


BAD_FUNCTIONAL = {
    "shape": (np.zeros(3, np.float32), np.zeros(4, np.int32), {}),
    "empty": (np.zeros(0, np.float32), np.zeros(0, np.int32), {}),
    "float_target": (np.zeros(3, np.float32), np.zeros(3, np.float32), {}),
    "non_binary": (np.zeros(3, np.float32), np.array([0, 2, 1], np.int32), {}),
    "negative_target": (np.zeros(3, np.float32), np.array([0, -1, 1], np.int32), {}),
    "int_preds": (np.zeros(3, np.int32), np.array([0, 1, 1], np.int32), {}),
    "k_zero": (np.zeros(3, np.float32), np.array([0, 1, 1], np.int32), {"k": 0}),
    "k_float": (np.zeros(3, np.float32), np.array([0, 1, 1], np.int32), {"k": 2.0}),
}


BAD_CASES = [(name, case) for name in _FUNCTIONAL for case in BAD_FUNCTIONAL
             if name in ("precision", "recall") or not BAD_FUNCTIONAL[case][2]]


@pytest.mark.parametrize("name, case", BAD_CASES)
def test_functional_errors_match_jax(name, case):
    preds, target, kwargs = BAD_FUNCTIONAL[case]
    jax_fn, port_fn = _FUNCTIONAL[name]
    assert _raised(port_fn, *_t(preds, target), **kwargs) == _raised(jax_fn, *_j(preds, target), **kwargs)


# ---- ranked_group_stats ---------------------------------------------------------------


def _grouped(n, groups, seed, special=None):
    rng = np.random.default_rng(seed)
    group = rng.integers(0, groups, n).astype(np.int32)
    preds, target = _query(n, seed + 100, special)
    return group, preds, target


STATS_CASES = [(1, 1, 0, None), (200, 7, 1, None), (300, 13, 2, "ties"), (64, 5, 3, "signed_zeros"),
               (90, 4, 4, "nan"), (50, 60, 5, None)]


@pytest.mark.parametrize("form", ["two_pass", "packed"])
@pytest.mark.parametrize("n, groups, seed, special", STATS_CASES)
def test_ranked_group_stats_equals_jax(monkeypatch, form, n, groups, seed, special):
    """All five arrays element for element; absent groups (50 elements over
    60 ids) get empty statistics in both."""
    monkeypatch.setattr(segment, "_lex_order", getattr(segment, f"_lex_order_{form}"))
    group, preds, target = _grouped(n, groups, seed, special)
    want = jax_ranked_group_stats(*_j(group, preds, target), num_groups=groups)
    got = segment.ranked_group_stats(*_t(group, preds, target), num_groups=groups)
    assert got.rank.dtype == got.cum_relevant.dtype == got.pos_per_group.dtype == torch.int32
    for field in ("group", "relevant", "rank", "cum_relevant", "pos_per_group"):
        assert np.array_equal(_np(getattr(got, field)), np.asarray(getattr(want, field))), field


@pytest.mark.parametrize("n, groups, seed, special", STATS_CASES)
def test_both_sort_forms_give_one_permutation(n, groups, seed, special):
    group, preds, _ = _grouped(n, groups, seed, special)
    group = group - groups // 2  # signed ids: the packed form's high word stays monotone
    g2, o2 = segment._lex_order_two_pass(*_t(group, preds))
    gp, op = segment._lex_order_packed(*_t(group, preds))
    assert torch.equal(g2, gp) and torch.equal(o2, op)


@pytest.mark.parametrize("k", [None, 1, 3, 1000])
def test_hits_in_topk_equals_jax(k):
    from metrics_tpu.ops.segment import hits_in_topk as jax_hits_in_topk

    group, preds, target = _grouped(300, 11, 9, "ties")
    want = jax_hits_in_topk(jax_ranked_group_stats(*_j(group, preds, target), num_groups=11), k)
    got = segment.hits_in_topk(segment.ranked_group_stats(*_t(group, preds, target), num_groups=11), k)
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), np.asarray(w))


def test_fixed_point_group_sums_are_float64_sums():
    rng = np.random.default_rng(3)
    values = torch.from_numpy(rng.random(10_000))
    starts = torch.tensor([0, 10, 10, 4000])
    ends = torch.tensor([10, 10, 4000, 10_000])
    got = segment._fixed_point_group_sums(values, starts, ends)
    want = [float(values[lo:hi].sum()) for lo, hi in zip(starts.tolist(), ends.tolist())]
    assert np.allclose(_np(got), want, rtol=0, atol=1e-9)


def test_get_group_indexes_equals_jax():
    idx = np.array([5, 2, 5, -1, 2, 7, 5], np.int32)
    got = [_np(g) for g in get_group_indexes(torch.from_numpy(idx))]
    want = [np.asarray(g) for g in jax_get_group_indexes(jnp.asarray(idx))]
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))


# ---- the modules -----------------------------------------------------------------------


def _epoch(n_queries, docs, seed, exclude=False, empty=()):
    """Flat, shuffled ``(idx, preds, target)`` of ``n_queries`` queries of
    ``docs`` documents each (as JAX's harness builds them), some queries
    without a relevant document, a quarter of the targets excluded."""
    rng = np.random.default_rng(seed)
    idx = np.repeat(np.arange(n_queries), docs).astype(np.int64)
    preds = rng.standard_normal(idx.size).astype(np.float32)
    target = (rng.standard_normal(idx.size) > 0).astype(np.int64)
    target[np.isin(idx, empty)] = 0
    if exclude:
        target[rng.random(idx.size) < 0.25] = -100
    # every query outside ``empty`` keeps a relevant document
    firsts = np.arange(0, idx.size, docs)
    target[firsts[~np.isin(idx[firsts], empty)]] = 1
    perm = rng.permutation(idx.size)
    return idx[perm], preds[perm], target[perm]


def _oracle(name, idx, preds, target, action, k=None):
    kwargs = {} if k is None or name in ("map", "mrr") else {"k": k}
    keep = target != -100
    idx, preds, target = idx[keep], preds[keep], target[keep]
    queries = np.unique(idx)
    return float(_compute_sklearn_metric(_ORACLES[name], [target[idx == q] for q in queries],
                                         [preds[idx == q] for q in queries], action, **kwargs))


def _both(name, kwargs, *batches):
    jax_cls, port_cls = _MODULES[name]
    jmetric, tmetric = jax_cls(**kwargs), port_cls(device=CPU, **kwargs)
    for batch in batches:
        jmetric.update(*_j(*batch))
        tmetric.update(*_t(*batch))
    return jmetric, tmetric


MODULE_K = [("map", None), ("mrr", None), ("precision", None), ("precision", 1), ("precision", 3),
            ("precision", 50), ("recall", None), ("recall", 1), ("recall", 3), ("recall", 50)]


@pytest.mark.parametrize("name, k", MODULE_K)
@pytest.mark.parametrize("action", ["skip", "pos", "neg", "error"])
@pytest.mark.parametrize("exclude", [False, True])
def test_module_matches_jax_and_the_oracle(name, k, action, exclude):
    empty = () if action == "error" else (2, 5)
    idx, preds, target = _epoch(9, 8, seed=sum(map(ord, f"{name}{k}{action}{exclude}")), exclude=exclude, empty=empty)
    kwargs = {"empty_target_action": action, **({} if k is None else {"k": k})}
    half = idx.size // 2
    jmetric, tmetric = _both(name, kwargs, (idx[:half], preds[:half], target[:half]),
                             (idx[half:], preds[half:], target[half:]))
    got = tmetric.compute()
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - float(jmetric.compute())) <= TOL
    assert abs(float(got) - _oracle(name, idx, preds, target, action, k)) <= TOL


@pytest.mark.parametrize("name", list(_MODULES))
def test_error_action_raises_as_jax(name):
    idx, preds, target = _epoch(5, 6, seed=11, empty=(3,))
    jmetric, tmetric = _both(name, {"empty_target_action": "error"}, (idx, preds, target))
    assert _raised(tmetric.compute) == _raised(jmetric.compute)


def _hazard(case):
    rng = np.random.default_rng(21)
    if case == "signed_zero_ties":
        idx = np.repeat([0, 1, 2], 6)
        preds = np.where(rng.random(18) < 0.5, 0.0, -0.0).astype(np.float32)
        target = np.tile([0, 1, 0, 0, 1, 0], 3)
    elif case == "nan_scores":
        idx = rng.integers(0, 4, 40)
        preds = rng.random(40).astype(np.float32)
        preds[::4] = np.nan
        target = (rng.random(40) < 0.5).astype(np.int64)
    elif case == "ties_in_input_order":
        idx = rng.integers(0, 3, 60)
        preds = (rng.integers(0, 2, 60) / 2).astype(np.float32)
        target = (rng.random(60) < 0.5).astype(np.int64)
    elif case == "negative_sparse_ids":
        idx = rng.choice(np.array([-2**31, -7, -1, 0, 1_000_003, 2**31 - 1]), 48)
        preds = rng.random(48).astype(np.float32)
        target = (rng.random(48) < 0.5).astype(np.int64)
    elif case == "one_element_groups":
        idx = np.arange(30) * 3
        preds = rng.random(30).astype(np.float32)
        target = (rng.random(30) < 0.5).astype(np.int64)
    elif case == "query_all_excluded":
        idx = np.repeat([0, 1, 2], 5)
        preds = rng.random(15).astype(np.float32)
        target = np.tile([1, 0, 1, 0, 0], 3)
        target[5:10] = -100
    else:  # all_queries_empty
        idx = np.repeat([0, 1, 2], 4)
        preds = rng.random(12).astype(np.float32)
        target = np.zeros(12, np.int64)
    return idx.astype(np.int64), preds, target


HAZARDS = ["signed_zero_ties", "nan_scores", "ties_in_input_order", "negative_sparse_ids",
           "one_element_groups", "query_all_excluded", "all_queries_empty"]


@pytest.mark.parametrize("case", HAZARDS)
@pytest.mark.parametrize("name, k", [("map", None), ("mrr", None), ("precision", 2), ("recall", 2)])
@pytest.mark.parametrize("action", ["skip", "neg"])
def test_hazards_match_jax_and_the_oracle(case, name, k, action):
    idx, preds, target = _hazard(case)
    kwargs = {"empty_target_action": action, **({} if k is None else {"k": k})}
    jmetric, tmetric = _both(name, kwargs, (idx, preds, target))
    got = float(tmetric.compute())
    assert abs(got - float(jmetric.compute())) <= TOL
    assert abs(got - _oracle(name, idx, preds, target, action, k)) <= TOL
    if case == "all_queries_empty" and action == "skip":
        assert got == 0.0


@pytest.mark.parametrize("name", list(_MODULES))
def test_module_errors_match_jax(name):
    jax_cls, port_cls = _MODULES[name]
    ok = (np.zeros(4, np.int64), np.zeros(4, np.float32), np.zeros(4, np.int64))
    bad = [
        (np.zeros(3, np.int64), ok[1], ok[2]),
        (ok[0], np.zeros(3, np.float32), ok[2]),
        (ok[0].astype(bool), ok[1], ok[2]),
        (ok[0].astype(np.float32), ok[1], ok[2]),
        (ok[0], ok[1].astype(bool), ok[2]),
        (ok[0], ok[1], ok[2].astype(np.float32)),
        (ok[0], ok[1], np.array([0, 2, 1, 0])),
    ]
    for batch in bad:
        assert _raised(port_cls(device=CPU).update, *_t(*batch)) == _raised(jax_cls().update, *_j(*batch))
    for kwargs in ({"empty_target_action": "casual_argument"},) + (({"k": 0}, {"k": -1}, {"k": 1.5})
                                                                    if name in ("precision", "recall") else ()):
        assert _raised(port_cls, device=CPU, **kwargs) == _raised(jax_cls, **kwargs)


def test_exclude_value_is_masked_only_for_the_binary_check():
    idx, preds, target = _hazard("query_all_excluded")
    target = target.copy()
    target[target == -100] = 7
    jmetric, tmetric = _both("map", {"exclude": 7}, (idx, preds, target))
    assert abs(float(tmetric.compute()) - float(jmetric.compute())) <= TOL


# ---- module behaviour --------------------------------------------------------------------


def _batches(n_batches=4, n=64, n_queries=9, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, n_queries, n), rng.random(n).astype(np.float32), rng.integers(0, 2, n))
            for _ in range(n_batches)]


@pytest.mark.parametrize("name", list(_MODULES))
def test_forward_returns_the_batch_value_and_keeps_the_epoch(name):
    kwargs = {"k": 3} if name in ("precision", "recall") else {}
    jax_cls, port_cls = _MODULES[name]
    jmetric, tmetric = jax_cls(**kwargs), port_cls(device=CPU, **kwargs)
    for batch in _batches():
        step = tmetric(*_t(*batch))
        assert abs(float(step) - float(jmetric(*_j(*batch)))) <= TOL
        alone = port_cls(device=CPU, **kwargs)
        alone.update(*_t(*batch))
        assert torch.equal(step, alone.compute())
    assert abs(float(tmetric.compute()) - float(jmetric.compute())) <= TOL


def test_collection_reset_pickle_and_state_dict():
    def collection():
        return MetricCollection([RetrievalMAP(device=CPU), RetrievalMRR(device=CPU),
                                 RetrievalPrecision(k=3, device=CPU), RetrievalRecall(k=3, device=CPU)])

    jcol = jm.MetricCollection([jm.RetrievalMAP(), jm.RetrievalMRR(), jm.RetrievalPrecision(k=3),
                                jm.RetrievalRecall(k=3)])
    tcol = collection()
    batches = _batches(seed=4)
    for batch in batches:
        tcol.update(*_t(*batch))
        jcol.update(*_j(*batch))
    want = {k: float(v) for k, v in jcol.compute().items()}
    got = tcol.compute()
    assert set(got) == set(want) and all(abs(float(got[k]) - want[k]) <= TOL for k in want)

    restored = pickle.loads(pickle.dumps(tcol))
    assert all(torch.equal(restored.compute()[k], got[k]) for k in got)

    tcol.persistent(True)
    loaded = collection()
    loaded.load_state_dict(tcol.state_dict(), strict=True)
    assert all(torch.equal(loaded.compute()[k], got[k]) for k in got)

    tcol.reset()
    assert all(not m.idx and not m.preds and not m.target for m in tcol.values())
    tcol.update(*_t(*batches[0]))
    alone = RetrievalMAP(device=CPU)
    alone.update(*_t(*batches[0]))
    assert torch.equal(tcol.compute()["RetrievalMAP"], alone.compute())


@pytest.mark.parametrize("name", ["map", "precision"])
def test_state_from_jax_computes_the_same_value(name):
    kwargs = {"k": 2} if name == "precision" else {}
    jax_cls, port_cls = _MODULES[name]
    jmetric = jax_cls(**kwargs)
    for batch in _batches(seed=6):
        jmetric.update(*_j(*batch))
    jmetric.persistent(True)
    state = {k: [np.asarray(v) for v in vs] for k, vs in jmetric.state_dict().items()}
    tmetric = port_cls(device=CPU, **kwargs)
    tmetric.load_state_dict(state_from_jax(state), strict=True)
    assert abs(float(tmetric.compute()) - float(jmetric.compute())) <= TOL


def test_second_compute_gives_the_same_bits():
    metric = RetrievalMAP(device=CPU)
    for batch in _batches(seed=8):
        metric.update(*_t(*batch))
    first = metric.compute()
    metric._computed = None
    assert torch.equal(first, metric.compute())


# ---- a user subclass: the _metric fallback ------------------------------------------------


class UserMAP(RetrievalMetric):
    """Average precision from scratch, per query, reference-style."""

    def _metric(self, preds, target):
        rel = target[torch.argsort(-preds, stable=True)].to(torch.float32)
        ranks = torch.arange(1, rel.shape[0] + 1, dtype=torch.float32)
        return torch.sum(torch.where(rel == 1, torch.cumsum(rel, 0) / ranks, 0.0)) / torch.clamp_min(rel.sum(), 1.0)


class UserMRR(RetrievalMetric):
    def _metric(self, preds, target):
        rel = target[torch.argsort(-preds, stable=True)]
        return torch.where(torch.any(rel == 1), 1.0 / (torch.argmax(rel) + 1.0), 0.0)


class UserPrecisionAt2(RetrievalMetric):
    def _metric(self, preds, target):
        k = min(2, preds.shape[0])
        return torch.sum(target[torch.argsort(-preds, stable=True)][:k]) / k


@pytest.mark.parametrize("user_cls, builtin_cls, kwargs", [
    (UserMAP, RetrievalMAP, {}), (UserMRR, RetrievalMRR, {}), (UserPrecisionAt2, RetrievalPrecision, {"k": 2})])
@pytest.mark.parametrize("action", ["skip", "pos", "neg"])
@pytest.mark.parametrize("ties", [False, True])
def test_user_subclass_matches_builtin(user_cls, builtin_cls, kwargs, action, ties):
    user = user_cls(empty_target_action=action, device=CPU)
    builtin = builtin_cls(empty_target_action=action, device=CPU, **kwargs)
    for idx, preds, target in _batches(seed=1):
        if ties:
            preds = (np.round(preds * 5) / 5).astype(np.float32)
        user.update(*_t(idx, preds, target))
        builtin.update(*_t(idx, preds, target))
    assert abs(float(user.compute()) - float(builtin.compute())) <= TOL


def test_unimplemented_metric_raises():
    class Incomplete(RetrievalMetric):
        pass

    metric = Incomplete(device=CPU)
    metric.update(torch.tensor([0, 0, 1, 1]), torch.tensor([0.3, 0.2, 0.6, 0.1]), torch.tensor([1, 0, 1, 1]))
    with pytest.raises(NotImplementedError):
        metric.compute()
