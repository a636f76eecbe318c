"""The port's step engine against the JAX package's, on the CPU.

Every case of ``tests/bases/test_engine.py`` is mirrored: the same seeded
numpy inputs go through the JAX package's ``compiled=True`` collection (or
``CompiledStepEngine``), the port's compiled one (on the CPU the engine runs
its step function directly: the plain version of the card's CUDA graph) and
the port's eager one, step by step and at the epoch, and ``trace_count``
and the keys of ``eager_fallbacks`` must equal JAX's:

* compiled against eager, for the classification and regression families,
  on values, states and the epoch value;
* one trace per signature, a second shape adding exactly one;
* a single-metric engine; ``compute_on_step=False``;
* a list-state member kept eager; a non-fused metric kept eager;
* defaults never aliased; clone and pickle dropping the engine;
* the signature keyed on the kwargs structure; the capped cache;
* the regression family's shared pass, and a standalone metric keeping
  its own update;
* a bad input that raises without demoting.

And beyond those: the classification siblings counted once per batch;
JAX's error text for ``num_classes`` inference under the engine (the port
demotes only the member that fails; JAX demotes the whole compiled group);
and a gloo world of 2 in which the engine runs eager and equals the eager
collection.

Tolerance: rtol 1e-5, atol 1e-6 (float32 sums of the same terms, added in
another order by XLA and by PyTorch); the port's compiled and eager runs
are compared within the same tolerance, their integer counts exactly.
"""
import importlib
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu_torch as tm
from metrics_tpu_torch.functional.regression import sufficient_stats
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.checks import shared_canonicalization
from metrics_tpu_torch.utilities.data import to_onehot, tracing
from tests.torch_workers import engine_world, run_world

# the modules themselves: the package names its functions alike
accuracy_module = importlib.import_module("metrics_tpu_torch.functional.classification.accuracy")
stat_scores_module = importlib.import_module("metrics_tpu_torch.functional.classification.stat_scores")

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6


def _cls_batch(n=512, c=4, seed=0):
    rng = np.random.RandomState(seed)
    probs = rng.rand(n, c).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    return probs, rng.randint(c, size=n)


def _reg_batch(n=512, seed=0):
    rng = np.random.RandomState(seed)
    t = (rng.randn(n) * 3 + 1).astype(np.float32)
    p = (t + rng.randn(n)).astype(np.float32)
    return p, t


def _jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _torch(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _cls_collection(pkg, compiled):
    kw = {"device": CPU} if pkg is tm else {}
    return pkg.MetricCollection(
        [
            pkg.Accuracy(**kw),
            pkg.Precision(num_classes=4, average="macro", **kw),
            pkg.Recall(num_classes=4, average="macro", **kw),
            pkg.F1(num_classes=4, average="macro", **kw),
        ],
        compiled=compiled,
    )


def _reg_collection(pkg, compiled):
    kw = {"device": CPU} if pkg is tm else {}
    return pkg.MetricCollection(
        [pkg.MeanSquaredError(**kw), pkg.MeanAbsoluteError(**kw), pkg.R2Score(**kw), pkg.PSNR(**kw),
         pkg.ExplainedVariance(**kw)],
        compiled=compiled,
    )


def _close(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=msg)


def _assert_states(port, ref, msg=""):
    """Every registered state of the port's collection equals ``ref``'s
    (a port or a JAX collection): integer counts exactly."""
    for key in port.keys():
        for sname in port[key]._defaults:
            got, want = getattr(port[key], sname), np.asarray(getattr(ref[key], sname))
            if not got.is_floating_point():
                assert np.array_equal(got.numpy(), want), f"{msg} state {key}.{sname}"
            else:
                _close(got, want, f"{msg} state {key}.{sname}")


@pytest.mark.parametrize("family", ["classification", "regression"])
def test_compiled_matches_eager_collection(family):
    """Values and states agree with the port's eager collection and JAX's
    compiled one step by step, and the epoch values agree after 4 batches."""
    mk = _cls_collection if family == "classification" else _reg_collection
    batch = _cls_batch if family == "classification" else _reg_batch
    eager, compiled, jax_compiled = mk(tm, False), mk(tm, True), mk(jm, True)
    for step in range(4):
        arrays = batch(seed=step)
        ve, vc, vj = eager(*_torch(*arrays)), compiled(*_torch(*arrays)), jax_compiled(*_jax(*arrays))
        assert set(ve) == set(vc) == set(vj)
        for k in ve:
            _close(vc[k], ve[k], f"step {step} value {k} vs eager")
            _close(vc[k], vj[k], f"step {step} value {k} vs JAX")
        _assert_states(compiled, eager, f"step {step} vs eager")
        _assert_states(compiled, jax_compiled, f"step {step} vs JAX")
    ee, ec, ej = eager.compute(), compiled.compute(), jax_compiled.compute()
    for k in ee:
        _close(ec[k], ee[k], f"epoch {k}")
        _close(ec[k], ej[k], f"epoch {k} vs JAX")
    # every metric ran compiled: nothing fell back
    assert compiled._engine.eager_fallbacks == {} == jax_compiled._engine.eager_fallbacks
    assert compiled._engine.trace_count == jax_compiled._engine.trace_count == 1


def test_zero_steadystate_recompilation():
    """One trace per input signature, as in JAX: same-shape steps hit the
    cache, a new shape adds exactly one, flipping back adds none."""
    col, jcol = _cls_collection(tm, True), _cls_collection(jm, True)
    first, second = _cls_batch(n=256), _cls_batch(n=128)

    def both(arrays):
        col(*_torch(*arrays))
        jcol(*_jax(*arrays))
        return col._engine.trace_count, jcol._engine.trace_count

    for _ in range(5):
        counts = both(first)
    assert counts == (1, 1), col._engine.cache_info()
    assert len(col._engine._compiled) == len(jcol._engine._compiled) == 1
    both(second)
    assert both(second) == (2, 2), col._engine.cache_info()
    assert both(first) == (2, 2), col._engine.cache_info()


def test_single_metric_engine():
    p, t = _reg_batch()
    m_eager, m_comp, m_jax = tm.MeanSquaredError(device=CPU), tm.MeanSquaredError(device=CPU), jm.MeanSquaredError()
    engine, jengine = tm.CompiledStepEngine(m_comp), jm.CompiledStepEngine(m_jax)
    for _ in range(3):
        ve, vc, vj = m_eager(*_torch(p, t)), engine(*_torch(p, t)), jengine(*_jax(p, t))
        _close(vc, ve)
        _close(vc, vj)
    _close(m_comp.compute(), m_eager.compute())
    _close(m_comp.compute(), m_jax.compute())
    assert engine.trace_count == jengine.trace_count == 1


def test_cat_state_metric_falls_back_eager():
    """AUROC keeps list states: it runs eager inside a compiled collection,
    with values equal to a fully eager run and to JAX's."""
    rng = np.random.RandomState(3)
    p = rng.rand(256).astype(np.float32)
    t = rng.randint(2, size=256)
    eager = tm.MetricCollection([tm.Accuracy(device=CPU), tm.AUROC(device=CPU)])
    compiled = tm.MetricCollection([tm.Accuracy(device=CPU), tm.AUROC(device=CPU)], compiled=True)
    jcompiled = jm.MetricCollection([jm.Accuracy(), jm.AUROC()], compiled=True)
    for _ in range(2):
        ve, vc, vj = eager(*_torch(p, t)), compiled(*_torch(p, t)), jcompiled(*_jax(p, t))
        for k in ve:
            _close(vc[k], ve[k], k)
            _close(vc[k], vj[k], k)
    assert set(compiled.eager_fallbacks) == set(jcompiled.eager_fallbacks) == {"AUROC"}
    assert compiled.eager_fallbacks["AUROC"] == jcompiled.eager_fallbacks["AUROC"]
    _close(compiled.compute()["AUROC"], eager.compute()["AUROC"])
    _close(compiled.compute()["AUROC"], jcompiled.compute()["AUROC"])


def test_donation_never_invalidates_defaults():
    """After a compiled step and ``reset()`` every state reads its default
    (which no step aliased), and the engine keeps working."""
    col, jcol = _cls_collection(tm, True), _cls_collection(jm, True)
    p, t = _cls_batch()
    col(*_torch(p, t))
    col.reset()
    for m in col.values():
        for sname, default in m._defaults.items():
            assert getattr(m, sname) is not default
            assert not torch.any(default != 0) and not torch.any(getattr(m, sname) != 0), sname
    jcol(*_jax(p, t))
    jcol.reset()
    v, vj = col(*_torch(p, t)), jcol(*_jax(p, t))
    assert 0.0 <= float(v["Accuracy"]) <= 1.0
    for k in v:
        _close(v[k], vj[k], k)


def test_compiled_collection_clone_and_pickle():
    col = _cls_collection(tm, True)
    p, t = _torch(*_cls_batch())
    col(p, t)
    clone = col.clone(prefix="c_")
    assert clone._engine is None  # the engine is not copied
    vc = clone(p, t)
    assert "c_Accuracy" in vc and clone._engine is not None and clone._engine is not col._engine
    _close(vc["c_Accuracy"], col(p, t)["Accuracy"])
    rt = pickle.loads(pickle.dumps(col))
    assert rt._engine is None
    assert "Accuracy" in rt(p, t)
    col(p, t)
    _assert_states(rt, col)


def test_compute_on_step_false_returns_none_and_accumulates():
    p, t = _reg_batch()
    m_eager = tm.MeanSquaredError(compute_on_step=False, device=CPU)
    m_comp = tm.MeanSquaredError(compute_on_step=False, device=CPU)
    m_jax = jm.MeanSquaredError(compute_on_step=False)
    engine, jengine = tm.CompiledStepEngine(m_comp), jm.CompiledStepEngine(m_jax)
    assert m_eager(*_torch(p, t)) is None
    assert engine(*_torch(p, t)) is None
    assert jengine(*_jax(p, t)) is None
    _close(m_comp.compute(), m_eager.compute())
    _close(m_comp.compute(), m_jax.compute())


def test_signature_includes_kwargs_structure():
    """weights-present and weights-absent steps build separately (another
    kwargs structure), both equal to eager and to JAX."""
    rng = np.random.RandomState(11)
    p = rng.rand(256).astype(np.float32)
    t = rng.randint(2, size=256)
    w = rng.rand(256).astype(np.float32)
    m_eager, m_comp = tm.BinnedAUROC(num_bins=32, device=CPU), tm.BinnedAUROC(num_bins=32, device=CPU)
    m_jax = jm.BinnedAUROC(num_bins=32)
    engine, jengine = tm.CompiledStepEngine(m_comp), jm.CompiledStepEngine(m_jax)
    (tw,) = _torch(w)

    def step(weighted):
        kw, jkw = ({"sample_weights": tw}, {"sample_weights": jnp.asarray(w)}) if weighted else ({}, {})
        vc, ve, vj = engine(*_torch(p, t), **kw), m_eager(*_torch(p, t), **kw), jengine(*_jax(p, t), **jkw)
        _close(vc, ve)
        _close(vc, vj)

    step(False)
    step(True)
    assert engine.trace_count == jengine.trace_count == 2  # two signatures, one build each
    step(True)
    assert engine.trace_count == jengine.trace_count == 2  # steady state: cache hit
    _close(m_comp.compute(), m_eager.compute())
    _close(m_comp.compute(), m_jax.compute())


def test_engine_cache_is_capped():
    col = tm.MetricCollection([tm.MeanSquaredError(device=CPU)], compiled=True)
    jcol = jm.MetricCollection([jm.MeanSquaredError()], compiled=True)
    col.forward(*_torch(*_reg_batch(n=8)))
    jcol.forward(*_jax(*_reg_batch(n=8)))
    col._engine._cache_size = jcol._engine._cache_size = 2
    for n in (16, 32, 64):
        col(*_torch(*_reg_batch(n=n)))
        jcol(*_jax(*_reg_batch(n=n)))
    assert len(col._engine._compiled) == len(jcol._engine._compiled) == 2
    assert col._engine.trace_count == jcol._engine.trace_count == 4


def test_regression_family_shares_one_pass_in_the_step():
    """The shared moments exist only inside both scopes, are memoized on
    input identity there, and equal JAX's."""
    p, t = _torch(*_reg_batch())
    assert sufficient_stats.regression_sufficient_stats(p, t) is None  # no context: bespoke paths
    with shared_canonicalization():
        # a canonicalization scope alone (what a composite opens) must NOT
        # fire the full multi-moment pass
        assert sufficient_stats.regression_sufficient_stats(p, t) is None
    with shared_canonicalization(), sufficient_stats.regression_family_sharing():
        s1 = sufficient_stats.regression_sufficient_stats(p, t)
        s2 = sufficient_stats.regression_sufficient_stats(p, t)
    assert s1 is s2  # memoized: one pass for the whole family
    _close(s1["sum_sq_diff"], torch.sum((t - p) ** 2))
    _close(s1["min_target"], torch.min(t))


def test_standalone_metric_keeps_bespoke_update(monkeypatch):
    """A lone MeanSquaredError forward never pays for the full shared pass;
    a collection, eager or compiled, makes exactly one per step."""
    calls = []
    real = sufficient_stats._compute_stats
    monkeypatch.setattr(sufficient_stats, "_compute_stats", lambda p, t: calls.append(1) or real(p, t))
    p, t = _torch(*_reg_batch())
    tm.MeanSquaredError(device=CPU)(p, t)
    assert calls == []  # bespoke path: the shared pass never fired
    _reg_collection(tm, False)(p, t)
    assert len(calls) == 1  # collection: exactly one shared pass
    compiled = _reg_collection(tm, True)
    compiled(p, t)
    compiled(p, t)
    assert len(calls) == 3  # one per compiled step


def test_regression_stats_parity_standalone_vs_shared():
    """The single-metric updates and the shared-pass collection accumulate
    the same states, which equal JAX's collection's."""
    p, t = _reg_batch(n=1024)
    singles = [tm.MeanSquaredError(device=CPU), tm.MeanAbsoluteError(device=CPU), tm.R2Score(device=CPU),
               tm.PSNR(device=CPU), tm.ExplainedVariance(device=CPU)]
    for m in singles:
        m(*_torch(p, t))
    col, jcol = _reg_collection(tm, False), _reg_collection(jm, False)
    col(*_torch(p, t))
    jcol(*_jax(p, t))
    for m in singles:
        name = type(m).__name__
        for sname in m._defaults:
            _close(getattr(m, sname), getattr(col[name], sname), f"{name}.{sname}")
    _assert_states(col, jcol, "vs JAX")


def test_bad_input_does_not_demote_the_engine():
    """A validation error at build time is a bad batch, not a forward that
    cannot be one step: it propagates, and the next valid batch still runs
    compiled."""
    col, jcol = _cls_collection(tm, True), _cls_collection(jm, True)
    p, t = _cls_batch()
    col(*_torch(p, t))
    jcol(*_jax(p, t))
    with pytest.raises(ValueError):
        col(*_torch(p, t[:100]))  # mismatched first dims
    with pytest.raises(ValueError):
        jcol(*_jax(p, t[:100]))
    assert col._engine.eager_fallbacks == {} == jcol._engine.eager_fallbacks  # not demoted
    col(*_torch(p, t))
    assert len(col._engine._compiled) == len(jcol._engine._compiled) == 1  # still compiled
    assert col._engine.trace_count == jcol._engine.trace_count == 2


class _RunningMax(Metric):
    # deliberately NOT _fused_forward: 'sum'-registered state updated
    # non-additively; a merge would corrupt it
    def __init__(self):
        super().__init__(device=CPU)
        self.add_state("seen", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds, target):
        self.seen = torch.maximum(self.seen, torch.max(preds))

    def compute(self):
        return self.seen


def test_non_fused_metric_falls_back_eager():
    eager, comp = _RunningMax(), _RunningMax()
    engine = tm.CompiledStepEngine(comp)
    assert list(engine.eager_fallbacks) == ["metric"]
    assert engine.eager_fallbacks["metric"] == "metric does not opt into fused one-update forward semantics"
    p, t = _torch(*_reg_batch())
    for _ in range(2):
        _close(engine(p, t), eager(p, t))
    _close(comp.compute(), eager.compute())


def test_classification_siblings_count_each_batch_once(monkeypatch):
    """Precision, Recall and F1 with the same arguments share one stat-score
    count per batch and Accuracy counts once, eagerly and compiled: the JAX
    package's ``fast_path_memo`` sharing."""
    counts = {"stat_scores": 0, "accuracy": 0}
    real_count, real_hits = stat_scores_module._stat_scores_label_count, accuracy_module._accuracy_hits

    def count_stat_scores(*args):
        counts["stat_scores"] += 1
        return real_count(*args)

    def count_hits(*args):
        counts["accuracy"] += 1
        return real_hits(*args)

    monkeypatch.setattr(stat_scores_module, "_stat_scores_label_count", count_stat_scores)
    monkeypatch.setattr(accuracy_module, "_accuracy_hits", count_hits)
    p, t = _torch(*_cls_batch())
    for compiled in (False, True):
        col = _cls_collection(tm, compiled)
        for step in range(3):
            before = dict(counts)
            col(p, t)
            assert counts["stat_scores"] - before["stat_scores"] == 1, (compiled, step)
            assert counts["accuracy"] - before["accuracy"] == 1, (compiled, step)
    # outside a collection each metric counts its own batch
    before = counts["stat_scores"]
    for m in list(_cls_collection(tm, False).values())[1:]:
        m(p, t)
    assert counts["stat_scores"] - before == 3


def test_num_classes_inference_under_the_engine_raises_jax_text():
    """``StatScores()`` on label inputs infers the one-hot width from the
    data maximum, which a compiled step cannot read: the member is demoted
    with JAX's error text. JAX demotes its whole compiled group; the port
    tries each member alone and keeps Accuracy compiled."""
    rng = np.random.RandomState(5)
    batches = [(rng.randint(5, size=300), rng.randint(5, size=300)) for _ in range(3)]
    eager = tm.MetricCollection([tm.Accuracy(device=CPU), tm.StatScores(device=CPU)])
    compiled = tm.MetricCollection([tm.Accuracy(device=CPU), tm.StatScores(device=CPU)], compiled=True)
    jcompiled = jm.MetricCollection([jm.Accuracy(), jm.StatScores()], compiled=True)
    with pytest.warns(UserWarning, match="falling back to eager forward"):
        for p, t in batches:
            ve, vc, vj = eager(*_torch(p, t)), compiled(*_torch(p, t)), jcompiled(*_jax(p, t))
            for k in ve:
                assert np.array_equal(vc[k].numpy(), ve[k].numpy()), k
                _close(vc[k], vj[k], k)
    assert compiled.eager_fallbacks["StatScores"] == jcompiled.eager_fallbacks["StatScores"]
    assert "`num_classes` is required when label inputs are traced under jit" in compiled.eager_fallbacks["StatScores"]
    assert set(compiled.eager_fallbacks) == {"StatScores"}
    assert set(jcompiled.eager_fallbacks) == {"Accuracy", "StatScores"}
    for k, v in eager.compute().items():
        assert np.array_equal(compiled.compute()[k].numpy(), v.numpy()), k
    # and the data-maximum inference of to_onehot itself, traced
    with tracing(), pytest.raises(ValueError, match="`num_classes` must be given when `to_onehot` is traced"):
        to_onehot(torch.tensor([0, 2, 1]))


def test_values_outlive_the_next_step_and_reset_between_steps():
    b1, b2 = _cls_batch(seed=1), _cls_batch(seed=2)
    col, eager, jcol = _cls_collection(tm, True), _cls_collection(tm, False), _cls_collection(jm, True)
    first = col(*_torch(*b1))
    kept = {k: v.clone() for k, v in first.items()}
    col(*_torch(*b2))
    for k in kept:
        assert torch.equal(first[k], kept[k]), k
    col.reset()
    jcol(*_jax(*b1))
    jcol.reset()
    vc, ve, vj = col(*_torch(*b2)), eager(*_torch(*b2)), jcol(*_jax(*b2))
    for k in vc:
        _close(vc[k], ve[k], k)
        _close(vc[k], vj[k], k)
    _assert_states(col, eager)


def test_compute_result_outlives_later_steps():
    """``ConfusionMatrix(normalize=None).compute()`` returns its state
    tensor: the matrix read after one step keeps its counts through a later
    step and through ``reset()``, and equals JAX's."""
    b1, b2, b3 = _cls_batch(seed=1), _cls_batch(seed=2), _cls_batch(seed=3)
    col = tm.MetricCollection([tm.ConfusionMatrix(num_classes=4, device=CPU)], compiled=True)
    jcol = jm.MetricCollection([jm.ConfusionMatrix(num_classes=4)], compiled=True)
    col(*_torch(*b1)), jcol(*_jax(*b1))
    cm = col.compute()["ConfusionMatrix"]
    kept = cm.clone()
    col(*_torch(*b2))
    col.reset()
    col(*_torch(*b3))
    assert torch.equal(cm, kept)
    assert np.array_equal(kept.numpy(), np.asarray(jcol.compute()["ConfusionMatrix"]))
    assert col.eager_fallbacks == {} == jcol.eager_fallbacks


def test_engine_in_a_gloo_world_runs_eager_and_equals_the_eager_collection():
    """In a torch.distributed world every member runs eager (the step does
    not sync), as in the JAX package: each step equals the eager
    collection's, the synced epoch equals one process over all batches."""
    rng = np.random.RandomState(9)
    batches = []
    for _ in range(4):
        probs = rng.rand(200, 4).astype(np.float32)
        batches.append((probs / probs.sum(1, keepdims=True), rng.randint(4, size=200)))
    ranks = run_world(2, engine_world, {"batches": batches, "num_classes": 4})
    whole = _cls_collection(tm, False)
    for p, t in batches:
        whole(*_torch(p, t))
    want = whole.compute()
    for rank, out in ranks.items():
        assert out["fallbacks"] == {} and out["trace_count"] == 0, rank
        for step in out["steps"]:
            for k, (vc, ve) in step.items():
                assert np.array_equal(vc, ve), (rank, k)
        for k in want:
            assert np.array_equal(out["compiled"][k], out["eager"][k]), (rank, k)
            _close(out["compiled"][k], want[k], f"rank {rank} epoch {k}")
