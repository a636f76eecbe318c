"""The port's double-buffer prover (pass 4, MTA009, ``metrics_tpu_torch/
analysis/concurrency.py``) and the engine's two-generation traces, against
the JAX package's, on the CPU.

One module-scoped fixture per package runs its whole registry once
(``audit_registry(quantized=True, cohort=True)``, the port's with
``device="cpu"``). The MTA009 cases of ``tests/analysis/test_concurrency.py``
and ``tests/analysis/test_serving_concurrency.py::
test_admission_is_the_prover_verdict`` are mirrored under their own names:
the verdicts and hazard kinds (as sets) are held against the JAX package's
on the same seeded numpy inputs. Beside them, the FX forms of the hazards
the JAX package reads off jaxprs: a tensor constant of the graph, an input
state returned, one storage behind two outputs, and a state written in
place — a view of its placeholder, which must read as a passthrough.
"""
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu_torch as M
from metrics_tpu_torch.analysis import audit_metric, audit_registry, composed_generation_hazards
from metrics_tpu_torch.analysis import concurrency as conc
from metrics_tpu_torch.analysis import fixtures as fx
from metrics_tpu_torch.analysis.program import registry_cases
from metrics_tpu_torch.engine import fake_trace
from metrics_tpu_torch.metric import Metric

CPU = "cpu"
_NP_X = np.linspace(0.0, 1.0, 8).astype(np.float32)
_X = torch.as_tensor(_NP_X)


def _jx():
    import jax.numpy as jnp

    return jnp.asarray(_NP_X)


@pytest.fixture(scope="module")
def registry_report():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # config-edge warnings from factories
        return audit_registry(quantized=True, cohort=True, device=CPU)


@pytest.fixture(scope="module")
def jax_report():
    from metrics_tpu.analysis import audit_registry as jax_audit_registry

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jax_audit_registry(quantized=True, cohort=True)


def _verdicts(report):
    return {
        fam: entry["evidence"]["double_buffer"]
        for fam, entry in report["families"].items()
        if (entry.get("evidence") or {}).get("double_buffer")
    }


def _kinds(verdict):
    return verdict["safe"], verdict["writeback_locked"], {h["kind"] for h in verdict["hazards"]}


# ---------------------------------------------------------------------------
# MTA009 — the registry
# ---------------------------------------------------------------------------
def test_registry_is_double_buffer_safe(registry_report):
    """Every engine-eligible family — plain, @cohort and the quantized
    variants — is proven two-generation safe: all 80."""
    verdicts = _verdicts(registry_report)
    unsafe = {fam: v for fam, v in verdicts.items() if v["safe"] is not True}
    assert unsafe == {}, unsafe
    assert len(verdicts) == 80  # 20 eligible bases + 20 cohort + 40 tiers
    eligible_bases = {
        fam for fam, entry in registry_report["families"].items() if "@" not in fam and entry["engine_eligible"]
    }
    assert eligible_bases <= {fam.split("@", 1)[0] for fam in verdicts}


def test_registry_double_buffer_verdicts_equal_jax(registry_report, jax_report):
    port, ref = _verdicts(registry_report), _verdicts(jax_report)
    assert sorted(port) == sorted(ref)
    for fam in ref:
        assert _kinds(port[fam]) == _kinds(ref[fam]), fam


def test_writeback_ordering_is_generation_monotonic():
    """The engine reads the states it steps from and installs the new ones
    under its lock, as the JAX engine's donate -> dispatch -> write-back."""
    from metrics_tpu.analysis.concurrency import writeback_generation_monotonic as jax_monotonic

    assert conc.writeback_generation_monotonic() is True is jax_monotonic()


# ---------------------------------------------------------------------------
# the two-generation traces
# ---------------------------------------------------------------------------
def test_two_generation_composition_is_alias_free_for_plain_engine():
    """The traced two-generation graph cross-checks the single-step verdict:
    zero hazards for a registry family, as in the JAX package; abstract: no
    build, no cache entry."""
    import metrics_tpu as J

    engine = M.CompiledStepEngine(M.MeanSquaredError(device=CPU))
    graph, _shapes, n_donated, n_state = engine.abstract_double_buffer_step(_X, _X)
    assert n_donated == 2 and n_state == 2
    assert composed_generation_hazards(graph, n_donated, n_state) == []
    assert engine.cache_info()["compiled_signatures"] == 0
    jengine = J.CompiledStepEngine(J.MeanSquaredError())
    closed, _, jn, js = jengine.abstract_double_buffer_step(_jx(), _jx())
    from metrics_tpu.analysis.concurrency import composed_generation_hazards as jax_hazards

    assert (jn, js) == (n_donated, n_state) and jax_hazards(closed, jn, js) == []


def test_two_generation_composition_is_alias_free_for_cohort():
    import metrics_tpu as J
    from metrics_tpu.analysis.concurrency import composed_generation_hazards as jax_hazards

    cohort = M.MetricCohort(M.MeanSquaredError(device=CPU), tenants=3)
    graph, shapes, n_donated, n_state = cohort.abstract_double_buffer(_X, _X)
    assert n_donated == 2 and n_state == 2
    assert composed_generation_hazards(graph, n_donated, n_state) == []
    jcohort = J.MetricCohort(J.MeanSquaredError(), tenants=3)
    closed, jshapes, jn, js = jcohort.abstract_double_buffer(_jx(), _jx())
    assert (jn, js) == (n_donated, n_state) and jax_hazards(closed, jn, js) == []
    # the stacked states of both generations, as the JAX package's
    for gen in (0, 2):
        assert {k: tuple(v.shape) for k, v in shapes[gen]["metric"].items()} == {
            k: tuple(v.shape) for k, v in jshapes[gen]["metric"].items()
        }


@pytest.mark.parametrize("name", ["MeanSquaredError", "Precision", "BinnedAUROC", "R2Score", "ConfusionMatrix"])
def test_two_generation_traces_equal_jax_shapes(name):
    """Each generation's state outputs have the JAX package's shapes and
    dtypes, and neither package finds a hazard, plain and at capacity 4."""
    import metrics_tpu as J
    from metrics_tpu.analysis.concurrency import composed_generation_hazards as jax_hazards
    from metrics_tpu.analysis.program import registry_cases as jax_registry_cases

    jfactory, jargs = {n: (f, a) for n, f, a in jax_registry_cases()}[name]
    factory, args = {n: (f, a) for n, f, a in registry_cases(CPU)}[name]
    for capacity in (None, 4):
        graph, shapes, n_donated, n_state = M.CompiledStepEngine(factory()).abstract_double_buffer_step(
            *args, capacity=capacity
        )
        closed, jshapes, jn, js = J.CompiledStepEngine(jfactory()).abstract_double_buffer_step(
            *jargs, capacity=capacity
        )
        assert (n_donated, n_state) == (jn, js)
        assert composed_generation_hazards(graph, n_donated, n_state) == jax_hazards(closed, jn, js) == []
        for gen in (0, 2):
            want = {k: (tuple(v.shape), str(v.dtype)) for k, v in jshapes[gen]["metric"].items()}
            got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in shapes[gen]["metric"].items()}
            assert {k: s for k, (s, _) in got.items()} == {k: s for k, (s, _) in want.items()}, (name, capacity)


def test_two_generation_trace_touches_nothing():
    """Like ``abstract_step``: no build, no trace count, states and the
    dispatch generation as they were."""
    metric = M.MeanSquaredError(device=CPU)
    metric.update(_X, _X)
    engine = M.CompiledStepEngine(metric, observe=False)
    before = {s: getattr(metric, s) for s in metric._defaults}
    generation = engine.dispatch_generation
    engine.abstract_double_buffer_step(_X, _X)
    engine.abstract_double_buffer_step(_X, _X, capacity=4)
    assert engine.cache_info()["compiled_signatures"] == 0 and engine.trace_count == 0
    assert engine.dispatch_generation == generation
    assert all(getattr(metric, s) is v for s, v in before.items())


def test_two_generation_trace_refuses_all_eager_engine():
    with pytest.raises(ValueError, match="runs eager"):
        M.CompiledStepEngine(M.AUROC(device=CPU)).abstract_double_buffer_step(_X, (_X > 0.5).long())


# ---------------------------------------------------------------------------
# the hazards in FX form
# ---------------------------------------------------------------------------
_CONST = torch.zeros(4)


@pytest.mark.parametrize(
    "fn,kinds",
    [
        # a fresh state and a value: clean
        (lambda s, x: (s + x, x.sum()), []),
        # the input state handed back
        (lambda s, x: (s, x.sum()), ["donated_passthrough"]),
        # a state written in place: a view of its placeholder
        (lambda s, x: (s.add_(x), x.sum()), ["donated_passthrough"]),
        # a view of the input state
        (lambda s, x: (s[:2], x.sum()), ["donated_passthrough"]),
        # a tensor constant of the graph
        (lambda s, x: (_CONST, x.sum()), ["const_state_output"]),
        # the value is the new state
        (lambda s, x: ((s + x,) * 2)[0:1] + ((s + x),), []),
    ],
    ids=["fresh", "passthrough", "in_place", "view", "constant", "two_fresh"],
)
def test_composed_hazards_in_fx_form(fn, kinds):
    graph, _ = fake_trace(fn, (torch.zeros(4), torch.ones(4)))
    assert [h["kind"] for h in composed_generation_hazards(graph, 1, 1)] == kinds


def test_composed_hazards_see_aliases_across_outputs():
    """One storage behind two state outputs, and a later output (a value, or
    the next generation's state) on a state's storage."""
    graph, _ = fake_trace(lambda s, x: (lambda t: (t, t[:1], t))(s + x), (torch.zeros(4), torch.ones(4)))
    hazards = composed_generation_hazards(graph, 1, 2)
    assert [h["kind"] for h in hazards] == ["duplicate_state_output", "cross_generation_alias"]
    assert [h["position"] for h in hazards] == [1, 2]


def test_check_double_buffer_reads_the_single_step_graph():
    """The single-step prover on graphs with each hazard: a constant state
    output and a value aliasing a state are MTA009 findings; an input state
    returned is MTA007's and only voids the verdict."""
    metric = M.MeanSquaredError(device=CPU)
    cases = [
        (lambda s, x: (s + x, (s + x).sum()), True, set(), []),
        (lambda s, x: (_CONST, x.sum()), False, {"const_state_output"}, ["MTA009"]),
        (lambda s, x: (lambda t: (t, t))(s + x), False, {"host_read_of_donated"}, ["MTA009"]),
        (lambda s, x: (s.mul_(2), x.sum()), False, {"donated_passthrough"}, []),
    ]
    for fn, safe, kinds, rules in cases:
        graph, _ = fake_trace(fn, (torch.zeros(4), torch.ones(4)))
        findings, infos = [], []
        verdict = conc.check_double_buffer(
            metric, findings, infos, step_closed=graph, n_donated=1, n_state_outputs=1, engine_eligible=True
        )
        assert verdict["safe"] is safe and {h["kind"] for h in verdict["hazards"]} == kinds, fn
        assert [f.rule for f in findings] == rules


def test_untraced_step_leaves_the_verdict_open():
    findings, infos = [], []
    verdict = conc.check_double_buffer(M.MeanSquaredError(device=CPU), findings, infos, engine_eligible=True)
    assert verdict["safe"] is None and findings == [] and "did not trace" in infos[0]
    assert conc.check_double_buffer(M.MeanSquaredError(device=CPU), findings, infos) is None


# ---------------------------------------------------------------------------
# the fixtures and the AST leg
# ---------------------------------------------------------------------------
def test_double_buffer_fixture_flavors_are_distinct():
    from metrics_tpu.analysis import audit_metric as jax_audit_metric
    from metrics_tpu.analysis import fixtures as jfx

    seed = audit_metric(fx.DoubleBufferAliaser(device=CPU), (_X,))
    assert [f.rule for f in seed.findings] == ["MTA009"]
    assert seed.findings[0].detail["flavor"] == "host_cached_seed"
    assert seed.evidence["double_buffer"]["safe"] is False

    escape = audit_metric(fx.HostReadOfDonated(device=CPU), (_X,))
    assert [f.rule for f in escape.findings] == ["MTA009"]
    assert escape.findings[0].detail["flavor"] == "state_ref_escape"
    assert escape.findings[0].subject == "HostReadOfDonated._last_value"
    for port, name in ((seed, "DoubleBufferAliaser"), (escape, "HostReadOfDonated")):
        ref = jax_audit_metric(getattr(jfx, name)(), (_jx(),))
        assert [(f.subject, f.detail["flavor"]) for f in port.findings] == [
            (f.subject, f.detail["flavor"]) for f in ref.findings if f.rule == "MTA009"
        ]


def test_mta007_families_fold_into_the_verdict_without_double_diagnosis():
    """A buffer-lifetime defect (MTA007) voids the verdict, with one
    diagnosis, not an MTA009 echo."""
    from metrics_tpu.analysis import audit_metric as jax_audit_metric
    from metrics_tpu.analysis import fixtures as jfx

    result = audit_metric(fx.UntouchedStatePassthrough(device=CPU), (_X,))
    assert {f.rule for f in result.findings} == {"MTA007"}
    db = result.evidence["double_buffer"]
    assert db["safe"] is False
    assert any(h["kind"] == "donation_lifetime" for h in db["hazards"])
    ref = jax_audit_metric(jfx.UntouchedStatePassthrough(), (_jx(),))
    assert _kinds(db) == _kinds(ref.evidence["double_buffer"])


def test_wrapped_state_reads_are_not_reference_escapes():
    """``self._scaled = self.acc * 2.0`` makes a new tensor; only bare
    ``self.<state>`` stashes are refused."""

    class _DerivedStash(Metric):
        _fused_forward = True

        def __init__(self):
            super().__init__(device=CPU)
            self.add_state("acc", default=torch.zeros(()), dist_reduce_fx="sum")

        def update(self, x):
            self.acc = self.acc + torch.sum(x)

        def compute(self):
            self._scaled = self.acc * 2.0  # derived: a new tensor, no alias
            return self.acc

    result = audit_metric(_DerivedStash(), (_X,))
    assert result.findings == []
    assert result.evidence["double_buffer"]["safe"] is True


def test_augmented_assignment_is_not_a_reference_escape():
    """``self._ema += self.acc`` computes ``target + value`` — only plain
    bare-state assignments are escapes, in both directions. The JAX case
    also asserts no finding at all; here the replica probe flags MTA005,
    since a tensor's ``+=`` writes ``_ema`` in place and so keeps state
    outside the registered states, which the rules of pass 4 do not judge."""
    import jax.numpy as jnp
    from metrics_tpu.analysis import audit_metric as jax_audit_metric
    from metrics_tpu.metric import Metric as JaxMetric

    class _AugAssigner(Metric):
        _fused_forward = True

        def __init__(self):
            super().__init__(device=CPU)
            self._ema = torch.zeros(())
            self.add_state("acc", default=torch.zeros(()), dist_reduce_fx="sum")

        def update(self, x):
            self.acc = self.acc + torch.sum(x)
            self.acc += self._ema  # an augmented assignment, not a seed

        def compute(self):
            self._ema += self.acc  # an augmented assignment, not a stash
            return self.acc

    class _JaxAugAssigner(JaxMetric):
        _fused_forward = True

        def __init__(self):
            super().__init__()
            self._ema = jnp.zeros(())
            self.add_state("acc", default=jnp.zeros(()), dist_reduce_fx="sum")

        def update(self, x):
            self.acc = self.acc + jnp.sum(x)
            self.acc += self._ema

        def compute(self):
            self._ema += self.acc
            return self.acc

    result = audit_metric(_AugAssigner(), (_X,))
    ref = jax_audit_metric(_JaxAugAssigner(), (_jx(),))
    assert [f for f in result.findings if f.rule in ("MTA008", "MTA009")] == []
    assert result.evidence["double_buffer"]["safe"] is True
    assert _kinds(result.evidence["double_buffer"]) == _kinds(ref.evidence["double_buffer"])
    assert conc._host_reference_hazards(_AugAssigner, {"acc"}) == []


def test_admission_is_the_prover_verdict():
    """The enrollment refusal and the MTA009 AST leg agree: the hazard
    fixtures refused, a registry-clean family admitted, and the traced
    two-generation graph of the admitted family hazard-free — in both
    packages."""
    import metrics_tpu as J
    from metrics_tpu.analysis import fixtures as jfx
    from metrics_tpu.analysis.concurrency import composed_generation_hazards as jax_hazards
    from metrics_tpu.serving.async_engine import _admission_refusal as jax_refusal

    from metrics_tpu_torch.serving.async_engine import _admission_refusal

    assert _admission_refusal(M.Accuracy(device=CPU)) is None
    assert _admission_refusal(M.MetricCollection([M.Accuracy(device=CPU)], compiled=True)) is None
    for name in ("DoubleBufferAliaser", "HostReadOfDonated"):
        reason = _admission_refusal(getattr(fx, name)(device=CPU))
        assert reason is not None and "MTA009" in reason
        assert reason.split(":")[0] == jax_refusal(getattr(jfx, name)()).split(":")[0]

    rng = np.random.RandomState(0)
    p, t = rng.rand(16, 4).astype(np.float32), rng.randint(4, size=16)
    engine = M.CompiledStepEngine(M.Accuracy(device=CPU), observe=False)
    graph, _, n_donated, n_state = engine.abstract_double_buffer_step(torch.from_numpy(p), torch.from_numpy(t))
    assert composed_generation_hazards(graph, n_donated, n_state) == []
    import jax.numpy as jnp

    closed, _, jn, js = J.CompiledStepEngine(J.Accuracy(), observe=False).abstract_double_buffer_step(
        jnp.asarray(p), jnp.asarray(t)
    )
    assert jax_hazards(closed, jn, js) == [] and (jn, js) == (n_donated, n_state)
