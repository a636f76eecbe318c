"""The port's metric fixtures trip exactly their rule (``metrics_tpu_torch/
analysis/fixtures.py`` through ``audit_metric``), against the JAX package's,
on the CPU.

The cases of ``tests/analysis/test_fixtures_fire.py`` are mirrored under
their own names. Each audits the port's fixture and the JAX package's twin
on the same seeded numpy batch and compares the ``(rule, subject,
suppressed)`` triples, then checks what the JAX case checks on the port.
One JAX triple is not an oracle: the JAX package's measured budget does not
run on JAX 0.9 (``jax.experimental.enable_x64`` is gone), so its
``CancellingVariance`` trips no MTA011. The port's does, as the JAX cases
intend, and that fixture's triples are compared without MTA011.
"""
import inspect
import re
import textwrap

import numpy as np
import pytest
import torch

from metrics_tpu_torch.analysis import audit_metric
from metrics_tpu_torch.analysis import fixtures as fx
from metrics_tpu_torch.metric import Metric

CPU = "cpu"
#: the rules the port's audit runs
PORTED_RULES = {"MTA001", "MTA002", "MTA003", "MTA004", "MTA005", "MTA006", "MTA007", "MTA008", "MTA009", "MTA010",
                "MTA011", "MTA012", "MTL105"}
#: rules whose JAX triples are no oracle, per fixture (see above)
RED_IN_JAX = {"CancellingVariance": {"MTA011"}}
_NP_X = np.linspace(0.0, 1.0, 8).astype(np.float32)
_X = (torch.as_tensor(_NP_X),)

# fixture name -> the one rule it must trip (and nothing else)
EXPECTED = [
    ("NarrowAccumulator", "MTA001"),
    ("CallbackInJit", "MTA002"),
    ("HostSyncUpdate", "MTA002"),
    ("DonatedAlias", "MTA003"),
    ("NonCommutativeMerge", "MTA004"),
    ("MeanWithoutCount", "MTA004"),
    ("UnscaledInt8Psum", "MTA004"),
    ("ReplicaDependentCount", "MTA005"),
    ("NonIdentityReset", "MTA006"),
    ("ComputeMutatesState", "MTA006"),
    ("OrphanResidual", "MTA006"),
    ("UntouchedStatePassthrough", "MTA007"),
    ("UnownedLoader", "MTA007"),
    ("SeamRegressor", "MTA008"),
    ("DoubleBufferAliaser", "MTA009"),
    ("HostReadOfDonated", "MTA009"),
    ("Int32RowCounter", "MTA010"),
    ("CancellingVariance", "MTA011"),
    ("EpsilonThresholdAUROC", "MTA012"),
    ("StaleSuppression", "MTL105"),
]


def _jax_audit(metric):
    import jax.numpy as jnp

    from metrics_tpu.analysis import audit_metric as jax_audit_metric

    return jax_audit_metric(metric, (jnp.asarray(_NP_X),))


def _triples(result, skip=frozenset()):
    return sorted(
        (f.rule, f.subject, f.suppressed) for f in result.findings + result.suppressed
        if f.rule in PORTED_RULES - skip
    )


def _both(name):
    """The port's and the JAX package's audit of fixture ``name``; their
    triples must be equal (over the rules whose JAX triples are oracles)."""
    from metrics_tpu.analysis import fixtures as jfx

    port = audit_metric(getattr(fx, name)(device=CPU), _X)
    ref = _jax_audit(getattr(jfx, name)())
    skip = RED_IN_JAX.get(name, frozenset())
    assert _triples(port, skip) == _triples(ref, skip), name
    return port, ref


@pytest.mark.parametrize("name,rule", EXPECTED, ids=[n for n, _ in EXPECTED])
def test_fixture_trips_exactly_its_rule(name, rule):
    result, _ = _both(name)
    fired = {f.rule for f in result.findings}
    assert fired == {rule}, f"{name} should trip exactly {rule}, got {sorted(fired)}: {[str(f) for f in result.findings]}"
    assert not result.suppressed


def test_narrow_accumulator_reports_both_flavors():
    result, _ = _both("NarrowAccumulator")
    messages = " | ".join(f.message for f in result.findings)
    assert "drifts" in messages
    assert "narrower" in messages


def test_callback_fixture_names_the_primitive():
    """The JAX fixture's finding names ``pure_callback``; the port's fixture
    makes its host round trip with ``.cpu().numpy()``, and the finding names
    the read that stops the trace."""
    result, ref = _both("CallbackInJit")
    assert any("pure_callback" in f.message for f in ref.findings)
    assert any(".numpy()" in f.message for f in result.findings)


def test_host_sync_fixture_classified_as_host_sync():
    result, ref = _both("HostSyncUpdate")
    assert any(f.detail.get("kind") == "host-sync" for f in result.findings)
    assert {f.detail.get("kind") for f in result.findings} == {f.detail.get("kind") for f in ref.findings}


def test_class_body_suppression_routes_to_suppressed_bucket():
    result, _ = _both("SuppressedNarrowAccumulator")
    assert result.findings == []
    assert {f.rule for f in result.suppressed} == {"MTA001"}
    assert all(f.suppressed for f in result.suppressed)


def test_analysis_allow_attribute_suppresses_dynamic_classes():
    """Classes without retrievable source (built at run time) suppress via
    the ``_analysis_allow`` attribute."""
    from metrics_tpu.analysis import fixtures as jfx

    cls = type("RuntimeBuilt", (fx.NarrowAccumulator,), {"_analysis_allow": ("MTA001",)})
    jcls = type("RuntimeBuilt", (jfx.NarrowAccumulator,), {"_analysis_allow": ("MTA001",)})
    result = audit_metric(cls(device=CPU), _X)
    assert _triples(result) == _triples(_jax_audit(jcls()))
    assert result.findings == []
    assert {f.rule for f in result.suppressed} == {"MTA001"}


def test_method_interior_allow_comments_do_not_widen_class_suppression():
    """An allow comment scoped to one line inside a method (the sharded
    mixin's ``add_state`` sites) must not suppress the rule class-wide for
    every subclass — only class-body-level comments count for pass 1."""
    from metrics_tpu.analysis.rules import class_allowed_rules as jax_class_allowed_rules
    from metrics_tpu.parallel.sharded_metric import ShardedStreamsMixin as JaxMixin

    from metrics_tpu_torch.analysis.rules import class_allowed_rules
    from metrics_tpu_torch.parallel.sharded_metric import ShardedStreamsMixin

    class Sub(ShardedStreamsMixin):
        pass

    class JaxSub(JaxMixin):
        pass

    assert class_allowed_rules(Sub) == jax_class_allowed_rules(JaxSub) == set()
    # the fixture's class-body comment still counts
    assert class_allowed_rules(fx.SuppressedNarrowAccumulator) == {"MTA001"}


def test_state_scoped_suppression_only_covers_named_states():
    """The mapping form ``_analysis_allow = {rule: (state, ...)}`` suppresses
    exactly those states; the same mapping naming another state leaves the
    finding standing and is itself flagged stale (MTL105)."""
    from metrics_tpu.analysis import fixtures as jfx

    def pair(name, allow):
        cls = type(name, (fx.NonCommutativeMerge,), {"_analysis_allow": allow})
        jcls = type(name, (jfx.NonCommutativeMerge,), {"_analysis_allow": allow})
        result = audit_metric(cls(device=CPU), _X)
        assert _triples(result) == _triples(_jax_audit(jcls()))
        return result

    result = pair("ScopedSub", {"MTA004": ("acc",)})
    assert result.findings == []
    assert {(f.rule, f.subject) for f in result.suppressed} == {("MTA004", "ScopedSub.acc")}

    result = pair("UnscopedSub", {"MTA004": ("other_state",)})
    assert {f.rule for f in result.findings} == {"MTA004", "MTL105"}
    stale = [f for f in result.findings if f.rule == "MTL105"]
    assert len(stale) == 1 and "other_state" in stale[0].message
    assert result.suppressed == []


def test_sharded_mixin_suppression_is_instance_scoped():
    """The mixin suppresses MTA004 for the stream states it registers and
    nothing else: a subclass adding an order-dependent reduction on a new
    state is still flagged."""
    from metrics_tpu_torch.parallel.sharded_metric import ShardedStreamsMixin

    class GoodSharded(ShardedStreamsMixin, Metric):
        def __init__(self):
            super().__init__(device=CPU)
            self._init_streams({"preds": (torch.float32, ())}, 4)

        def update(self, p):  # pragma: no cover - never traced here
            pass

        def compute(self):
            return torch.zeros(())

    class BadSharded(GoodSharded):
        def __init__(self):
            super().__init__()
            self.add_state("weird", default=torch.zeros(()), dist_reduce_fx=fx.NonCommutativeMerge._subtract_reduce)

    good = audit_metric(GoodSharded())
    assert good.findings == []
    assert {f.subject.split(".")[1] for f in good.suppressed} == {"preds", "counts"}

    bad = audit_metric(BadSharded())
    assert [(f.rule, f.subject) for f in bad.findings] == [("MTA004", "BadSharded.weird")]


def test_unscaled_int8_psum_flags_magnitude_not_commutativity():
    """The quantized flavor of MTA004: a bare int8 cast is commutative — it
    must flag on the magnitude-preservation contract instead."""
    result, ref = _both("UnscaledInt8Psum")
    assert len(result.findings) == len(ref.findings) == 1
    msg = result.findings[0].message
    assert "magnitude-preserving" in msg
    assert "order-dependent" not in msg


def test_block_scaled_quantized_sync_audits_clean():
    """POSITIVE control: a state on the int8 sync tier — block scales and
    its error-feedback residual companion — produces zero findings."""
    m = fx.BlockScaledQuantizedSync(device=CPU)
    assert m.sync_precisions() == {"hist": "int8"}
    assert "hist__qres" in m._defaults  # the companion really registered
    result, ref = _both("BlockScaledQuantizedSync")
    assert result.findings == [] and result.suppressed == []
    assert result.evidence["double_buffer"]["safe"] is True
    assert result.evidence["host_seam"] == ref.evidence["host_seam"]


def test_residual_companion_does_not_satisfy_mean_without_count():
    """A quantized state's residual must not double as the 'paired count'
    that legitimizes a mean state, and must itself produce no findings."""
    import jax.numpy as jnp
    from metrics_tpu.metric import Metric as JaxMetric

    class MeanPlusQuantized(Metric):
        def __init__(self):
            super().__init__(device=CPU)
            self.add_state("avg", default=torch.zeros(()), dist_reduce_fx="mean")
            self.add_state("hist", default=torch.zeros((8,)), dist_reduce_fx="sum", sync_precision="int8")

        def update(self, x):
            self.avg = (self.avg + torch.mean(x)) / 2.0
            self.hist = self.hist + x

        def compute(self):
            return self.avg

    class JaxMeanPlusQuantized(JaxMetric):
        def __init__(self):
            super().__init__()
            self.add_state("avg", default=jnp.zeros(()), dist_reduce_fx="mean")
            self.add_state("hist", default=jnp.zeros((8,)), dist_reduce_fx="sum", sync_precision="int8")

        def update(self, x):
            self.avg = (self.avg + jnp.mean(x)) / 2.0
            self.hist = self.hist + x

        def compute(self):
            return self.avg

    result = audit_metric(MeanPlusQuantized(), _X)
    ref = _jax_audit(JaxMeanPlusQuantized())
    strip = lambda triples: [(r, s.split(".", 1)[1], q) for r, s, q in triples]  # noqa: E731
    assert strip(_triples(result)) == strip(_triples(ref))
    mean_findings = [f for f in result.findings if "mean" in f.message.lower()]
    assert len(mean_findings) == 1 and mean_findings[0].subject.endswith(".avg")
    assert not any(f.subject.endswith("__qres") for f in result.findings)


def test_replica_dependent_count_names_the_divergence():
    result, _ = _both("ReplicaDependentCount")
    assert any("diverges" in f.message for f in result.findings)
    assert any("batches" in f.subject for f in result.findings)


def test_stale_suppression_fixture_names_the_stale_rule():
    result, _ = _both("StaleSuppression")
    assert len(result.findings) == 1
    assert "MTA003" in result.findings[0].message
    assert result.suppressed == []


def test_seam_regressor_names_the_exceeded_budget():
    """The MTA008 fixture regresses against its committed baseline entry
    (SEAM_BASELINE.json budgets one synced state, the class registers
    three): the finding carries the exact key, count and allowance, as the
    JAX package's does."""
    result, ref = _both("SeamRegressor")
    assert all(f.rule == "MTA008" for f in result.findings)
    assert [f.detail for f in result.findings] == [f.detail for f in ref.findings]
    sync = [f for f in result.findings if f.detail.get("key") == "per_sync.host_collectives"]
    assert len(sync) == 1
    assert sync[0].detail["got"] == 3 and sync[0].detail["baseline"] == 1
    assert "SEAM_BASELINE.json" in sync[0].message


def test_int32_row_counter_names_state_horizon_and_floor():
    """The MTA010 fixture's finding carries the exact horizon (2^31 - 1 rows
    for a 1-per-row int32 counter), the fleet floor it breaches, and the
    remediation pair (widen, or suppress + StateGuard(overflow_margin)) —
    the JAX package's detail."""
    result, ref = _both("Int32RowCounter")
    f, = result.findings
    assert f.subject == "Int32RowCounter.rows"
    assert f.detail["kind"] == "int-overflow"
    assert abs(f.detail["rows"] - 2 ** 31) < 2 ** 10
    assert f.detail["floor"] == float(2 ** 40)
    assert "overflow_margin" in f.message
    assert f.detail == ref.findings[0].detail


def test_cancelling_variance_blows_its_committed_budget():
    """The MTA011 fixture is structurally flagged AND measured: its
    NUMERICS_BASELINE.json entry commits a 2^-20 budget, the adversarial
    probes observe 1.0 (everything lost), and the finding names both. The
    JAX case is red on JAX 0.9 (its budget cannot run); the port asserts
    the case's intent, with the JAX package's site."""
    result, ref = _both("CancellingVariance")
    f, = result.findings
    assert f.rule == "MTA011"
    assert f.detail["observed"] > f.detail["baseline"]
    assert f.detail["sites"] >= 1
    assert "NUMERICS_BASELINE.json" in f.message
    ev = result.evidence["numerics"]["cancellation"]
    assert ev["sites"] and ev["sites"][0]["primitive"] == "sub"
    assert ev["sites"] == ref.evidence["numerics"]["cancellation"]["sites"]


def test_epsilon_threshold_auroc_names_the_failing_scale():
    result, ref = _both("EpsilonThresholdAUROC")
    f, = result.findings
    assert f.rule == "MTA012"
    assert any(r["scale"] == 2.0 ** -10 for r in f.detail["failing"])
    assert "scale-invariant" in f.message
    assert [r["scale"] for r in f.detail["failing"]] == [r["scale"] for r in ref.findings[0].detail["failing"]]


def test_double_buffer_fixtures_void_the_ping_pong_verdict():
    """Both MTA009 flavors mark the family unsafe in the evidence, each
    naming its hazard kind, as the JAX package's verdicts do."""
    for name, kind in (("DoubleBufferAliaser", "host_cached_seed"), ("HostReadOfDonated", "state_ref_escape")):
        result, ref = _both(name)
        db, jdb = result.evidence["double_buffer"], ref.evidence["double_buffer"]
        assert db["safe"] is jdb["safe"] is False
        assert {h["kind"] for h in db["hazards"]} == {h["kind"] for h in jdb["hazards"]} == {kind}


def test_unlocked_shared_counter_is_suppressed_in_tree_but_fires_unsuppressed():
    """The MTL106 fixture class: its in-tree allows route the findings to the
    suppressed bucket; the same source without the allows fires both
    writes — pinned against the real fixtures.py text, under both
    packages' linters."""
    from metrics_tpu.analysis.lint import lint_source as jax_lint_source

    from metrics_tpu_torch.analysis.lint import lint_source

    src = "import threading\n" + textwrap.dedent(inspect.getsource(fx.UnlockedSharedCounter))
    suppressed = lint_source(src, "fixtures.py")
    assert {f.rule for f in suppressed if f.suppressed} == {"MTL106"}
    assert [f for f in suppressed if not f.suppressed] == []

    bare = re.sub(r"#\s*metrics-tpu:\s*allow\(MTL106\)[^\n]*", "", src)
    live = [f for f in lint_source(bare, "fixtures.py") if not f.suppressed]
    assert {f.rule for f in live} == {"MTL106"}
    assert len(live) == 2  # the worker write AND the owner-thread write
    assert all("value" in f.message for f in live)
    jax_live = [f for f in jax_lint_source(bare, "fixtures.py") if not f.suppressed]
    assert sorted((f.rule, f.subject) for f in live) == sorted((f.rule, f.subject) for f in jax_live)
