"""The cohort variant audit (``audit_registry(cohort=True)``,
``_audit_cohort_variant``) of the port against the JAX package's, on the CPU.

The cases of ``tests/analysis/test_cohort_audit.py`` are mirrored under
their own names: the vmapped cohort step must uphold the per-tenant step's
invariants — MTA003 aliasing and MTA007 passthrough on the STACKED states,
MTA002 host transfers — and pass 4's evidence rides every ``@cohort``
family. Where the JAX case hand-builds a vmapped jaxpr, the port builds the
same program with ``make_fx`` over ``torch.func.vmap``, on fake tensors of
the card (a fake tensor needs no card). Left out until the port's
sanitizer (MetricSan) lands: ``test_metricsan_clean_across_cohort_lifecycle``
and ``test_metricsan_still_flags_external_pokes_with_cohort_armed``.
"""
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu_torch as M
from metrics_tpu_torch.analysis import audit_metric, audit_registry, hint_for_watch_key
from metrics_tpu_torch.analysis import fixtures as fx
from metrics_tpu_torch.analysis.distributed import _donated_passthrough_positions
from metrics_tpu_torch.analysis.program import _audit_cohort_variant, _duplicate_outvars
from metrics_tpu_torch.engine import LeafSpec, fake_trace

CPU = "cpu"
_NP_X = np.linspace(0.0, 1.0, 16, dtype=np.float32)
_X = torch.as_tensor(_NP_X)
_CARD = torch.device("cuda", 0)


def _jx():
    import jax.numpy as jnp

    return jnp.asarray(_NP_X)


@pytest.fixture(scope="module")
def registry_report():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # config-edge warnings from factories
        return audit_registry(quantized=False, cohort=True, device=CPU)


# ---------------------------------------------------------------------------
# registry-level: every engine-eligible family's cohort variant is clean
# ---------------------------------------------------------------------------
def test_registry_cohort_variants_audited_and_clean(registry_report):
    base_eligible = {
        f for f, e in registry_report["families"].items() if "@" not in f and e["engine_eligible"]
    }
    cohort = {f.split("@")[0]: e for f, e in registry_report["families"].items() if f.endswith("@cohort")}
    # one cohort variant per engine-eligible base family, zero findings
    assert set(cohort) == base_eligible and len(cohort) == 20
    for fam, entry in cohort.items():
        assert entry["findings"] == [], (fam, entry["findings"])
        assert entry["evidence"]["double_buffer"]["safe"] is True, fam
        assert entry["evidence"]["host_seam"]["per_health"] == {"device_fetches": 1}, fam


# ---------------------------------------------------------------------------
# the detectors bind on vmapped programs
# ---------------------------------------------------------------------------
def _vmapped(fn, *specs):
    """``make_fx`` of ``torch.func.vmap(fn)`` over fake tensors of the card
    with a leading tenant axis of 4."""
    return fake_trace(lambda *xs: torch.func.vmap(fn)(*xs), tuple(LeafSpec(s, torch.float32, _CARD) for s in specs))[0]


def test_cohort_detectors_see_through_the_vmap():
    """The graph-level detectors the cohort audit runs (duplicate outputs for
    MTA003, input passthrough for MTA007) bind on VMAPPED programs — no
    registry family trips them, so they are proven on hand-built stacked
    programs, as the JAX case proves them on hand-built jaxprs."""
    import jax
    import jax.numpy as jnp
    from metrics_tpu.analysis.distributed import _donated_passthrough_positions as jax_passthrough
    from metrics_tpu.analysis.program import _duplicate_outvars as jax_duplicates

    # passthrough: a vmapped step returning its stacked state
    graph = _vmapped(lambda s, x: (s, x.sum()), (4,), (4, 8))
    assert _donated_passthrough_positions(graph, 1) == [0]
    closed = jax.make_jaxpr(jax.vmap(lambda s, x: (s, jnp.sum(x))))(jnp.zeros(4), jnp.zeros((4, 8)))
    assert jax_passthrough(closed, 1) == [0]
    # ... and the PyTorch-only form: the stacked state written in place
    graph = _vmapped(lambda s, x: (s.add_(x.sum()), x.sum()), (4,), (4, 8))
    assert _donated_passthrough_positions(graph, 1) == [0]

    # aliasing: one batched value bound to two outputs of the stacked step
    def aliased(s, x):
        t = s + x.sum()
        return t, t

    dups = _duplicate_outvars(_vmapped(aliased, (4,), (4, 8)))
    assert dups and dups[0][0] == 2
    jdups = jax_duplicates(jax.make_jaxpr(jax.vmap(lambda s, x: (lambda t: (t, t))(s + jnp.sum(x))))(
        jnp.zeros(4), jnp.zeros((4, 8))
    ))
    assert [d[0] for d in dups] == [d[0] for d in jdups]
    # a clean stacked step trips neither
    clean = _vmapped(lambda s, x: (s + x.sum(), x.mean()), (4,), (4, 8))
    assert _donated_passthrough_positions(clean, 1) == [] and _duplicate_outvars(clean) == []

    # the update-level flavors still fire for the broken fixtures when the
    # cohort template is audited as a family (the base audit runs first)
    assert any(f.rule == "MTA003" for f in audit_metric(fx.DonatedAlias(device=CPU), (_X,)).findings)
    assert any(f.rule == "MTA007" for f in audit_metric(fx.UntouchedStatePassthrough(device=CPU), (_X,)).findings)


def test_cohort_audit_flags_callbacks_surviving_the_vmap():
    from metrics_tpu.analysis import fixtures as jfx
    from metrics_tpu.analysis.program import _audit_cohort_variant as jax_cohort_variant

    result = _audit_cohort_variant(fx.CallbackInJit(device=CPU), (_X,))
    ref = jax_cohort_variant(jfx.CallbackInJit(), (_jx(),))
    assert "MTA002" in {f.rule for f in result.findings}
    assert {f.rule for f in result.findings} == {f.rule for f in ref.findings}
    # the stacked step did not trace: its verdict stays open
    assert result.evidence["double_buffer"]["safe"] is None


def test_cohort_audit_clean_positive_control():
    import metrics_tpu as J
    from metrics_tpu.analysis.program import _audit_cohort_variant as jax_cohort_variant

    result = _audit_cohort_variant(M.MeanSquaredError(device=CPU), (_X, _X))
    ref = jax_cohort_variant(J.MeanSquaredError(), (_jx(), _jx()))
    assert result.findings == [] == ref.findings
    assert result.evidence["host_seam"] == ref.evidence["host_seam"]
    assert result.evidence["double_buffer"] == ref.evidence["double_buffer"]


# ---------------------------------------------------------------------------
# watchdog cross-link: cohort watch keys resolve through the suffix
# ---------------------------------------------------------------------------
def test_hint_for_watch_key_resolves_cohort_suffix():
    from metrics_tpu.analysis import audit_metric as jax_audit_metric
    from metrics_tpu.analysis import fixtures as jfx
    from metrics_tpu.analysis import hint_for_watch_key as jax_hint

    audit_metric(fx.NarrowAccumulator(device=CPU), (_X,))  # seeds the registry with MTA001
    hint = hint_for_watch_key("engine[NarrowAccumulator]@cohort")
    assert hint is not None and "MTA001" in hint
    assert hint == hint_for_watch_key("engine[NarrowAccumulator]")
    jax_audit_metric(jfx.NarrowAccumulator(), (_jx(),))
    assert jax_hint("engine[NarrowAccumulator]@cohort").split(" on ")[0] == hint.split(" on ")[0]
