"""The port's host-seam budgets (pass 4, MTA008, ``metrics_tpu_torch/
analysis/concurrency.py``) against the JAX package's and the committed
``SEAM_BASELINE.json``, on the CPU.

One module-scoped fixture per package runs its whole registry once
(``audit_registry(quantized=True, cohort=True)``, the port's with
``device="cpu"``) under a telemetry scope: 29 families, 80 of them
engine-eligible with their variants. The MTA008 cases of
``tests/analysis/test_concurrency.py`` are mirrored under their own names;
each budget is held against the JAX package's on the same seeded inputs,
exactly. The baseline is the JAX package's file, read and never written.
"""
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu_torch as M
import metrics_tpu_torch.observability as obs
from metrics_tpu_torch.analysis import (
    audit_metric,
    audit_registry,
    flatten_seam_budget,
    host_seam_budget,
    host_seam_sites,
    load_seam_baseline,
)
from metrics_tpu_torch.analysis import fixtures as fx
from metrics_tpu_torch.engine import LeafSpec, fake_trace

CPU = "cpu"
_NP_X = np.linspace(0.0, 1.0, 8).astype(np.float32)
_X = torch.as_tensor(_NP_X)


def _jx():
    import jax.numpy as jnp

    return jnp.asarray(_NP_X)


def _audited(run):
    """``(report, gauges)`` of a registry audit run under a telemetry scope."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # config-edge warnings from factories
        with obs.telemetry_scope() as tel:
            report = run()
    return report, dict(tel.gauges)


@pytest.fixture(scope="module")
def registry_report():
    return _audited(lambda: audit_registry(quantized=True, cohort=True, device=CPU))


@pytest.fixture(scope="module")
def jax_report():
    import metrics_tpu.observability as jobs
    from metrics_tpu.analysis import audit_registry as jax_audit_registry

    with jobs.telemetry_scope() as tel:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            report = jax_audit_registry(quantized=True, cohort=True)
    return report, dict(tel.gauges)


def _seams(report):
    return {
        fam: (entry.get("evidence") or {}).get("host_seam")
        for fam, entry in report["families"].items()
        if (entry.get("evidence") or {}).get("host_seam")
    }


# ---------------------------------------------------------------------------
# MTA008 — host-seam budgets
# ---------------------------------------------------------------------------
def test_seam_budget_counts_states_and_phases():
    """MSE: two sum states -> two host collectives per sync, two fetches per
    checkpoint, one value fetch per compute, zero steady crossings."""
    import metrics_tpu as J
    from metrics_tpu.analysis import host_seam_budget as jax_budget

    budget = host_seam_budget(M.MeanSquaredError(device=CPU))
    assert budget == jax_budget(J.MeanSquaredError())
    flat = flatten_seam_budget(budget)
    assert flat["per_sync.host_collectives"] == 2
    assert flat["per_sync.quantized_payloads"] == 0
    assert flat["per_checkpoint.device_fetches"] == 2
    assert flat["per_compute.device_fetches"] == 1
    assert flat["steady_per_step"] == 0
    assert flat["per_dispatch.callbacks"] == 0


def test_seam_budget_quantized_tier_reclassifies_payloads_and_residuals():
    """An int8 tier: the same collective count, the quantized payloads
    counted, and the ``__qres`` residual raises the checkpoint fetch count."""
    import metrics_tpu as J
    from metrics_tpu.analysis import host_seam_budget as jax_budget

    exact = flatten_seam_budget(host_seam_budget(M.MeanSquaredError(device=CPU)))
    q, jq = M.MeanSquaredError(device=CPU), J.MeanSquaredError()
    q.set_sync_precision("int8")
    jq.set_sync_precision("int8")
    budget = host_seam_budget(q)
    assert budget == jax_budget(jq)
    flat = flatten_seam_budget(budget)
    assert flat["per_sync.host_collectives"] == exact["per_sync.host_collectives"]
    assert flat["per_sync.quantized_payloads"] == 2
    assert flat["per_checkpoint.device_fetches"] > exact["per_checkpoint.device_fetches"]


def test_seam_budget_cohort_variant_is_tenant_count_independent():
    """One collective per STATE (stacked), plus exactly one health fetch."""
    import metrics_tpu as J
    from metrics_tpu.analysis import host_seam_budget as jax_budget

    budget = host_seam_budget(M.MeanSquaredError(device=CPU), cohort=True)
    assert budget == jax_budget(J.MeanSquaredError(), cohort=True)
    flat = flatten_seam_budget(budget)
    assert flat["per_sync.host_collectives"] == 2
    assert flat["per_health.device_fetches"] == 1


def test_callbacks_in_step_program_enter_the_dispatch_budget():
    """A host transfer in the step graph is a per-dispatch crossing. The JAX
    case budgets ``CallbackInJit``'s step (a ``pure_callback``); the port's
    fixture reads ``.numpy()``, which stops a fake trace, so its stand-in is
    a step traced over fake tensors of the card that copies to the host and
    back — a transfer there, where a CPU program's ``.cpu()`` is none."""
    import metrics_tpu as J
    from metrics_tpu.analysis import fixtures as jfx
    from metrics_tpu.analysis import host_seam_budget as jax_budget

    card = LeafSpec((8,), torch.float32, torch.device("cuda", 0))
    graph, _ = fake_trace(lambda v: v + v.sum().cpu().to(v.device), (card,))
    flat = flatten_seam_budget(host_seam_budget(fx.CallbackInJit(device=CPU), step_closed=graph))
    assert flat["per_dispatch.callbacks"] >= 1
    assert flat["steady_per_step"] >= 1
    closed, _, _ = J.CompiledStepEngine(jfx.CallbackInJit(), observe=False).abstract_step(_jx())
    ref = flatten_seam_budget(jax_budget(jfx.CallbackInJit(), step_closed=closed))
    assert flat == ref
    # the same copy in a CPU program crosses nothing
    cpu_graph, _ = fake_trace(lambda v: v + v.sum().cpu().to(v.device), (_X,))
    assert flatten_seam_budget(host_seam_budget(fx.CallbackInJit(device=CPU), step_closed=cpu_graph))[
        "per_dispatch.callbacks"
    ] == 0


def test_committed_baseline_covers_every_audited_family(registry_report):
    """Every engine-eligible family and variant has a committed seam budget,
    and the port's budget, flattened, equals it family by family, with the
    states inventory (80 families: 20 bases, 20 @cohort, 20 @int8, 20 @bf16)."""
    baseline = load_seam_baseline()
    assert baseline, "SEAM_BASELINE.json missing or empty"
    measured = _seams(registry_report[0])
    assert len(measured) == 80
    assert sorted(set(measured) - set(baseline)) == []
    for fam in sorted(measured):
        assert flatten_seam_budget(measured[fam]) == baseline[fam]["budget"], fam
        assert measured[fam]["states"] == baseline[fam]["states"], fam
    # the baseline's only other entry is the deliberately tight fixture's
    assert sorted(set(baseline) - set(measured)) == ["SeamRegressor"]


def test_registry_seam_budgets_equal_jax(registry_report, jax_report):
    """The port's 80 budgets are the JAX package's, exactly, and so is the
    ``analysis.seam.crossings`` gauge the registry audit sets."""
    port, ref = _seams(registry_report[0]), _seams(jax_report[0])
    assert sorted(port) == sorted(ref)
    for fam in ref:
        assert port[fam] == ref[fam], fam
    assert registry_report[1]["analysis.seam.crossings"] == jax_report[1]["analysis.seam.crossings"] > 0


def test_variant_namespaces_carry_seam_evidence(registry_report):
    fams = registry_report[0]["families"]
    assert (fams["MeanSquaredError@cohort"]["evidence"] or {}).get("host_seam")
    assert (fams["MeanSquaredError@int8"]["evidence"] or {}).get("host_seam")
    cohort_seam = fams["MeanSquaredError@cohort"]["evidence"]["host_seam"]
    assert cohort_seam["per_health"]["device_fetches"] == 1


def test_seam_regression_fires_mta008_and_counts():
    """The committed SeamRegressor budget is one synced state; the class
    registers three — the gate and the ``analysis.seam.regressions``
    counter fire, as in the JAX package."""
    import metrics_tpu.observability as jobs
    from metrics_tpu.analysis import audit_metric as jax_audit_metric
    from metrics_tpu.analysis import fixtures as jfx

    with obs.telemetry_scope() as tel:
        result = audit_metric(fx.SeamRegressor(device=CPU), (_X,))
        assert {f.rule for f in result.findings} == {"MTA008"}
        assert any(
            f.detail.get("key") == "per_sync.host_collectives"
            and f.detail.get("got") == 3
            and f.detail.get("baseline") == 1
            for f in result.findings
        )
        assert tel.counters.get("analysis.seam.regressions", 0) >= 1
    with jobs.telemetry_scope() as jtel:
        ref = jax_audit_metric(jfx.SeamRegressor(), (_jx(),))
        assert jtel.counters.get("analysis.seam.regressions", 0) >= 1
    mta008 = lambda r: sorted((f.subject, f.detail["got"], f.detail["baseline"]) for f in r.findings  # noqa: E731
                              if f.rule == "MTA008")
    assert mta008(result) == mta008(ref)


def test_unbaselined_families_are_measured_not_gated():
    """A class absent from the committed baseline gets evidence but no
    MTA008 finding."""

    class _NeverCommitted(M.MeanSquaredError):
        pass

    result = audit_metric(_NeverCommitted(device=CPU), (_X, _X))
    assert result.findings == []
    assert result.evidence["host_seam"]["per_sync"]["host_collectives"] == 2


def test_host_seam_sites_name_the_library_crossings():
    """The AST leg names crossings on the port's own serving-loop host paths
    (and never the JAX package's files), with a sync and a dispatch phase
    and device fetches among them, as the JAX package's table has."""
    from metrics_tpu.analysis import host_seam_sites as jax_sites

    sites = host_seam_sites()
    assert sites, "no crossing sites found on the serving-loop host paths"
    phases = {s["phase"] for s in sites}
    assert "sync" in phases and "dispatch" in phases
    kinds = {s["kind"] for s in sites}
    assert "device_fetch" in kinds
    for s in sites:
        assert ":" in s["site"] and s["call"]
        assert s["site"].startswith("metrics_tpu_torch/"), s
    assert phases == {s["phase"] for s in jax_sites()}


def test_healthy_run_keeps_pass4_counters_at_zero():
    """The seam half of the JAX case: a clean audit moves no
    ``analysis.seam.regressions``. Its MetricSan half (a locked threaded run
    moves no ``san.thread.races``) waits for the port's sanitizer."""
    with obs.telemetry_scope() as tel:
        seam0 = tel.counters.get("analysis.seam.regressions", 0)
        result = audit_metric(M.MeanSquaredError(device=CPU), (_X, _X))
        assert result.findings == []
        assert tel.counters.get("analysis.seam.regressions", 0) == seam0


def test_evidence_rides_the_report_schema(registry_report):
    """``evidence["host_seam"]`` / ``evidence["double_buffer"]`` ride the
    report of every engine-eligible family beside pass 5's ``numerics``;
    eager-only families carry ``numerics`` alone, as the JAX package's do."""
    report = registry_report[0]
    entry = report["families"]["MeanSquaredError"]
    assert set(entry["evidence"]) == {"host_seam", "double_buffer", "numerics"}
    assert entry["evidence"]["double_buffer"]["writeback_locked"] is True
    eager = report["families"]["AUROC"]
    assert eager["engine_eligible"] is False
    assert set(eager["evidence"]) == {"numerics"}
    assert report["version"] == 4
    assert report["host_seam_sites"] == host_seam_sites()
