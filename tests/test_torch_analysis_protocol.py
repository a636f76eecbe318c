"""The port's fleet-protocol model checker (``metrics_tpu_torch/analysis/
protocol.py``) against the JAX package's, on the CPU.

Every case of ``tests/analysis/test_protocol.py`` is mirrored under its own
name, driving the port's own fleet with every shard's cohort on the CPU
(``device="cpu"``). The full explorers run once per module (module-scoped
fixtures), as the JAX package's do. The cross-package cases run the JAX
package's explorers over the same schedule space and hold the port to the
same coverage counts, the same violations per fixture and the same minimal
counterexample.
"""
import inspect
import json
import os
import textwrap
import time

import pytest

from metrics_tpu_torch.analysis import fixtures as fx
from metrics_tpu_torch.analysis.lint import lint_source
from metrics_tpu_torch.analysis.protocol import (
    _baseline_findings,
    build_protocol_entry,
    check_protocol,
    counterexample_report,
    explore_crash_consistency,
    explore_fencing,
    load_protocol_baseline,
    refresh_protocol_baseline,
    tighten_protocol_baseline,
)
from metrics_tpu_torch.analysis.rules import RULES

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


@pytest.fixture(scope="module")
def crash_run():
    t0 = time.monotonic()
    evidence, findings = explore_crash_consistency(device=CPU)
    return evidence, findings, time.monotonic() - t0


@pytest.fixture(scope="module")
def fence_run():
    t0 = time.monotonic()
    evidence, findings = explore_fencing(device=CPU)
    return evidence, findings, time.monotonic() - t0


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's explorers over the same schedule spaces: the full
    clean runs and both fleet fixtures."""
    from metrics_tpu.analysis import fixtures as jfx
    from metrics_tpu.analysis import protocol as jp

    return {
        "crash": jp.explore_crash_consistency(),
        "fence": jp.explore_fencing(),
        "gc": jp.explore_crash_consistency(coordinator_cls=jfx.GcBeforeDurableCoordinator),
        "unfenced": jp.explore_fencing(shard_cls=jfx.UnfencedCheckpointShard),
    }


@pytest.fixture(scope="module")
def port_fixture_runs():
    return {
        "gc": explore_crash_consistency(coordinator_cls=fx.GcBeforeDurableCoordinator, device=CPU),
        "unfenced": explore_fencing(shard_cls=fx.UnfencedCheckpointShard, device=CPU),
    }


# ----------------------------------------------------------------------
# MTA013: exhaustive crash-consistency coverage, clean in-tree
# ----------------------------------------------------------------------
def test_crash_explorer_exhaustive_and_clean(crash_run):
    """The acceptance pin: all 4 migration phases × {single kill, double
    kill, partition} × both recovery permutations — plus the no-fault
    base case — explored with ZERO violations on the real coordinator."""
    evidence, findings, _ = crash_run
    assert findings == [], [str(f) for f in findings]
    assert evidence["phases"] == ["prepare", "in_flight", "pre_commit", "pre_gc"]
    assert set(evidence["modes"]) == {"none", "kill", "double_kill", "partition"}
    assert evidence["recovery_orders"] == 2
    # 1 base case + 4 phases x 3 fault modes x 2 recovery orders
    assert evidence["schedules"] == 25
    for phase in evidence["phases"]:
        for mode in ("kill", "double_kill", "partition"):
            assert f"{phase}/{mode}" in evidence["crash_points"]
    assert "recover/kill" in evidence["crash_points"]
    assert set(evidence["invariants"]) == {
        "exactly-one-owner", "no-lost-tenant", "cursor-monotone",
        "no-double-count", "gc-only-after-durable", "recover-idempotent",
    }
    # memoization prunes: distinct durable states < schedules
    assert 0 < evidence["states_explored"] < evidence["schedules"]
    assert evidence["explored"] + evidence["pruned"] == evidence["schedules"]


def test_fencing_explorer_exhaustive_and_clean(fence_run):
    evidence, findings, _ = fence_run
    assert findings == [], [str(f) for f in findings]
    assert set(evidence["writes"]) == {"checkpoint", "submit_wave", "replicate", "migrate"}
    assert set(evidence["points"]) == {"after_fence", "after_promote", "after_failover", "expired"}
    assert evidence["schedules"] == 16
    assert evidence["stale_writes_checked"] == 16


def test_protocol_explorer_bounded(crash_run, fence_run):
    """The perf guard: the full state space stays under a fixed state/time
    budget on the CPU. The state bound also catches a fingerprint
    regression (wall-clock leaking back in explodes distinct-state counts
    run to run)."""
    crash_ev, _, crash_s = crash_run
    fence_ev, _, fence_s = fence_run
    assert crash_ev["states_explored"] <= 32
    assert fence_ev["states_explored"] <= 16
    assert crash_s < 120.0, f"crash exploration took {crash_s:.1f}s"
    assert fence_s < 120.0, f"fencing exploration took {fence_s:.1f}s"


def test_explorer_is_deterministic_on_reduced_scope():
    """Same schedule space → same durable-state census, twice. Pins the
    wall-clock scrubbing in the fingerprint (written_at stamps, npz zip
    mtimes) that makes the baseline counters comparable across runs."""
    runs = [
        explore_crash_consistency(modes=("none", "kill"), phases=("in_flight",), device=CPU)[0]
        for _ in range(2)
    ]
    assert runs[0]["states_explored"] == runs[1]["states_explored"]
    assert runs[0]["crash_points"] == runs[1]["crash_points"]


# ----------------------------------------------------------------------
# fixtures: each trips exactly its rule
# ----------------------------------------------------------------------
def test_gc_before_durable_fixture_trips_exactly_mta013():
    """The GC-before-durable coordinator loses the tenant on the NO-FAULT
    schedule: the protocol itself is unsound, no kill required — and the
    counterexample names the minimal failing schedule."""
    _, findings = explore_crash_consistency(
        coordinator_cls=fx.GcBeforeDurableCoordinator, modes=("none",), device=CPU)
    assert findings and {f.rule for f in findings} == {"MTA013"}
    minimal = min(findings, key=lambda f: len(f.detail["schedule"]))
    assert minimal.detail["invariant"] in ("no-lost-tenant", "gc-only-after-durable")
    assert any("runs to completion" in s for s in minimal.detail["schedule"])


def test_gc_before_durable_self_heals_under_kill():
    """A kill at the pre-GC boundary is SURVIVED even by the broken
    coordinator — recovery refuses the non-durable commit and aborts the
    txn home."""
    _, findings = explore_crash_consistency(
        coordinator_cls=fx.GcBeforeDurableCoordinator, modes=("kill",), phases=("pre_gc",), device=CPU)
    assert findings == [], [str(f) for f in findings]


def test_gc_before_durable_caught_under_partition_too():
    _, findings = explore_crash_consistency(
        coordinator_cls=fx.GcBeforeDurableCoordinator, modes=("partition",), phases=("pre_gc",), device=CPU)
    assert findings and {f.rule for f in findings} == {"MTA013"}


def test_unfenced_shard_fixture_trips_exactly_mta014(port_fixture_runs):
    _, findings = port_fixture_runs["unfenced"]
    assert findings and {f.rule for f in findings} == {"MTA014"}
    invariants = {f.detail["invariant"] for f in findings}
    assert "fenced-write-refused" in invariants
    assert "no-fenced-durability" in invariants


def test_non_atomic_manifest_writer_fixture_trips_exactly_mtl107():
    """In-tree the fixture's allows keep the gate green; stripped, its
    source fires exactly MTL107 — once per pattern."""
    src = "import json\nimport os\n" + textwrap.dedent(inspect.getsource(fx.NonAtomicManifestWriter))
    rel = "analysis/fixtures.py"
    in_tree = lint_source(src, rel)
    assert all(f.suppressed for f in in_tree if f.rule == "MTL107")

    stripped = "\n".join(line for line in src.splitlines() if "metrics-tpu: allow" not in line)
    fired = [f for f in lint_source(stripped, rel) if not f.suppressed]
    assert fired and {f.rule for f in fired} == {"MTL107"}
    assert {f.detail["pattern"] for f in fired} == {"non-atomic-open", "rename-without-fsync"}


def test_mtl107_respects_fsync_before_rename():
    """The real atomic primitive's shape — fsync ordered before os.replace
    in the same function — must NOT flag (the port's kernel build publishes
    its library this way)."""
    clean = (
        "import os\n"
        "def publish(tmp, path):\n"
        "    f = os.open(tmp, os.O_RDONLY)\n"
        "    os.fsync(f)\n"
        "    os.close(f)\n"
        "    os.replace(tmp, path)\n"
    )
    assert [f for f in lint_source(clean, "ops/x.py") if f.rule == "MTL107"] == []


def test_mtl107_scopes_fsync_per_function():
    """An fsync in ANOTHER function does not sanctify this one's rename."""
    src = (
        "import os\n"
        "def a(f):\n"
        "    os.fsync(f)\n"
        "def b(tmp, path):\n"
        "    os.rename(tmp, path)\n"
    )
    fired = [f for f in lint_source(src, "ops/x.py") if f.rule == "MTL107"]
    assert len(fired) == 1 and fired[0].detail["pattern"] == "rename-without-fsync"


# ----------------------------------------------------------------------
# the committed tighten-only baseline
# ----------------------------------------------------------------------
def test_committed_baseline_matches_fresh_exploration(crash_run, fence_run):
    """PROTOCOL_BASELINE.json (the file the JAX package gates on) covers
    both scenarios, and the port's fresh run meets every committed
    coverage floor."""
    baseline = load_protocol_baseline(os.path.join(_REPO, "PROTOCOL_BASELINE.json"))
    assert baseline == load_protocol_baseline()  # the default resolves to the repo root
    assert baseline.get("schema") == "metrics_tpu.protocol_baseline"
    entries = baseline["entries"]
    assert {"crash_consistency", "fencing"} <= set(entries)
    assert set(baseline["fixtures"]) == {
        "GcBeforeDurableCoordinator", "NonAtomicManifestWriter", "UnfencedCheckpointShard"}
    fresh = {
        "crash_consistency": build_protocol_entry(crash_run[0]),
        "fencing": build_protocol_entry(fence_run[0]),
    }
    assert _baseline_findings(fresh, baseline) == []
    assert fresh == {k: entries[k] for k in fresh}


def test_baseline_gate_flags_coverage_regression():
    baseline = {
        "schema": "metrics_tpu.protocol_baseline",
        "entries": {"crash_consistency": {"states_explored": 99, "schedules": 99, "crash_points": 99}},
    }
    fresh = {"crash_consistency": {"states_explored": 6, "schedules": 25, "crash_points": 14}}
    findings = _baseline_findings(fresh, baseline)
    assert findings and all(f.rule == "MTA013" for f in findings)
    assert all("tighten-only" in f.message for f in findings)


def test_tighten_only_merge_preserves_fixtures_and_prunes():
    baseline = {
        "fixtures": ["GcBeforeDurableCoordinator"],
        "entries": {
            "crash_consistency": {"states_explored": 10, "schedules": 5, "crash_points": 3},
            "GcBeforeDurableCoordinator": {"expected_rule": "MTA013", "min_violations": 1},
            "retired_scenario": {"states_explored": 1, "schedules": 1, "crash_points": 1},
        },
    }
    fresh = {"crash_consistency": {"states_explored": 6, "schedules": 25, "crash_points": 14}}
    merged, pruned = tighten_protocol_baseline(baseline, fresh)
    assert merged["entries"]["crash_consistency"] == {"states_explored": 10, "schedules": 25, "crash_points": 14}
    assert merged["entries"]["GcBeforeDurableCoordinator"] == {"expected_rule": "MTA013", "min_violations": 1}
    assert pruned == ["retired_scenario"]


def test_refresh_refusal_ladder(tmp_path):
    """The port's ``refresh_protocol_baseline`` refuses skipped passes, red
    explorations and missing files, and a permitted refresh writes only the
    path its caller gives (never the committed file here)."""
    committed = os.path.join(_REPO, "PROTOCOL_BASELINE.json")
    with open(committed, "rb") as fh:
        committed_bytes = fh.read()

    assert "NOT refreshed" in refresh_protocol_baseline(str(tmp_path / "x.json"), {}, skipped=True)
    red = {"summary": {"findings": 2}, "evidence": {"baseline_entries": {}}}
    assert "NOT refreshed" in refresh_protocol_baseline(str(tmp_path / "x.json"), red, skipped=False)
    green = {"summary": {"findings": 0},
             "evidence": {"baseline_entries": {"crash_consistency": {
                 "states_explored": 6, "schedules": 25, "crash_points": 14}}}}
    assert "NOT refreshed" in refresh_protocol_baseline(str(tmp_path / "missing.json"), green, skipped=False)

    path = tmp_path / "PROTOCOL_BASELINE.json"
    path.write_text(json.dumps({
        "schema": "metrics_tpu.protocol_baseline",
        "fixtures": [],
        "entries": {"crash_consistency": {"states_explored": 2, "schedules": 2, "crash_points": 2}},
    }))
    out = refresh_protocol_baseline(str(path), green, skipped=False)
    assert "refreshed" in out and "NOT" not in out
    merged = json.loads(path.read_text())
    assert merged["entries"]["crash_consistency"]["schedules"] == 25
    assert load_protocol_baseline(str(path))["entries"]["crash_consistency"]["schedules"] == 25
    with open(committed, "rb") as fh:
        assert fh.read() == committed_bytes
    assert sorted(os.listdir(tmp_path)) == ["PROTOCOL_BASELINE.json"]


# ----------------------------------------------------------------------
# check_protocol: the pass-6 entry point (report payload + telemetry)
# ----------------------------------------------------------------------
def test_check_protocol_clean_payload_and_telemetry():
    """Healthy tree: zero findings, the evidence payload, the
    states-explored gauge set, and the healthy-run-zero violations counter
    NOT emitted."""
    import metrics_tpu_torch.observability as obs

    obs.enable()
    try:
        result = check_protocol(baseline_path=os.path.join(_REPO, "PROTOCOL_BASELINE.json"), device=CPU)
        snap = obs.get().snapshot()
    finally:
        obs.disable()
    assert result["summary"]["findings"] == 0
    assert result["summary"]["violations"] == 0
    assert {"crash_consistency", "fencing", "baseline_entries", "states_explored"} <= set(result["evidence"])
    assert result["findings"] == []
    assert snap["gauges"]["analysis.protocol.states_explored"] > 0
    assert "analysis.protocol.violations" not in snap["counters"]


def test_counterexample_report_minimal_first():
    _, findings = explore_crash_consistency(
        coordinator_cls=fx.GcBeforeDurableCoordinator, modes=("none", "kill"), phases=("pre_gc",), device=CPU)
    report = counterexample_report(findings)
    assert "counterexample" in report and "minimal schedule first" in report
    head = report.splitlines()[1]
    assert "[0]" in head and "MTA013" in head
    lengths = [len(f.detail["schedule"]) for f in findings]
    first = report.split("[0]")[1].split("[1]")[0] if "[1]" in report else report
    assert str(min(lengths) - 1) + ". " in first  # steps numbered from 0

    assert counterexample_report([]).startswith("protocol explorer: no")


def test_rules_registered():
    for rid, slug in (("MTA013", "crash-consistency"),
                      ("MTA014", "fencing-linearizability"),
                      ("MTL107", "non-atomic-durability")):
        assert rid in RULES and RULES[rid].slug == slug


# ----------------------------------------------------------------------
# the port against the JAX package, same schedule space
# ----------------------------------------------------------------------
def _coverage(evidence):
    keys = ("states_explored", "schedules", "crash_points", "explored", "pruned", "stale_writes_checked")
    return {k: evidence[k] for k in keys if k in evidence}


def _violations(findings):
    return [
        (f.rule, f.subject, f.detail.get("invariant"), f.detail.get("phase"), f.detail.get("mode"),
         f.detail.get("write"), f.detail.get("point"), tuple(f.detail.get("recovery_order", ())))
        for f in findings
    ]


def test_explorer_coverage_equals_jax(crash_run, fence_run, jax_runs):
    assert _coverage(crash_run[0]) == _coverage(jax_runs["crash"][0])
    assert _coverage(fence_run[0]) == _coverage(jax_runs["fence"][0])
    assert build_protocol_entry(crash_run[0]) == {"states_explored": 6, "schedules": 25, "crash_points": 14}
    assert build_protocol_entry(fence_run[0]) == {"states_explored": 2, "schedules": 16, "crash_points": 16}
    assert jax_runs["crash"][1] == [] and jax_runs["fence"][1] == []


@pytest.mark.parametrize("fixture", ["gc", "unfenced"])
def test_fixture_violations_equal_jax(fixture, jax_runs, port_fixture_runs):
    port_ev, port_findings = port_fixture_runs[fixture]
    jax_ev, jax_findings = jax_runs[fixture]
    assert _violations(port_findings) == _violations(jax_findings)
    assert _coverage(port_ev) == _coverage(jax_ev)
    baseline = load_protocol_baseline()["entries"]
    name = {"gc": "GcBeforeDurableCoordinator", "unfenced": "UnfencedCheckpointShard"}[fixture]
    assert len(port_findings) >= baseline[name]["min_violations"]
    assert {f.rule for f in port_findings} == {baseline[name]["expected_rule"]}


def test_minimal_counterexample_equals_jax(jax_runs, port_fixture_runs):
    """The report's first schedule — the repro an operator replays — is
    the same text in both packages, for both fleet fixtures."""
    from metrics_tpu.analysis.protocol import counterexample_report as jax_report

    for fixture in ("gc", "unfenced"):
        port = counterexample_report(port_fixture_runs[fixture][1]).split("\n[1]")[0]
        want = jax_report(jax_runs[fixture][1]).split("\n[1]")[0]
        assert port == want
        assert "[0]" in port


def test_the_watchdog_hint_names_the_fixture_rules(port_fixture_runs):
    from metrics_tpu_torch.analysis.program import hint_for_watch_key
    from metrics_tpu_torch.observability.watchdog import _analysis_hint

    assert port_fixture_runs  # the fixtures' runs registered their findings
    for name, rule in (("GcBeforeDurableCoordinator", "MTA013"), ("UnfencedCheckpointShard", "MTA014")):
        hint = hint_for_watch_key(name)
        assert hint is not None and rule in hint and name in hint
        assert _analysis_hint(f"engine[{name}]@cohort") == hint
    assert hint_for_watch_key("NoSuchClass") is None


def test_cuda_without_a_card_raises():
    """The explorers run on the card unless the caller asks for the CPU:
    asking for the card on a machine without one raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card tests cover device='cuda'")
    for device in ("cuda", None):
        with pytest.raises(RuntimeError, match="no.*CUDA|none is available"):
            explore_fencing(writes=("checkpoint",), points=("after_fence",), device=device)
        with pytest.raises(RuntimeError, match="none is available"):
            explore_crash_consistency(modes=("none",), device=device)
