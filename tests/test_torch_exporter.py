"""The port's Prometheus export surface against the JAX package's, on the CPU.

Every case of ``tests/bases/test_exporter.py`` is mirrored on
``metrics_tpu_torch.observability.exporter`` under the same name: zero
sockets and bit-identical results when off; the lifecycle (idempotent
arming, a disarm that releases the port, scopes that restore); scrapes that
parse with the same validator, carry every registry key and stay consistent
while a writer or a live serving pipeline races them. Beside them: the
64-tenant scrape (``tests/bases/test_cohort_health.py``), ``/healthz`` after
an SLO breach (``tests/bases/test_serving.py``), the glossary's exporter
families (``tests/bases/test_glossary.py``), the review hazards of the JAX
exporter (ROADMAP Queue 3 item 6), and one seeded workload rendered by both
packages: the same family names, types and label names, and the same
values wherever they are not a clock or an identity.

Every server binds port 0 (OS-assigned) and every scrape and wait has a
timeout.
"""
import gc
import json
import os
import re
import socket
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.observability as jobs
import metrics_tpu_torch as tm
import metrics_tpu_torch.observability as obs
from metrics_tpu.observability import costledger as jcl
from metrics_tpu_torch.observability import costledger as cl
from metrics_tpu_torch.observability import telemetry as telemetry_mod
from metrics_tpu_torch.observability.exporter import parse_prometheus_text, render_exposition
from metrics_tpu_torch.observability.telemetry import prometheus_name

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"
WAIT_S = 30.0


def _clean():
    gc.collect()  # cohorts of an earlier file's reference cycles leave the weak registries
    for pkg, ledger in ((obs, cl), (jobs, jcl)):
        pkg.disable()
        pkg.get().reset()
        pkg.disable_exporter()
        ledger.disable_cost_ledger()
        ledger.get_ledger().reset()
    # an SLO leaked from another test frame must not flip /healthz to degraded
    for name in ("metrics_tpu.serving.slo", "metrics_tpu_torch.serving.slo"):
        slo_mod = sys.modules.get(name)
        if slo_mod is not None:
            slo_mod._ACTIVE.clear()


@pytest.fixture(autouse=True)
def _pristine():
    _clean()
    yield
    _clean()


def _scrape(port: int, path: str = "/metrics") -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.read().decode()


def _grid(rng, shape):
    """Multiples of 1/256: every sum is exact in any order."""
    return (rng.randint(0, 256, size=shape) / 256.0).astype(np.float32)


# ----------------------------------------------------------------------
# 1. zero-sockets / zero-overhead when off
# ----------------------------------------------------------------------
def test_zero_sockets_and_bit_identical_when_off():
    assert obs.get_exporter() is None
    col = tm.MetricCollection([tm.Accuracy(device=CPU)], compiled=True)
    p = torch.from_numpy(np.random.RandomState(0).rand(64, 4).astype(np.float32))
    t = torch.from_numpy(np.random.RandomState(1).randint(4, size=64))
    baseline = col(p, t)["Accuracy"]
    # no exporter thread appeared as a side effect of the forward
    assert obs.get_exporter() is None
    assert not any(th.name.startswith("metrics-tpu-exporter") for th in threading.enumerate())
    assert obs.get().counters == {}
    # the same forward under an armed exporter is bit-identical
    col2 = tm.MetricCollection([tm.Accuracy(device=CPU)], compiled=True)
    with obs.exporter_scope(0):
        again = col2(p, t)["Accuracy"]
    assert torch.equal(baseline, again)


def test_render_does_not_mutate_registry():
    obs.enable()
    obs.get().count("engine.dispatches", 2)
    before = obs.get().snapshot()
    render_exposition()
    after = obs.get().snapshot()
    assert before["counters"] == after["counters"]
    assert before["gauges"] == after["gauges"]


# ----------------------------------------------------------------------
# 2. lifecycle
# ----------------------------------------------------------------------
def test_enable_is_idempotent_and_explicit_port_restarts():
    first = obs.enable_exporter(0)
    try:
        assert obs.enable_exporter() is first  # no port requested: keep
        assert obs.enable_exporter(first.port) is first  # same port: keep
        assert obs.enable_exporter(0) is first  # 0 = any port: keep
    finally:
        obs.disable_exporter()
    assert obs.get_exporter() is None


def test_disarm_releases_the_port():
    exporter = obs.enable_exporter(0)
    port = exporter.port
    assert _scrape(port, "/healthz")
    obs.disable_exporter()
    # the port is re-bindable at once: the disarm closed the listener
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        s.bind(("127.0.0.1", port))
    finally:
        s.close()
    # and a fresh exporter re-binds the same (OS-assigned) port for real
    again = obs.enable_exporter(port)
    assert again.port == port
    obs.disable_exporter()


def test_exporter_scope_restores_prior_state():
    with obs.exporter_scope(0) as ex:
        assert obs.get_exporter() is ex
    assert obs.get_exporter() is None


def test_healthz_carries_identity():
    with obs.exporter_scope(0) as ex:
        blob = json.loads(_scrape(ex.port, "/healthz"))
    assert blob["status"] == "ok"
    assert blob["rank"] == 0 and blob["world_size"] == 1


def test_unknown_path_is_404():
    with obs.exporter_scope(0) as ex:
        with pytest.raises(urllib.error.HTTPError) as err:
            _scrape(ex.port, "/nope")
        assert err.value.code == 404


# ----------------------------------------------------------------------
# 3. scrape correctness
# ----------------------------------------------------------------------
def test_scrape_is_valid_and_complete():
    obs.enable()
    tel = obs.get()
    tel.count("engine.dispatches", 7)
    tel.gauge("cohort.size", 3)
    tel.observe("metric.Accuracy.forward_s", 0.25)
    tel.observe_hist("sync.latency_ms", 2.0, obs.LATENCY_BUCKETS_MS)
    tel.observe_hist("sync.latency_ms", 80.0, obs.LATENCY_BUCKETS_MS)
    with obs.exporter_scope(0) as ex:
        text = _scrape(ex.port)
    samples = parse_prometheus_text(text)
    snap = tel.snapshot()
    for name in snap["counters"]:
        # counters carry _total, which also keeps a counter-and-histogram
        # key from declaring one family with two types
        assert prometheus_name(name) + "_total" in samples, name
    for name in snap["gauges"]:
        assert prometheus_name(name) in samples, name
    for name in snap["timers"]:
        assert prometheus_name(name) + "_sum" in samples, name
        assert prometheus_name(name) + "_count" in samples, name
    for name in snap["histograms"]:
        assert prometheus_name(name) + "_bucket" in samples, name
    # values survive the round trip
    assert samples[prometheus_name("engine.dispatches") + "_total"][0][1] == 7
    hist = samples[prometheus_name("sync.latency_ms") + "_count"]
    assert hist[0][1] == 2
    # identity rides the exposition
    assert samples["metrics_tpu_identity"][0][0]["rank"] == "0"


def test_counter_histogram_double_key_renders_one_type_per_family():
    """A key recorded as both a counter and a histogram
    (``sync.payload_bytes``) renders two families (the counter takes
    _total): a scraper rejects one name declared with two types."""
    obs.enable()
    tel = obs.get()
    tel.count("sync.payload_bytes", 4096)
    tel.observe_hist("sync.payload_bytes", 4096, obs.PAYLOAD_BUCKETS_BYTES)
    samples = parse_prometheus_text(tel.to_prometheus())  # raises on dup TYPE
    assert prometheus_name("sync.payload_bytes") + "_total" in samples
    assert prometheus_name("sync.payload_bytes") + "_bucket" in samples


def test_parser_rejects_duplicate_family_declarations():
    with pytest.raises(ValueError, match="declared twice"):
        parse_prometheus_text(
            "# TYPE m counter\nm_total 1\n# TYPE m histogram\n"
            'm_bucket{le="+Inf"} 1\nm_count 1\n'
        )


def test_scrape_counts_scrapes():
    obs.enable()
    with obs.exporter_scope(0) as ex:
        _scrape(ex.port)
        _scrape(ex.port)
    assert obs.get().counters["exporter.scrapes"] == 2


def test_scrape_while_updating_is_consistent():
    """A scrape racing a writer thread always parses with the histogram
    invariants intact (one locked snapshot a render, never a torn
    registry)."""
    obs.enable()
    tel = obs.get()
    stop = threading.Event()

    def hammer():
        i = 0
        while not stop.is_set():
            tel.count("engine.dispatches")
            tel.observe_hist("sync.latency_ms", float(i % 100), obs.LATENCY_BUCKETS_MS)
            tel.gauge("cohort.size", i)
            i += 1

    writer = threading.Thread(target=hammer, daemon=True)
    writer.start()
    try:
        with obs.exporter_scope(0) as ex:
            for _ in range(10):
                samples = parse_prometheus_text(_scrape(ex.port))
                name = prometheus_name("sync.latency_ms")
                if name + "_bucket" in samples:
                    # the parser enforced cumulativity and +Inf == _count
                    assert name + "_count" in samples
    finally:
        stop.set()
        writer.join(timeout=5)
    assert not writer.is_alive()


def test_parser_rejects_malformed_expositions():
    with pytest.raises(ValueError):
        parse_prometheus_text("not a metric line at all!")
    with pytest.raises(ValueError, match="label"):
        # junk inside the label block must not be silently skipped
        parse_prometheus_text('m{garbage,ok="1"} 3\n')
    with pytest.raises(ValueError, match="label"):
        # 'bad-label' embeds a valid-looking 'label="1"' a findall-based
        # extraction would accept
        parse_prometheus_text('m{bad-label="1"} 3\n')
    with pytest.raises(ValueError):
        # decreasing cumulative buckets
        parse_prometheus_text(
            'm_bucket{le="1"} 5\nm_bucket{le="2"} 3\nm_bucket{le="+Inf"} 5\nm_count 5\n'
        )
    with pytest.raises(ValueError):
        # +Inf bucket disagrees with _count
        parse_prometheus_text(
            'm_bucket{le="1"} 1\nm_bucket{le="+Inf"} 2\nm_count 3\n'
        )


def test_env_port_parsing(monkeypatch):
    from metrics_tpu_torch.utilities import env

    monkeypatch.setenv("METRICS_TPU_EXPORTER", "9464")
    env.refresh()
    assert env.exporter_port() == 9464
    monkeypatch.setenv("METRICS_TPU_EXPORTER", "not-a-port")
    env.refresh()
    assert env.exporter_port() == -1
    monkeypatch.delenv("METRICS_TPU_EXPORTER")
    env.refresh()
    assert env.exporter_port() is None


def test_percentile_estimator():
    h = {"buckets": [1.0, 2.0, 4.0], "counts": [0, 0, 0, 0], "sum": 0.0, "count": 0}
    assert telemetry_mod.percentile(h, 50) == 0.0
    h = {"buckets": [1.0, 2.0, 4.0], "counts": [2, 2, 0, 0], "sum": 3.0, "count": 4}
    # p50 crosses at the end of the first bucket
    assert telemetry_mod.percentile(h, 50) == pytest.approx(1.0)
    # p75 lands mid-second-bucket
    assert 1.0 < telemetry_mod.percentile(h, 75) <= 2.0
    # overflow mass clamps to the last finite edge
    h = {"buckets": [1.0, 2.0], "counts": [0, 0, 5], "sum": 50.0, "count": 5}
    assert telemetry_mod.percentile(h, 99) == 2.0
    with pytest.raises(ValueError):
        telemetry_mod.percentile(h, 101)


def test_report_shows_histogram_percentiles_and_sorted_keys():
    obs.enable()
    tel = obs.get()
    tel.observe_hist("sync.latency_ms", 1.0, obs.LATENCY_BUCKETS_MS)
    tel.count("zzz.last", 1)
    tel.count("aaa.first", 1)
    report = tel.report()
    assert "p50=" in report and "p95=" in report and "p99=" in report
    assert report.index("aaa.first") < report.index("zzz.last")


def test_session_gauges_ride_the_exposition(tmp_path):
    from metrics_tpu_torch.reliability import EvalSession

    session = EvalSession(tm.MeanSquaredError(device=CPU), tmp_path, checkpoint_every=1)
    session.step(0, torch.ones(8), torch.zeros(8))
    session.step(1, torch.ones(8), torch.zeros(8))
    samples = parse_prometheus_text(render_exposition())
    label = str(session.journal.directory)
    cursors = {labels["journal"]: v for labels, v in samples["metrics_tpu_session_cursor"]}
    assert cursors[label] == 1
    generations = {labels["journal"]: v for labels, v in samples["metrics_tpu_session_generation"]}
    assert generations[label] >= 1
    checkpoints = {labels["journal"]: v for labels, v in samples["metrics_tpu_session_checkpoints"]}
    assert checkpoints[label] == 2


def test_snapshot_identity_override_rides_the_exposition():
    """Offline renderers pass the artifact's identity so the exposition
    names the process that produced the numbers, not the renderer."""
    tel = telemetry_mod.Telemetry()
    tel.counters["engine.dispatches"] = 1
    text = tel.to_prometheus(identity={"rank": 3, "world_size": 8, "host": "pod-7"})
    samples = parse_prometheus_text(text)
    labels = samples["metrics_tpu_identity"][0][0]
    assert labels == {"rank": "3", "world_size": "8", "host": "pod-7"}


def test_explicit_host_change_restarts_the_listener():
    first = obs.enable_exporter(0)
    try:
        other = obs.enable_exporter(0, host="0.0.0.0")
        assert other is not first and other.host == "0.0.0.0"
        # unspecified binding keeps whatever is armed
        assert obs.enable_exporter() is other
    finally:
        obs.disable_exporter()
    assert first._server is None and other._server is None  # both listeners closed


# ----------------------------------------------------------------------
# live serving pipeline: scrapes racing an active async wave stream
# ----------------------------------------------------------------------
def test_scrape_loop_racing_a_live_async_serving_pipeline():
    from metrics_tpu_torch.serving import AsyncServingEngine, IngestQueue, ServingSLO

    obs.enable()
    cohort = tm.MetricCohort(tm.Accuracy(device=CPU), tenants=4)
    slo = ServingSLO(e2e_p99_ms=60_000.0, max_queue_age_ms=60_000.0)
    pipe = AsyncServingEngine(cohort, slo=slo)
    q = IngestQueue(pipe, rows_per_step=8, max_buffered_rows=1 << 14)
    rng = np.random.RandomState(0)
    ids = np.tile(np.arange(4), 8)

    stop = threading.Event()
    submit_errors = []

    def feeder():
        try:
            while not stop.is_set():
                p = rng.rand(32).astype(np.float32)
                q.submit(ids, p, (p > 0.5).astype(np.int32))
        except Exception as err:  # noqa: BLE001 - surfaced in the assert
            submit_errors.append(err)

    try:
        with obs.exporter_scope(0) as ex:
            feed = threading.Thread(target=feeder)
            feed.start()
            try:
                scrapes = [_scrape(ex.port) for _ in range(12)]
            finally:
                stop.set()
                feed.join(timeout=WAIT_S)
            assert not feed.is_alive()
            pipe.drain(timeout_s=WAIT_S)
            final = _scrape(ex.port)
    finally:
        pipe.close()
    assert submit_errors == []
    # every scrape, whatever instant mid-wave it landed on, parses with the
    # histogram invariants intact (one locked snapshot a render)
    for text in scrapes + [final]:
        parse_prometheus_text(text)
    # the post-drain scrape carries the whole serving surface
    for family in ("metrics_tpu_serving_queue_depth", "metrics_tpu_serving_queue_age_ms",
                   "metrics_tpu_serving_latency_e2e_ms_bucket", "metrics_tpu_serving_latency_queue_wait_ms_bucket",
                   "metrics_tpu_serving_slo_e2e_burn", "metrics_tpu_serving_slo_queue_age_burn",
                   "metrics_tpu_engine_compile_cold_total"):
        assert family in final, family


# ----------------------------------------------------------------------
# the 64-tenant scrape (tests/bases/test_cohort_health.py)
# ----------------------------------------------------------------------
def test_acceptance_64_tenant_scrape_and_disabled_twin():
    """A 64-tenant cohort with the exporter armed serves a valid scrape
    naming the poisoned tenant by slot with staleness and guard-verdict
    rows, plus every registry key; the same run with observability off is
    bit-identical with zero counters, zero sockets and no health arrays."""
    from metrics_tpu_torch.reliability import guard_scope

    tenants = 64
    rng = np.random.RandomState(0)
    preds, target = torch.from_numpy(_grid(rng, (tenants, 32))), torch.from_numpy(_grid(rng, (tenants, 32)))
    poison = preds.clone()
    poison[5] = float("inf")

    def drive(cohort):
        with guard_scope("quarantine"):
            cohort(preds, target)
            cohort(poison, target)
            cohort(preds, target)
        return {k: v.clone() for k, v in cohort._states["metric"].items()}

    # disabled twin first: zero counters, zero sockets, no health arrays
    twin = tm.MetricCohort(tm.MeanSquaredError(device=CPU), tenants=tenants)
    twin_states = drive(twin)
    assert obs.get().counters == {}
    assert obs.get_exporter() is None
    assert twin._health is None

    obs.enable()
    cohort = tm.MetricCohort(tm.MeanSquaredError(device=CPU), tenants=tenants)
    with obs.exporter_scope(0) as ex:
        states = drive(cohort)
        cohort.health()
        text = _scrape(ex.port)
    obs.disable()

    for sname in twin_states:
        assert torch.equal(twin_states[sname], states[sname]), sname
    samples = parse_prometheus_text(text)
    cid = str(cohort._exporter_id)
    verdicts = {labels["tenant"]: v for labels, v in samples["metrics_tpu_cohort_tenant_guard_verdicts"]
                if labels["cohort"] == cid}
    assert verdicts["5"] == 1
    assert all(v == 0 for t, v in verdicts.items() if t != "5")
    assert len(verdicts) == tenants
    stale = {labels["tenant"]: v for labels, v in samples["metrics_tpu_cohort_tenant_staleness"]
             if labels["cohort"] == cid}
    assert len(stale) == tenants
    rows = {labels["tenant"]: v for labels, v in samples["metrics_tpu_cohort_tenant_rows_seen"]
            if labels["cohort"] == cid}
    assert set(rows.values()) == {3 * 32}
    snap = obs.get().snapshot()
    for name in snap["counters"]:
        assert prometheus_name(name) + "_total" in samples, name
    for name in snap["gauges"]:
        assert prometheus_name(name) in samples, name
    for name in snap["histograms"]:
        assert prometheus_name(name) + "_bucket" in samples, name


# ----------------------------------------------------------------------
# /healthz after an SLO breach (tests/bases/test_serving.py)
# ----------------------------------------------------------------------
def test_healthz_reports_degraded_on_slo_breach():
    from metrics_tpu_torch.serving import AsyncServingEngine, ServingSLO

    with obs.telemetry_scope():
        slo = ServingSLO(e2e_p99_ms=1e-6, sustain=1, name="pytest-slo")
        col = tm.MetricCollection([tm.Accuracy(device=CPU), tm.F1(num_classes=4, average="macro", device=CPU)],
                                  compiled=True)
        pipe = AsyncServingEngine(col, slo=slo)
        try:
            rng = np.random.RandomState(12)
            for _ in range(2):
                p = rng.rand(96, 4).astype(np.float32)
                pipe.forward(torch.from_numpy(p / p.sum(1, keepdims=True)),
                             torch.from_numpy(rng.randint(4, size=96)))
            pipe.drain(timeout_s=WAIT_S)
            assert slo.breaching
            with obs.exporter_scope(0) as ex:
                payload = json.loads(_scrape(ex.port, "/healthz"))
        finally:
            pipe.close()
    assert payload["status"] == "degraded"
    verdicts = {s["name"]: s for s in payload["serving_slo"]["slos"]}
    assert verdicts["pytest-slo"]["breaching"]
    assert verdicts["pytest-slo"]["burns"]["e2e"] > 1.0


# ----------------------------------------------------------------------
# the glossary (tests/bases/test_glossary.py)
# ----------------------------------------------------------------------
def test_exporter_tenant_families_are_documented():
    """Every per-cohort family the port's export surface renders appears in
    the JAX package's glossary (``docs/observability.md``)."""
    obs.enable()
    cohort = tm.MetricCohort(tm.MeanSquaredError(device=CPU), tenants=2)
    x = torch.from_numpy(_grid(np.random.RandomState(0), (2, 8)))
    cohort(x, x)
    text = obs.render_exposition()
    families = set(re.findall(r"^(metrics_tpu_cohort[a-z_]*)\{", text, flags=re.M))
    assert families, "exposition rendered no cohort families"
    doc = (REPO / "docs" / "observability.md").read_text()
    assert not sorted(f for f in families if f not in doc)


# ----------------------------------------------------------------------
# the JAX exporter's review hazards (ROADMAP Queue 3 item 6)
# ----------------------------------------------------------------------
def test_cohort_families_do_not_collide_with_the_registry_gauges():
    """The per-cohort families are not ``metrics_tpu_cohort_size`` /
    ``_capacity`` (the registry gauges ``cohort.size`` / ``cohort.capacity``
    own those names): one exposition declares each family once."""
    obs.enable()
    cohort = tm.MetricCohort(tm.MeanSquaredError(device=CPU), tenants=3)
    x = torch.from_numpy(_grid(np.random.RandomState(1), (3, 8)))
    cohort(x, x)
    text = render_exposition()
    samples = parse_prometheus_text(text)  # raises on a family declared twice
    assert samples["metrics_tpu_cohort_size"] == [({}, 3.0)]
    assert samples["metrics_tpu_cohort_capacity"] == [({}, 4.0)]
    cid = str(cohort._exporter_id)
    assert samples["metrics_tpu_cohort_live_tenants"] == [({"cohort": cid}, 3.0)]
    assert samples["metrics_tpu_cohort_slot_capacity"] == [({"cohort": cid}, 4.0)]
    assert len(re.findall(r"^# TYPE ", text, flags=re.M)) == len(set(re.findall(r"^# TYPE (\S+)", text, flags=re.M)))


def test_load_state_dict_starts_a_fresh_health_window_in_the_exposition():
    obs.enable()
    cohort = tm.MetricCohort(tm.MeanSquaredError(device=CPU), tenants=2)
    x = torch.from_numpy(_grid(np.random.RandomState(2), (2, 8)))
    cohort(x, x)
    cohort(x, x)
    saved = cohort.state_dict()
    assert cohort.health()["updates"].tolist() == [2, 2]
    cohort.load_state_dict(saved)
    cid = str(cohort._exporter_id)
    samples = parse_prometheus_text(render_exposition())
    # the restored cohort scrapes its size but no health rows until a step
    assert samples["metrics_tpu_cohort_live_tenants"] == [({"cohort": cid}, 2.0)]
    assert "metrics_tpu_cohort_tenant_updates" not in samples
    cohort(x, x)
    samples = parse_prometheus_text(render_exposition())
    assert [v for labels, v in samples["metrics_tpu_cohort_tenant_updates"] if labels["cohort"] == cid] == [1.0, 1.0]
    assert [v for labels, v in samples["metrics_tpu_cohort_step"] if labels["cohort"] == cid] == [1.0]


def test_a_dropped_or_copied_cohort_follows_its_registration():
    import copy
    import gc
    import pickle

    obs.enable()
    cohort = tm.MetricCohort(tm.MeanSquaredError(device=CPU), tenants=2)
    x = torch.from_numpy(_grid(np.random.RandomState(3), (2, 8)))
    cohort(x, x)
    clone = pickle.loads(pickle.dumps(cohort))
    twin = copy.deepcopy(cohort)
    ids = {cohort._exporter_id, clone._exporter_id, twin._exporter_id}
    assert len(ids) == 3
    labels = {lab["cohort"] for lab, _ in parse_prometheus_text(render_exposition())["metrics_tpu_cohort_step"]}
    assert {str(i) for i in ids} <= labels
    gone = str(clone._exporter_id)
    del clone
    gc.collect()
    samples = parse_prometheus_text(render_exposition())
    assert gone not in {lab["cohort"] for lab, _ in samples["metrics_tpu_cohort_live_tenants"]}
    assert twin.health()["updates"].tolist() == [1, 1]


def test_a_failing_source_degrades_to_a_comment_not_an_error():
    obs.enable()
    cohort = tm.MetricCohort(tm.MeanSquaredError(device=CPU), tenants=2)
    x = torch.from_numpy(_grid(np.random.RandomState(4), (2, 8)))
    cohort(x, x)

    def broken(stale_after=16):
        raise RuntimeError("health unavailable")

    cohort.health = broken
    with obs.exporter_scope(0) as ex:
        text = _scrape(ex.port)
    parse_prometheus_text(text)
    assert f"# metrics_tpu exporter: cohort {cohort._exporter_id} health unavailable (RuntimeError)" in text


# ----------------------------------------------------------------------
# parity: one seeded workload through both packages
# ----------------------------------------------------------------------
# families whose values are a clock (build and step wall times) or the
# program's digest label: names, types and label names compared, values not
_CLOCKED = re.compile(r"(_s_sum|_ms_sum|_ms_bucket|_s_bucket|_compile_ms)$")
# cost-model families JAX renders (its XLA cost analysis resolves on the CPU)
# and the port cannot (no cost model: flops / bytes None by design)
_JAX_ONLY = {"metrics_tpu_engine_program_flops", "metrics_tpu_engine_program_bytes_accessed"}
# label values that name a process-local object, not a quantity
_OBJECT_LABELS = {"cohort", "journal", "program", "host", "fleet"}
# JAX's armed ledger traces and lowers each new program once more, and those
# runs of the step function count in metric.<Name>.{update,compute}_calls
# and their timers (its docstring says the ledger touches no trace counter);
# the port's ledger runs nothing: these values are compared with the ledger
# disarmed
_LEDGER_COUNTED = re.compile(r"^metrics_tpu_metric_\w+_(update|compute)_(calls_total|s_count)$")


def _workload(pkg, o, ledger_mod, conv, kw, directory, armed):
    """A cohort with a poisoned tenant under quarantine, a compiled
    collection over two signatures, a session of three steps and a live
    fleet (two leased shards of 4 tenants: two waves, a commit, a
    replication, a migration and one more wave), with telemetry on and the
    ledger armed or not; returns the rendered exposition."""
    gc.collect()  # the first workload's fleet (a coordinator-replicator cycle) leaves the weak registries
    rng = np.random.RandomState(7)
    preds, target = _grid(rng, (4, 16)), _grid(rng, (4, 16))
    poison = preds.copy()
    poison[2] = np.inf
    probs = rng.rand(48, 4).astype(np.float32)
    labels = rng.randint(4, size=48)
    guard_scope = (jm if pkg is jm else tm).reliability.guard_scope
    with o.telemetry_scope(), ledger_mod.cost_ledger_scope():
        if not armed:
            ledger_mod.disable_cost_ledger()
        cohort = pkg.MetricCohort(pkg.MeanSquaredError(**kw), tenants=4)
        with guard_scope("quarantine"):
            for p in (preds, poison, preds):
                cohort(conv(p), conv(target))
        col = pkg.MetricCollection([pkg.Accuracy(**kw), pkg.F1(num_classes=4, average="macro", **kw)],
                                   compiled=True)
        for rows in (48, 32, 48):
            col(conv(probs[:rows]), conv(labels[:rows]))
        session = pkg.reliability.EvalSession(pkg.MeanSquaredError(**kw), directory, checkpoint_every=2)
        for i in range(3):
            session.step(i, conv(preds[0]), conv(target[0]))
        fl = pkg.fleet
        shards = [fl.FleetShard(nm, pkg.MeanSquaredError(**kw), os.path.join(directory, "fleet", nm))
                  for nm in ("s0", "s1")]
        shards[0].add_tenants(range(4))
        shards[1].add_tenants(range(4, 8))
        coord = fl.MigrationCoordinator(fl.FleetPlacement(["s0", "s1"]), shards)
        authority = fl.LeaseAuthority(ttl_s=3600.0)
        for sh in shards:
            sh.attach_lease(authority)
        replicator = fl.ShardReplicator(coord, authority=authority)
        for step in range(2):
            for sh in shards:
                sh.submit_wave(step, list(sh.tenants()), conv(preds), conv(target))
        for sh in shards:
            sh.checkpoint()
            replicator.replicate(sh)
        coord.migrate(0, "s1")
        shards[0].submit_wave(2, list(shards[0].tenants()), conv(preds[:3]), conv(target[:3]))
        cohort.health()
        text = o.render_exposition()
        del session, cohort, coord, replicator, shards
    return text


def _families(text, armed):
    """``{sample name: (type, sorted label-name tuples, sorted values or None)}``."""
    types = dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, flags=re.M))
    out = {}
    for name, samples in parse_prometheus_text(text).items():
        base = next((f for f in (name, re.sub(r"_(total|sum|count|bucket)$", "", name)) if f in types), None)
        label_names = sorted(tuple(sorted(labels)) for labels, _ in samples)
        if _CLOCKED.search(name) or name.startswith("metrics_tpu_engine_program_compile_ms"):
            values = None
        elif armed and _LEDGER_COUNTED.match(name):
            values = None
        else:
            values = sorted((tuple(sorted((k, v) for k, v in labels.items() if k not in _OBJECT_LABELS)), value)
                            for labels, value in samples)
        out[name] = (types.get(base), label_names, values)
    return out


@pytest.mark.parametrize("armed", [False, True], ids=["ledger_off", "ledger_armed"])
def test_exposition_matches_jax_on_one_seeded_workload(tmp_path, armed):
    jax_text = _workload(jm, jobs, jcl, jnp.asarray, {}, tmp_path / "jax", armed)
    port_text = _workload(tm, obs, cl, torch.from_numpy, {"device": CPU}, tmp_path / "port", armed)
    jax_fams, port_fams = _families(jax_text, armed), _families(port_text, armed)
    assert {k: v for k, v in jax_fams.items() if k not in _JAX_ONLY} == port_fams
    # the comparison saw every kind of source
    for family in ("metrics_tpu_fleet_placement_generation", "metrics_tpu_fleet_migrations_total",
                   "metrics_tpu_fleet_tenants_in_flight", "metrics_tpu_fleet_shard_epoch",
                   "metrics_tpu_fleet_shard_replication_lag", "metrics_tpu_fleet_failovers",
                   "metrics_tpu_cohort_tenant_guard_verdicts", "metrics_tpu_session_cursor",
                   "metrics_tpu_engine_compile_cold_total", "metrics_tpu_engine_compile_ms_bucket",
                   "metrics_tpu_metric_MeanSquaredError_update_calls_total", "metrics_tpu_identity"):
        assert family in port_fams, family
    assert ("metrics_tpu_engine_program_compiles" in port_fams) == armed
    verdicts = dict(port_fams["metrics_tpu_cohort_tenant_guard_verdicts"][2])
    assert verdicts[(("tenant", "2"),)] == 1.0
