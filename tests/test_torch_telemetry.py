"""The port's telemetry registry against the JAX package's, on the CPU.

Every case of ``tests/bases/test_telemetry.py`` whose subject is ported is
mirrored here on ``metrics_tpu_torch.observability``; the cases about parts
not ported yet are listed in ``NOT_PORTED`` with the item that ports them.
Beyond those, parity scenarios run the same numpy-seeded batches through
both packages with telemetry and span tracing on, and compare **exactly**
(integers and strings, no tolerance): counters, gauges, byte counts,
histogram buckets, event kinds and fields, watchdog snapshots and the
Prometheus text with timers masked. Keys and fields that differ by design
are named in ``BY_DESIGN`` with the reason. And: forward values, epoch
values and states are bit-equal (``torch.equal``) with every recorder on
and off, eager, compiled and cohort; ``metric.<Name>.update_calls`` under
``compiled=True`` equals the engine's ``trace_count``; the corrected
under-trace warning; and the glossary: every registry key the port's
source emits appears in the JAX package's ``docs/observability.md``.
"""
import json
import re
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.observability as jobs
import metrics_tpu_torch as tm
import metrics_tpu_torch.observability as obs
from metrics_tpu_torch.observability import telemetry as telemetry_mod
from metrics_tpu_torch.observability.watchdog import RecompilationWatchdog
from metrics_tpu_torch.utilities.data import tracing

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"

# the JAX cases whose subject the port does not have yet, by the item
# (ROADMAP Queue 1) that ports it; test_collective_counters_record_at_trace_time
# came with the sync tiers: tests/test_torch_quantize.py
# (test_sync_state_counts_one_collective_per_state_like_jax)
NOT_PORTED = {
    "test_jitted_functional_trace_counter": "none: the port has no compiled canonicalizer, so "
    "trace.checks._canonicalize_jit is never emitted (BY_DESIGN)",
    "test_reliability_counters_zero_on_healthy_run": "reliability/ (item 4): StateGuard, SyncPolicy, envelopes",
}

# registry keys and event fields that differ by design, with the reason
BY_DESIGN = {
    # JAX jits its canonicalizer and counts its traces; the port has none
    "trace.checks._canonicalize_jit": "no compiled canonicalizer in the port",
    "checks._canonicalize_jit": "no compiled canonicalizer in the port (watchdog key)",
    # AUROC's list states keep the caller's target dtype: an int64 target
    # is 8 bytes an element in the port, 4 in JAX (no x64: int32)
    "metric.AUROC.state_nbytes": "int64 targets kept as int64",
    # the eager_fallback event's member list: the port demotes the members
    # that fail alone, JAX the whole compiled group
    "eager_fallback.metrics": "per-member demotion",
}

# histograms of host-clock durations: their bucket is the host's timing,
# so only the observation count is compared (engine.compile_ms: a build's
# wall time, a trace and compile in JAX, a step function's first run here)
WALL_CLOCK_HISTOGRAMS = ("sync.latency_ms", "engine.compile_ms")


def _pristine():
    for pkg in (jobs, obs):
        pkg.disable()
        pkg.get().reset()
        pkg.enable_tracing(max_spans=8192)
        pkg.disable_tracing()
        pkg.get_tracer().reset()
        pkg.disable_flight()


@pytest.fixture(autouse=True)
def _pristine_recorders():
    """Both packages' recorders are process-global: every test starts and
    ends with all of them off and empty."""
    _pristine()
    yield
    _pristine()


def _cls_batch(n=256, c=4, seed=0):
    rng = np.random.RandomState(seed)
    probs = rng.rand(n, c).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    return probs, rng.randint(c, size=n)


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _collection(pkg, compiled=False):
    kw = {"device": CPU} if pkg is tm else {}
    return pkg.MetricCollection(
        [pkg.Accuracy(**kw), pkg.Precision(num_classes=4, average="macro", **kw),
         pkg.F1(num_classes=4, average="macro", **kw)],
        compiled=compiled,
    )


# ----------------------------------------------------------------------
# parity machinery
# ----------------------------------------------------------------------
def _without_by_design(d):
    return {k: v for k, v in d.items() if k not in BY_DESIGN}


def _histograms(snap):
    out = {}
    for name, h in _without_by_design(snap["histograms"]).items():
        if name in WALL_CLOCK_HISTOGRAMS:
            out[name] = {"buckets": h["buckets"], "count": h["count"]}
        else:
            out[name] = {"buckets": h["buckets"], "counts": h["counts"], "sum": h["sum"], "count": h["count"]}
    return out


def _events(snap):
    """Event kinds and fields, with the by-design fields dropped."""
    out = []
    for e in snap["events"]:
        out.append({k: v for k, v in e.items() if f"{e['kind']}.{k}" not in BY_DESIGN})
    return out


def _watchdog(snap):
    wd = dict(snap["watchdog"])
    wd["keys"] = _without_by_design(wd["keys"])
    return wd


def _prometheus(tel):
    """``to_prometheus()`` text with the timers' sums and the wall-clock
    histograms' buckets and sums masked, and the by-design families
    dropped."""
    snap = tel.snapshot()
    timers = {telemetry_mod.prometheus_name(n) for n in snap["timers"]}
    clocks = {telemetry_mod.prometheus_name(n) for n in WALL_CLOCK_HISTOGRAMS}
    dropped = {telemetry_mod.prometheus_name(n) for n in BY_DESIGN}
    lines = []
    for line in tel.to_prometheus().splitlines():
        family = line.split()[2] if line.startswith("# TYPE") else re.split(r"[{ ]", line)[0]
        base = re.sub(r"_(total|sum|count|bucket)$", "", family)
        if base in dropped:
            continue
        if (base in timers and family.endswith("_sum")) or (base in clocks and not family.endswith("_count")):
            line = re.sub(r" \S+$", " <masked>", line)
        lines.append(line)
    return lines


def assert_telemetry_parity(jax_tel, port_tel, what):
    """The two registries agree exactly but for ``BY_DESIGN``."""
    js, ps = jax_tel.snapshot(), port_tel.snapshot()
    assert _without_by_design(ps["counters"]) == _without_by_design(js["counters"]), f"{what}: counters"
    assert _without_by_design(ps["gauges"]) == _without_by_design(js["gauges"]), f"{what}: gauges"
    assert sorted(_without_by_design(ps["timers"])) == sorted(_without_by_design(js["timers"])), f"{what}: timers"
    assert {k: v["count"] for k, v in _without_by_design(ps["timers"]).items()} == {
        k: v["count"] for k, v in _without_by_design(js["timers"]).items()
    }, f"{what}: timer counts"
    assert _histograms(ps) == _histograms(js), f"{what}: histograms"
    assert [e["kind"] for e in ps["events"]] == [e["kind"] for e in js["events"]], f"{what}: event kinds"
    assert _events(ps) == _events(js), f"{what}: event fields"
    assert _watchdog(ps) == _watchdog(js), f"{what}: watchdog"
    assert ps["dropped_events"] == js["dropped_events"]
    assert _prometheus(port_tel) == _prometheus(jax_tel), f"{what}: prometheus text"


def _both(scenario):
    """Run ``scenario(pkg, conv)`` once per package with telemetry on;
    returns the two registries (JAX's, the port's)."""
    out = []
    for pkg, o, conv in ((jm, jobs, _j), (tm, obs, _t)):
        with o.telemetry_scope() as tel:
            scenario(pkg, conv)
        out.append(tel)
    return out


# ----------------------------------------------------------------------
# 1. disabled-by-default invariant
# ----------------------------------------------------------------------
def test_disabled_by_default_records_nothing():
    assert not obs.enabled()
    col = _collection(tm, compiled=True)
    p, t = _t(*_cls_batch())
    for _ in range(3):
        col(p, t)
    col.compute()
    snap = obs.get().snapshot()
    assert snap["counters"] == {}
    assert snap["events"] == []
    assert snap["timers"] == {}
    assert snap["histograms"] == {} and snap["dropped_events"] == 0
    assert snap["watchdog"]["keys"] == {}


def _states(col):
    return {(k, s): getattr(col[k], s) for k in col.keys() for s in col[k]._defaults}


@pytest.mark.parametrize("compiled", [False, True])
def test_forward_results_bit_identical_enabled_vs_disabled(compiled, tmp_path):
    """Instrumentation must not change the math: same batches, bit-equal
    step values, epoch values and states, with telemetry, tracing and the
    flight recorder all on against all off."""
    batches = [_t(*_cls_batch(seed=s)) for s in range(3)]
    plain = _collection(tm, compiled)
    v_plain = [plain(*b) for b in batches]
    e_plain = plain.compute()

    with obs.telemetry_scope(), obs.tracing_scope(), obs.flight_scope(tmp_path):
        instrumented = _collection(tm, compiled)
        v_inst = [instrumented(*b) for b in batches]
        e_inst = instrumented.compute()
    assert obs.get().counters  # it did record

    for step, (va, vb) in enumerate(zip(v_plain, v_inst)):
        for k in va:
            assert torch.equal(va[k], vb[k]), f"step {step} {k}"
    for k in e_plain:
        assert torch.equal(e_plain[k], e_inst[k]), k
    for key, v in _states(plain).items():
        assert torch.equal(v, _states(instrumented)[key]), key


def test_cohort_results_bit_identical_with_every_recorder(tmp_path):
    """The cohort's step values, epoch values and stacked states are
    bit-equal with every recorder on (health then follows telemetry, a
    separate program whose member states are the plain program's)."""
    rng = np.random.RandomState(7)
    probs = rng.rand(3, 32, 4).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    batch = _t(probs, rng.randint(4, size=(3, 32)))
    runs = []
    for on in (False, True):
        cohort = tm.MetricCohort(_collection(tm), tenants=3)
        if on:
            with obs.telemetry_scope(), obs.tracing_scope(), obs.flight_scope(tmp_path):
                values = [cohort(*batch) for _ in range(2)]
                epoch = cohort.compute()
            assert cohort.health() is not None
        else:
            values = [cohort(*batch) for _ in range(2)]
            epoch = cohort.compute()
            assert cohort.health() is None
        runs.append((values, epoch, cohort._states))
    (v_off, e_off, s_off), (v_on, e_on, s_on) = runs
    for a, b in zip(v_off, v_on):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for k in e_off:
        assert torch.equal(e_off[k], e_on[k]), k
    for name, d in s_off.items():
        for sname, v in d.items():
            assert torch.equal(v, s_on[name][sname]), (name, sname)


# ----------------------------------------------------------------------
# 2. engine counter correctness, against the JAX package
# ----------------------------------------------------------------------
def test_engine_cache_hit_miss_counters_across_two_signatures():
    a = np.random.RandomState(0).rand(64).astype(np.float32)
    b = np.random.RandomState(1).rand(96).astype(np.float32)
    cols = {}

    def scenario(pkg, conv):
        kw = {"device": CPU} if pkg is tm else {}
        col = cols[pkg] = pkg.MetricCollection([pkg.MeanSquaredError(**kw)], compiled=True)
        for x in (a, a, b, b, a):  # miss, hit, miss, hit, hit
            col(*conv(x, x))

    jax_tel, port_tel = _both(scenario)
    c = port_tel.counters
    assert c["engine.cache_misses"] == 2, c
    assert c["engine.cache_hits"] == 3, c
    assert c["engine.dispatches"] == 5, c
    # counters agree with the engine's own bookkeeping, and with JAX's
    assert cols[tm]._engine.trace_count == 2
    assert port_tel.watchdog.retrace_count() == 0
    assert cols[tm]._engine.cache_info()["seen_signatures"] == cols[jm]._engine.cache_info()["seen_signatures"] == 2
    assert_telemetry_parity(jax_tel, port_tel, "MSE over two signatures")


def test_per_metric_lifecycle_counters_and_state_nbytes():
    obs.enable()
    m = tm.MeanSquaredError(device=CPU)
    p = torch.from_numpy(np.random.RandomState(0).rand(64).astype(np.float32))
    m(p, p)
    m.compute()
    c = obs.get().counters
    assert c["metric.MeanSquaredError.forward_calls"] == 1
    assert c["metric.MeanSquaredError.update_calls"] >= 1
    assert c["metric.MeanSquaredError.compute_calls"] >= 1
    snap = obs.get().snapshot()
    assert snap["gauges"]["metric.MeanSquaredError.state_nbytes"] > 0
    assert snap["timers"]["metric.MeanSquaredError.forward_s"]["count"] == 1


def test_sync_payload_counters():
    p, t = _cls_batch(n=32)

    def scenario(pkg, conv):
        m = pkg.Accuracy(**({"device": CPU} if pkg is tm else {}))
        m.dist_sync_fn = lambda x, group=None: [x]  # 1-process gather stand-in
        m.update(*conv(p, t))
        m.compute()

    jax_tel, port_tel = _both(scenario)
    c = port_tel.counters
    assert c["sync.calls"] == 1
    assert c["sync.payload_bytes"] > 0 and c["sync.wire_bytes"] == c["sync.payload_bytes"]
    events = [e for e in port_tel.events if e["kind"] == "sync"]
    assert events and events[0]["metric"] == "Accuracy" and events[0]["quantized_states"] == 0
    assert_telemetry_parity(jax_tel, port_tel, "Accuracy with a 1-process dist_sync_fn")


def test_collective_counters_count_every_executed_collective():
    """``masked_cat_sync`` counts one ``cat`` (two ops: buffer and count)
    with the JAX package's byte counts. JAX counts once per trace of the
    program that holds the collective; the port's collectives run eagerly,
    so each executed call counts."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from metrics_tpu.parallel.collective import masked_cat_sync as jax_masked_cat_sync
    from metrics_tpu_torch.parallel.collective import masked_cat_sync

    buffer = np.arange(16, dtype=np.float32)
    count = np.array(5, dtype=np.int32)
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    fn = jax.jit(jax.shard_map(lambda b, c: jax_masked_cat_sync(b, c, "dp"), mesh=mesh,
                               in_specs=(P("dp"), P()), out_specs=P(), check_vma=False))
    with jobs.telemetry_scope() as jax_tel:
        fn(*_j(buffer, count))
    with obs.telemetry_scope() as port_tel:
        masked_cat_sync(*_t(buffer, count))
    for key in ("collective.cat", "collective.ops", "collective.payload_bytes", "collective.wire_bytes"):
        assert port_tel.counters[key] == jax_tel.counters[key], key
    assert port_tel.counters["collective.payload_bytes"] == 16 * 4 + 4
    assert _histograms(port_tel.snapshot()) == _histograms(jax_tel.snapshot())
    with obs.telemetry_scope():
        masked_cat_sync(*_t(buffer, count))
    assert port_tel.counters["collective.cat"] == 2 and port_tel.counters["collective.ops"] == 4


# ----------------------------------------------------------------------
# 3. recompilation watchdog
# ----------------------------------------------------------------------
def _polymorphic_loop(pkg, conv, caught_by_pkg):
    kw = {"device": CPU} if pkg is tm else {}
    # a class of its own: the watchdog warns once per engine key in each
    # process, and the JAX package's own test of this loop (which may run
    # in the same worker) must find ``engine[MeanSquaredError]`` unwarned
    metric = type("TelemetryPolyMSE", (pkg.MeanSquaredError,), {})(**kw)
    # small LRU so the trace budget (max(8, cache_size)) stays at 8 and the
    # loop needs ~12 distinct shapes, not cache_size + 4
    col = pkg.MetricCollection([metric], compiled=True)
    p0 = np.random.RandomState(0).rand(4).astype(np.float32)
    col(*conv(p0, p0))  # build the engine
    col._engine._cache_size = 4
    budget = max(8, col._engine.cache_size)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for n in range(8, 8 + 2 * (budget + 4), 2):  # every step a new shape
            p = np.random.RandomState(n).rand(n).astype(np.float32)
            col(*conv(p, p))
    caught_by_pkg[pkg] = [w for w in caught if "recompilation watchdog" in str(w.message)]


def test_watchdog_fires_on_shape_polymorphic_loop():
    caught = {}
    jax_tel, port_tel = _both(lambda pkg, conv: _polymorphic_loop(pkg, conv, caught))
    assert port_tel.watchdog.retrace_count() > 0
    assert len(caught[tm]) == 1  # rate-limited: warn_once per key
    assert port_tel.counters["watchdog.retraces"] == port_tel.watchdog.retrace_count()
    # one-shot verdict: the tally keeps climbing, the event log does not
    assert [e["kind"] for e in port_tel.events].count("retrace") == 1
    assert [str(w.message) for w in caught[tm]] == [str(w.message) for w in caught[jm]]
    assert_telemetry_parity(jax_tel, port_tel, "shape-polymorphic loop")


def test_watchdog_silent_at_steady_state():
    obs.enable()
    col = _collection(tm, compiled=True)
    p, t = _t(*_cls_batch())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(12):
            col(p, t)
    assert obs.get().watchdog.retrace_count() == 0
    assert not [w for w in caught if "recompilation watchdog" in str(w.message)]


def test_watchdog_flags_cache_thrash_immediately():
    wd = RecompilationWatchdog()
    wd.note_compile("engine[x]", new_signature=True)  # legit build
    assert wd.retrace_count() == 0
    wd.note_compile("engine[x]", new_signature=False)  # evicted and rebuilt
    assert wd.retrace_count("engine[x]") == 1


# ----------------------------------------------------------------------
# 4. export round-trips + bounded log
# ----------------------------------------------------------------------
def test_to_json_round_trips():
    tel = obs.enable()
    tel.count("a.b", 3)
    tel.gauge("g", 2.5)
    tel.observe("t.x", 0.25)
    tel.event("custom", detail="v", n=1)
    blob = json.loads(obs.to_json())
    assert blob == tel.snapshot()
    assert blob["counters"]["a.b"] == 3
    assert blob["timers"]["t.x"]["count"] == 1
    assert blob["events"] == [{"kind": "custom", "detail": "v", "n": 1}]
    lines = tel.to_jsonl().splitlines()
    assert [json.loads(line) for line in lines] == blob["events"]


def test_event_log_is_bounded():
    tel = obs.enable(max_events=16)
    try:
        for i in range(64):
            tel.event("e", i=i)
        assert len(tel.events) == 16
        assert list(tel.events)[-1]["i"] == 63
    finally:
        obs.enable(max_events=1024)


def test_report_is_human_readable():
    obs.enable()
    m = tm.MeanSquaredError(device=CPU)
    p = torch.from_numpy(np.random.RandomState(0).rand(32).astype(np.float32))
    m(p, p)
    text = obs.report()
    assert "metrics_tpu telemetry report" in text
    assert "metric.MeanSquaredError.update_calls" in text
    assert "recompilation watchdog" in text


def test_telemetry_scope_restores_prior_state():
    assert not obs.enabled()
    with obs.telemetry_scope() as tel:
        assert obs.enabled()
        tel.count("inside", 1)
    assert not obs.enabled()
    assert obs.get().counters["inside"] == 1


# ----------------------------------------------------------------------
# satellites: public fallback surface, env cache, warn_once
# ----------------------------------------------------------------------
def test_collection_eager_fallbacks_public_surface():
    col = tm.MetricCollection([tm.Accuracy(device=CPU), tm.AUROC(device=CPU)], compiled=True)
    assert col.eager_fallbacks == {}  # engine not built yet
    p = torch.from_numpy(np.random.RandomState(0).rand(64).astype(np.float32))
    t = torch.from_numpy(np.random.RandomState(1).randint(2, size=64))
    col(p, t)
    assert "AUROC" in col.eager_fallbacks
    assert "Accuracy" not in col.eager_fallbacks
    assert col.eager_fallbacks == col._engine.eager_fallbacks
    r = repr(col)
    assert "demoted to eager" in r and "AUROC" in r
    clean = tm.MetricCollection([tm.Accuracy(device=CPU)], compiled=True)
    clean(p, t)
    assert "demoted" not in repr(clean)


def test_construction_time_eager_fallback_events_match_jax():
    p = np.random.RandomState(0).rand(64).astype(np.float32)
    t = np.random.RandomState(1).randint(2, size=64)

    def scenario(pkg, conv):
        kw = {"device": CPU} if pkg is tm else {}
        col = pkg.MetricCollection([pkg.Accuracy(**kw), pkg.AUROC(**kw)], compiled=True)
        col(*conv(p, t))
        col(*conv(p, t))

    jax_tel, port_tel = _both(scenario)
    assert [e["kind"] for e in port_tel.events] == ["eager_fallback"]
    assert port_tel.counters["engine.eager_steps"] == 2
    assert_telemetry_parity(jax_tel, port_tel, "AUROC statically eager")


def test_env_flags_cached_and_refreshable(monkeypatch):
    from metrics_tpu_torch.utilities import env

    try:
        monkeypatch.setenv("METRICS_TPU_TELEMETRY", "1")
        assert not env.telemetry_requested()  # cached at import
        env.refresh()
        assert env.telemetry_requested()
    finally:
        monkeypatch.undo()
        env.refresh()
    assert env.parse_flag("TRUE") and env.parse_flag(" on ")
    assert not env.parse_flag("0") and not env.parse_flag(None) and not env.parse_flag("no")


def test_warn_once_rate_limits_per_key():
    from metrics_tpu_torch.utilities.prints import warn_once

    key = "test-torch-warn-once-unique-key"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert warn_once("first", key=key) is True
        assert warn_once("second (dropped)", key=key) is False
        assert warn_once("different message, default key (port)") is True
    messages = [str(w.message) for w in caught]
    assert messages == ["first", "different message, default key (port)"]


# ----------------------------------------------------------------------
# 6. fixed-bucket histograms + bounded-log accounting
# ----------------------------------------------------------------------
def test_observe_hist_fixed_buckets_and_overflow():
    tel = obs.enable()
    edges = obs.LATENCY_BUCKETS_MS
    tel.observe_hist("drill.ms", 0.05, edges)
    tel.observe_hist("drill.ms", 0.1, edges)  # on an edge: inclusive upper bound
    tel.observe_hist("drill.ms", 75.0, edges)
    tel.observe_hist("drill.ms", 10**9, edges)  # beyond the last edge: +Inf bucket
    h = tel.snapshot()["histograms"]["drill.ms"]
    assert h["buckets"] == list(edges) == list(jobs.LATENCY_BUCKETS_MS)
    assert len(h["counts"]) == len(edges) + 1
    assert h["counts"][0] == 2
    assert h["counts"][edges.index(100.0)] == 1
    assert h["counts"][-1] == 1
    assert h["count"] == 4 and h["sum"] == pytest.approx(0.05 + 0.1 + 75.0 + 10**9)
    assert "histograms" in obs.report() and "drill.ms" in obs.report()
    assert obs.percentile(h, 50) == jobs.percentile(h, 50)
    tel.reset()
    assert tel.snapshot()["histograms"] == {}


def test_sync_histograms_recorded_on_host_sync():
    from metrics_tpu_torch.utilities.distributed import gather_all_tensors

    obs.enable()
    m = tm.Accuracy(device=CPU)
    m.update(*_t(*_cls_batch()))
    m.dist_sync_fn = gather_all_tensors  # force the host sync path
    m.compute()
    hists = obs.get().snapshot()["histograms"]
    assert hists["sync.latency_ms"]["count"] == 1
    assert hists["sync.latency_ms"]["buckets"] == list(obs.LATENCY_BUCKETS_MS)
    assert hists["sync.payload_bytes"]["count"] == 1
    assert hists["sync.payload_bytes"]["sum"] > 0
    assert hists["sync.payload_bytes"]["buckets"] == list(jobs.PAYLOAD_BUCKETS_BYTES)


def test_dropped_events_surfaced_when_the_bounded_log_wraps():
    tel = obs.enable(max_events=4)
    try:
        for i in range(10):
            tel.event("e", i=i)
        snap = tel.snapshot()
        assert len(snap["events"]) == 4
        assert snap["dropped_events"] == 6
        assert "6 dropped by the bounded log" in tel.report()
        tel.reset()
        assert tel.snapshot()["dropped_events"] == 0
    finally:
        obs.enable(max_events=1024)


def test_host_timing_under_trace_warns_once_with_lint_crosslink():
    """``metric_scope`` entered while a step is built (the engine's
    ``tracing()`` scope) warns once per ``Name.phase``, naming MTL103. The
    JAX package's check asks ``jax.core.trace_state_clean``, which JAX
    0.9.0 lacks, so its warning never fires (ROADMAP Queue 3 item 5)."""

    class HostTimedTorchDrillMetric:  # unique name => fresh warn_once key
        pass

    obs.enable()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(2):
            with tracing(), telemetry_mod.metric_scope(HostTimedTorchDrillMetric(), "update"):
                pass
        with telemetry_mod.metric_scope(HostTimedTorchDrillMetric(), "compute"):
            pass  # concrete: no warning
    fired = [w for w in caught if "trace-time cost" in str(w.message)]
    assert len(fired) == 1
    msg = str(fired[0].message)
    assert "HostTimedTorchDrillMetric.update" in msg and "MTL103" in msg


def test_metric_scope_in_the_engine_build_warns_once_per_name_phase():
    """The build's first run of the step function is under ``tracing()``:
    each member's update and compute warn once; the later steps run muted
    and warn no more."""

    class EngineDrillMSE(tm.MeanSquaredError):  # unique name => fresh keys
        pass

    obs.enable()
    col = tm.MetricCollection([EngineDrillMSE(device=CPU)], compiled=True)
    p = torch.from_numpy(np.random.RandomState(0).rand(32).astype(np.float32))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(3):
            col(p, p)
    fired = sorted(str(w.message).split("metric_scope(")[1].split(")")[0]
                   for w in caught if "trace-time cost" in str(w.message))
    assert fired == ["EngineDrillMSE.compute", "EngineDrillMSE.update"]
    assert all("MTL103" in str(w.message) for w in caught if "trace-time cost" in str(w.message))


def test_exit_dump_is_atomic_and_parseable(tmp_path, monkeypatch):
    target = tmp_path / "dump.json"
    monkeypatch.setenv(telemetry_mod._DUMP_ENV, str(target))
    tel = obs.enable()
    tel.count("drill.exit", 7)
    telemetry_mod._dump_at_exit()
    blob = json.loads(target.read_text())
    assert blob["counters"]["drill.exit"] == 7
    assert blob["dropped_events"] == 0
    assert [p.name for p in tmp_path.iterdir()] == ["dump.json"]


# ----------------------------------------------------------------------
# 7. parity scenarios: the same batches through both packages
# ----------------------------------------------------------------------
@pytest.mark.parametrize("compiled", [False, True])
def test_collection_three_steps_and_compute_match_jax(compiled):
    batches = [_cls_batch(seed=s) for s in range(3)]
    cols = {}

    def scenario(pkg, conv):
        col = cols[pkg] = _collection(pkg, compiled)
        for b in batches:
            col(*conv(*b))
        col.compute()

    jax_tel, port_tel = _both(scenario)
    assert_telemetry_parity(jax_tel, port_tel, f"collection compiled={compiled}")
    if compiled:
        # the build-time rule: a member's update and compute count once per
        # build, which is the engine's trace_count, as in the JAX package
        trace_count = cols[tm]._engine.trace_count
        assert trace_count == cols[jm]._engine.trace_count == 1
        for name in ("Accuracy", "Precision", "F1"):
            assert port_tel.counters[f"metric.{name}.update_calls"] == trace_count
            assert port_tel.counters[f"metric.{name}.compute_calls"] == trace_count + 1  # + the epoch compute


def test_demotion_matches_jax_but_the_demoted_list():
    """``StatScores()`` on labels cannot infer ``num_classes`` in a built
    step: both engines demote, count one trace failure and record one
    ``eager_fallback`` event with the same reason. The event's member list
    differs by design: the port demotes ``StatScores`` alone, JAX the whole
    compiled group; so the port's Accuracy stays compiled and the later
    steps' counters differ too, which this scenario leaves to one step."""
    rng = np.random.RandomState(5)
    p, t = rng.randint(5, size=300), rng.randint(5, size=300)
    cols = {}

    def scenario(pkg, conv):
        kw = {"device": CPU} if pkg is tm else {}
        col = cols[pkg] = pkg.MetricCollection([pkg.Accuracy(**kw), pkg.StatScores(**kw)], compiled=True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            col(*conv(p, t))

    jax_tel, port_tel = _both(scenario)
    (jax_event,), (port_event,) = jax_tel.events, port_tel.events
    assert jax_event["metrics"] == ["Accuracy", "StatScores"] and port_event["metrics"] == ["StatScores"]
    assert set(cols[jm].eager_fallbacks) == {"Accuracy", "StatScores"}
    assert set(cols[tm].eager_fallbacks) == {"StatScores"}
    assert port_tel.counters["engine.trace_failures"] == 1
    assert_telemetry_parity(jax_tel, port_tel, "demotion")


def test_three_tenant_cohort_with_health_following_telemetry_matches_jax():
    rng = np.random.RandomState(11)
    batches = []
    for _ in range(3):
        probs = rng.rand(3, 16, 4).astype(np.float32)
        probs /= probs.sum(-1, keepdims=True)
        batches.append((probs, rng.randint(4, size=(3, 16))))
    cohorts = {}

    def scenario(pkg, conv):
        cohort = cohorts[pkg] = pkg.MetricCohort(_collection(pkg), tenants=3)  # track_health=None
        for b in batches:
            cohort(*conv(*b))
        cohort.compute()
        cohort.health(stale_after=2)

    jax_tel, port_tel = _both(scenario)
    c = port_tel.counters
    assert c["cohort.dispatches"] == 3 and c["cohort.dispatch_tenants"] == 9 and c["cohort.health_snapshots"] == 1
    assert port_tel.gauges["cohort.size"] == 3 and port_tel.gauges["cohort.capacity"] == 4
    assert cohorts[tm]._engine.trace_count == cohorts[jm]._engine.trace_count == 1
    assert_telemetry_parity(jax_tel, port_tel, "3-tenant cohort")


def test_cohort_sync_telemetry_matches_jax():
    """A cohort's ``compute()`` under an installed one-process backend syncs
    the exact tier: one collective per stacked state, its bytes, the
    ``cohort_sync`` event, as JAX's."""
    from metrics_tpu.parallel import backend as jax_backend
    from metrics_tpu_torch.parallel import backend as port_backend

    rng = np.random.RandomState(13)
    probs = rng.rand(3, 16, 4).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    batch = (probs, rng.randint(4, size=(3, 16)))

    def scenario(pkg, conv):
        mod = port_backend if pkg is tm else jax_backend
        cohort = pkg.MetricCohort(_collection(pkg), tenants=3, track_health=False)
        cohort(*conv(*batch))
        prev = mod.set_sync_backend(mod.SingleProcessBackend())
        try:
            cohort.compute()
        finally:
            mod.set_sync_backend(prev)

    jax_tel, port_tel = _both(scenario)
    assert port_tel.counters["sync.calls"] == 1 and port_tel.counters["cohort.sync_collectives"] == 10
    assert [e["kind"] for e in port_tel.events] == ["cohort_sync"]
    assert_telemetry_parity(jax_tel, port_tel, "cohort sync")


# ----------------------------------------------------------------------
# 8. the glossary
# ----------------------------------------------------------------------
_EMIT = re.compile(r"""(?:\btel|_telemetry|_obs\.get\(\))\.(count|gauge|observe|observe_hist|event)\(\s*(f?)"([^"]+)\"""")

# the JAX package emits these event kinds too (metrics_tpu/cohort.py, the
# cohort's sync; metrics_tpu/reliability/sync.py, a guarded gather's retry;
# metrics_tpu/reliability/guard.py, the state guard's one event per class;
# metrics_tpu/serving/async_engine.py, an admission refusal) and its
# glossary omits them: gaps of the reference's doc
GLOSSARY_GAPS = {"cohort_sync", "sync_retry", "nonfinite_state", "serving_demotion"}


def test_every_emitted_key_is_in_the_jax_glossary():
    doc = (REPO / "docs" / "observability.md").read_text()
    keys = set()
    for path in sorted((REPO / "metrics_tpu_torch").rglob("*.py")):
        for _, fstring, key in _EMIT.findall(path.read_text()):
            # an f-string key is checked by its literal prefix
            keys.add(key.split("{")[0] if fstring else key)
    assert {"engine.dispatches", "sync.payload_bytes", "metric.", "collective.", "trace.", "retrace"} <= keys
    missing = sorted(k for k in keys if k not in doc and k not in GLOSSARY_GAPS)
    assert not missing, f"keys the port emits that docs/observability.md does not name: {missing}"
