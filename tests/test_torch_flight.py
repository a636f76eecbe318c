"""The port's failure flight recorder against the JAX package's, on the CPU.

Every case of ``tests/reliability/test_flight.py`` whose subject is ported
is mirrored on ``metrics_tpu_torch.observability``: healthy runs write
nothing, one injected fault writes one dump, disabled hooks are no-ops,
and the dump mechanics (schema 1, sequencing, the per-reason cap,
keep-last-K GC, re-arming, the identity stamp, a failed dump that warns
and returns None). The cases whose fault lives in a part not ported yet
are listed in ``NOT_PORTED`` with the item that ports them.

Parity scenarios run the same batches through both packages with the
recorder armed and compare the buffered event kinds and fields and the
dump's keys exactly; the atomic writers the dump goes through
(``reliability.checkpoint.atomic_file``, ``journal.atomic_write_json``)
are held to their contract.
"""
import glob
import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.observability as jobs
import metrics_tpu_torch as tm
import metrics_tpu_torch.observability as obs
from metrics_tpu_torch.engine import CompiledStepEngine
from metrics_tpu_torch.observability import flight as flight_mod
from metrics_tpu_torch.observability.watchdog import RecompilationWatchdog
from metrics_tpu_torch.reliability.checkpoint import atomic_file
from metrics_tpu_torch.reliability.journal import atomic_write_json

CPU = "cpu"

# the JAX cases whose fault lives in a part the port does not have yet, by
# the item (ROADMAP Queue 1) that ports it; the sync cases
# (test_sync_terminal_failure_dumps_exactly_once,
# test_hung_sync_timeout_dumps_exactly_once) came with the sync tiers and are
# in tests/test_torch_guarded_sync.py
NOT_PORTED = {
    "test_state_guard_quarantine_dumps_once_per_poisoned_batch": "reliability/ (item 4): StateGuard",
    "test_state_guard_warn_policy_records_but_does_not_dump": "reliability/ (item 4): StateGuard",
    "test_session_torn_write_fallback_dumps_exactly_once": "reliability/ (item 4): EvalSession, journal",
}


def _pristine():
    for pkg in (jobs, obs):
        pkg.disable_flight()
        pkg.disable()
        pkg.get().reset()
        pkg.disable_tracing()
        pkg.get_tracer().reset()


@pytest.fixture(autouse=True)
def _pristine_recorders():
    """Both packages' recorders are process-global: every test starts and
    ends with all of them off and empty."""
    _pristine()
    yield
    _pristine()


def _dump_files(directory) -> list:
    return sorted(glob.glob(os.path.join(os.fspath(directory), "flight-*.json")))


def _load_dump(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _cls_batch(n=96, c=4, seed=3):
    rng = np.random.RandomState(seed)
    probs = rng.rand(n, c).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    return probs, rng.randint(c, size=n)


def _reg_batches(n=5, size=64, seed=7):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rng.rand(size).astype(np.float32)
        out.append((t + 0.1 * rng.randn(size).astype(np.float32), t))
    return out


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _failing_build_once(monkeypatch):
    """The step function of the next build raises once (the JAX package's
    ``faultinject.failing_engine_compile(times=1)``); every later build,
    the members' trials included, is healthy."""
    make = CompiledStepEngine._make_step_fn
    left = {"n": 1}

    def make_step_fn(self, names, *args):
        step = make(self, names, *args)

        def failing(states, args, kwargs):
            if left["n"]:
                left["n"] -= 1
                raise RuntimeError("FaultInjected: step build failed")
            return step(states, args, kwargs)

        return failing

    monkeypatch.setattr(CompiledStepEngine, "_make_step_fn", make_step_fn)


# ----------------------------------------------------------------------
# 1. the healthy-run-zero-dumps invariant (+ bit-identical results)
# ----------------------------------------------------------------------
def test_healthy_run_zero_dumps_and_bit_identical(tmp_path):
    """The JAX case also drives an ``EvalSession`` (reliability/, item 4);
    here the compiled collection alone."""
    batches = [_t(*b) for b in _reg_batches()]
    bare = tm.MetricCollection([tm.MeanSquaredError(device=CPU)], compiled=True)
    for b in batches:
        bare(*b)
    want = bare.compute()

    armed_dir = tmp_path / "flight"
    with obs.flight_scope(armed_dir) as rec:
        col = tm.MetricCollection([tm.MeanSquaredError(device=CPU)], compiled=True)
        for b in batches:
            col(*b)
        got = col.compute()

    for k in want:
        assert torch.equal(got[k], want[k])
    assert [e["kind"] for e in rec.events] == ["engine_dispatch"] * len(batches)
    assert [e["cache_hit"] for e in rec.events] == [False] + [True] * (len(batches) - 1)
    assert rec.dumps == 0 and rec.dump_paths == []
    assert _dump_files(armed_dir) == []


# ----------------------------------------------------------------------
# 2. one injected fault, one dump
# ----------------------------------------------------------------------
def test_engine_dispatch_failure_dumps_exactly_once(tmp_path, monkeypatch):
    p, t = _t(*_cls_batch())
    with obs.flight_scope(tmp_path) as rec:
        col = tm.MetricCollection([tm.Accuracy(device=CPU), tm.Precision(average="macro", num_classes=4,
                                                                        device=CPU)], compiled=True)
        col(p, t)  # healthy warm-up: builds the engine, dumps nothing
        assert rec.dumps == 0
        _failing_build_once(monkeypatch)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            # new shape => fresh build => injected failure => demote-to-eager
            col(torch.cat([p, p]), torch.cat([t, t]))
        col(p, t)  # demoted loop keeps running, no further dumps

    files = _dump_files(tmp_path)
    assert len(files) == 1 and rec.dumps == 1
    dump = _load_dump(files[0])
    assert dump["format"] == "metrics_tpu.flight_dump"
    assert dump["reason"] == "engine_dispatch_failure"
    assert "FaultInjected" in dump["context"]["error"]
    # neither member fails alone: the whole group is demoted, as in JAX
    assert set(dump["context"]["demoted"]) == {"Accuracy", "Precision"}
    lo, hi = dump["step_range"]
    assert lo >= 1 and hi >= lo
    assert any(e["kind"] == "engine_dispatch" for e in dump["events"])


def test_watchdog_retrace_dumps_once_with_analysis_hint(tmp_path):
    wd = RecompilationWatchdog()
    with obs.flight_scope(tmp_path) as rec:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            wd.note_compile("engine[drill]", new_signature=True)  # legit build
            assert rec.dumps == 0
            wd.note_compile("engine[drill]", new_signature=False)  # thrash: fires
            wd.note_compile("engine[drill]", new_signature=False)  # fires again...
    files = _dump_files(tmp_path)
    assert len(files) == 1 and rec.dumps == 1  # ...but one dump per key
    dump = _load_dump(files[0])
    assert dump["reason"] == "watchdog_retrace"
    assert dump["context"]["key"] == "engine[drill]"
    assert "recompiled a previously compiled signature" in dump["context"]["verdict"]
    # the analyzer's hint rides along: None, since no audit has named a
    # class "drill" (analysis/program.py's registry resolves class names)
    assert "hint" in dump and dump["hint"] is None
    assert sum(e["kind"] == "watchdog_retrace" for e in rec.events) == 2


# ----------------------------------------------------------------------
# 3. disabled is invisible
# ----------------------------------------------------------------------
def test_disabled_hooks_are_noops(tmp_path, monkeypatch):
    assert not obs.flight_enabled()
    flight_mod.record("anything", detail=1)
    assert flight_mod.dump_on_failure("anything") is None
    assert list(tmp_path.iterdir()) == []

    col = tm.MetricCollection([tm.Accuracy(device=CPU)], compiled=True)
    _failing_build_once(monkeypatch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        col(*_t(*_cls_batch()))  # demotes; with the recorder disarmed nothing is written
    assert "Accuracy" in col.eager_fallbacks
    assert list(tmp_path.iterdir()) == []


def test_flight_scope_restores_prior_recorder(tmp_path):
    outer = obs.enable_flight(tmp_path / "outer")
    try:
        with obs.flight_scope(tmp_path / "inner") as inner:
            assert obs.get_flight() is inner
            flight_mod.record("inner_event")
        assert obs.get_flight() is outer and obs.flight_enabled()
        flight_mod.record("outer_event")
        assert [e["kind"] for e in outer.events] == ["outer_event"]
        assert [e["kind"] for e in inner.events] == ["inner_event"]
    finally:
        obs.disable_flight()


# ----------------------------------------------------------------------
# 4. dump mechanics: schema, sequencing, and never-breaks-recovery
# ----------------------------------------------------------------------
def test_manual_dump_schema_and_sequencing(tmp_path):
    with obs.flight_scope(tmp_path) as rec:
        with obs.tracing_scope():
            rec.record("drill", step=7, detail="a")
            rec.record("drill", step=9)
        first = rec.dump("live drill", hint="MTA001", extra=1)
        second = rec.dump("live drill")
    assert os.path.basename(first) == "flight-0001-live-drill.json"
    assert os.path.basename(second) == "flight-0002-live-drill.json"
    dump = _load_dump(first)
    assert dump["schema_version"] == 1
    assert dump["step_range"] == [7, 9]
    assert dump["hint"] == "MTA001" and dump["context"] == {"extra": 1}
    assert [e["step"] for e in dump["events"]] == [7, 9]
    assert dump["telemetry"] is None and dump["cost_ledger"] is None


def test_dump_carries_telemetry_snapshot_when_enabled(tmp_path):
    with obs.telemetry_scope() as tel:
        tel.count("drill.counter", 3)
        with obs.flight_scope(tmp_path) as rec:
            rec.record("drill")
            path = rec.dump("with telemetry")
    dump = _load_dump(path)
    assert dump["telemetry"]["counters"]["drill.counter"] == 3


def test_failed_dump_warns_and_returns_none(tmp_path):
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("a file where the dump directory should go")
    with obs.flight_scope(blocker):
        flight_mod.record("drill")
        with pytest.warns(UserWarning, match="dump for 'torch-drill-fault' failed"):
            assert flight_mod.dump_on_failure("torch-drill-fault") is None


def test_failure_dumps_capped_per_reason(tmp_path):
    with obs.flight_scope(tmp_path) as rec:
        rec.max_dumps_per_reason = 2
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(5):
                flight_mod.record("repeat_fault")
                flight_mod.dump_on_failure("torch-repeat-fault")
        manual = rec.dump("torch-repeat-fault")  # the live-drill path is uncapped
    files = _dump_files(tmp_path)
    assert len(files) == 3 and manual in files
    capped = [w for w in caught if "2-dump cap" in str(w.message)]
    assert len(capped) == 1
    assert sum(e["kind"] == "repeat_fault" for e in rec.events) == 5


def test_rearmed_recorder_never_overwrites_prior_dumps(tmp_path):
    with obs.flight_scope(tmp_path) as rec:
        rec.record("first_life")
        first = rec.dump("same-reason")
    with obs.flight_scope(tmp_path) as rec2:
        rec2.record("second_life")
        second = rec2.dump("same-reason")
    assert first != second
    assert len(_dump_files(tmp_path)) == 2
    assert _load_dump(first)["events"][0]["kind"] == "first_life"
    assert _load_dump(second)["events"][0]["kind"] == "second_life"


def test_keep_last_k_dump_gc(tmp_path):
    bystander = os.path.join(tmp_path, "not-a-flight-dump.json")
    with open(bystander, "w") as f:
        f.write("{}")
    rec = flight_mod.enable_flight(tmp_path, keep_dumps=3)
    try:
        paths = [rec.dump(f"drill-{i}") for i in range(7)]
    finally:
        flight_mod.disable_flight()
    files = _dump_files(tmp_path)
    assert len(files) == 3
    assert files == sorted(paths[-3:])
    assert os.path.exists(bystander)
    assert sorted(rec.dump_paths) == files


def test_dump_gc_extends_across_rearms(tmp_path):
    with obs.flight_scope(tmp_path) as rec:
        rec.keep_dumps = 2
        rec.dump("first")
        rec.dump("second")
    with obs.flight_scope(tmp_path) as rec2:
        rec2.keep_dumps = 2
        rec2.dump("third")
    names = [os.path.basename(p) for p in _dump_files(tmp_path)]
    assert len(names) == 2
    assert any("second" in n for n in names) and any("third" in n for n in names)


def test_dump_carries_identity_stamp(tmp_path):
    with obs.flight_scope(tmp_path) as rec:
        rec.record("who_am_i")
        path = rec.dump("identity-drill")
    dump = _load_dump(path)
    assert dump["identity"]["rank"] == 0
    assert dump["identity"]["world_size"] == 1
    assert "host" in dump["identity"] and "pid" in dump["identity"]


def test_rearm_after_gc_never_reuses_freed_sequence_numbers(tmp_path):
    with obs.flight_scope(tmp_path) as rec:
        rec.keep_dumps = 2
        for i in range(3):
            rec.dump(f"life1-{i}")  # GC leaves 0002, 0003
    with obs.flight_scope(tmp_path) as rec2:
        rec2.keep_dumps = 2
        fresh = rec2.dump("life2")
    assert os.path.exists(fresh)
    files = _dump_files(tmp_path)
    assert len(files) == 2 and fresh in files
    assert os.path.basename(fresh).startswith("flight-0004-")


# ----------------------------------------------------------------------
# 5. the atomic writers
# ----------------------------------------------------------------------
def test_atomic_write_leaves_the_old_file_on_a_failed_write(tmp_path):
    path = tmp_path / "artifact.json"
    atomic_write_json(path, {"generation": 1})
    with pytest.raises(RuntimeError, match="crash mid-write"):
        with atomic_file(path) as f:
            f.write(b'{"generation": 2, "torn')
            raise RuntimeError("crash mid-write")
    assert json.loads(path.read_text()) == {"generation": 1}
    assert [p.name for p in tmp_path.iterdir()] == ["artifact.json"]
    atomic_write_json(path, {"generation": 2})
    assert json.loads(path.read_text()) == {"generation": 2}


# ----------------------------------------------------------------------
# 6. parity with the JAX package: event windows and dump keys
# ----------------------------------------------------------------------
def _flight_both(tmp_path, scenario):
    """Run ``scenario(pkg, conv)`` once per package with telemetry and the
    flight recorder armed; returns ``(events, dumps)`` per package."""
    out = []
    for pkg, o, conv, name in ((jm, jobs, _j, "jax"), (tm, obs, _t, "port")):
        with o.telemetry_scope(), o.flight_scope(tmp_path / name) as rec:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                scenario(pkg, conv)
        out.append(([dict(e) for e in rec.events], [_load_dump(p) for p in _dump_files(tmp_path / name)]))
    return out


def _comparable(events):
    """Event kinds and fields; the wall-clock stamp and the process-wide
    step counter (each package numbers its own) are dropped."""
    return [{k: v for k, v in e.items() if k not in ("t", "step")} for e in events]


def test_polymorphic_loop_flight_matches_jax(tmp_path):
    """One watchdog verdict: one ``watchdog_retrace`` dump, the same event
    window (engine dispatches, the verdict) and the same dump keys."""

    def scenario(pkg, conv):
        kw = {"device": CPU} if pkg is tm else {}
        # a class of its own: the watchdog warns once per engine key in a
        # process, and other tests of this loop may share the worker
        col = pkg.MetricCollection([type("FlightPolyMSE", (pkg.MeanSquaredError,), {})(**kw)], compiled=True)
        p0 = np.zeros(2, np.float32)
        col(*conv(p0, p0))  # build the engine
        col._engine._cache_size = 4  # the build budget max(8, cache_size) is 8
        for n in range(4, 28, 2):  # 12 new shapes: past the budget
            p = np.random.RandomState(n).rand(n).astype(np.float32)
            col(*conv(p, p))

    (jax_events, jax_dumps), (port_events, port_dumps) = _flight_both(tmp_path, scenario)
    assert len(port_dumps) == len(jax_dumps) == 1
    assert [e["kind"] for e in port_events] == [e["kind"] for e in jax_events]
    assert _comparable(port_events) == _comparable(jax_events)
    (jd,), (pd,) = jax_dumps, port_dumps
    assert sorted(pd) == sorted(jd)
    assert pd["format"] == jd["format"] and pd["schema_version"] == jd["schema_version"]
    assert pd["reason"] == jd["reason"] == "watchdog_retrace" and pd["context"] == jd["context"]
    assert sorted(pd["identity"]) == sorted(jd["identity"])
    assert _comparable(pd["events"]) == _comparable(jd["events"])
    # the telemetry snapshot riding the dump: the same counters, the cost
    # ledger's engine.compile.{cold,warm} among them
    assert pd["telemetry"]["counters"] == jd["telemetry"]["counters"]
    assert pd["telemetry"]["counters"]["engine.compile.cold"] == 8


def test_demotion_flight_matches_jax_but_the_demoted_list(tmp_path):
    """A demotion dumps once with the same reason and error; ``demoted``
    lists the members demoted, which differ by design (the port demotes
    ``StatScores`` alone, JAX the whole compiled group)."""
    rng = np.random.RandomState(5)
    p, t = rng.randint(5, size=300), rng.randint(5, size=300)

    def scenario(pkg, conv):
        kw = {"device": CPU} if pkg is tm else {}
        pkg.MetricCollection([pkg.Accuracy(**kw), pkg.StatScores(**kw)], compiled=True)(*conv(p, t))

    (jax_events, jax_dumps), (port_events, port_dumps) = _flight_both(tmp_path, scenario)
    assert _comparable(port_events) == _comparable(jax_events)
    (jd,), (pd,) = jax_dumps, port_dumps
    assert sorted(pd) == sorted(jd) and pd["reason"] == jd["reason"] == "engine_dispatch_failure"
    assert pd["context"]["error"] == jd["context"]["error"]
    assert jd["context"]["demoted"] == ["Accuracy", "StatScores"] and pd["context"]["demoted"] == ["StatScores"]


def test_cohort_flight_records_match_jax(tmp_path):
    """The cohort's dispatch records and its health breadcrumb (a stale
    tenant named) equal JAX's; a healthy cohort writes no dump."""
    rng = np.random.RandomState(9)
    probs = rng.rand(3, 16, 4).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    labels = rng.randint(4, size=(3, 16))

    def scenario(pkg, conv):
        kw = {"device": CPU} if pkg is tm else {}
        cohort = pkg.MetricCohort(pkg.MeanSquaredError(**kw), tenants=3)
        for _ in range(3):
            cohort(*conv(probs[..., 0], labels.astype(np.float32)))
        cohort.add_tenant()
        cohort(*conv(np.zeros((4, 16), np.float32), np.zeros((4, 16), np.float32)))
        cohort.health(stale_after=1)

    (jax_events, jax_dumps), (port_events, port_dumps) = _flight_both(tmp_path, scenario)
    assert jax_dumps == port_dumps == []
    assert [e["kind"] for e in port_events] == ["cohort_dispatch"] * 4 + ["cohort_health"]
    assert _comparable(port_events) == _comparable(jax_events)
