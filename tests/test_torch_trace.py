"""The port's span tracing against the JAX package's, on the CPU.

Every case of ``tests/bases/test_trace.py`` is mirrored on
``metrics_tpu_torch.observability``: tracing off by default and invisible,
step-structured spans (phases, nesting, step attribution, flows), the
bounded ring, the Perfetto export, and the ``METRICS_TPU_TRACE`` flag. The
``trace_export`` cases run the JAX package's own CLI
(``scripts/trace_export.py``) as a subprocess on dumps the port wrote: the
formats are one.

Parity scenarios run the same numpy-seeded batches through both packages
with tracing on and compare the span sequences exactly: each span's name,
phase, step (relative to the scenario's first), parent (by position) and
attributes. The engine's spans under ``compiled=True`` include the build's
update and compute spans once per signature (the build-time rule: JAX's
fire at trace time).
"""
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.observability as jobs
import metrics_tpu_torch as tm
import metrics_tpu_torch.observability as obs
from metrics_tpu.observability import trace as jax_trace_mod
from metrics_tpu_torch.observability import trace as trace_mod
from metrics_tpu_torch.utilities.distributed import gather_all_tensors

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"


def _pristine():
    for pkg, mod in ((jobs, jax_trace_mod), (obs, trace_mod)):
        pkg.enable_tracing(max_spans=mod._DEFAULT_MAX_SPANS)
        pkg.disable_tracing()
        pkg.get_tracer().reset()
        pkg.disable()
        pkg.get().reset()
        pkg.disable_flight()


@pytest.fixture(autouse=True)
def _pristine_tracing():
    """Both packages' recorders are process-global: every test starts and
    ends with all of them off and empty, and the ring at its default size."""
    _pristine()
    yield
    _pristine()


def _cls_batch(n=128, c=4, seed=0):
    rng = np.random.RandomState(seed)
    probs = rng.rand(n, c).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    return probs, rng.randint(c, size=n)


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _collection(pkg=tm, compiled=False):
    kw = {"device": CPU} if pkg is tm else {}
    return pkg.MetricCollection(
        [pkg.Accuracy(**kw), pkg.Precision(num_classes=4, average="macro", **kw),
         pkg.F1(num_classes=4, average="macro", **kw)],
        compiled=compiled,
    )


# ----------------------------------------------------------------------
# 1. disabled is invisible
# ----------------------------------------------------------------------
def test_tracing_is_off_by_default_and_records_nothing():
    assert not obs.tracing_enabled()
    m = tm.Accuracy(device=CPU)
    m(*_t(*_cls_batch()))
    m.compute()
    assert len(obs.get_tracer().spans) == 0
    assert obs.get_tracer().step_range() is None


def test_disabled_span_is_the_shared_null_context():
    a = trace_mod.span("x", phase="update")
    b = trace_mod.span("y", phase="sync")
    assert a is b is trace_mod._NULL_CM


@pytest.mark.parametrize("compiled", [False, True])
def test_results_bit_identical_with_tracing_enabled(compiled):
    p, t = _t(*_cls_batch())
    plain = _collection(compiled=compiled)
    v_plain = plain(p, t)
    e_plain = plain.compute()

    traced = _collection(compiled=compiled)
    with obs.tracing_scope() as tracer:
        v_traced = traced(p, t)
        e_traced = traced.compute()
    assert len(tracer.spans) > 0
    for k in v_plain:
        assert torch.equal(v_plain[k], v_traced[k]) and torch.equal(e_plain[k], e_traced[k]), k
    assert not obs.tracing_enabled()


# ----------------------------------------------------------------------
# 2. span structure: phases, nesting, step attribution
# ----------------------------------------------------------------------
def test_metric_phases_are_attributed():
    with obs.tracing_scope() as tracer:
        m = tm.Accuracy(device=CPU)
        m(*_t(*_cls_batch()))
        m.compute()
    phases = {s["phase"] for s in tracer.spans}
    assert "update" in phases and "compute" in phases
    assert phases <= set(obs.PHASES)


def test_engine_dispatch_spans_and_step_counter():
    p, t = _t(*_cls_batch())
    col = _collection(compiled=True)
    with obs.tracing_scope() as tracer:
        start = trace_mod.current_step()
        for _ in range(3):
            col(p, t)
    names = [s["name"] for s in tracer.spans]
    assert names.count("engine.dispatch") == 3
    assert "engine.cache_lookup" in names and "engine.donate" in names
    dispatch_phases = {s["phase"] for s in tracer.spans if s["name"].startswith("engine.")}
    assert dispatch_phases == {"dispatch"}
    steps = sorted({s["step"] for s in tracer.spans if s["name"] == "engine.dispatch"})
    assert steps == [start + 1, start + 2, start + 3]
    assert tracer.step_range() == [start + 1, start + 3]
    # the build-time rule: the members' update spans come from the build
    # (the first step) only
    updates = [s for s in tracer.spans if s["name"].endswith(".update")]
    assert len(updates) == 3 and {s["step"] for s in updates} == {start + 1}


def test_nesting_records_parent_child():
    rec = trace_mod.TraceRecorder()
    with rec.span("outer", phase="update"):
        with rec.span("inner", phase="sync"):
            pass
    inner, outer = rec.spans  # children commit first
    assert inner["name"] == "inner" and outer["name"] == "outer"
    assert inner["parent"] == outer["id"]
    assert outer["parent"] is None


def test_step_scope_pins_the_step_index():
    rec = trace_mod.enable_tracing()
    rec.reset()
    auto_before = trace_mod.current_step()
    with trace_mod.step_scope(777):
        assert trace_mod.current_step() == 777
        assert trace_mod.advance_step() == 777
        trace_mod.instant("mark")
    assert trace_mod.current_step() == auto_before
    assert [s["step"] for s in rec.spans] == [777]


def test_sync_span_is_phase_sync():
    m = tm.Accuracy(device=CPU)
    m.update(*_t(*_cls_batch(n=48)))
    m.dist_sync_fn = gather_all_tensors
    with obs.tracing_scope() as tracer:
        m.compute()
    sync = [s for s in tracer.spans if s["phase"] == "sync"]
    assert len(sync) == 1
    assert sync[0]["name"] == "metrics_tpu.Accuracy.sync"
    assert sync[0]["args"] == {"rank": 0}


def test_canonicalization_is_spanned_and_memo_hits_are_not():
    """``checks.input_format_classification`` spans the canonicalization
    proper (phase canonicalize); a sibling's memo hit inside
    ``shared_canonicalization`` costs a dict probe and records nothing."""
    from metrics_tpu_torch.utilities.checks import _input_format_classification, shared_canonicalization

    p, t = _t(*_cls_batch())
    with obs.tracing_scope() as tracer, shared_canonicalization():
        _input_format_classification(p, t)
        _input_format_classification(p, t)
    (span,) = tracer.spans
    assert span["name"] == "checks.input_format_classification" and span["phase"] == "canonicalize"
    with obs.tracing_scope() as tracer:
        m = tm.AUROC(device=CPU)
        m.update(torch.rand(32), torch.randint(0, 2, (32,)))
    assert [s["name"] for s in tracer.spans] == ["checks.input_format_classification", "metrics_tpu.AUROC.update"]
    assert tracer.spans[0]["parent"] == tracer.spans[1]["id"]


def test_unknown_phase_falls_back_to_other():
    rec = trace_mod.TraceRecorder()
    with rec.span("x", phase="not-a-phase"):
        pass
    assert rec.spans[0]["phase"] == "other"


def test_muted_hooks_record_nothing_on_this_thread_only():
    rec = trace_mod.enable_tracing()
    rec.reset()
    seen = []

    def other():
        with trace_mod.span("other_thread", phase="update"):
            pass
        seen.append(trace_mod.hooks_muted())

    with trace_mod.muted():
        with trace_mod.span("muted", phase="update"):
            th = threading.Thread(target=other)
            th.start()
            th.join(timeout=30)
        assert not th.is_alive()
    with trace_mod.span("unmuted", phase="update"):
        pass
    assert [s["name"] for s in rec.spans] == ["other_thread", "unmuted"] and seen == [False]


# ----------------------------------------------------------------------
# 2b. causal batch flows
# ----------------------------------------------------------------------
def test_next_batch_id_is_monotone_and_thread_safe():
    seen = []
    lock = threading.Lock()

    def grab():
        ids = [trace_mod.next_batch_id() for _ in range(50)]
        with lock:
            seen.extend(ids)

    threads = [threading.Thread(target=grab) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert len(seen) == len(set(seen)) == 200


def test_flow_scope_pins_flow_onto_spans_and_instants():
    rec = trace_mod.enable_tracing()
    rec.reset()
    bid = trace_mod.next_batch_id()
    assert trace_mod.current_flow() is None
    with trace_mod.flow_scope(bid):
        assert trace_mod.current_flow() == (bid,)
        with rec.span("work", phase="dispatch"):
            pass
        rec.instant("mark")
        with rec.span("other", phase="dispatch", flow=(bid + 1000,)):
            pass
    assert trace_mod.current_flow() is None
    work, mark, other = rec.spans
    assert work["flow"] == [bid] and mark["flow"] == [bid] and other["flow"] == [bid + 1000]


def test_flow_scope_accepts_id_tuples_and_nests():
    with trace_mod.flow_scope((3, 1, 2)):
        assert trace_mod.current_flow() == (3, 1, 2)
        with trace_mod.flow_scope(None):
            assert trace_mod.current_flow() is None
        assert trace_mod.current_flow() == (3, 1, 2)


def test_complete_span_commits_a_finished_interval():
    rec = trace_mod.TraceRecorder()
    t0 = time.perf_counter_ns()
    t1 = t0 + 2_000_000  # 2 ms
    rec.complete_span("queue_wait", phase="queue", t0_ns=t0, t1_ns=t1, step=7, flow=4)
    (s,) = rec.spans
    assert s["phase"] == "queue" and s["step"] == 7 and s["flow"] == [4]
    assert abs(s["dur_us"] - 2000.0) < 1.0


def test_perfetto_flow_events_link_spans_across_threads():
    rec = trace_mod.enable_tracing()
    rec.reset()
    bid = trace_mod.next_batch_id()
    with rec.span("submit", phase="queue", flow=bid):
        pass

    def worker():
        with trace_mod.flow_scope(bid):
            with rec.span("dispatch", phase="dispatch"):
                pass
            with rec.span("writeback", phase="dispatch"):
                pass

    th = threading.Thread(target=worker)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    blob = rec.to_perfetto()
    flow_events = [e for e in blob["traceEvents"] if e.get("cat") == "flow"]
    assert [e["ph"] for e in flow_events] == ["s", "t", "f"]
    assert all(e["id"] == flow_events[0]["id"] for e in flow_events)
    assert str(blob["traceEvents"][0]["pid"]) in str(flow_events[0]["id"])
    assert flow_events[-1]["bp"] == "e"
    assert len({e["tid"] for e in flow_events}) == 2
    spans = [e for e in blob["traceEvents"] if e["ph"] == "X"]
    assert all(e["args"].get("batch") == [bid] for e in spans)


def test_live_threads_spans_land_on_their_own_perfetto_tracks():
    """Threads alive at the same time have distinct native ids, so their
    spans land on distinct tracks (the low 16 bits of ``get_ident()``, a
    stack address, collide between live threads)."""
    rec = trace_mod.TraceRecorder()
    threads = 16
    together = threading.Barrier(threads)
    ids = {}

    def worker(i):
        together.wait(timeout=30)  # every thread is alive before any records
        ids[i] = threading.get_native_id()
        t0 = time.perf_counter_ns()
        with rec.span(f"w{i}.span", phase="dispatch"):
            rec.instant(f"w{i}.instant", phase="dispatch")
        rec.complete_span(f"w{i}.leg", phase="queue", t0_ns=t0, t1_ns=time.perf_counter_ns())
        together.wait(timeout=30)

    pool = [threading.Thread(target=worker, args=(i,)) for i in range(threads)]
    for th in pool:
        th.start()
    for th in pool:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in pool)
    tracks = {}
    events = [e for e in trace_mod.spans_to_perfetto(list(rec.spans))["traceEvents"] if e["ph"] in ("X", "i")]
    assert len(events) == 3 * threads
    for e in events:
        tracks.setdefault(int(e["name"].split(".")[0][1:]), set()).add(e["tid"])
    assert sorted(tracks) == list(range(threads))
    assert all(tracks[i] == {ids[i]} for i in range(threads)), (tracks, ids)
    assert len({ids[i] for i in range(threads)}) == threads


def test_single_span_flow_emits_no_dangling_arrow():
    rec = trace_mod.TraceRecorder()
    with rec.span("only", phase="queue", flow=9):
        pass
    blob = trace_mod.spans_to_perfetto(list(rec.spans))
    assert [e for e in blob["traceEvents"] if e.get("cat") == "flow"] == []


# ----------------------------------------------------------------------
# 3. bounded ring buffer
# ----------------------------------------------------------------------
def test_ring_buffer_drops_oldest_and_counts():
    rec = trace_mod.TraceRecorder(max_spans=4)
    for i in range(10):
        rec.instant(f"e{i}")
    assert len(rec.spans) == 4
    assert rec.dropped == 6
    assert [s["name"] for s in rec.spans] == ["e6", "e7", "e8", "e9"]
    snap = rec.snapshot()
    assert snap["dropped"] == 6 and snap["max_spans"] == 4


def test_enable_resize_preserves_newest():
    rec = trace_mod.enable_tracing(max_spans=8)
    rec.reset()
    for i in range(6):
        rec.instant(f"e{i}")
    trace_mod.enable_tracing(max_spans=3)
    assert [s["name"] for s in rec.spans] == ["e3", "e4", "e5"]


# ----------------------------------------------------------------------
# 4. perfetto export schema
# ----------------------------------------------------------------------
def _assert_trace_event_schema(blob):
    assert isinstance(blob, dict) and "traceEvents" in blob
    events = blob["traceEvents"]
    assert isinstance(events, list) and events
    for ev in events:
        assert isinstance(ev["name"], str)
        assert ev["ph"] in ("X", "i", "M")
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        if ev["ph"] == "X":
            assert isinstance(ev["ts"], (int, float))
            assert isinstance(ev["dur"], (int, float)) and ev["dur"] >= 0
        if ev["ph"] == "i":
            assert ev["s"] in ("t", "p", "g")
    assert json.loads(json.dumps(blob)) == blob


def test_to_perfetto_is_schema_valid():
    col = _collection(compiled=True)
    with obs.tracing_scope() as tracer:
        col(*_t(*_cls_batch()))
        col.compute()
        trace_mod.instant("marker", phase="other", note="hi")
    blob = tracer.to_perfetto()
    _assert_trace_event_schema(blob)
    cats = {e.get("cat") for e in blob["traceEvents"] if e["ph"] == "X"}
    assert {"dispatch", "update", "compute"} <= cats
    assert any("step" in e.get("args", {}) for e in blob["traceEvents"])
    assert any(e["ph"] == "i" and e["name"] == "marker" for e in blob["traceEvents"])
    assert blob["traceEvents"][0]["args"]["name"] == "metrics_tpu rank 0/1"


def test_snapshot_json_roundtrip():
    with obs.tracing_scope() as tracer:
        with trace_mod.span("a", phase="update", k=1):
            pass
    snap = json.loads(tracer.to_json())
    assert snap["format"] == "metrics_tpu.trace"
    assert snap["schema_version"] == 2
    assert len(snap["spans"]) == 1
    assert snap["spans"][0]["args"] == {"k": 1}
    assert "flow" not in snap["spans"][0]


# ----------------------------------------------------------------------
# 5. the JAX package's trace_export CLI on the port's dumps
# ----------------------------------------------------------------------
def _trace_export(*argv):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, str(REPO / "scripts" / "trace_export.py"), *map(str, argv)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_trace_export_converts_native_dump_and_merges_ranks(tmp_path):
    """A native dump converts next to its input; two ranks' dumps merge on
    the step index into one timeline with a track per rank."""
    paths = []
    for rank in (0, 1):
        with obs.identity_scope(rank, 2), obs.tracing_scope() as tracer:
            with trace_mod.step_scope(5):
                with trace_mod.span("a", phase="sync"):
                    pass
            paths.append(tmp_path / f"rank{rank}.json")
            paths[-1].write_text(tracer.to_json())
    proc = _trace_export(paths[0])
    assert proc.returncode == 0, proc.stderr[-2000:]
    _assert_trace_event_schema(json.loads((tmp_path / "rank0.perfetto.json").read_text()))
    merged = tmp_path / "merged.json"
    proc = _trace_export("--merge", *paths, "-o", merged)
    assert proc.returncode == 0, proc.stderr[-2000:]
    names = {e["args"]["name"] for e in json.loads(merged.read_text())["traceEvents"] if e["ph"] == "M"}
    assert names == {"metrics_tpu rank 0/2", "metrics_tpu rank 1/2"}


def test_trace_export_converts_flight_dump_and_passthrough(tmp_path):
    with obs.flight_scope(tmp_path / "flight") as rec:
        rec.record("session_step", step=3)
        rec.record("sync_failure", step=4, timeout=True)
        dump = rec.dump("sync_timeout")
    proc = _trace_export(dump, "-o", tmp_path / "out.json")
    assert proc.returncode == 0, proc.stderr[-2000:]
    blob = json.loads((tmp_path / "out.json").read_text())
    _assert_trace_event_schema(blob)
    instants = [e for e in blob["traceEvents"] if e["ph"] == "i"]
    assert [e["name"] for e in instants] == ["session_step", "sync_failure"]
    assert instants[1]["args"]["timeout"] is True
    # already-converted files pass through unchanged
    proc = _trace_export(tmp_path / "out.json", "-o", tmp_path / "again.json")
    assert proc.returncode == 0 and json.loads((tmp_path / "again.json").read_text()) == blob


def test_trace_export_cli_writes_next_to_input(tmp_path):
    with obs.tracing_scope() as tracer:
        trace_mod.instant("x")
    src = tmp_path / "dump.json"
    src.write_text(tracer.to_json())
    proc = _trace_export(src)
    assert proc.returncode == 0, proc.stderr[-2000:]
    _assert_trace_event_schema(json.loads((tmp_path / "dump.perfetto.json").read_text()))


def test_trace_export_rejects_telemetry_snapshots(tmp_path):
    """A telemetry snapshot carries an ``events`` list but no timeline: the
    CLI refuses it loudly."""
    with obs.telemetry_scope() as tel:
        tel.count("a")
        tel.event("custom")
    src = tmp_path / "telemetry.json"
    src.write_text(tel.to_json())
    proc = _trace_export(src)
    assert proc.returncode != 0 and "telemetry snapshots" in proc.stderr


# ----------------------------------------------------------------------
# 6. environment flag
# ----------------------------------------------------------------------
def test_metrics_tpu_trace_env_flag_enables_at_import():
    code = "import sys, metrics_tpu_torch.observability as o; print(o.tracing_enabled(), 'jax' in sys.modules)"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env={**env, "METRICS_TPU_TRACE": "1"})
    assert out.stdout.strip().endswith("True False"), out.stderr[-500:]


# ----------------------------------------------------------------------
# 7. span parity with the JAX package
# ----------------------------------------------------------------------
def _span_sequence(spans, start_step):
    """Each span's (name, phase, step relative to ``start_step``, parent's
    position in the sequence, attributes)."""
    spans = list(spans)
    position = {s["id"]: i for i, s in enumerate(spans)}
    return [(s["name"], s["phase"], s["step"] - start_step, position.get(s["parent"]), s["args"]) for s in spans]


def _traced_both(scenario):
    out = []
    for pkg, o, mod, conv in ((jm, jobs, jax_trace_mod, _j), (tm, obs, trace_mod, _t)):
        with o.tracing_scope() as tracer:
            start = mod.current_step()
            scenario(pkg, conv)
        out.append(_span_sequence(tracer.spans, start))
    return out


def _eager_steps(pkg, conv):
    col = _collection(pkg)
    for s in range(3):
        col(*conv(*_cls_batch(seed=s)))
    col.compute()


def _compiled_steps(pkg, conv):
    col = _collection(pkg, compiled=True)
    for s in range(3):
        col(*conv(*_cls_batch(seed=s)))
    col.compute()


def _two_signatures(pkg, conv):
    kw = {"device": CPU} if pkg is tm else {}
    col = pkg.MetricCollection([pkg.MeanSquaredError(**kw)], compiled=True)
    a = np.random.RandomState(0).rand(64).astype(np.float32)
    b = np.random.RandomState(1).rand(96).astype(np.float32)
    for x in (a, a, b, b, a):
        col(*conv(x, x))


def _cohort_steps(pkg, conv):
    rng = np.random.RandomState(3)
    cohort = pkg.MetricCohort(_collection(pkg), tenants=3)
    for _ in range(2):
        probs = rng.rand(3, 16, 4).astype(np.float32)
        probs /= probs.sum(-1, keepdims=True)
        cohort(*conv(probs, rng.randint(4, size=(3, 16))))
    cohort.compute()
    cohort.compute()


def _host_sync(pkg, conv):
    m = pkg.Accuracy(**({"device": CPU} if pkg is tm else {}))
    m.dist_sync_fn = lambda x, group=None: [x]
    m.update(*conv(*_cls_batch(n=48)))
    m.compute()


@pytest.mark.parametrize(
    "scenario", [_eager_steps, _compiled_steps, _two_signatures, _cohort_steps, _host_sync],
    ids=["eager", "compiled", "two_signatures", "cohort", "host_sync"],
)
def test_span_sequences_match_jax(scenario):
    jax_spans, port_spans = _traced_both(scenario)
    assert port_spans, "the port recorded no span"
    assert port_spans == jax_spans
