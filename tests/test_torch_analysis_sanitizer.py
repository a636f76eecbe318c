"""MetricSan of the port against the JAX package's, on the CPU.

Every case of ``tests/analysis/test_sanitizer.py`` is mirrored under its own
name: healthy runs stay silent, each injected fault produces exactly one
flight dump naming the rule it refutes, and arming/disarming is fully
reversible (the unarmed library is bit-for-bit the code that shipped).
``test_sanitizer_verdicts_equal_jax`` then runs the same scenarios, on the
same seeded numpy inputs, through both packages' ``san_scope`` and holds
the lists of ``(rule, check, subject)`` equal. The healthy-run-zero cases
at the end cover the write sites only the port has.

One deliberate difference shapes the use-after-donate case: the port
donates nothing (every state is copied into the graph's buffers and cloned
out) and its ``reset()`` clones the defaults, so the injector frees the
registered defaults the step read (``form="free"``), and the canary looks
for dead storage where the JAX package asks ``is_deleted()``. Its graph
form needs the card (``tests/test_torch_cuda.py``).

The sanitizer is process-global: every case leaves both packages disarmed.
"""
import glob
import json
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu_torch as M
from metrics_tpu_torch.analysis import concurrency as _conc
from metrics_tpu_torch.analysis import fixtures as fx
from metrics_tpu_torch.analysis import register_threadsan_target, san_scope
from metrics_tpu_torch.analysis.sanitizer import MetricSanError, disable_san, enable_san
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.observability import flight as _flight
from metrics_tpu_torch.reliability import faultinject as fi
from metrics_tpu_torch.utilities import env as _env

CPU = "cpu"
_NP_X = np.linspace(0.0, 1.0, 8, dtype=np.float32)
_X = torch.as_tensor(_NP_X)


def _dumps(directory):
    return sorted(glob.glob(os.path.join(str(directory), "flight-*.json")))


@pytest.fixture(autouse=True)
def _pristine_hooks():
    """Every test leaves the library disarmed with zero wrapper residue."""
    yield
    disable_san()
    assert "__setattr__" not in Metric.__dict__
    assert not _env.san_enabled()


# ---------------------------------------------------------------------------
# healthy code under the armed sanitizer: silence
# ---------------------------------------------------------------------------
def test_healthy_eager_and_compiled_runs_produce_zero_violations(tmp_path):
    with _flight.flight_scope(tmp_path):
        with san_scope() as san:
            m = M.MeanSquaredError(device=CPU)
            for _ in range(3):
                m(_X, _X)
            m.compute()
            m.reset()
            engine = M.CompiledStepEngine(M.MeanSquaredError(device=CPU))
            for _ in range(3):
                engine.step(_X, _X)
            col = M.MetricCollection(
                {"mse": M.MeanSquaredError(device=CPU), "mae": M.MeanAbsoluteError(device=CPU)},
                compiled=True,
            )
            col(_X, _X)
    assert san.violations == []
    assert _dumps(tmp_path) == []


def test_healthy_quantized_tier_under_san_is_clean(tmp_path):
    """Residual seeding, sync-stream restores, and tier bookkeeping are
    sanctioned lifecycle writes — the interceptor must not flag them."""
    with _flight.flight_scope(tmp_path):
        with san_scope() as san:
            m = M.MeanSquaredError(device=CPU)
            m.set_sync_precision("int8")
            for _ in range(2):
                m(_X, _X)
            m.compute()
            m.astype(torch.float32)
            sd = m.state_dict()
            m.load_state_dict(sd)
    assert san.violations == []
    assert _dumps(tmp_path) == []


def test_checkpoint_roundtrip_and_guard_under_san_is_clean(tmp_path):
    from metrics_tpu_torch.reliability import guard_scope

    with _flight.flight_scope(tmp_path):
        with san_scope() as san:
            with guard_scope("warn"):
                m = M.MeanSquaredError(device=CPU)
                m(_X, _X)
            m.persistent(True)
            state = m.state_dict()
            m2 = M.MeanSquaredError(device=CPU)
            m2.load_state_dict(state)
    assert san.violations == []
    assert _dumps(tmp_path) == []


# ---------------------------------------------------------------------------
# injected faults: exactly one dump each, naming the rule
# ---------------------------------------------------------------------------
def test_compute_mutation_dumps_exactly_once_naming_mta006(tmp_path):
    with _flight.flight_scope(tmp_path):
        with san_scope() as san:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                bad = fx.ComputeMutatesState(device=CPU)
                bad.update(_X)
                bad.compute()
                bad.compute()  # second offence: deduped, still one dump
    assert [v["rule"] for v in san.violations] == ["MTA006"]
    dumps = _dumps(tmp_path)
    assert len(dumps) == 1
    payload = json.loads(open(dumps[0]).read())
    assert payload["reason"] == "metricsan_state_write_outside_update"
    assert "MTA006" in payload["hint"]
    assert payload["context"]["rule"] == "MTA006"


def test_non_identity_reset_dumps_exactly_once_naming_mta006(tmp_path):
    with _flight.flight_scope(tmp_path):
        with san_scope() as san:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                bad = fx.NonIdentityReset(device=CPU)
                bad.reset()
                bad.reset()  # identity probe runs once per class/state
    assert [v["rule"] for v in san.violations] == ["MTA006"]
    dumps = _dumps(tmp_path)
    assert len(dumps) == 1
    payload = json.loads(open(dumps[0]).read())
    assert payload["reason"] == "metricsan_non_identity_reset"
    assert "MTA006" in payload["hint"] and "identity" in payload["hint"]


class _FusedNonIdentityReset(fx.NonIdentityReset):
    _fused_forward = True  # engine-eligible: its resets run inside the step


def test_reset_probe_skips_engine_steps_and_traces_without_losing_the_class(tmp_path):
    """The resets inside a compiled step (value checks off, as in a build on
    the card) and inside an FX trace are not probed and leave the class
    unprobed: the first concrete ``reset()`` still reports its one MTA006."""
    from metrics_tpu_torch.engine import fake_trace

    with _flight.flight_scope(tmp_path):
        with san_scope() as san:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                col = M.MetricCollection({"bad": _FusedNonIdentityReset(device=CPU)}, compiled=True)
                for _ in range(3):
                    col(_X)
                probe = _FusedNonIdentityReset(device=CPU)
                fake_trace(lambda v: (probe.reset(), probe.acc + v.sum())[1], (_X,))
                assert col._engine.trace_count == 1 and san.violations == []
                col.reset()
    assert [(v["rule"], v["subject"]) for v in san.violations] == [("MTA006", "_FusedNonIdentityReset.acc")]
    assert len(_dumps(tmp_path)) == 1


def test_use_after_donate_dumps_exactly_once_naming_mta007(tmp_path):
    """The donation_unsafe_engine injector frees the registered defaults
    the step read, as a dispatch that consumed them without the clone would
    (the port donates nothing, so the hazard is otherwise invisible) — the
    canary must catch the dead storage."""
    with _flight.flight_scope(tmp_path):
        with san_scope() as san:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                m = M.MeanSquaredError(device=CPU)
                engine = M.CompiledStepEngine(m)
                engine.step(_X, _X)  # warm: build + write back fresh states
                m.reset()
                with fi.donation_unsafe_engine():
                    # cache hit: no rebuild; the unsafe dispatch frees the
                    # defaults the step read in place
                    engine.step(_X, _X)
    rules = {v["rule"] for v in san.violations}
    assert rules == {"MTA007"}
    dumps = _dumps(tmp_path)
    assert len(dumps) == 1
    payload = json.loads(open(dumps[0]).read())
    assert payload["reason"] == "metricsan_use_after_donate"
    assert "MTA007" in payload["hint"] and "donated" in payload["hint"]


def test_external_state_poke_is_flagged(tmp_path):
    with _flight.flight_scope(tmp_path):
        with san_scope() as san:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                m = M.MeanSquaredError(device=CPU)
                m.total = torch.tensor(99)  # user code poking state
    assert [v["rule"] for v in san.violations] == ["MTA006"]
    assert len(_dumps(tmp_path)) == 1


class DoublingSync(Metric):
    """A gather→reduce composite that is no identity at world size 1."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("acc", default=torch.zeros(()), dist_reduce_fx=lambda stacked: stacked.sum(0) * 2.0)

    def update(self, x):
        self.acc = self.acc + torch.sum(x)

    def compute(self):
        return self.acc


def test_single_replica_sync_drift_names_mta005(tmp_path):
    """A gather→reduce composite that is not an identity at world size 1
    (here: a doubling reduction) is caught on the cheapest mesh."""
    with _flight.flight_scope(tmp_path):
        with san_scope() as san:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                m = DoublingSync(device=CPU)
                m.update(_X)
                m._sync_dist()  # the single-process backend: world size 1
    assert [v["rule"] for v in san.violations] == ["MTA005"]
    payload = json.loads(open(_dumps(tmp_path)[0]).read())
    assert payload["reason"] == "metricsan_single_replica_sync_drift"
    assert "MTA005" in payload["hint"]


def test_healthy_single_replica_sync_is_identity(tmp_path):
    with _flight.flight_scope(tmp_path):
        with san_scope() as san:
            m = M.MeanSquaredError(device=CPU)
            m.update(_X, _X)
            m._sync_dist()
    assert san.violations == []
    assert _dumps(tmp_path) == []


# ---------------------------------------------------------------------------
# ThreadSan — the MTL106 dynamic twin
# ---------------------------------------------------------------------------
def _unregister(cls):
    with _conc._TARGET_LOCK:
        _conc._EXTRA_TARGETS[:] = [t for t in _conc._EXTRA_TARGETS if t[0] is not cls]


@pytest.fixture()
def _threadsan_counter():
    register_threadsan_target(fx.UnlockedSharedCounter, ("value",), "_lock")
    yield fx.UnlockedSharedCounter
    _unregister(fx.UnlockedSharedCounter)


def test_thread_race_dumps_exactly_once_naming_mtl106(tmp_path, _threadsan_counter):
    """The UnlockedSharedCounter drill: the worker thread and the owner
    thread both write `value` lock-free — one violation, one flight dump,
    named after the static rule that predicted it. Deterministic: the
    worker joins before the owner writes."""
    with _flight.flight_scope(tmp_path):
        with san_scope() as san:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                c = fx.UnlockedSharedCounter()
                c.spin(3)  # worker thread writes, unlocked
                c.bump()  # owner thread writes, unlocked: the race
                c.bump()  # second offence: deduped, still one dump
    assert [v["rule"] for v in san.violations] == ["MTL106"]
    assert san.violations[0]["subject"] == "UnlockedSharedCounter.value"
    dumps = _dumps(tmp_path)
    assert len(dumps) == 1
    payload = json.loads(open(dumps[0]).read())
    assert payload["reason"] == "metricsan_thread_race"
    assert "MTL106" in payload["hint"] and "thread-shared-state" in payload["hint"]


def test_thread_race_counter_matches_deduped_dumps(tmp_path, _threadsan_counter):
    """`san.thread.races` counts once per deduped dump (the documented
    1:1 contract), not once per racy write observed."""
    from metrics_tpu_torch import observability as obs

    with obs.telemetry_scope() as tel:
        before = tel.counters.get("san.thread.races", 0)
        with _flight.flight_scope(tmp_path):
            with san_scope() as san:
                c = fx.UnlockedSharedCounter()
                c.spin(3)
                for _ in range(5):
                    c.bump()  # five racy writes, ONE (class, attr) violation
        assert len(san.violations) == 1
        assert tel.counters.get("san.thread.races", 0) - before == 1
    assert len(_dumps(tmp_path)) == 1


def test_instrumentation_preserves_inherited_custom_setattr(tmp_path):
    """A watched class that INHERITS a custom __setattr__ must keep it
    while armed — arming may observe writes, never change them."""

    class _Base:
        def __setattr__(self, name, value):
            object.__setattr__(self, name, ("tracked", value))

    class _Child(_Base):
        def __init__(self):
            object.__setattr__(self, "_lock", threading.Lock())

    register_threadsan_target(_Child, ("value",), "_lock")
    try:
        unarmed = _Child()
        unarmed.value = 0
        assert unarmed.value == ("tracked", 0)
        with san_scope() as san:
            armed = _Child()
            armed.value = 0
            assert armed.value == ("tracked", 0)  # base logic still runs
        assert san.violations == []
        disarmed = _Child()
        disarmed.value = 1
        assert disarmed.value == ("tracked", 1)
    finally:
        _unregister(_Child)


class _Locked:
    """The healthy counterpart of UnlockedSharedCounter: every write holds
    the owning lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def spin(self):
        t = threading.Thread(target=self._worker, daemon=True)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()

    def _worker(self):
        with self._lock:
            self.value += 1

    def bump(self):
        with self._lock:
            self.value += 1


def test_locked_cross_thread_writes_stay_silent(tmp_path):
    """Both sides write under the owning lock — zero violations, zero
    dumps (a held Lock reads as synchronized)."""
    register_threadsan_target(_Locked, ("value",), "_lock")
    try:
        with _flight.flight_scope(tmp_path):
            with san_scope() as san:
                c = _Locked()
                c.spin()
                c.bump()
    finally:
        _unregister(_Locked)
    assert san.violations == []
    assert _dumps(tmp_path) == []


def test_single_owner_handoff_is_not_a_race(tmp_path, _threadsan_counter):
    """Construct on the main thread, then hand the attr to ONE worker
    that is its sole writer afterwards: the first cross-thread transition
    is an ownership handoff, not a race."""
    with _flight.flight_scope(tmp_path):
        with san_scope() as san:
            c = fx.UnlockedSharedCounter()  # __init__ writes on main
            c.spin(5)  # after the handoff, only the worker writes
    assert san.violations == []
    assert _dumps(tmp_path) == []


def test_thread_write_map_prunes_collected_objects(_threadsan_counter):
    """ThreadSan's per-instance write history dies with the instance."""
    import gc

    with san_scope() as san:
        c = fx.UnlockedSharedCounter()
        c.bump()
        oid = id(c)
        assert any(k[0] == oid for k in san._thread_writes)
        del c
        gc.collect()
        assert not any(k[0] == oid for k in san._thread_writes)
        assert oid not in san._thread_live


def test_single_thread_writes_never_race(tmp_path, _threadsan_counter):
    """One owning thread writing lock-free is not a race."""
    with _flight.flight_scope(tmp_path):
        with san_scope() as san:
            c = fx.UnlockedSharedCounter()
            for _ in range(5):
                c.bump()
    assert san.violations == []
    assert _dumps(tmp_path) == []


def test_threadsan_disarm_restores_uninstrumented_classes(_threadsan_counter):
    """Arm/disarm reversibility extends to ThreadSan: the instrumented
    `__setattr__` is fully removed, and writes afterwards are plain."""
    disable_san()  # start disarmed even under env arming
    with san_scope():
        assert "__setattr__" in fx.UnlockedSharedCounter.__dict__
    assert "__setattr__" not in fx.UnlockedSharedCounter.__dict__
    c = fx.UnlockedSharedCounter()
    c.spin(2)
    c.bump()  # disarmed: the (still broken) fixture runs unobserved
    assert c.value == 3


# ---------------------------------------------------------------------------
# arming semantics
# ---------------------------------------------------------------------------
def test_raise_mode_raises_metricsan_error():
    with san_scope(raise_on_violation=True):
        m = M.MeanSquaredError(device=CPU)
        with pytest.raises(MetricSanError, match="MTA006"):
            m.total = torch.tensor(1)


def test_disarmed_library_pays_nothing_and_stays_silent(tmp_path):
    """Off = off: no interceptor installed, no dumps, direct state pokes
    behave exactly as before the sanitizer existed."""
    assert "__setattr__" not in Metric.__dict__
    with _flight.flight_scope(tmp_path):
        m = M.MeanSquaredError(device=CPU)
        m.total = torch.tensor(5)
        assert int(m.total) == 5
    assert _dumps(tmp_path) == []


def test_san_scope_restores_prior_armed_state():
    outer = enable_san()
    try:
        with san_scope() as inner:
            assert inner is not outer
            assert _env.san_enabled()
        # the outer arming survives the inner scope's exit
        assert _env.san_enabled()
        assert "__setattr__" in Metric.__dict__
    finally:
        disable_san()
    assert not _env.san_enabled()


def test_env_flag_arms_at_refresh(monkeypatch):
    monkeypatch.setenv("METRICS_TPU_SAN", "1")
    flags = _env.refresh()
    assert flags["san"] is True and _env.san_requested()
    monkeypatch.delenv("METRICS_TPU_SAN")
    _env.refresh()
    assert not _env.san_requested()


def test_results_bit_identical_with_and_without_san():
    m1, m2 = M.MeanSquaredError(device=CPU), M.MeanSquaredError(device=CPU)
    v1 = m1(_X, _X * 0.5)
    with san_scope():
        v2 = m2(_X, _X * 0.5)
    assert torch.equal(v1, v2)
    assert torch.equal(m1.compute(), m2.compute())


def test_non_weakrefable_watched_objects_are_silently_untracked(tmp_path):
    """A __slots__ class (no __weakref__) cannot have its lifetime
    tracked, so ThreadSan records NO history for it."""

    class _Slotted:
        __slots__ = ("value", "_lock")

        def __init__(self):
            self._lock = threading.Lock()
            self.value = 0

    register_threadsan_target(_Slotted, ("value",), "_lock")
    try:
        with _flight.flight_scope(tmp_path):
            with san_scope() as san:
                s = _Slotted()
                t = threading.Thread(target=lambda: setattr(s, "value", 1))
                t.start()
                t.join(timeout=10)
                assert not t.is_alive()
                s.value = 2
                s.value = 3  # would be transition 2 if history were kept
        assert san.violations == []
        assert san._thread_writes == {} and san._thread_live == {}
    finally:
        _unregister(_Slotted)
    assert _dumps(tmp_path) == []


# ---------------------------------------------------------------------------
# parity: the same scenarios through both packages' sanitizers
# ---------------------------------------------------------------------------
def _scenario(pkg, name):
    """Run one scenario on package ``pkg`` ("jax" or "torch") under its own
    ``san_scope``; returns the sorted ``(rule, check, subject)`` list."""
    if pkg == "jax":
        import jax.numpy as jnp

        import metrics_tpu as P
        from metrics_tpu.analysis import fixtures as pfx
        from metrics_tpu.analysis import register_threadsan_target as register
        from metrics_tpu.analysis import san_scope as scope
        from metrics_tpu.analysis.concurrency import _EXTRA_TARGETS, _TARGET_LOCK
        from metrics_tpu.metric import Metric as Base
        from metrics_tpu.reliability import faultinject as pfi

        kw = {}
        arr = jnp.asarray
        zeros = jnp.zeros
    else:
        P, pfx, register, scope, pfi, Base = M, fx, register_threadsan_target, san_scope, fi, Metric
        _EXTRA_TARGETS, _TARGET_LOCK = _conc._EXTRA_TARGETS, _conc._TARGET_LOCK
        kw = {"device": CPU}
        arr = torch.as_tensor
        zeros = torch.zeros

    rng = np.random.RandomState(7)
    preds, target = rng.rand(2, 8).astype(np.float32)
    x, y = arr(preds), arr(target)

    class DoublingSync(Base):
        def __init__(self):
            super().__init__(**kw)
            self.add_state("acc", default=zeros(()), dist_reduce_fx=lambda stacked: stacked.sum(0) * 2.0)

        def update(self, v):
            self.acc = self.acc + v.sum()

        def compute(self):
            return self.acc

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with scope() as san:
            if name == "compute_mutation":
                m = pfx.ComputeMutatesState(**kw)
                m.update(x)
                m.compute()
                m.compute()
            elif name == "non_identity_reset":
                m = pfx.NonIdentityReset(**kw)
                m.reset()
                m.reset()
            elif name == "external_poke":
                m = P.MeanSquaredError(**kw)
                m(x, y)
                m.sum_squared_error = arr(np.float32(1.0))
            elif name == "single_replica_drift":
                m = DoublingSync()
                m.update(x)
                m._sync_dist()
            elif name == "thread_race":
                register(pfx.UnlockedSharedCounter, ("value",), "_lock")
                try:
                    c = pfx.UnlockedSharedCounter()
                    c.spin(3)
                    c.bump()
                    c.bump()
                finally:
                    with _TARGET_LOCK:
                        _EXTRA_TARGETS[:] = [t for t in _EXTRA_TARGETS if t[0] is not pfx.UnlockedSharedCounter]
            elif name == "use_after_donate":
                m = P.MeanSquaredError(**kw)
                engine = P.CompiledStepEngine(m)
                engine.step(x, y)
                m.reset()
                with pfi.donation_unsafe_engine():
                    engine.step(x, y)
            elif name == "healthy_eager":
                m = P.MeanSquaredError(**kw)
                for _ in range(3):
                    m(x, y)
                m.compute()
                m.reset()
            elif name == "healthy_compiled":
                col = P.MetricCollection(
                    {"mse": P.MeanSquaredError(**kw), "mae": P.MeanAbsoluteError(**kw)}, compiled=True
                )
                for _ in range(3):
                    col(x, y)
                col.compute()
            elif name == "healthy_cohort":
                cohort = P.MetricCohort(P.MetricCollection([P.MeanSquaredError(**kw)]), tenants=2)
                stacked = rng.rand(2, 2, 8).astype(np.float32)
                cohort(arr(stacked[0]), arr(stacked[1]))
                cohort.compute()
                cohort.tenant_collection(1).compute()
    return sorted((v["rule"], v["check"], v["subject"]) for v in san.violations)


_SCENARIOS = {
    "compute_mutation": [("MTA006", "state_write_outside_update", "ComputeMutatesState.total")],
    "non_identity_reset": [("MTA006", "non_identity_reset", "NonIdentityReset.acc")],
    "external_poke": [("MTA006", "state_write_outside_update", "MeanSquaredError.sum_squared_error")],
    "single_replica_drift": [("MTA005", "single_replica_sync_drift", "DoublingSync.acc")],
    "thread_race": [("MTL106", "thread_race", "UnlockedSharedCounter.value")],
    "use_after_donate": [("MTA007", "use_after_donate", "MeanSquaredError")],
    "healthy_eager": [],
    "healthy_compiled": [],
    "healthy_cohort": [],
}


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_sanitizer_verdicts_equal_jax(name):
    """One scenario through JAX's ``san_scope`` and the port's, on the same
    seeded numpy inputs: the same ``(rule, check, subject)`` list, which is
    the one the scenario is built to produce."""
    from metrics_tpu.analysis.sanitizer import disable_san as jax_disable_san

    try:
        jax_verdicts = _scenario("jax", name)
    finally:
        jax_disable_san()
    assert _scenario("torch", name) == jax_verdicts == _SCENARIOS[name]


# ---------------------------------------------------------------------------
# healthy-run zero over the write sites only the port has
# ---------------------------------------------------------------------------
def _rows(rng, tenants, n=16):
    return (
        torch.as_tensor(rng.rand(tenants, n).astype(np.float32)),
        torch.as_tensor(rng.rand(tenants, n).astype(np.float32)),
    )


def test_async_serving_worker_writes_are_sanctioned(tmp_path):
    """An ``AsyncServingEngine`` steps a compiled collection on its worker
    thread: the write-back there is a lifecycle write (the allow depth is
    thread-local), and the pipeline's thread-shared attributes race
    nowhere."""
    from metrics_tpu_torch import observability as obs
    from metrics_tpu_torch.serving import AsyncServingEngine

    rng = np.random.RandomState(0)
    with obs.telemetry_scope() as tel, _flight.flight_scope(tmp_path):
        # the registry is process-global and a scope does not clear it:
        # pin the delta this healthy run contributes
        races0 = tel.counters.get("san.thread.races", 0)
        with san_scope() as san:
            col = M.MetricCollection(
                {"mse": M.MeanSquaredError(device=CPU), "mae": M.MeanAbsoluteError(device=CPU)}, compiled=True
            )
            assert tel.gauges.get("san.thread.watched_attrs", 0) > 0
            pipe = AsyncServingEngine(col)
            try:
                for _ in range(6):
                    p, t = _rows(rng, 1)
                    pipe.forward(p[0], t[0])
                pipe.drain()
                col.compute()
            finally:
                pipe.close()
    assert san.violations == []
    assert _dumps(tmp_path) == []
    assert tel.counters.get("san.thread.races", 0) == races0


def test_cohort_forward_slots_and_guard_verdicts_are_sanctioned(tmp_path):
    """A cohort's partial wave (``forward_slots``) and its guard epilogue
    (``_apply_guard_verdicts`` with a quarantined tenant) under the armed
    sanitizer: no violation, and only the guard's own dump."""
    from metrics_tpu_torch.reliability import guard_scope

    rng = np.random.RandomState(1)
    with _flight.flight_scope(tmp_path):
        with san_scope() as san:
            cohort = M.MetricCohort(
                M.MetricCollection([M.MeanSquaredError(device=CPU), M.MeanAbsoluteError(device=CPU)]), tenants=4
            )
            cohort(*_rows(rng, 4))
            cohort.forward_slots([1, 3], *_rows(rng, 2))
            p, t = _rows(rng, 4)
            p[2, 0] = float("nan")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                with guard_scope("quarantine"):
                    cohort(p, t)
            cohort.compute()
    assert san.violations == []
    assert {json.loads(open(d).read())["reason"] for d in _dumps(tmp_path)} <= {"state_guard_quarantine"}


class _SlowSum(Metric):
    """A sum whose update can be made to stall (an EvalSession's deadline
    then abandons the step and restores the pre-step snapshot)."""

    stall_s = 0.0

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x):
        if self.stall_s:
            time.sleep(self.stall_s)
        self.total = self.total + x.sum()

    def compute(self):
        return self.total


def test_engine_guard_rollback_and_session_restore_are_sanctioned(tmp_path):
    """The compiled step's guard verdicts (``_apply_guard_verdicts``), the
    eager guard's rollback to the last-good snapshot (``guard.py``) and an
    ``EvalSession``'s restore after a step past its deadline
    (``session.py``'s ``_restore``) are lifecycle writes."""
    from metrics_tpu_torch.reliability import EvalSession, SessionStepTimeoutError, guard_scope

    rng = np.random.RandomState(2)
    p, t = _rows(rng, 1)
    bad = p[0].clone()
    bad[3] = float("inf")
    with _flight.flight_scope(tmp_path / "dumps"):
        with san_scope() as san:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                col = M.MetricCollection({"mse": M.MeanSquaredError(device=CPU)}, compiled=True)
                eager = M.MeanSquaredError(device=CPU)
                with guard_scope("quarantine") as guard:
                    col(p[0], t[0])
                    col(bad, t[0])
                    eager(p[0], t[0])
                    eager(bad, t[0])
                assert guard.stats["quarantined"] == 2
                slow = _SlowSum(device=CPU)
                session = EvalSession(slow, str(tmp_path / "journal"), step_deadline_s=0.2)
                session.step(0, p[0])
                slow.stall_s = 1.0
                with pytest.raises(SessionStepTimeoutError):
                    session.step(1, p[0])
                time.sleep(1.2)  # the abandoned worker finishes its (sanctioned) update
    assert san.violations == []


def test_hierarchical_sync_and_fleet_adoption_are_sanctioned(tmp_path):
    """The two-level sync (``_sync_dist_hierarchical`` under the wrapped
    ``_sync_dist``) and the fleet's ``adopt_into`` of a tenant envelope
    write registered states in sanctioned contexts only."""
    from metrics_tpu_torch.fleet.migration import adopt_into, tenant_envelope
    from metrics_tpu_torch.parallel.hierarchy import reset_quorum
    from metrics_tpu_torch.reliability import faultinject

    rng = np.random.RandomState(3)
    with _flight.flight_scope(tmp_path):
        with san_scope() as san:
            m = M.MeanSquaredError(device=CPU)
            p, t = _rows(rng, 1)
            m.update(p[0], t[0])
            try:
                with faultinject.simulated_pods(2, 2):
                    m.compute()
            finally:
                reset_quorum()  # the exchange's membership is process state a scrape renders
            src = M.MeanSquaredError(device=CPU)
            src.update(p[0], t[0])
            dst = M.MeanSquaredError(device=CPU)
            adopt_into(dst, tenant_envelope(src, 5, cursor=1))
            assert torch.equal(dst.compute(), src.compute())
    assert san.violations == []
    assert _dumps(tmp_path) == []
