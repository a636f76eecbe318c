"""The port's ``StateGuard`` against the JAX package's, on the CPU.

Every case of ``tests/reliability/test_state_guard.py`` is mirrored, the
compiled ones with ``compiled=True`` as well as eagerly: the same seeded
numpy batches, poisoned the same way, go through the JAX package's
collection under a guard and through the port's, and the port must end where
a run that never saw the poisoned batch ends (quarantine), raise with its
state usable (raise) or keep the NaN (warn), with the guard's ``stats`` and
the telemetry counters equal to JAX's. On the CPU the port's compiled
collection runs the step engine's step function directly: the same function
the card captures into its CUDA graph, the guard's finite flags and
``torch.where`` rollback included. Beyond those: a 16-tenant cohort with 3
poisoned tenants, where only those roll back, per tenant, as in JAX's cohort.

Tolerance: none for states, counts, stats and the guarded-against-clean
comparison (bit-equal: a rolled-back batch leaves the exact prior bits);
port values against JAX's within rtol 1e-5 (their own float32 sums).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.observability as jobs
import metrics_tpu_torch as tm
import metrics_tpu_torch.observability as obs
from metrics_tpu import reliability as jrel
from metrics_tpu.reliability import faultinject as jfi
from metrics_tpu_torch import reliability
from metrics_tpu_torch.reliability import NonFiniteStateError
from metrics_tpu_torch.reliability import faultinject as fi
from metrics_tpu_torch.reliability.guard import StateGuard, active, install_guard, uninstall_guard

CPU = "cpu"


@pytest.fixture(autouse=True)
def _pristine():
    def clean():
        for pkg in (jobs, obs):
            pkg.disable()
            pkg.get().reset()
            pkg.disable_flight()
        uninstall_guard()
        jrel.uninstall_guard()

    clean()
    yield
    clean()


def _batches(n=4, size=64, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(size).astype(np.float32), rng.rand(size).astype(np.float32)) for _ in range(n)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _reg(compiled, jax_side=False):
    if jax_side:
        return jm.MetricCollection([jm.MeanSquaredError(), jm.MeanAbsoluteError()], compiled=compiled)
    return tm.MetricCollection([tm.MeanSquaredError(device=CPU), tm.MeanAbsoluteError(device=CPU)], compiled=compiled)


def _states(col):
    return {(k, s): getattr(m, s).clone() for k, m in col.items() for s in m._defaults}


def test_policy_validation_and_install_cycle():
    with pytest.raises(ValueError, match="policy"):
        StateGuard("explode")
    assert active() is None
    g = install_guard("warn")
    assert active() is g and g.policy == "warn"
    uninstall_guard()
    assert active() is None
    with reliability.guard_scope("quarantine") as g2:
        assert active() is g2
    assert active() is None


@pytest.mark.parametrize("mode", ["nan", "inf"])
@pytest.mark.parametrize("compiled", [False, True])
def test_quarantine_recovers_last_good_state(mode, compiled):
    """The final states with a quarantined poisoned batch are bit-equal to a
    run that never saw it; the stats and counters equal JAX's."""
    batches = _batches()
    clean = _reg(compiled)
    for p, t in batches:
        clean(_t(p), _t(t))

    results = {}
    for pkg, side in (("port", False), ("jax", True)):
        chaotic = _reg(compiled, jax_side=side)
        rel, telemetry, conv = (jrel, jobs, jnp.asarray) if side else (reliability, obs, _t)
        poison = jfi.poison if side else fi.poison
        with telemetry.telemetry_scope(), rel.guard_scope("quarantine") as guard:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                for i, (p, t) in enumerate(batches):
                    chaotic(conv(p), conv(t))
                    if i == 1:
                        chaotic(poison(conv(p), mode), conv(t))
            values = {k: float(v) for k, v in chaotic.compute().items()}
            counters = dict(telemetry.get().counters)
            events = [e["kind"] for e in telemetry.get().events]
        results[pkg] = (chaotic, values, dict(guard.stats), counters, events)
    chaotic, values, stats, counters, events = results["port"]
    want = _states(clean)
    for key, v in _states(chaotic).items():
        assert torch.equal(v, want[key]), key
    assert values == {k: float(v) for k, v in clean.compute().items()}
    assert stats["quarantined"] == 2 == results["jax"][2]["quarantined"]
    assert counters["reliability.quarantined"] == 2 == results["jax"][3]["reliability.quarantined"]
    assert "nonfinite_state" in events and "nonfinite_state" in results["jax"][4]
    for k, v in results["jax"][1].items():
        assert values[k] == pytest.approx(v, rel=1e-5)


@pytest.mark.parametrize("compiled", [False, True])
def test_raise_policy_fails_fast_with_usable_state(compiled):
    batches = _batches(2)
    col = tm.MetricCollection([tm.MeanSquaredError(device=CPU)], compiled=compiled)
    col(*map(_t, batches[0]))
    before = _states(col)
    with reliability.guard_scope("raise"):
        with pytest.raises(NonFiniteStateError):
            col(fi.poison(_t(batches[1][0]), "nan"), _t(batches[1][1]))
    for key, v in _states(col).items():
        assert torch.equal(v, before[key]), key  # the poisoned batch rolled back
    col(*map(_t, batches[1]))
    assert int(col["MeanSquaredError"].total) == 128
    jcol = jm.MetricCollection([jm.MeanSquaredError()], compiled=compiled)
    jcol(*map(jnp.asarray, batches[0]))
    with jrel.guard_scope("raise"):
        with pytest.raises(jrel.NonFiniteStateError):
            jcol(jfi.poison(jnp.asarray(batches[1][0]), "nan"), jnp.asarray(batches[1][1]))


@pytest.mark.parametrize("compiled", [False, True])
def test_warn_policy_keeps_poisoned_state_but_warns_once(compiled):
    batches = _batches(2)
    col = tm.MetricCollection([tm.MeanSquaredError(device=CPU)], compiled=compiled)
    col(*map(_t, batches[0]))
    with reliability.guard_scope("warn") as guard:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            col(fi.poison(_t(batches[1][0]), "nan"), _t(batches[1][1]))
            col(fi.poison(_t(batches[1][0]), "nan"), _t(batches[1][1]))
    assert bool(torch.isnan(col.compute()["MeanSquaredError"]))
    assert guard.stats["violations"] >= 2
    assert guard.stats["quarantined"] == 0
    assert len([w for w in caught if "StateGuard" in str(w.message)]) <= 1


def test_direct_update_path_is_guarded():
    m = tm.MeanSquaredError(device=CPU)
    p = _t(np.random.RandomState(0).rand(32).astype(np.float32))
    m.update(p, p)
    with reliability.guard_scope("quarantine") as guard:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m.update(fi.poison(p, "inf"), p)
    assert guard.stats["quarantined"] == 1
    assert int(m.total) == 32


def test_nonfinite_updates_injector_restores_update():
    m = tm.MeanSquaredError(device=CPU)
    orig_update = m.update
    p = _t(np.random.RandomState(0).rand(16).astype(np.float32))
    with fi.nonfinite_updates(m, times=1) as injected:
        m.update(p, p)
    assert injected["count"] == 1
    assert m.update is orig_update
    assert bool(torch.isnan(m.sum_squared_error))


def test_integer_state_metrics_pass_the_guard():
    rng = np.random.RandomState(0)
    probs = rng.rand(32, 4).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    with reliability.guard_scope("raise") as guard:
        m = tm.ConfusionMatrix(num_classes=4, device=CPU)
        m(_t(probs), _t(rng.randint(4, size=32)))
    assert guard.stats["violations"] == 0


def test_engine_guard_toggle_does_not_corrupt_cache():
    """Guard on, off, on: two graphs (signatures), and the unguarded one is
    never served to a guarded step or the other way round, as in JAX."""
    p = np.random.RandomState(0).rand(64).astype(np.float32)
    infos = []
    for side in (False, True):
        if side:
            col = jm.MetricCollection([jm.MeanSquaredError()], compiled=True)
        else:
            col = tm.MetricCollection([tm.MeanSquaredError(device=CPU)], compiled=True)
        x = jnp.asarray(p) if side else _t(p)
        rel = jrel if side else reliability
        col(x, x)
        with rel.guard_scope("quarantine"):
            col(x, x)
        col(x, x)
        info = col._engine.cache_info()
        infos.append((info["compiled_signatures"], info["trace_count"], int(col["MeanSquaredError"].total)))
    assert infos[0] == infos[1] == (2, 2, 3 * 64)


def test_engine_dispatch_failure_with_guard_demotes_and_preserves_state():
    p = _t(np.random.RandomState(0).rand(32).astype(np.float32))
    col = tm.MetricCollection([tm.MeanSquaredError(device=CPU)], compiled=True)
    col(p, p)
    with obs.telemetry_scope(), reliability.guard_scope("quarantine"):
        with fi.failing_engine_compile(times=1):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                col(p, p)
        assert obs.get().counters.get("reliability.engine_dispatch_recoveries") == 1
    assert col.eager_fallbacks
    assert int(col["MeanSquaredError"].total) == 64
    col(p, p)
    assert int(col["MeanSquaredError"].total) == 96


def test_fused_forward_merge_overflow_is_quarantined():
    m = tm.MeanSquaredError(device=CPU)
    a = torch.tensor([np.float32(np.sqrt(3.0e38))], dtype=torch.float32)
    zero = torch.zeros(1)
    m(a, zero)
    assert bool(torch.isfinite(m.sum_squared_error))
    before = m.sum_squared_error.clone()
    with reliability.guard_scope("quarantine") as guard:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m(a, zero)  # the merge overflows
    assert guard.stats["quarantined"] >= 1
    assert torch.equal(m.sum_squared_error, before)


def test_fused_forward_merge_overflow_is_quarantined_in_the_compiled_step():
    """The compiled step checks the MERGED states too: a finite batch whose
    merge overflows is rolled back inside the step."""
    col = tm.MetricCollection([tm.MeanSquaredError(device=CPU)], compiled=True)
    a = torch.tensor([np.float32(np.sqrt(3.0e38))], dtype=torch.float32)
    zero = torch.zeros(1)
    col(a, zero)
    before = _states(col)
    with reliability.guard_scope("quarantine") as guard:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            col(a, zero)
    assert guard.stats["quarantined"] == 1
    for key, v in _states(col).items():
        assert torch.equal(v, before[key]), key


def test_quarantine_rolls_back_list_state_metrics():
    rng = np.random.RandomState(7)
    p, t = _t(rng.rand(32).astype(np.float32)), _t(rng.randint(2, size=32))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = tm.AUROC(device=CPU)
        m.update(p, t)
        want = float(m.compute())
        with reliability.guard_scope("quarantine") as guard:
            m.update(fi.poison(p, "nan"), t)
    assert guard.stats["quarantined"] == 1
    assert len(m.preds) == 1
    assert float(m.compute()) == want


def test_quarantine_forward_on_cat_state_metric_survives():
    rng = np.random.RandomState(13)
    p, t = _t(rng.rand(32).astype(np.float32)), _t(rng.randint(2, size=32))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = tm.AUROC(device=CPU)
        m(p, t)
        want = float(m.compute())
        with reliability.guard_scope("quarantine") as guard:
            m(fi.poison(p, "nan"), t)
    assert guard.stats["quarantined"] == 1
    assert len(m.preds) == 1
    assert float(m.compute()) == want


def test_poison_helper_validates():
    with pytest.raises(ValueError, match="mode"):
        fi.poison(torch.zeros(3), "bad")
    with pytest.raises(ValueError, match="floating"):
        fi.poison(torch.zeros(3, dtype=torch.int32))
    out = fi.poison(torch.zeros(3), "inf", index=2)
    assert bool(torch.isinf(out[2])) and bool(torch.isfinite(out[0]))
    jout = np.asarray(jfi.poison(jnp.zeros(3), "inf", index=2))
    assert np.array_equal(out.numpy(), jout)


def test_keyboard_interrupt_inside_guarded_compiled_step_keeps_last_good_state():
    batches = _batches(2)
    col = _reg(True)
    col(*map(_t, batches[0]))
    before = _states(col)
    p, t = map(_t, batches[1])
    doubled = (torch.cat([p, p]), torch.cat([t, t]))  # a new shape: a new build
    with reliability.guard_scope("quarantine"):
        with pytest.raises(KeyboardInterrupt):
            with fi.failing_engine_compile(times=1, exc_type=KeyboardInterrupt):
                col(*doubled)
        for key, v in _states(col).items():
            assert torch.equal(v, before[key]), key
        col(*doubled)
    assert int(col["MeanSquaredError"].total) == 64 + 128


# ----------------------------------------------------------------------
# overflow_margin
# ----------------------------------------------------------------------
def test_overflow_margin_validation():
    with pytest.raises(ValueError, match="overflow_margin"):
        StateGuard("warn", overflow_margin=-1)
    with pytest.raises(ValueError, match="overflow_margin"):
        StateGuard("warn", overflow_margin=2.5)
    assert StateGuard("warn", overflow_margin=0).overflow_margin == 0


def test_overflow_margin_warns_once_and_counts():
    obs.enable()
    guard = install_guard(StateGuard("warn", overflow_margin=10))
    m = tm.ConfusionMatrix(num_classes=2, device=CPU)
    m.confmat = torch.tensor([[2**31 - 512, 0], [0, 0]], dtype=torch.int32)
    before = m.confmat.clone()
    p, t = torch.tensor([0.9, 0.1]), torch.tensor([1, 0])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m.update(p, t)
        m.update(p, t)
    msgs = [str(w.message) for w in caught if "integer accumulator" in str(w.message)]
    assert len(msgs) == 1
    assert "ConfusionMatrix.confmat" in msgs[0] and "2^10" in msgs[0]
    assert guard.stats["overflow_warns"] == 1
    assert obs.get().counters.get("reliability.guard_overflow_warns") == 1
    assert m.confmat[0, 0] > before[0, 0]


def test_overflow_margin_healthy_run_is_silent_and_costless():
    obs.enable()
    guard = install_guard(StateGuard("quarantine", overflow_margin=8))
    m = tm.ConfusionMatrix(num_classes=2, device=CPU)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(3):
            m.update(torch.tensor([0.9, 0.1]), torch.tensor([1, 0]))
    assert not [w for w in caught if "integer accumulator" in str(w.message)]
    assert guard.stats["overflow_warns"] == 0
    assert "reliability.guard_overflow_warns" not in obs.get().counters
    assert StateGuard("warn").overflow_margin is None


def test_overflow_margin_rides_the_compiled_engine_epilogue():
    obs.enable()
    guard = install_guard(StateGuard("warn", overflow_margin=12))
    col = tm.MetricCollection([tm.ConfusionMatrix(num_classes=2, device=CPU)], compiled=True)
    p, t = torch.tensor([0.9, 0.1, 0.2, 0.8]), torch.tensor([1, 0, 0, 1])
    col(p, t)
    col["ConfusionMatrix"].confmat = torch.tensor([[2**31 - 2048, 0], [0, 0]], dtype=torch.int32)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        col(p, t)
        col(p, t)
    assert len([w for w in caught if "integer accumulator" in str(w.message)]) <= 1
    assert guard.stats["overflow_warns"] == 1


def test_overflow_margin_warns_per_instance_not_per_class():
    obs.enable()
    guard = install_guard(StateGuard("warn", overflow_margin=10))
    p, t = torch.tensor([0.9, 0.1]), torch.tensor([1, 0])
    near = torch.tensor([[2**31 - 512, 0], [0, 0]], dtype=torch.int32)
    a, b = tm.ConfusionMatrix(num_classes=2, device=CPU), tm.ConfusionMatrix(num_classes=2, device=CPU)
    a.confmat = near
    a.update(p, t)
    assert guard.stats["overflow_warns"] == 1
    b.update(p, t)
    assert guard.stats["overflow_warns"] == 1
    b.confmat = near
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        b.update(p, t)
    assert guard.stats["overflow_warns"] == 2
    assert any("integer accumulator" in str(w.message) for w in caught)


# ----------------------------------------------------------------------
# the cohort's guard: one flag per tenant
# ----------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["quarantine", "raise", "warn"])
def test_cohort_guard_rolls_back_only_poisoned_tenants(policy):
    """16 tenants, 3 of them fed a NaN row: under quarantine and raise only
    those 3 roll back (every other tenant's states bit-equal to the
    unpoisoned run, the poisoned ones to the run that skipped the batch),
    ``health()["guard_verdicts"]`` counts exactly them, and the stats equal
    JAX's cohort's; under warn every tenant keeps its batch."""
    tenants, rows, bad = 16, 8, [2, 7, 11]
    rng = np.random.RandomState(5)
    steps = [((rng.randint(0, 8, (tenants, rows)) / 8).astype(np.float32),
              (rng.randint(0, 8, (tenants, rows)) / 8).astype(np.float32)) for _ in range(3)]
    poisoned_p = steps[1][0].copy()
    poisoned_p[bad, 0] = np.nan

    def template(side):
        if side:
            return jm.MetricCollection([jm.MeanSquaredError(), jm.MeanAbsoluteError()])
        return tm.MetricCollection([tm.MeanSquaredError(device=CPU), tm.MeanAbsoluteError(device=CPU)])

    def run(side, poisoned, skip=False):
        cohort = (jm if side else tm).MetricCohort(template(side), tenants=tenants, track_health=True)
        conv = jnp.asarray if side else _t
        rel = jrel if side else reliability
        with rel.guard_scope(policy) as guard, warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for i, (p, t) in enumerate(steps):
                if i == 1 and skip:
                    continue
                p = poisoned_p if (i == 1 and poisoned) else p
                try:
                    cohort(conv(p), conv(t))
                except (NonFiniteStateError, jrel.NonFiniteStateError):
                    assert policy == "raise"
        return cohort, dict(guard.stats)

    cohort, stats = run(False, True)
    clean, _ = run(False, False)
    skipped, _ = run(False, False, skip=True)
    jcohort, jstats = run(True, True)
    for name in cohort.keys():
        for sname in cohort._template[name]._defaults:
            got = cohort._states[name][sname]
            if policy == "warn":  # the NaN stays in the poisoned tenants' sums
                assert sname == "total" or torch.isnan(got[bad]).all(), (name, sname)
                assert torch.equal(got[3], clean._states[name][sname][3])
                continue
            good = [i for i in range(tenants) if i not in bad]
            assert torch.equal(got[good], clean._states[name][sname][good]), (name, sname)
            assert torch.equal(got[bad], skipped._states[name][sname][bad]), (name, sname)
            np.testing.assert_array_equal(got.numpy(), np.asarray(jcohort._states[name][sname]))
    health, jhealth = cohort.health(), jcohort.health()
    if policy != "warn":
        assert np.flatnonzero(health["guard_verdicts"]).tolist() == bad
        assert health["guard_verdicts"].tolist() == jhealth["guard_verdicts"].tolist()
    assert health["nonfinite"].tolist() == np.asarray(jhealth["nonfinite"]).tolist()
    assert stats == jstats
