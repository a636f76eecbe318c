"""The port's guarded sync (``SyncPolicy``) against the JAX package's, on the CPU.

The cases of ``tests/reliability/test_guarded_sync.py`` and
``tests/reliability/test_qsync_reliability.py`` are mirrored: bounded retry
with (jittered) backoff, the per-attempt timeout that is terminal and never
retried, the degraded local-only fallback that is atomic across a whole
sync, the quantized tier under retries (the payload is quantized once, the
residual committed once) and under degradation (the exact local state, the
residual untouched), and the residual companions' ``state_dict`` round trip
across every family. Each drill also runs through the JAX package with the
same faults, and the outcomes (values, residuals, policy stats, counters)
are compared case by case.

Tolerances: single-process worlds, so the synced values are the local truth
or the one-rank quantized merge: held BIT-equal to JAX's for the quantized
tier and within 1e-6 for the family values (their own float32 formulas).
Timed drills assert lower bounds on sleeps only.

The JAX cases that wait for the checkpoint envelope (ROADMAP Queue 1 item
4): the envelope half of ``test_quantized_roundtrip_every_family`` and
``test_envelope_strict_load_flags_missing_residual``.
"""
import time
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
from metrics_tpu.metric import Metric as JaxMetric
from metrics_tpu.parallel.backend import set_sync_backend as jax_set_sync_backend
from metrics_tpu.reliability import faultinject as jfi
from metrics_tpu.utilities.distributed import gather_all_tensors as jax_gather
from metrics_tpu_torch import reliability
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.parallel.backend import get_sync_backend, set_sync_backend
from metrics_tpu_torch.reliability import SyncFailedError, SyncPolicy, SyncTimeoutError
from metrics_tpu_torch.reliability import faultinject as fi
from metrics_tpu_torch.reliability.sync import active_policy, apply_sync_policy, set_sync_policy
from metrics_tpu_torch.utilities.distributed import gather_all_tensors

CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean():
    def clean():
        set_sync_policy(None)
        jrel.set_sync_policy(None)
        set_sync_backend(None)
        jax_set_sync_backend(None)
        for pkg in (jobs, obs):
            pkg.disable()
            pkg.get().reset()
            pkg.disable_flight()

    clean()
    yield
    clean()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cls_batch(seed=0):
    rng = np.random.RandomState(seed)
    probs = rng.rand(48, 4).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    return probs, rng.randint(4, size=48)


def _filled_accuracy(seed=0, jax_side=False):
    probs, target = _cls_batch(seed)
    if jax_side:
        m = jm.Accuracy()
        m.update(jnp.asarray(probs), jnp.asarray(target))
        return m
    m = tm.Accuracy(device=CPU)
    m.update(torch.from_numpy(probs), torch.from_numpy(target))
    return m


def test_policy_install_scope_and_validation():
    assert active_policy() is None
    with pytest.raises(ValueError, match="max_retries"):
        SyncPolicy(max_retries=-1)
    with reliability.sync_policy_scope(max_retries=5) as p:
        assert active_policy() is p and p.max_retries == 5
    assert active_policy() is None
    fn = lambda x, group=None: [x]  # noqa: E731
    assert apply_sync_policy(fn) is fn


def test_policy_fields_and_defaults_equal_jax():
    p, j = SyncPolicy(), jrel.SyncPolicy()
    for field in ("max_retries", "backoff_s", "timeout_s", "degraded_ok", "jitter", "max_backoff_s", "levels"):
        assert getattr(p, field) == getattr(j, field), field
    assert p.stats == j.stats == {"retries": 0, "degraded": 0, "timeouts": 0}
    assert SyncPolicy(backoff_s=0.5).max_backoff_s == jrel.SyncPolicy(backoff_s=0.5).max_backoff_s == 4.0
    level1 = SyncPolicy(timeout_s=5.0, degraded_ok=True)
    p = SyncPolicy(levels={1: level1})
    assert p.for_level(1) is level1 and p.for_level(0) is p
    with pytest.raises(TypeError, match="SyncPolicy"):
        SyncPolicy(levels={1: {"timeout_s": 1.0}})
    with pytest.raises(ValueError, match="nest"):
        SyncPolicy(levels={1: SyncPolicy(levels={0: SyncPolicy()})})


def test_fails_twice_then_succeeds_yields_correct_synced_result():
    want = float(_filled_accuracy().compute())
    m2 = _filled_accuracy()
    m2.dist_sync_fn = gather_all_tensors
    with obs.telemetry_scope(), fi.flaky_sync_backend(fails=2):
        with reliability.sync_policy_scope(max_retries=2, backoff_s=0.001) as pol:
            got = float(m2.compute())
        counters = dict(obs.get().counters)
    assert got == want
    assert pol.stats["retries"] == 2 and pol.stats["degraded"] == 0
    assert counters["reliability.sync_retries"] == 2
    assert "reliability.degraded_syncs" not in counters
    assert int(m2.total) == 48
    j = _filled_accuracy(jax_side=True)
    j.dist_sync_fn = jax_gather
    with jobs.telemetry_scope(), jfi.flaky_sync_backend(fails=2):
        with jrel.sync_policy_scope(max_retries=2, backoff_s=0.001) as jpol:
            assert abs(float(j.compute()) - got) <= 1e-6
        jcounters = dict(jobs.get().counters)
    assert jpol.stats == pol.stats
    keys = ("reliability.sync_retries", "sync.calls", "sync.payload_bytes", "sync.wire_bytes")
    assert {k: counters[k] for k in keys} == {k: jcounters[k] for k in keys}


def test_exhausted_retries_raise_without_degraded_ok():
    m = _filled_accuracy()
    m.dist_sync_fn = gather_all_tensors
    with fi.flaky_sync_backend(fails=99) as flaky:
        with reliability.sync_policy_scope(max_retries=1, backoff_s=0.001) as pol:
            with pytest.raises(SyncFailedError, match="injected sync failure"):
                m.compute()
    assert pol.stats["retries"] >= 1
    assert flaky.calls == 2  # the first state's two attempts, then the raise


def test_dead_backend_degrades_to_local_state_with_one_warning():
    want = float(_filled_accuracy().compute())
    m2 = _filled_accuracy()
    m2.dist_sync_fn = gather_all_tensors
    with obs.telemetry_scope(), fi.flaky_sync_backend(fails=10**6):
        with reliability.sync_policy_scope(max_retries=1, backoff_s=0.001, degraded_ok=True) as pol:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                got = float(m2.compute())
        events = list(obs.get().events)
        counters = dict(obs.get().counters)
    assert got == want
    assert pol.stats["degraded"] >= 1
    assert counters["reliability.degraded_syncs"] >= 1
    assert any(e["kind"] == "degraded_sync" for e in events)
    fired = [w for w in caught if "LOCAL-ONLY" in str(w.message)]
    assert len(fired) <= 1


def test_hung_backend_times_out_then_degrades():
    want = float(_filled_accuracy().compute())
    m2 = _filled_accuracy()
    m2.dist_sync_fn = gather_all_tensors
    with fi.flaky_sync_backend(fails=0, delay_s=5.0, slow_calls=10**6):
        with reliability.sync_policy_scope(max_retries=0, timeout_s=0.05, degraded_ok=True) as pol:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                got = float(m2.compute())
    assert got == want
    assert pol.stats["timeouts"] >= 1 and pol.stats["degraded"] >= 1


def test_backoff_sleeps_between_retries_and_wrapper_always_raises():
    calls = []

    def failing(x, group=None):
        calls.append(time.perf_counter())
        raise RuntimeError("down")

    with reliability.sync_policy_scope(max_retries=2, backoff_s=0.05, degraded_ok=True, jitter=False):
        with pytest.raises(SyncFailedError):
            apply_sync_policy(failing)(torch.tensor(1.0))
    assert len(calls) == 3
    assert calls[1] - calls[0] >= 0.04
    assert calls[2] - calls[1] >= 0.08


def test_jittered_policies_decorrelate_and_respect_the_bound():
    a = SyncPolicy(backoff_s=0.01, max_backoff_s=0.5)
    b = SyncPolicy(backoff_s=0.01, max_backoff_s=0.5)

    def schedule(policy, n=24):
        out, prev = [], None
        for _ in range(n):
            prev = policy.next_backoff(prev)
            out.append(prev)
        return out

    sched_a, sched_b = schedule(a), schedule(b)
    assert sched_a != sched_b
    for sched in (sched_a, sched_b):
        assert all(0.01 <= s <= 0.5 for s in sched)
    assert max(sched_a) > 0.01


def test_jitter_is_on_by_default_and_sleeps_at_least_base():
    calls = []

    def failing(x, group=None):
        calls.append(time.perf_counter())
        raise RuntimeError("down")

    with reliability.sync_policy_scope(max_retries=1, backoff_s=0.03) as pol:
        assert pol.jitter is True
        with pytest.raises(SyncFailedError):
            apply_sync_policy(failing)(torch.tensor(1.0))
    assert len(calls) == 2
    assert calls[1] - calls[0] >= 0.02


def test_backoff_validation():
    with pytest.raises(ValueError, match="backoff"):
        SyncPolicy(backoff_s=-1.0)
    with pytest.raises(ValueError, match="backoff"):
        SyncPolicy(max_backoff_s=0.0)
    p = SyncPolicy(backoff_s=1.0, max_backoff_s=1.5, jitter=False)
    assert p.next_backoff(p.next_backoff(None)) == 1.5
    jp = jrel.SyncPolicy(backoff_s=1.0, max_backoff_s=1.5, jitter=False)
    assert [p.next_backoff(v) for v in (None, 0.4, 1.0)] == [jp.next_backoff(v) for v in (None, 0.4, 1.0)]


def test_timeout_is_terminal_not_retried():
    calls = []

    def slow(x, group=None):
        calls.append(time.perf_counter())
        time.sleep(0.5)
        return [x]

    with reliability.sync_policy_scope(max_retries=5, backoff_s=0.001, timeout_s=0.05) as pol:
        with pytest.raises(SyncTimeoutError):
            apply_sync_policy(slow)(torch.tensor(1.0))
    assert len(calls) == 1
    assert pol.stats["timeouts"] == 1 and pol.stats["retries"] == 0


def test_degradation_is_atomic_across_states():
    want = float(_filled_accuracy().compute())
    m2 = _filled_accuracy()
    m2.dist_sync_fn = gather_all_tensors
    with fi.flaky_sync_backend(fails=2) as flaky:
        with reliability.sync_policy_scope(max_retries=1, backoff_s=0.001, degraded_ok=True) as pol:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                got = float(m2.compute())
    assert got == want
    assert pol.stats["degraded"] == 1
    assert flaky.calls == 2  # the second state never gathered globally


def test_set_sync_policy_returns_previous():
    a, b = SyncPolicy(), SyncPolicy(max_retries=7)
    assert set_sync_policy(a) is None
    assert set_sync_policy(b) is a
    assert set_sync_policy(None) is b


def test_flaky_backend_restores_previous_backend():
    before = get_sync_backend()
    with fi.flaky_sync_backend(fails=1) as flaky:
        assert get_sync_backend() is flaky
        assert flaky.rank() == 0 and flaky.world_size == 1
    assert type(get_sync_backend()) is type(before)


def test_compiled_engine_runs_eager_under_distributed_backend():
    p = torch.from_numpy(np.random.RandomState(0).rand(64).astype(np.float32))
    col = tm.MetricCollection([tm.MeanSquaredError(device=CPU)], compiled=True)
    with fi.flaky_sync_backend(fails=0):
        col(p, p)
    assert int(col["MeanSquaredError"].total) == 64


def test_sync_failure_dumps_exactly_once(tmp_path):
    """``tests/reliability/test_flight.py::test_sync_terminal_failure_dumps_exactly_once``:
    one injected fault, one dump (the terminal gather), none for the
    degradation that follows."""
    import glob
    import json

    m = _filled_accuracy()
    m.dist_sync_fn = gather_all_tensors
    with obs.flight_scope(tmp_path) as rec:
        with fi.flaky_sync_backend(fails=10**6):
            with reliability.sync_policy_scope(max_retries=1, backoff_s=0.001, degraded_ok=True):
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    m.compute()
    files = sorted(glob.glob(str(tmp_path / "flight-*.json")))
    assert len(files) == 1 and rec.dumps == 1
    with open(files[0]) as f:
        dump = json.load(f)
    assert dump["reason"] == "sync_failed"
    assert dump["context"]["attempts"] == 2
    assert any(e["kind"] == "sync_failure" for e in dump["events"])


def test_hung_sync_timeout_dumps_exactly_once(tmp_path):
    import glob
    import json

    m = _filled_accuracy()
    m.dist_sync_fn = gather_all_tensors
    with obs.flight_scope(tmp_path) as rec:
        with fi.flaky_sync_backend(fails=0, delay_s=5.0, slow_calls=10**6):
            with reliability.sync_policy_scope(max_retries=0, timeout_s=0.05, degraded_ok=True):
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    m.compute()
    files = sorted(glob.glob(str(tmp_path / "flight-*.json")))
    assert len(files) == 1 and rec.dumps == 1
    with open(files[0]) as f:
        dump = json.load(f)
    assert dump["reason"] == "sync_timeout"
    assert dump["context"]["timeout_s"] == 0.05


# ----------------------------------------------------------------------
# the quantized tier under the policy (tests/reliability/test_qsync_reliability.py)
# ----------------------------------------------------------------------
class QHist(Metric):
    def __init__(self, precision="int8", bins=256):
        super().__init__(device=CPU)
        self.add_state("hist", default=torch.zeros(bins), dist_reduce_fx="sum", sync_precision=precision)

    def update(self, x):
        self.hist = self.hist + x

    def compute(self):
        return self.hist


class JaxQHist(JaxMetric):
    def __init__(self, precision="int8", bins=256):
        super().__init__()
        self.add_state("hist", default=jnp.zeros((bins,)), dist_reduce_fx="sum", sync_precision=precision)

    def update(self, x):
        self.hist = self.hist + x

    def compute(self):
        return self.hist


def _x(seed=3):
    return np.random.RandomState(seed).rand(256).astype(np.float32) * 5


def _filled(precision="int8", seed=3):
    m = QHist(precision)
    m.dist_sync_fn = gather_all_tensors
    m.update(torch.from_numpy(_x(seed)))
    return m


def _jax_filled(precision="int8", seed=3):
    m = JaxQHist(precision)
    m.dist_sync_fn = jax_gather
    m.update(jnp.asarray(_x(seed)))
    return m


def test_retry_resends_identical_payload_and_commits_residual_once():
    clean = _filled()
    want = _np(clean.compute())
    clean_res = _np(clean.hist__qres)
    assert np.abs(clean_res).max() > 0
    m = _filled()
    with fi.flaky_sync_backend(fails=2):
        with reliability.sync_policy_scope(max_retries=2, backoff_s=0.001) as pol:
            got = _np(m.compute())
    assert pol.stats["retries"] == 2 and pol.stats["degraded"] == 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_np(m.hist__qres), clean_res)
    j = _jax_filled()
    with jfi.flaky_sync_backend(fails=2):
        with jrel.sync_policy_scope(max_retries=2, backoff_s=0.001):
            np.testing.assert_array_equal(np.asarray(j.compute()), got)
    np.testing.assert_array_equal(np.asarray(j.hist__qres), _np(m.hist__qres))


def test_exhausted_retries_raise_and_leave_residual_unchanged():
    m = _filled()
    with fi.flaky_sync_backend(fails=99):
        with reliability.sync_policy_scope(max_retries=1, backoff_s=0.001):
            with pytest.raises(reliability.SyncFailedError):
                m.compute()
    assert float(m.hist__qres.abs().max()) == 0.0


def test_degraded_fallback_keeps_exact_local_state_and_residual():
    m = _filled()
    local = _np(m.hist)
    with obs.telemetry_scope(), fi.flaky_sync_backend(fails=10**6):
        with reliability.sync_policy_scope(max_retries=1, backoff_s=0.001, degraded_ok=True) as pol:
            with warnings.catch_warnings(record=True):
                warnings.simplefilter("always")
                got = _np(m.compute())
    assert pol.stats["degraded"] == 1
    np.testing.assert_array_equal(got, local)
    assert float(m.hist__qres.abs().max()) == 0.0


def test_hung_sync_timeout_degrades_without_advancing_residual():
    m = _filled()
    local = _np(m.hist)
    with fi.flaky_sync_backend(fails=0, delay_s=30.0, slow_calls=4):
        with reliability.sync_policy_scope(max_retries=0, timeout_s=0.2, degraded_ok=True):
            with warnings.catch_warnings(record=True):
                warnings.simplefilter("always")
                got = _np(m.compute())
    np.testing.assert_array_equal(got, local)
    assert float(m.hist__qres.abs().max()) == 0.0


def test_second_sync_succeeding_after_degradation_commits_residual():
    m = _filled()
    with fi.flaky_sync_backend(fails=10**6):
        with reliability.sync_policy_scope(max_retries=0, backoff_s=0.001, degraded_ok=True):
            with warnings.catch_warnings(record=True):
                warnings.simplefilter("always")
                m.compute()
    m.update(torch.zeros(256))
    got = _np(m.compute())
    np.testing.assert_array_equal(got, _np(_filled().compute()))
    assert float(m.hist__qres.abs().max()) > 0


def test_cohort_degrades_atomically_and_keeps_its_residuals():
    """The cohort's flat sync under a dead backend: every tenant's exact local
    states, the stacked residuals untouched; a retried sync commits the
    residual stack once, equal to a clean sync's."""
    rng = np.random.RandomState(9)
    p = torch.from_numpy(rng.rand(3, 32).astype(np.float32))
    t = torch.from_numpy(rng.rand(3, 32).astype(np.float32))

    def cohort():
        c = tm.MetricCohort(tm.MetricCollection([tm.MeanSquaredError(device=CPU)], sync_precision="int8"), tenants=3)
        c(p, t)
        return c

    alone = tm.MetricCohort(tm.MetricCollection([tm.MeanSquaredError(device=CPU)]), tenants=3)
    alone(p, t)
    want_local = _np(alone.compute()["MeanSquaredError"])
    c = cohort()
    with fi.flaky_sync_backend(fails=10**6):
        with reliability.sync_policy_scope(max_retries=0, degraded_ok=True) as pol:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                got = _np(c.compute()["MeanSquaredError"])
    np.testing.assert_array_equal(got, want_local)
    assert pol.stats["degraded"] == 1
    assert float(c._states["MeanSquaredError"]["sum_squared_error__qres"].abs().max()) == 0.0
    clean = cohort()
    with fi.flaky_sync_backend(fails=0):
        clean.compute()
    retried = cohort()
    with fi.flaky_sync_backend(fails=1):
        with reliability.sync_policy_scope(max_retries=1, backoff_s=0.001):
            retried.compute()
    res = retried._states["MeanSquaredError"]["sum_squared_error__qres"]
    assert float(res.abs().max()) > 0
    assert torch.equal(res, clean._states["MeanSquaredError"]["sum_squared_error__qres"])


# ----------------------------------------------------------------------
# residual companions through state_dict, every family
# ----------------------------------------------------------------------
_R = np.random.RandomState(1234)
_N, _C = 48, 4
_PROBS = _R.rand(_N, _C).astype(np.float32)
_PROBS /= _PROBS.sum(1, keepdims=True)
_MC = (_PROBS, _R.randint(_C, size=_N))
_BIN = (_PROBS[:, 1].copy(), _R.randint(2, size=_N))
_REG = (_R.rand(_N).astype(np.float32), _R.rand(_N).astype(np.float32))
_RET = (_R.randint(6, size=_N), _R.rand(_N).astype(np.float32), _R.randint(2, size=_N))

FAMILIES = [
    ("Accuracy", lambda m: m.Accuracy(), _MC),
    ("Precision", lambda m: m.Precision(num_classes=_C, average="macro"), _MC),
    ("F1", lambda m: m.F1(num_classes=_C, average="macro"), _MC),
    ("StatScores", lambda m: m.StatScores(reduce="micro"), _MC),
    ("ConfusionMatrix", lambda m: m.ConfusionMatrix(num_classes=_C), _MC),
    ("IoU", lambda m: m.IoU(num_classes=_C), _MC),
    ("MatthewsCorrcoef", lambda m: m.MatthewsCorrcoef(num_classes=_C), _MC),
    ("CohenKappa", lambda m: m.CohenKappa(num_classes=_C), _MC),
    ("HammingDistance", lambda m: m.HammingDistance(), _BIN),
    ("AUROC", lambda m: m.AUROC(), _BIN),
    ("ROC", lambda m: m.ROC(), _BIN),
    ("BinnedAUROC", lambda m: m.BinnedAUROC(num_bins=16), _BIN),
    ("MeanSquaredError", lambda m: m.MeanSquaredError(), _REG),
    ("MeanAbsoluteError", lambda m: m.MeanAbsoluteError(), _REG),
    ("R2Score", lambda m: m.R2Score(), _REG),
    ("ExplainedVariance", lambda m: m.ExplainedVariance(), _REG),
    ("PSNR", lambda m: m.PSNR(data_range=1.0), _REG),
    ("RetrievalMAP", lambda m: m.RetrievalMAP(), _RET),
]


def _port_factory(make):
    """The family's port, built on the CPU by name."""

    class _CPU:
        def __getattr__(self, name):
            cls = getattr(tm, name)
            return lambda *a, **k: cls(*a, device=CPU, **k)

    return lambda: make(_CPU())


def _values(x):
    if isinstance(x, (tuple, list)):
        return [_values(v) for v in x]
    return _np(x)


def _assert_values(a, b, name, rtol=0.0):
    if isinstance(a, list):
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            _assert_values(x, y, name, rtol)
    elif rtol:
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6, err_msg=name)
    else:
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("name,make,args", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_quantized_state_dict_roundtrip_every_family(name, make, args):
    """``set_sync_precision("int8")`` on every family (eligible states tier
    up, list states stay exact, as in JAX), a world-1 quantized sync to fill
    the residuals, then the ``state_dict`` round trip restores states and
    residuals bit for bit; the synced value equals JAX's within 1e-6."""
    factory = _port_factory(make)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = factory()
        applied = m.set_sync_precision("int8")
        j = make(jm)
        assert applied == j.set_sync_precision("int8"), name
        targs = tuple(torch.from_numpy(np.asarray(a)) for a in args)
        jargs = tuple(jnp.asarray(a) for a in args)
        for _ in range(2):
            m.update(*targs)
            j.update(*jargs)
        if applied:
            m.dist_sync_fn = gather_all_tensors
            j.dist_sync_fn = jax_gather
            _assert_values(_values(m.compute()), _values(j.compute()), name, rtol=1e-6)
        m.persistent(True)
        saved = m.state_dict()
        for res_name in m._sync_residual_names():
            assert res_name in saved, f"{name}: residual {res_name} missing from state_dict"
        m._computed = None
        want = _values(m.compute())
        m2 = factory()
        m2.set_sync_precision("int8")
        m2.persistent(True)
        m2.load_state_dict(saved, strict=True)
        for res_name in m._sync_residual_names():
            assert torch.equal(getattr(m2, res_name), saved[res_name]), name
        if applied:
            m2.dist_sync_fn = gather_all_tensors
        _assert_values(want, _values(m2.compute()), name)
