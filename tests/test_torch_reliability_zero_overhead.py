"""The reliability layer costs nothing until enabled: the port against the
JAX package, on the CPU.

The cases of ``tests/reliability/test_zero_overhead.py`` that need no
``serving/``: with no guard, no policy and no session (the defaults) the
hooks are one global read; a guard installed over healthy data leaves step
values, epoch values and states bit-equal to the unguarded run, eager and
compiled, as in JAX; the unguarded step's signature carries no guard token;
a healthy run moves no ``reliability.*`` counter; a ``SyncPolicy`` with no
failure is transparent; each reliability warning keys its own rate limit; a
collection outside any session runs bit-equal with no session counter and no
cursor in its ``state_dict``. JAX's unguarded values are compared with the
port's within rtol 1e-5 (their own float32 sums).
"""
import tempfile
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
from metrics_tpu_torch import reliability
from metrics_tpu_torch.reliability.guard import active
from metrics_tpu_torch.reliability.sync import active_policy, apply_sync_policy

CPU = "cpu"


@pytest.fixture(autouse=True)
def _pristine():
    def clean():
        for pkg in (jobs, obs):
            pkg.disable()
            pkg.get().reset()
            pkg.disable_flight()
        reliability.uninstall_guard()
        jrel.uninstall_guard()

    clean()
    yield
    clean()


def _cls_batches(n=3, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        probs = rng.rand(256, 4).astype(np.float32)
        probs /= probs.sum(1, keepdims=True)
        out.append((torch.from_numpy(probs), torch.from_numpy(rng.randint(4, size=256))))
    return out


def _collection(compiled):
    return tm.MetricCollection(
        [
            tm.Accuracy(device=CPU),
            tm.Precision(num_classes=4, average="macro", device=CPU),
            tm.F1(num_classes=4, average="macro", device=CPU),
        ],
        compiled=compiled,
    )


def test_defaults_are_off():
    assert active() is None and jrel.guard.active() is None
    assert active_policy() is None
    fn = lambda x, group=None: [x]  # noqa: E731
    assert apply_sync_policy(fn) is fn


@pytest.mark.parametrize("compiled", [False, True])
def test_guard_scope_on_healthy_data_is_bit_identical(compiled):
    batches = _cls_batches()
    plain = _collection(compiled)
    v_plain = [plain(p, t) for p, t in batches]
    e_plain = plain.compute()
    with reliability.guard_scope("quarantine") as guard:
        guarded = _collection(compiled)
        v_guard = [guarded(p, t) for p, t in batches]
        e_guard = guarded.compute()
    for va, vb in zip(v_plain, v_guard):
        for k in va:
            assert torch.equal(va[k], vb[k]), k
    for k in e_plain:
        assert torch.equal(e_plain[k], e_guard[k]), k
    for key in plain.keys():
        for sname in plain[key]._defaults:
            assert torch.equal(getattr(plain[key], sname), getattr(guarded[key], sname)), (key, sname)
    assert guard.stats["violations"] == 0
    jcol = jm.MetricCollection(
        [jm.Accuracy(), jm.Precision(num_classes=4, average="macro"), jm.F1(num_classes=4, average="macro")],
        compiled=compiled,
    )
    for p, t in batches:
        jcol(jnp.asarray(p.numpy()), jnp.asarray(t.numpy()))
    for k, v in jcol.compute().items():
        assert float(e_guard[k]) == pytest.approx(float(v), rel=1e-5), k


def test_unguarded_engine_programs_carry_no_guard_token():
    p, t = _cls_batches(1)[0]
    col = _collection(compiled=True)
    col(p, t)
    (signature,) = list(col._engine._compiled)
    names, precisions, guard_token = signature[:3]
    assert guard_token is None
    assert len(signature) == 6  # no cohort-capacity or health token
    assert all(prec == () for _, prec in precisions)
    assert col._engine.trace_count == 1


def test_healthy_run_keeps_every_reliability_counter_at_zero():
    batches = _cls_batches()
    with obs.telemetry_scope():
        with reliability.guard_scope("quarantine"):
            with reliability.sync_policy_scope(max_retries=2, degraded_ok=True):
                col = _collection(compiled=True)
                for p, t in batches:
                    col(p, t)
                col.compute()
                m = tm.Accuracy(device=CPU)
                m.update(*batches[0])
                env = reliability.save_envelope(m)
                reliability.load_envelope(tm.Accuracy(device=CPU), env, strict=True)
        rel_counters = {k: v for k, v in obs.get().counters.items() if k.startswith("reliability.")}
    assert rel_counters == {}, rel_counters


def test_sync_policy_scope_without_failures_is_transparent():
    from metrics_tpu_torch.utilities.distributed import gather_all_tensors

    p, t = _cls_batches(1)[0]
    m = tm.Accuracy(device=CPU)
    m.update(p, t)
    want = float(m.compute())
    m2 = tm.Accuracy(device=CPU)
    m2.update(p, t)
    m2.dist_sync_fn = gather_all_tensors
    with reliability.sync_policy_scope(max_retries=3, timeout_s=5.0, degraded_ok=True) as pol:
        got = float(m2.compute())
    assert got == want
    assert pol.stats == {"retries": 0, "degraded": 0, "timeouts": 0}


def test_reliability_warnings_key_per_feature():
    from metrics_tpu_torch.utilities.prints import _WARN_ONCE_SEEN

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with reliability.guard_scope("quarantine"):
            m = tm.MeanSquaredError(device=CPU)
            x = torch.from_numpy(np.random.RandomState(0).rand(8).astype(np.float32))
            bad = x.clone()
            bad[0] = float("nan")
            m.update(bad, x)
    assert "guard-quarantine:MeanSquaredError" in _WARN_ONCE_SEEN


def test_collection_outside_any_session_is_bit_identical_with_zero_session_counters():
    batches = _cls_batches()
    control = _collection(compiled=True)
    v_control = [control(p, t) for p, t in batches]
    e_control = control.compute()
    with obs.telemetry_scope():
        with tempfile.TemporaryDirectory() as d:
            unrelated = reliability.EvalSession(tm.MeanSquaredError(device=CPU), d, checkpoint_every=None)
            bystander = _collection(compiled=True)
            v_by = [bystander(p, t) for p, t in batches]
            e_by = bystander.compute()
        del unrelated
        session_counters = {k: v for k, v in obs.get().counters.items() if k.startswith("reliability.session_")}
    assert session_counters == {}, session_counters
    for va, vb in zip(v_control, v_by):
        for k in va:
            assert torch.equal(va[k], vb[k]), k
    for k in e_control:
        assert torch.equal(e_control[k], e_by[k]), k
    assert "__session_cursor__" not in bystander.state_dict()
    for key in bystander.keys():
        assert bystander[key]._session_cursor is None
