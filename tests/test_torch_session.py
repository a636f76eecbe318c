"""The port's ``EvalSession`` against the JAX package's, on the CPU.

Every case of ``tests/reliability/test_session.py`` is mirrored, its virtual
DDP worlds over ``tests/torch_virtual.py`` (threads in one process, the
torch-only twin of ``tests/helpers/testers.py``): a preempted session
resumes from its rotated checkpoints, skips replayed batches exactly once
and ends bit-equal to an uninterrupted run (a plain metric, a compiled
collection, a two-rank collection); a torn newest generation falls back;
the cursor rides inside the checksummed envelope; skewed ranks roll back to
a common generation, or raise typed (``degraded_ok`` warns); the step
deadline checkpoints the last-good state and raises; an engine demotion
writes a protective checkpoint; a git SHA drift warns; a journal seeded
without cursors resumes from the manifest. So are the session cases of
``tests/reliability/test_chaos_e2e.py`` (an eval loop that survives NaN
batches, an engine build failure and a corrupted checkpoint, and the guard
with a flaky sync backend) and of ``tests/reliability/test_hierarchy_chaos.py``
(a resume across a dropped slice, with and without a ``SyncPolicy``, a
skewed slice over a flat world without deadlock, a healthy resume's full
quorum). The main scenarios run through the JAX package too, and its
cursors, replay counts and values must equal the port's.

``NOT_PORTED`` names the JAX session cases that need a part of the JAX
package the port does not have yet: none since the port has ``serving/``
(its background-checkpoint cases are in ``tests/test_torch_serving_chaos.py``).

Tolerance: none for states, cursors and stats (bit-equal); port values
against JAX's within rtol 1e-5 (their own float32 sums).
"""
import threading
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
from metrics_tpu.parallel.backend import set_sync_backend as jax_set_sync_backend
from metrics_tpu_torch import reliability
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.parallel.backend import set_sync_backend
from metrics_tpu_torch.parallel.hierarchy import HierarchicalSyncBackend, SyncTopology, last_quorum, reset_quorum
from metrics_tpu_torch.reliability import EvalSession, SessionResumeError, SessionStepTimeoutError, SyncPolicy
from metrics_tpu_torch.reliability import faultinject as fi
from metrics_tpu_torch.reliability.sync import set_sync_policy
from tests.helpers.testers import run_virtual_ddp as jax_run_virtual_ddp
from tests.torch_virtual import _RANK, VirtualDDPGroup, run_virtual_ddp

CPU = "cpu"
N_BATCHES = 8
KILL_AT = 5

# every JAX session case is ported: the four background-checkpoint cases of
# tests/reliability/test_serving_chaos.py are in tests/test_torch_serving_chaos.py
NOT_PORTED = {}


@pytest.fixture(autouse=True)
def _pristine():
    def clean():
        for pkg in (jobs, obs):
            pkg.disable()
            pkg.get().reset()
            pkg.disable_flight()
        reliability.uninstall_guard()
        jrel.uninstall_guard()
        set_sync_policy(None)
        jrel.set_sync_policy(None)
        set_sync_backend(None)
        jax_set_sync_backend(None)
        reset_quorum()

    clean()
    yield
    clean()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _reg_batches(n=N_BATCHES, size=64, seed=7):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rng.rand(size).astype(np.float32)
        p = t + 0.1 * rng.randn(size).astype(np.float32)
        out.append((p, t))
    return out


def _cls_batches(n=N_BATCHES, size=48, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        probs = rng.rand(size, 4).astype(np.float32)
        probs /= probs.sum(1, keepdims=True)
        out.append((probs, rng.randint(4, size=size).astype(np.int32)))
    return out


def _reg_collection(compiled=False):
    return tm.MetricCollection([tm.MeanSquaredError(device=CPU), tm.MeanAbsoluteError(device=CPU)], compiled=compiled)


def _assert_bit_identical(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    else:
        assert torch.equal(got, want)


def _run_preempt_resume(make_metric, batches, tmp_path, checkpoint_every=2, jax_side=False):
    """Kill a session mid-epoch, resume a fresh metric and session from disk,
    replay the whole stream; returns (final value, resumed session)."""
    rel, conv = (jrel, jnp.asarray) if jax_side else (reliability, _t)
    d = tmp_path / ("jax" if jax_side else "port")
    first = rel.EvalSession(make_metric(), d, checkpoint_every=checkpoint_every)
    with pytest.raises(rel.faultinject.Preempted):
        with rel.faultinject.preempt_at_step(first, KILL_AT):
            for i, (p, t) in enumerate(batches):
                first.step(i, conv(p), conv(t))
    resumed = rel.EvalSession(make_metric(), d, checkpoint_every=checkpoint_every)
    cursor = resumed.resume()
    assert 0 <= cursor < KILL_AT
    for i, (p, t) in enumerate(batches):
        resumed.step(i, conv(p), conv(t))
    assert resumed.stats["replays_skipped"] == cursor + 1
    assert resumed.stats["steps"] == len(batches) - cursor - 1
    return resumed.compute(), resumed


def test_not_ported_cases_exist_in_the_jax_suite():
    from pathlib import Path

    import re

    repo = Path(__file__).resolve().parent.parent
    for case in NOT_PORTED:
        path, name = case.split("::")
        assert f"def {name}(" in (repo / path).read_text(), case
    # the session cases of the serving chaos suite: each one is ported under
    # its own name, or listed above
    jax_cases = re.findall(r"^def (test_\w+)\(", (repo / "tests/reliability/test_serving_chaos.py").read_text(), re.M)
    port = (repo / "tests/test_torch_serving_chaos.py").read_text()
    missing = [n for n in jax_cases if f"def {n}(" not in port and f"tests/reliability/test_serving_chaos.py::{n}" not in NOT_PORTED]
    assert jax_cases and not missing, missing


def test_preempted_plain_metric_resumes_bit_identical(tmp_path):
    batches = _reg_batches()
    clean = tm.MeanSquaredError(device=CPU)
    for p, t in batches:
        clean(_t(p), _t(t))
    with obs.telemetry_scope():
        got, session = _run_preempt_resume(lambda: tm.MeanSquaredError(device=CPU), batches, tmp_path)
        assert obs.get().counters["reliability.session_replays_skipped"] > 0
    _assert_bit_identical(got, clean.compute())
    jgot, jsession = _run_preempt_resume(jm.MeanSquaredError, batches, tmp_path, jax_side=True)
    assert session.stats == jsession.stats and session.cursor == jsession.cursor
    assert float(got) == pytest.approx(float(jgot), rel=1e-5)


def test_preempted_compiled_collection_resumes_bit_identical(tmp_path):
    batches = _reg_batches()
    clean = _reg_collection(compiled=True)
    for p, t in batches:
        clean(_t(p), _t(t))
    got, _ = _run_preempt_resume(lambda: _reg_collection(compiled=True), batches, tmp_path)
    _assert_bit_identical(got, clean.compute())


def test_preempted_multiprocess_collection_resumes_bit_identical(tmp_path):
    world = 2
    batches = _cls_batches()

    def _shard(batch, rank):
        probs, target = batch
        return _t(probs[rank::world]), _t(target[rank::world])

    def _col():
        return tm.MetricCollection([tm.Accuracy(device=CPU), tm.Precision(num_classes=4, average="macro", device=CPU)])

    want = {}

    def uninterrupted(rank, world_size):
        col = _col()
        for batch in batches:
            col.update(*_shard(batch, rank))
        values = col.compute()
        if rank == 0:
            want.update(values)

    run_virtual_ddp(world, uninterrupted)

    def killed(rank, world_size):
        session = EvalSession(_col(), tmp_path / f"rank{rank}", checkpoint_every=1)
        try:
            with fi.preempt_at_step(session, KILL_AT):
                for i, batch in enumerate(batches):
                    session.step(i, *_shard(batch, rank))
        except fi.Preempted:
            pass

    run_virtual_ddp(world, killed)
    got = {}

    def resumed(rank, world_size):
        session = EvalSession(_col(), tmp_path / f"rank{rank}", checkpoint_every=1)
        assert session.resume() == KILL_AT - 1
        for i, batch in enumerate(batches):
            session.step(i, *_shard(batch, rank))
        assert session.stats["replays_skipped"] == KILL_AT
        values = session.compute()
        if rank == 0:
            got.update(values)

    run_virtual_ddp(world, resumed)
    _assert_bit_identical(got, want)


def test_resume_falls_back_over_torn_newest_generation(tmp_path):
    batches = _reg_batches()
    clean = tm.MeanSquaredError(device=CPU)
    for p, t in batches:
        clean(_t(p), _t(t))
    session = EvalSession(tm.MeanSquaredError(device=CPU), tmp_path / "j", checkpoint_every=1)
    for i, (p, t) in enumerate(batches[:KILL_AT]):
        session.step(i, _t(p), _t(t))
    newest = session.journal.records()[-1]
    fi.torn_write(session.journal._gen_path(int(newest["generation"])))
    fresh = EvalSession(tm.MeanSquaredError(device=CPU), tmp_path / "j", checkpoint_every=1)
    with pytest.warns(UserWarning, match="falling back"):
        cursor = fresh.resume()
    assert cursor == KILL_AT - 2
    for i, (p, t) in enumerate(batches):
        fresh.step(i, _t(p), _t(t))
    _assert_bit_identical(fresh.compute(), clean.compute())


def test_replay_guard_is_exactly_once_without_any_crash(tmp_path):
    batches = _reg_batches(4)
    clean = tm.MeanSquaredError(device=CPU)
    for p, t in batches:
        clean(_t(p), _t(t))
    session = EvalSession(tm.MeanSquaredError(device=CPU), tmp_path / "j", checkpoint_every=None)
    for i, (p, t) in enumerate(batches[:2]):
        session.step(i, _t(p), _t(t))
    for i, (p, t) in enumerate(batches):
        assert (session.step(i, _t(p), _t(t)) is None) == (i < 2)
    assert session.stats["replays_skipped"] == 2
    _assert_bit_identical(session.compute(), clean.compute())


def test_cursor_rides_inside_the_checksummed_envelope(tmp_path):
    session = EvalSession(tm.MeanSquaredError(device=CPU), tmp_path / "j", checkpoint_every=1)
    p, t = _reg_batches(1)[0]
    session.step(0, _t(p), _t(t))
    envelope, record, _ = session.journal.load_latest_good()
    assert Metric._SESSION_CURSOR_KEY in envelope["payload"]
    value = envelope["payload"][Metric._SESSION_CURSOR_KEY]
    assert value.dtype == np.int32 and value.shape == () and int(value) == 0
    assert envelope["spec"][Metric._SESSION_CURSOR_KEY] == {"kind": "array", "dtype": "int32", "shape": []}
    assert record["cursor"] == 0
    bad = fi.corrupt_envelope(envelope, "payload")
    with pytest.raises(reliability.CheckpointError):
        reliability.load_envelope(EvalSession(tm.MeanSquaredError(device=CPU), tmp_path / "j2").metric, bad, strict=True)


def test_multihost_skew_rolls_back_to_common_generation(tmp_path):
    batches = _cls_batches()

    def phase1(rank, world_size):
        session = EvalSession(tm.Accuracy(device=CPU), tmp_path / f"rank{rank}", checkpoint_every=1, keep_last=3)
        for i in range(4):
            if i == 3 and rank == 1:
                with fi.cursor_skew(session, +2):
                    session.step(i, *map(_t, batches[i]))
            else:
                session.step(i, *map(_t, batches[i]))

    run_virtual_ddp(2, phase1)
    cursors = {}

    def phase2(rank, world_size):
        session = EvalSession(tm.Accuracy(device=CPU), tmp_path / f"rank{rank}", keep_last=3)
        cursors[rank] = (session.resume(), session.stats["resume_rollbacks"])

    with obs.telemetry_scope():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            run_virtual_ddp(2, phase2)
        assert obs.get().counters["reliability.session_resume_rollbacks"] >= 1
    assert cursors[0][0] == cursors[1][0] < 4
    assert cursors[0][1] + cursors[1][1] >= 1
    # the JAX package's sessions resume the port's journals to the same cursors
    jcursors = {}

    def jax_phase2(rank, world_size):
        session = jrel.EvalSession(jm.Accuracy(), tmp_path / f"rank{rank}", keep_last=3)
        jcursors[rank] = session.resume()

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_run_virtual_ddp(2, jax_phase2)
    assert jcursors == {0: cursors[0][0], 1: cursors[1][0]}


def test_multihost_skew_without_common_generation_raises_typed(tmp_path):
    batches = _cls_batches()

    def phase1(rank, world_size):
        session = EvalSession(tm.Accuracy(device=CPU), tmp_path / f"rank{rank}", checkpoint_every=1, keep_last=1)
        with fi.cursor_skew(session, +2 if rank == 1 else 0):
            for i in range(3):
                session.step(i, *map(_t, batches[i]))

    run_virtual_ddp(2, phase1)

    def phase2_strict(rank, world_size):
        session = EvalSession(tm.Accuracy(device=CPU), tmp_path / f"rank{rank}", keep_last=1)
        with pytest.raises(SessionResumeError, match="skewed step cursors"):
            session.resume()

    run_virtual_ddp(2, phase2_strict)

    def phase2_degraded(rank, world_size):
        session = EvalSession(tm.Accuracy(device=CPU), tmp_path / f"rank{rank}", keep_last=1, degraded_ok=True)
        assert session.resume() >= 0

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run_virtual_ddp(2, phase2_degraded)
    assert any("LOCAL accounting" in str(w.message) for w in caught)


def test_step_deadline_checkpoints_last_good_then_raises(tmp_path):
    class WedgedMSE(tm.MeanSquaredError):
        wedge = False

        def update(self, preds, target):
            if WedgedMSE.wedge:
                time.sleep(2.0)
            return super().update(preds, target)

    batches = _reg_batches(3)
    session = EvalSession(WedgedMSE(device=CPU), tmp_path / "j", checkpoint_every=None, step_deadline_s=0.2)
    session.step(0, *map(_t, batches[0]))
    good_total = int(session.metric.total)
    WedgedMSE.wedge = True
    try:
        with obs.telemetry_scope():
            with pytest.raises(SessionStepTimeoutError, match="deadline"):
                session.step(1, *map(_t, batches[1]))
            assert obs.get().counters["reliability.session_deadline_exceeded"] == 1
            assert obs.get().counters["reliability.session_protective_checkpoints"] == 1
    finally:
        WedgedMSE.wedge = False
    assert session.cursor == 0
    envelope, record, _ = session.journal.load_latest_good()
    assert record["cursor"] == 0 and "protective" in record["note"]
    fresh = EvalSession(tm.MeanSquaredError(device=CPU), tmp_path / "j")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert fresh.resume() == 0
    assert int(fresh.metric.total) == good_total


def test_engine_demotion_triggers_protective_checkpoint(tmp_path):
    batches = _reg_batches(2)
    col = _reg_collection(compiled=True)
    session = EvalSession(col, tmp_path / "j", checkpoint_every=1000)
    session.step(0, *map(_t, batches[0]))
    assert session.journal.records() == []
    p, t = map(_t, batches[1])
    doubled = (torch.cat([p, p]), torch.cat([t, t]))
    with obs.telemetry_scope():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with fi.failing_engine_compile(times=1):
                session.step(1, *doubled)
        assert obs.get().counters["reliability.session_protective_checkpoints"] == 1
    records = session.journal.records()
    assert len(records) == 1 and "engine dispatch failure" in records[0]["note"]
    assert records[0]["cursor"] == 1
    clean = _reg_collection(compiled=False)
    clean(*map(_t, batches[0]))
    clean(*doubled)
    resumed = EvalSession(_reg_collection(), tmp_path / "j")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert resumed.resume() == 1
    _assert_bit_identical(resumed.compute(), clean.compute())


def test_resume_warns_on_git_sha_drift(tmp_path, monkeypatch):
    import metrics_tpu_torch.reliability.journal as journal_mod

    batches = _reg_batches(2)
    monkeypatch.setattr(journal_mod, "_GIT_SHA", "a" * 40)
    session = EvalSession(tm.MeanSquaredError(device=CPU), tmp_path / "j", checkpoint_every=1)
    session.step(0, *map(_t, batches[0]))
    monkeypatch.setattr(journal_mod, "_GIT_SHA", "b" * 40)
    fresh = EvalSession(tm.MeanSquaredError(device=CPU), tmp_path / "j")
    with pytest.warns(UserWarning, match="git SHA"):
        assert fresh.resume() == 0


def test_session_validates_inputs(tmp_path):
    with pytest.raises(TypeError, match="EvalSession wraps"):
        EvalSession(object(), tmp_path)
    with pytest.raises(ValueError, match="checkpoint_every"):
        EvalSession(tm.MeanSquaredError(device=CPU), tmp_path, checkpoint_every=0)
    session = EvalSession(tm.MeanSquaredError(device=CPU), tmp_path)
    with pytest.raises(ValueError, match="step_index"):
        session.step(-1, torch.zeros(3), torch.zeros(3))
    with pytest.raises(RuntimeError, match="background_checkpoints=True"):
        with fi.preempt_at_step(session, 3, during="background_write"):
            pass
    with pytest.raises(ValueError, match="during must be"):
        with fi.preempt_at_step(session, 3, during="commit"):
            pass
    background = EvalSession(tm.MeanSquaredError(device=CPU), tmp_path / "bg", background_checkpoints=True)
    assert background._bg is not None
    with fi.preempt_at_step(background, 3, during="background_write") as info:
        assert info == {"preempted_at": -1, "torn_writes": 0}
    background.close()
    assert background._bg is None


def test_state_dict_carries_cursor_for_enrolled_metrics_only(tmp_path):
    plain = tm.MeanSquaredError(device=CPU)
    assert "__session_cursor__" not in plain.state_dict()
    session = EvalSession(tm.MeanSquaredError(device=CPU), tmp_path)
    p, t = _reg_batches(1)[0]
    session.step(0, _t(p), _t(t))
    sd = session.metric.state_dict()
    assert sd["__session_cursor__"].dtype == torch.int32 and int(sd["__session_cursor__"]) == 0
    other = tm.MeanSquaredError(device=CPU)
    other.load_state_dict(sd)
    assert other._session_cursor == 0


def test_skew_agreement_never_advertises_torn_generations(tmp_path):
    batches = _cls_batches()

    def phase1(rank, world_size):
        session = EvalSession(tm.Accuracy(device=CPU), tmp_path / f"rank{rank}", checkpoint_every=1, keep_last=3)
        for i in range(4):
            session.step(i, *map(_t, batches[i]))
        if rank == 1:
            newest = session.journal.records()[-1]
            fi.torn_write(session.journal._gen_path(int(newest["generation"])))

    run_virtual_ddp(2, phase1)
    cursors = {}

    def phase2(rank, world_size):
        session = EvalSession(tm.Accuracy(device=CPU), tmp_path / f"rank{rank}", keep_last=3)
        cursors[rank] = session.resume()

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run_virtual_ddp(2, phase2)
    assert cursors[0] == cursors[1] == 2


def test_skew_agreement_survives_manifest_loss(tmp_path):
    import os

    batches = _cls_batches()

    def phase1(rank, world_size):
        session = EvalSession(tm.Accuracy(device=CPU), tmp_path / f"rank{rank}", checkpoint_every=1, keep_last=3)
        for i in range(4 if rank == 0 else 3):
            session.step(i, *map(_t, batches[i]))
        if rank == 1:
            os.remove(session.journal.manifest_path)

    run_virtual_ddp(2, phase1)
    cursors = {}

    def phase2(rank, world_size):
        session = EvalSession(tm.Accuracy(device=CPU), tmp_path / f"rank{rank}", keep_last=3)
        cursors[rank] = session.resume()

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run_virtual_ddp(2, phase2)
    assert cursors[0] == cursors[1] == 2


def test_resume_accepts_pre_session_envelopes(tmp_path):
    m = tm.MeanSquaredError(device=CPU)
    p, t = map(_t, _reg_batches(1)[0])
    m.update(p, t)
    journal = reliability.CheckpointJournal(tmp_path / "j")
    journal.commit(reliability.save_envelope(m), cursor=6)
    session = EvalSession(tm.MeanSquaredError(device=CPU), tmp_path / "j")
    assert session.resume() == 6
    assert torch.equal(session.metric.sum_squared_error, m.sum_squared_error)
    assert session.step(6, p, t) is None
    assert session.step(7, p, t) is not None


def test_a_jax_session_journal_resumes_in_the_port(tmp_path):
    """A JAX session preempted mid-epoch resumes in the port: the cursor and
    state come from the JAX package's checksummed envelope, and the port's
    rerun ends where JAX's uninterrupted run ends."""
    batches = _reg_batches()
    first = jrel.EvalSession(jm.MeanSquaredError(), tmp_path / "j", checkpoint_every=2)
    with pytest.raises(jrel.faultinject.Preempted):
        with jrel.faultinject.preempt_at_step(first, KILL_AT):
            for i, (p, t) in enumerate(batches):
                first.step(i, jnp.asarray(p), jnp.asarray(t))
    resumed = EvalSession(tm.MeanSquaredError(device=CPU), tmp_path / "j", checkpoint_every=2)
    assert resumed.resume() == KILL_AT - 2  # checkpoints after steps 1 and 3
    for i, (p, t) in enumerate(batches):
        resumed.step(i, _t(p), _t(t))
    clean = jm.MeanSquaredError()
    for p, t in batches:
        clean(jnp.asarray(p), jnp.asarray(t))
    assert float(resumed.compute()) == pytest.approx(float(clean.compute()), rel=1e-5)


# ----------------------------------------------------------------------
# test_chaos_e2e.py
# ----------------------------------------------------------------------
def _chaos_col(compiled):
    return tm.MetricCollection(
        [tm.MeanSquaredError(device=CPU), tm.MeanAbsoluteError(device=CPU), tm.R2Score(device=CPU)], compiled=compiled
    )


@pytest.mark.parametrize("compiled", [False, True])
def test_eval_loop_survives_layered_faults(compiled):
    batches = [(p, t) for t, p in ((b[1], b[0]) for b in _reg_batches(6, 128, seed=11))]
    clean = _chaos_col(compiled)
    for p, t in batches:
        clean(_t(p), _t(t))
    chaotic = _chaos_col(compiled)
    with obs.telemetry_scope(), reliability.guard_scope("quarantine") as guard:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for i, (p, t) in enumerate(batches):
                p, t = _t(p), _t(t)
                if i == 2:
                    chaotic(fi.poison(p, "nan"), t)
                if i == 3 and compiled:
                    with fi.failing_engine_compile(times=1):
                        chaotic(torch.cat([p, p]), torch.cat([t, t]))
                chaotic(p, t)
        env = reliability.save_envelope(chaotic)
        with pytest.raises(reliability.CheckpointError):
            reliability.load_envelope(_chaos_col(False), fi.corrupt_envelope(env, "payload"), strict=True)
        restored = _chaos_col(False)
        reliability.load_envelope(restored, env, strict=True)
    if compiled:
        p, t = map(_t, batches[3])
        clean(torch.cat([p, p]), torch.cat([t, t]))
    want = {k: float(v) for k, v in clean.compute().items()}
    got = {k: float(v) for k, v in chaotic.compute().items()}
    got_restored = {k: float(v) for k, v in restored.compute().items()}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
        assert got_restored[k] == got[k], k
    assert guard.stats["quarantined"] >= 1
    c = obs.get().counters
    assert c["reliability.quarantined"] >= 1
    assert c["reliability.checkpoint_rejects"] == 1
    if compiled:
        assert c.get("reliability.engine_dispatch_recoveries", 0) == 1


def test_quarantine_plus_flaky_sync_together():
    from metrics_tpu_torch.utilities.distributed import gather_all_tensors

    batches = [(_t(p), _t(t)) for p, t in _reg_batches(3, 128, seed=21)]
    clean = tm.MeanSquaredError(device=CPU)
    for p, t in batches:
        clean.update(p, t)
    want = float(clean.compute())
    m = tm.MeanSquaredError(device=CPU)
    m.dist_sync_fn = gather_all_tensors
    with reliability.guard_scope("quarantine"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for p, t in batches:
            m.update(p, t)
        m.update(fi.poison(batches[0][0], "inf"), batches[0][1])
        with fi.flaky_sync_backend(fails=2):
            with reliability.sync_policy_scope(max_retries=3, backoff_s=0.001):
                got = float(m.compute())
    assert got == want


# ----------------------------------------------------------------------
# test_hierarchy_chaos.py: the session over a two-level backend
# ----------------------------------------------------------------------
class SumVec(Metric):
    """A plain exact sum state for the session drills."""

    def __init__(self, n=8):
        super().__init__(device=CPU)
        self.add_state("hist", default=torch.zeros((n,)), dist_reduce_fx="sum")

    def update(self, x):
        self.hist = self.hist + x

    def compute(self):
        return self.hist


def test_pod_dropout_mid_session_resumes_exactly_once_with_quorum(tmp_path):
    def batch(i):
        return torch.full((8,), float(i + 1))

    with fi.simulated_pods(2), obs.telemetry_scope():
        m = SumVec()
        session = EvalSession(m, tmp_path / "journal", checkpoint_every=1)
        for i in range(3):
            session.step(i, batch(i))
        pre = m.hist.clone()
        m2 = SumVec()
        s2 = EvalSession(m2, tmp_path / "journal", checkpoint_every=1)
        with fi.pod_dropout(slice_id=1):
            policy = SyncPolicy(max_retries=0, levels={1: SyncPolicy(max_retries=0, degraded_ok=True)})
            with reliability.sync_policy_scope(policy):
                with warnings.catch_warnings(record=True):
                    warnings.simplefilter("always")
                    cursor = s2.resume()
        assert cursor == 2
        assert torch.equal(m2.hist, pre)
        assert s2.stats["partial_quorum_resumes"] == 1
        assert obs.get().counters.get("reliability.session_partial_quorum_resumes") == 1
        q = last_quorum()
        assert q.source == "session" and q.degraded_level == 1
        assert q.slices_present == (0,) and q.lost_slices == (1,)
        assert s2.step(2, batch(2)) is None
        assert torch.equal(m2.hist, pre)
        assert s2.stats["replays_skipped"] == 1


def test_pod_dropout_resume_degrades_without_a_sync_policy(tmp_path):
    with fi.simulated_pods(2):
        m = SumVec()
        session = EvalSession(m, tmp_path / "journal", checkpoint_every=1)
        session.step(0, torch.ones(8))
        s2 = EvalSession(SumVec(), tmp_path / "journal", degraded_ok=True)
        with fi.pod_dropout(slice_id=1):
            with warnings.catch_warnings(record=True):
                warnings.simplefilter("always")
                cursor = s2.resume()
        assert cursor == 0
        assert s2.stats["partial_quorum_resumes"] == 1
        q = last_quorum()
        assert q.source == "session" and q.slices_present == (0,)


def test_slice_local_skew_resume_does_not_deadlock_over_flat(tmp_path):
    dirs = [tmp_path / f"rank{r}" for r in range(4)]
    for r in range(4):
        s = EvalSession(SumVec(), dirs[r], checkpoint_every=1)
        s.step(0, torch.ones(8))
        if r != 1:
            s.step(1, torch.ones(8))
    flat = VirtualDDPGroup(4)
    prev = set_sync_backend(HierarchicalSyncBackend.over_flat(SyncTopology.regular(2, 2), flat))
    cursors, errors = {}, {}

    def worker(rank):
        _RANK.rank = rank
        try:
            s = EvalSession(SumVec(), dirs[rank])
            with warnings.catch_warnings(record=True):
                warnings.simplefilter("always")
                cursors[rank] = s.resume()
        except BaseException as err:  # noqa: BLE001 - surfaced below
            errors[rank] = err
            flat.abort()

    threads = [threading.Thread(target=worker, args=(r,), daemon=True) for r in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads), "resume deadlocked"
    finally:
        set_sync_backend(prev)
    assert not errors, errors
    assert cursors == {0: 0, 1: 0, 2: 0, 3: 0}


def test_healthy_session_resume_records_full_quorum(tmp_path):
    with fi.simulated_pods(2):
        session = EvalSession(SumVec(4), tmp_path / "journal", checkpoint_every=1)
        session.checkpoint()
        s2 = EvalSession(SumVec(4), tmp_path / "journal")
        s2.resume()
        q = last_quorum()
        assert q is not None and q.full and q.source == "session"
        assert s2.stats["partial_quorum_resumes"] == 0
