"""The port's serving chaos drills against the JAX package's, on the CPU.

Every case of ``tests/reliability/test_serving_chaos.py`` is mirrored: a
preemption mid background write resumes bit-equal and exactly once, a
healthy background run writes no flight dump, the backpressure policies do
what their names say under a slow consumer, a submission is validated before
any row is shed, a parked writer error survives a non-raising drain, a
closed session checkpoints synchronously, and shedding by health sheds the
poisoned tenant first and a healthy tenant loudly. The main drills run
through the JAX package too: its cursors, replay counts, journal records,
shed accounting and dumps must equal the port's, its values within 1e-5.
These four cases were listed as not ported in ``tests/test_torch_session.py``
until the port had ``serving/``: the preemption mid background write, the
healthy background run, the parked error and the closed session.

Every wait has a bound.
"""
import glob
import os
import tempfile

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
from metrics_tpu.serving import AsyncServingEngine as JaxAsyncServingEngine
from metrics_tpu.serving import IngestQueue as JaxIngestQueue
from metrics_tpu_torch.reliability import EvalSession
from metrics_tpu_torch.reliability import faultinject as fi
from metrics_tpu_torch.reliability.faultinject import Preempted, preempt_at_step, slow_consumer
from metrics_tpu_torch.serving import AsyncServingEngine, IngestOverflowError, IngestQueue

CPU = "cpu"
WAIT_S = 30.0


@pytest.fixture(autouse=True)
def _pristine():
    def clean():
        for pkg in (jobs, obs):
            pkg.disable()
            pkg.get().reset()
            pkg.disable_flight()

    clean()
    yield
    clean()


@pytest.fixture(autouse=True)
def _bounded_drains(monkeypatch):
    """Every barrier of both packages' pipelines has a bound, the implicit
    ones too (``compute()``, ``close()``): a hang in a worker fails its test
    instead of running out the suite's clock."""
    for cls in (AsyncServingEngine, JaxAsyncServingEngine):
        real = cls.drain
        monkeypatch.setattr(cls, "drain", lambda self, timeout_s=WAIT_S, _real=real: _real(self, timeout_s))


def _cls_batches(n=8, seed=0, rows=64):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        p = rng.rand(rows, 4).astype(np.float32)
        p /= p.sum(1, keepdims=True)
        out.append((p, rng.randint(4, size=rows).astype(np.int32)))
    return out


def _t(batch):
    return tuple(torch.from_numpy(np.asarray(a)) for a in batch)


def _j(batch):
    return tuple(jnp.asarray(a) for a in batch)


def _col():
    return tm.MetricCollection(
        [tm.Accuracy(device=CPU), tm.F1(num_classes=4, average="macro", device=CPU)], compiled=True
    )


def _jax_col():
    return jm.MetricCollection([jm.Accuracy(), jm.F1(num_classes=4, average="macro")], compiled=True)


def _dumps(directory):
    return sorted(glob.glob(os.path.join(directory, "*.json")))


# ----------------------------------------------------------------------
# 1. preemption mid background write: exactly once, bit-equal
# ----------------------------------------------------------------------
def _preempt_drill(pkg_obs, session_cls, inject, make_col, conv, batches):
    """The drill in one package: what it leaves on disk, the resume and the
    resumed values."""
    out = {}
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as fd:
        pkg_obs.enable_flight(fd)
        try:
            session = session_cls(make_col(), d, checkpoint_every=2, background_checkpoints=True)
            for i in range(4):
                session.step(i, *conv(batches[i]))
            session.flush_checkpoints()
            out["committed"] = [r["cursor"] for r in session.journal.records()]
            with inject.preempt_at_step(session, 6, during="background_write") as info:
                session.step(4, *conv(batches[4]))
                session.step(5, *conv(batches[5]))  # the cadence fires: the commit is torn
                session._bg.drain(timeout_s=10.0, raise_errors=False)
                with pytest.raises(inject.Preempted):
                    session.step(6, *conv(batches[6]))
            out["info"] = dict(info)
            out["carcass"] = any(p.endswith(".tmp") for p in glob.glob(os.path.join(d, "*")))
            out["after"] = [r["cursor"] for r in session.journal.records()]
            dumps = _dumps(fd)
            out["dumps"] = len(dumps)
            with open(dumps[0]) as f:
                out["dump_reason"] = "background_checkpoint_failure" in f.read()
            session._bg.close()
            del session

            resumed = session_cls(make_col(), d, checkpoint_every=2, background_checkpoints=True)
            out["cursor"] = resumed.resume()
            for i, b in enumerate(batches):
                resumed.step(i, *conv(b))
            out["replays_skipped"] = resumed.stats["replays_skipped"]
            out["values"] = {k: np.asarray(v) for k, v in resumed.compute().items()}
            resumed.flush_checkpoints()
            out["final"] = [r["cursor"] for r in resumed.journal.records()]
            resumed.close()
        finally:
            pkg_obs.disable_flight()
    return out


def test_preempt_mid_background_write_resumes_bit_identical():
    batches = _cls_batches(n=8, seed=1)
    twin = _col()
    for b in batches:
        twin(*_t(b))
    e_twin = twin.compute()

    port = _preempt_drill(obs, EvalSession, fi, _col, _t, batches)
    assert port["committed"] == [1, 3]
    assert port["info"] == {"preempted_at": 6, "torn_writes": 1}
    # the torn write was never visible: a .tmp carcass, the manifest ends at 3
    assert port["carcass"] and port["after"] == [1, 3]
    assert port["dumps"] == 1 and port["dump_reason"]
    assert port["cursor"] == 3 and port["replays_skipped"] == 4
    for k in e_twin:
        assert np.array_equal(np.asarray(e_twin[k]), port["values"][k]), k

    ref = _preempt_drill(jobs, jrel.EvalSession, jfi, _jax_col, _j, batches)
    for key in ("committed", "info", "carcass", "after", "dumps", "dump_reason", "cursor", "replays_skipped",
                "final"):
        assert port[key] == ref[key], key
    for k in ref["values"]:
        np.testing.assert_allclose(port["values"][k], ref["values"][k], rtol=1e-5, err_msg=k)


def test_background_checkpoints_healthy_run_writes_zero_dumps():
    batches = _cls_batches(n=6, seed=2)
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as fd:
        obs.enable_flight(fd)
        try:
            session = EvalSession(_col(), d, checkpoint_every=2, background_checkpoints=True)
            for i, b in enumerate(batches):
                session.step(i, *_t(b))
            session.flush_checkpoints()
            assert session._bg.stats["errors"] == 0
            assert _dumps(fd) == []
            # newest state wins: every committed generation is a cadence cursor
            assert {r["cursor"] for r in session.journal.records()} <= {1, 3, 5}
            assert session.journal.records()[-1]["cursor"] == 5
            session.close()
        finally:
            obs.disable_flight()


def test_background_checkpoint_resumes_to_the_same_state_as_a_synchronous_one():
    """The envelope the writer commits is the synchronous envelope: the same
    checksum, and a resume from either restores the same bits."""
    from metrics_tpu_torch.reliability.checkpoint import read_envelope

    batches = _cls_batches(n=4, seed=9)
    checksums = {}
    states = {}
    for background in (False, True):
        with tempfile.TemporaryDirectory() as d:
            session = EvalSession(_col(), d, checkpoint_every=4, background_checkpoints=background)
            for i, b in enumerate(batches):
                session.step(i, *_t(b))
            session.flush_checkpoints()
            (record,) = session.journal.records()
            checksums[background] = read_envelope(session.journal._gen_path(record["generation"]))["checksum"]
            session.close()
            fresh = EvalSession(_col(), d)
            assert fresh.resume() == 3
            states[background] = dict(fresh.metric._named_states())
    assert checksums[False] == checksums[True]
    for k, v in states[False].items():
        assert torch.equal(torch.as_tensor(v), torch.as_tensor(states[True][k])), k


def test_protective_checkpoint_goes_through_the_writer_synchronously(tmp_path):
    from metrics_tpu_torch.reliability.faultinject import failing_engine_compile

    batches = _cls_batches(n=3, seed=10)
    session = EvalSession(_col(), tmp_path / "j", checkpoint_every=None, background_checkpoints=True)
    session.step(0, *_t(batches[0]))
    with failing_engine_compile(times=1):
        session.step(1, *_t(_cls_batches(n=1, seed=11, rows=40)[0]))
    assert session.stats["protective_checkpoints"] == 1
    # durable at once, through the writer's lock: no flush needed
    assert [r["cursor"] for r in session.journal.records()] == [1]
    assert session._bg.stats["commits"] == 1
    session.close()


# ----------------------------------------------------------------------
# 2. slow consumer: the backpressure drills
# ----------------------------------------------------------------------
def test_slow_consumer_block_policy_bounds_then_raises():
    """A wave that cannot form (one tenant never contributes) under
    ``block`` bound-waits and raises typed: it never hangs, never drops."""
    cohort = tm.MetricCohort(tm.Accuracy(device=CPU), tenants=2)
    q = IngestQueue(cohort, rows_per_step=8, max_buffered_rows=16, policy="block", block_timeout_s=0.4)
    rng = np.random.RandomState(0)
    ids = np.zeros(16, dtype=np.int32)  # tenant 0 only: no wave can form
    p = rng.rand(16).astype(np.float32)
    q.submit(ids, p, (p > 0.5).astype(np.int32))
    with pytest.raises(IngestOverflowError):
        q.submit(ids, p, (p > 0.5).astype(np.int32))
    assert q.stats["shed_rows"] == 0  # block never loses data
    assert q.buffered_rows == 16


def test_slow_consumer_delays_async_dispatches_but_loses_nothing():
    served = _col()
    pipe = AsyncServingEngine(served)
    batches = _cls_batches(n=3, seed=3)
    pipe.forward(*_t(batches[0]))  # the first dispatch outside the drill
    pipe.drain(timeout_s=WAIT_S)
    with slow_consumer(pipe, delay_s=0.05) as info:
        for b in batches[1:]:
            pipe.forward(*_t(b))
        pipe.drain(timeout_s=WAIT_S)
    assert info["delayed"] == 2
    assert pipe.stats["dispatches"] == 3 and pipe.stats["errors"] == 0
    assert "_dispatch" not in pipe.__dict__  # the drill restored the method
    reference = _col()
    for b in batches:
        reference(*_t(b))
    for key in reference.keys():
        for sname in reference[key]._defaults:
            assert torch.equal(getattr(reference[key], sname), getattr(served[key], sname))
    pipe.close()


def test_slow_consumer_wraps_ingest_queue_target():
    cohort = tm.MetricCohort(tm.Accuracy(device=CPU), tenants=2)
    q = IngestQueue(cohort, rows_per_step=8, max_buffered_rows=256)
    rng = np.random.RandomState(1)
    ids = np.tile(np.array([0, 1], dtype=np.int32), 8)
    p = rng.rand(16).astype(np.float32)
    with slow_consumer(q, delay_s=0.02) as info:
        q.submit(ids, p, (p > 0.5).astype(np.int32))
    assert info["delayed"] == 1
    assert q.stats["dispatches"] == 1 and q.buffered_rows == 0
    assert q._target is cohort
    with pytest.raises(TypeError, match="slow_consumer wraps"):
        with slow_consumer(cohort):
            pass


# ----------------------------------------------------------------------
# 3. shed policies: loss is counted, a healthy tenant's loss is loud
# ----------------------------------------------------------------------
def _shed_oldest(pkg, pkg_obs, queue_cls, kw, fd):
    pkg_obs.enable_flight(fd)
    try:
        cohort = pkg.MetricCohort(pkg.Accuracy(**kw), tenants=2)
        q = queue_cls(cohort, rows_per_step=8, max_buffered_rows=16, policy="shed_oldest")
        rng = np.random.RandomState(2)
        ids = np.zeros(16, dtype=np.int32)  # ragged: tenant 0 only
        p = rng.rand(16).astype(np.float32)
        q.submit(ids, p, (p > 0.5).astype(np.int32))
        q.submit(ids, p, (p > 0.5).astype(np.int32))  # sheds the oldest 16
        return dict(q.stats), q.buffered_rows, _dumps(fd)
    finally:
        pkg_obs.disable_flight()


def test_shed_oldest_counts_rows_and_writes_no_dump():
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        port = _shed_oldest(tm, obs, IngestQueue, {"device": CPU}, a)
        ref = _shed_oldest(jm, jobs, JaxIngestQueue, {}, b)
    stats, buffered, dumps = port
    assert stats["shed_rows"] == 16 and stats["shed_healthy_rows"] == 0
    assert buffered == 16
    assert dumps == []  # a breadcrumb, no dump
    assert port == ref


def test_oversize_submission_rejected_before_any_shedding():
    cohort = tm.MetricCohort(tm.Accuracy(device=CPU), tenants=2)
    q = IngestQueue(cohort, rows_per_step=8, max_buffered_rows=16, policy="shed_oldest")
    rng = np.random.RandomState(4)
    p = rng.rand(16).astype(np.float32)
    q.submit(np.zeros(16, dtype=np.int32), p, (p > 0.5).astype(np.int32))
    bp = rng.rand(17).astype(np.float32)
    with pytest.raises(ValueError, match="max_buffered_rows"):
        q.submit(np.zeros(17, dtype=np.int32), bp, (bp > 0.5).astype(np.int32))
    assert q.stats["shed_rows"] == 0 and q.buffered_rows == 16


def test_unknown_tenant_rejected_before_backpressure():
    cohort = tm.MetricCohort(tm.Accuracy(device=CPU), tenants=2)
    q = IngestQueue(cohort, rows_per_step=8, max_buffered_rows=16, policy="shed_oldest")
    rng = np.random.RandomState(5)
    p = rng.rand(16).astype(np.float32)
    q.submit(np.zeros(16, dtype=np.int32), p, (p > 0.5).astype(np.int32))  # at the bound
    bp = rng.rand(8).astype(np.float32)
    with pytest.raises(KeyError):
        q.submit(np.full(8, 7, dtype=np.int32), bp, (bp > 0.5).astype(np.int32))  # slot 7 is not live
    assert q.stats["shed_rows"] == 0 and q.buffered_rows == 16


def test_parked_bg_error_survives_nonraising_drain_until_flush():
    batches = _cls_batches(n=2, seed=6)
    with tempfile.TemporaryDirectory() as d:
        session = EvalSession(_col(), d, checkpoint_every=None, background_checkpoints=True)
        session.step(0, *_t(batches[0]))

        def failing_commit(job):
            raise OSError("injected disk-full")

        session._bg._commit_job = failing_commit
        try:
            session.checkpoint()
            session._bg.drain(timeout_s=10.0, raise_errors=False)  # parked, kept
            assert session.resume() == 0  # nothing committed; resume does not raise the parked error
        finally:
            del session._bg._commit_job
        with pytest.raises(OSError, match="disk-full"):
            session.flush_checkpoints()
        session.flush_checkpoints()  # consumed by the raising barrier
        session.close()


def test_session_close_stops_writer_and_falls_back_to_sync():
    batches = _cls_batches(n=3, seed=7)
    with tempfile.TemporaryDirectory() as d:
        session = EvalSession(_col(), d, checkpoint_every=1, background_checkpoints=True)
        session.step(0, *_t(batches[0]))
        writer = session._bg._worker
        session.close()
        assert session._bg is None
        assert writer is None or not writer.is_alive()
        session.step(1, *_t(batches[1]))  # the cadence checkpoint: synchronous now
        assert [r["cursor"] for r in session.journal.records()][-1] == 1
        session.close()  # a no-op now


def _shed_by_health(pkg, pkg_obs, queue_cls, kw, conv, fd):
    pkg_obs.enable_flight(fd)
    out = []
    try:
        with pkg_obs.telemetry_scope():
            cohort = pkg.MetricCohort(pkg.MeanSquaredError(**kw), tenants=2, track_health=True)
            rng = np.random.RandomState(3)
            # poison tenant 1 in the step: NaN rows make a non-finite state,
            # counted by the health accumulators riding the step
            x = rng.rand(2, 8).astype(np.float32)
            bad = x.copy()
            bad[1, 0] = np.nan
            cohort(*conv((bad, x)))
            out.append(int(cohort.health()["nonfinite"][1]))
            q = queue_cls(cohort, rows_per_step=8, max_buffered_rows=16, policy="shed_by_health")
            p = rng.rand(16).astype(np.float32)
            q.submit(np.ones(16, dtype=np.int32), p, p)  # the poisoned tenant's ragged rows
            q.submit(np.zeros(16, dtype=np.int32), p, p)  # sheds the poisoned buffer first
            out.append((dict(q.stats), len(_dumps(fd))))
            q.submit(np.zeros(16, dtype=np.int32), p, p)  # only healthy rows left: loud
            dumps = _dumps(fd)
            with open(dumps[0]) as f:
                reason = "ingest_shed_healthy" in f.read()
            out.append((dict(q.stats), len(dumps), reason,
                        pkg_obs.get().counters.get("serving.ingest.shed_healthy_rows")))
    finally:
        pkg_obs.disable_flight()
    return out


def test_shed_by_health_sheds_poisoned_first_and_healthy_loss_is_loud():
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        port = _shed_by_health(tm, obs, IngestQueue, {"device": CPU}, _t, a)
        ref = _shed_by_health(jm, jobs, JaxIngestQueue, {}, _j, b)
    nonfinite, (first, first_dumps), (second, dumps, reason, counter) = port
    assert nonfinite > 0
    assert first["shed_rows"] == 16 and first["shed_healthy_rows"] == 0 and first_dumps == 0
    assert second["shed_healthy_rows"] == 16 and second["shed_rows"] == 32
    assert dumps == 1 and reason and counter == 16
    assert port == ref


def test_preempt_at_step_validates_during():
    batches = _cls_batches(n=1, seed=8)
    with tempfile.TemporaryDirectory() as d:
        session = EvalSession(_col(), d, checkpoint_every=None)
        with pytest.raises(ValueError, match="during"):
            with preempt_at_step(session, 1, during="flush"):
                pass
        with pytest.raises(RuntimeError, match="background_checkpoints=True"):
            with preempt_at_step(session, 1, during="background_write"):
                pass
        assert "step" not in session.__dict__  # nothing left patched
        session.step(0, *_t(batches[0]))
        with preempt_at_step(session, 1) as info, pytest.raises(Preempted):
            session.step(1, *_t(batches[0]))
        assert info["preempted_at"] == 1
