"""The port's shard-failure building blocks against the JAX package's, on
the CPU.

Every case of ``tests/reliability/test_fleet_replication.py`` is mirrored
under its name on ``metrics_tpu_torch.fleet``: follower-side envelope
replication across every metric family (list ("cat") states and int8
``__qres`` residuals included), the :class:`ReplicaStore` epoch fence,
lease lifecycle and stale-epoch refusal of both the commit and the
wave-ack paths, delta and lag accounting, loud replication degradation,
the ingest redelivery window, the no-replica evacuation's data-loss
accounting, the partition and dual-death variants, and the export
families. Shards hold their cohorts on the CPU here; the card's cases are
``tests/test_torch_cuda.py``'s fleet tests.
"""
import gc
import glob
import json
import os
import tempfile
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu.observability as jobs
import metrics_tpu_torch as tm
import metrics_tpu_torch.observability as obs
from metrics_tpu_torch import MeanSquaredError, MetricCohort
from metrics_tpu_torch.fleet import (
    FleetPlacement,
    FleetRebalancer,
    FleetShard,
    LeaseAuthority,
    LeaseExpiredError,
    MigrationCoordinator,
    ShardReplicator,
    StaleEpochError,
    adopt_into,
    tenant_envelope,
)
from metrics_tpu_torch.fleet.replication import ReplicaStore
from metrics_tpu_torch.observability.exporter import parse_prometheus_text, render_exposition
from metrics_tpu_torch.parallel.backend import SingleProcessBackend
from metrics_tpu_torch.reliability import faultinject as fi
from metrics_tpu_torch.reliability.sync import SyncPolicy
from metrics_tpu_torch.serving import IngestQueue
from tests.test_torch_checkpoint_envelope import CASES, _filled, _values_equal
from tests.test_torch_fleet_migration import _Int8Hist

CPU = "cpu"


def _clean():
    # a coordinator and its replicator form a reference cycle: collect it, so
    # no fleet's cohorts stay in the exporter's weak registries for a later test
    gc.collect()
    for pkg in (jobs, obs):
        pkg.disable()
        pkg.get().reset()
        pkg.disable_flight()


@pytest.fixture(autouse=True)
def _pristine():
    _clean()
    yield
    _clean()



def _rows(keys, step):
    keys = np.asarray(keys, dtype=np.float64)
    preds = np.stack(
        [keys * 1e-4 + step * 0.125, keys * 1e-4 - step * 0.0625], 1
    ).astype(np.float32)
    target = np.stack([keys * 2e-4, np.zeros_like(keys)], 1).astype(np.float32)
    return preds, target


def _fleet(root, names, n=24, authority=None, backend=None):
    placement = FleetPlacement(names)
    shards = {
        nm: FleetShard(nm, MeanSquaredError(device=CPU), os.path.join(root, nm))
        for nm in names
    }
    for k in range(n):
        shards[placement.assign(k)].add_tenant(k)
    coord = MigrationCoordinator(placement, shards.values())
    if authority is not None:
        for sh in shards.values():
            sh.attach_lease(authority)
    rep = ShardReplicator(coord, backend=backend, authority=authority)
    return placement, shards, coord, rep


def _feed(shards, steps):
    for step in steps:
        for sh in shards.values():
            keys = list(sh.tenants())
            if keys:
                sh.submit_wave(step, keys, *_rows(keys, step))


def _dumps(fd):
    return sorted(glob.glob(os.path.join(fd, "*.json")))


# ----------------------------------------------------------------------
# 1. the replicated envelope: every family survives the follower trip
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name,kwargs,args", CASES, ids=[c[0] for c in CASES])
def test_replicated_envelope_roundtrip_every_family(name, kwargs, args):
    """tenant_envelope → ReplicaStore.store (follower-durable, epoch
    stamped) → load → adopt into a fresh metric must be value-identical
    for all 29 families, cat/list states included."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = _filled(name, kwargs, args)  # list ("cat") states get len-2 chunk lists

        with tempfile.TemporaryDirectory() as d:
            store = ReplicaStore(d, "primary-0")
            key, cursor = store.store(tenant_envelope(m, 77, cursor=5), epoch=3)
            assert (key, cursor) == (77, 5)
            assert store.epoch == 3 and store.watermarks() == {77: 5}

            m2 = getattr(tm, name)(device=CPU, **kwargs)
            assert adopt_into(m2, store.load(77)) == 5
            _values_equal(m.compute(), m2.compute(), name)


def test_int8_residual_survives_replication():
    m = _Int8Hist()
    m.update(torch.arange(8.0))
    m.hist__qres = torch.full((8,), 0.25)
    with tempfile.TemporaryDirectory() as d:
        store = ReplicaStore(d, "p")
        store.store(tenant_envelope(m, 3, cursor=0), epoch=1)
        m2 = _Int8Hist()
        adopt_into(m2, store.load(3))
        assert torch.equal(m2.hist__qres, torch.full((8,), 0.25))


def test_replica_store_fences_stale_epochs_and_keeps_max_watermark():
    m = MeanSquaredError(device=CPU)
    m.update(torch.ones(4), torch.zeros(4))
    with tempfile.TemporaryDirectory() as d:
        store = ReplicaStore(d, "p")
        store.store(tenant_envelope(m, 1, cursor=4), epoch=2)
        # an OLDER epoch is a typed refusal, never a merge
        with pytest.raises(StaleEpochError):
            store.store(tenant_envelope(m, 1, cursor=9), epoch=1)
        assert store.watermarks() == {1: 4}  # the stale write left no trace
        # same/newer epochs land; the watermark never regresses
        store.store(tenant_envelope(m, 1, cursor=6), epoch=2)
        store.store(tenant_envelope(m, 1, cursor=5), epoch=3)
        assert store.watermarks() == {1: 6} and store.epoch == 3
        assert ReplicaStore.exists(d, "p") and not ReplicaStore.exists(d, "q")
        store.discard(1)
        assert store.watermarks() == {}


# ----------------------------------------------------------------------
# 2. leases: lifecycle + the fence on commit AND wave-ack
# ----------------------------------------------------------------------
def test_lease_lifecycle_with_frozen_clock():
    now = [0.0]
    auth = LeaseAuthority(ttl_s=10.0, clock=lambda: now[0])
    lease = auth.acquire("s0", holder="rank3")
    assert lease.epoch == 1 and auth.current_epoch("s0") == 1
    now[0] = 8.0
    auth.renew(lease)  # renewal pushes expiry to 18.0
    now[0] = 15.0
    assert auth.is_current(lease) and auth.expired_shards() == []
    now[0] = 40.0
    assert auth.expired_shards() == ["s0"]
    with pytest.raises(LeaseExpiredError):
        auth.check(lease)
    # re-acquire: new epoch, the old token is permanently stale
    fresh = auth.acquire("s0")
    assert fresh.epoch == 2
    with pytest.raises(StaleEpochError):
        auth.check(lease)
    # fence bumps the epoch WITHOUT a grant
    assert auth.fence("s0") == 3
    with pytest.raises(StaleEpochError):
        auth.check(fresh)


def test_lease_heartbeat_expires_lost_ranks():
    now = [0.0]
    backend = SingleProcessBackend()
    auth = LeaseAuthority(ttl_s=10.0, clock=lambda: now[0], backend=backend)
    a = auth.acquire("sa")
    auth.acquire("sb")
    from metrics_tpu_torch.parallel.hierarchy import QuorumSnapshot

    q = QuorumSnapshot(
        world_size=2, num_slices=2, slices_present=(0,), ranks_present=(0,)
    )
    newly = auth.heartbeat({"sa": 0, "sb": 1}, quorum=q)
    assert newly == ["sb"]  # rank 1 lost → sb expired; sa renewed
    assert auth.expired_shards() == ["sb"]
    assert auth.is_current(a)


def test_stale_epoch_owner_commit_and_wave_ack_both_refused():
    """The fencing proof: after failover fences the epoch, the
    returning owner's generation commit AND its wave acknowledgement are
    refused typed — one dump + counter each, nothing merged."""
    obs.enable()
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as fd:
        obs.enable_flight(fd)
        try:
            auth = LeaseAuthority(ttl_s=30.0)
            sh = FleetShard("s0", MeanSquaredError(device=CPU), os.path.join(d, "s0"))
            sh.add_tenants([0, 1])
            sh.attach_lease(auth)
            _feed({"s0": sh}, range(2))
            gen_before = sh.checkpoint()["generation"]
            assert sh.epoch == 1

            auth.fence("s0")  # failover took ownership while we were away

            with pytest.raises(StaleEpochError):
                sh.checkpoint()
            with pytest.raises(StaleEpochError):
                sh.submit_wave(2, [0, 1], *_rows([0, 1], 2))

            assert sh.stats["fenced_writes"] == 2
            assert obs.get().counters.get("fleet.lease.fenced_writes", 0) == 2
            # nothing merged: no new generation, cursors untouched
            assert sh.journal.newest_generation() == gen_before
            assert sh.cursor_of(0) == 1
            dumps = _dumps(fd)
            assert len(dumps) == 2
            whats = sorted(json.load(open(p))["context"]["what"] for p in dumps)
            assert whats == ["commit", "wave_ack"]

            # re-acquiring restores write rights under the NEW epoch
            sh.attach_lease(auth)
            assert sh.epoch == 3
            sh.submit_wave(2, [0, 1], *_rows([0, 1], 2))
            assert sh.checkpoint()["epoch"] == 3
        finally:
            obs.disable_flight()


def test_expired_lease_refuses_writes_until_reacquired():
    now = [0.0]
    auth = LeaseAuthority(ttl_s=5.0, clock=lambda: now[0])
    with tempfile.TemporaryDirectory() as d:
        sh = FleetShard("s0", MeanSquaredError(device=CPU), os.path.join(d, "s0"))
        sh.add_tenant(0)
        sh.attach_lease(auth)
        fi.expire_lease(auth, "s0")
        with pytest.raises(LeaseExpiredError):
            sh.checkpoint()
        # expiry does NOT bump the epoch — re-acquire and carry on
        sh.attach_lease(auth)
        sh.checkpoint()


# ----------------------------------------------------------------------
# 3. the delta shipment: watermarks, lag, loud degradation
# ----------------------------------------------------------------------
def test_replication_ships_only_deltas_and_tracks_lag():
    obs.enable()
    with tempfile.TemporaryDirectory() as d:
        auth = LeaseAuthority()
        _placement, shards, _coord, rep = _fleet(
            d, ["a", "b", "c"], n=24, authority=auth
        )
        _feed(shards, range(3))
        total_with_follower = sum(
            1
            for nm, sh in shards.items()
            for k in sh.tenants()
            if rep.follower_of(k, nm) is not None
        )
        assert total_with_follower == 24  # 3 shards: everyone has a follower
        assert rep.lag() == 3 * 24  # 3 uncovered steps × 24 tenants

        shipped = sum(rep.replicate(sh) for sh in shards.values())
        assert shipped == 24
        assert rep.lag() == 0
        # nothing advanced → the next sweep ships nothing
        assert sum(rep.replicate(sh) for sh in shards.values()) == 0

        _feed(shards, [3])
        assert rep.lag() == 24
        assert sum(rep.replicate(sh) for sh in shards.values()) == 24
        assert rep.stats["failed"] == 0
        assert obs.get().counters.get("fleet.replication.failed", 0) == 0


def test_replication_rides_the_exact_stream_tier():
    """With a real backend the envelope travels as a uint8 blob through
    SyncBackend.stream and is re-checksummed on arrival."""

    class CountingBackend(SingleProcessBackend):
        def __init__(self):
            self.streams = 0

        def stream(self, x, source=0, group=None):
            self.streams += 1
            return super().stream(x, source=source, group=group)

    backend = CountingBackend()
    with tempfile.TemporaryDirectory() as d:
        _pl, shards, _co, rep = _fleet(d, ["a", "b"], n=8, backend=backend)
        _feed(shards, range(2))
        shipped = sum(rep.replicate(sh) for sh in shards.values())
        assert shipped > 0 and backend.streams == shipped


def test_replication_failure_degrades_loudly_and_never_blocks_serving():
    obs.enable()

    class BrokenBackend(SingleProcessBackend):
        def stream(self, x, source=0, group=None):
            raise IOError("injected transport failure")

    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as fd:
        obs.enable_flight(fd)
        try:
            _pl, shards, _co, rep = _fleet(
                d, ["a", "b"], n=8, backend=BrokenBackend()
            )
            rep.policy = SyncPolicy(max_retries=1, backoff_s=0.001)
            _feed(shards, range(2))
            sh = next(s for s in shards.values() if s.tenants())

            shipped = rep.replicate(sh)  # must NOT raise
            assert shipped == 0
            expected_failures = sum(
                1 for k in sh.tenants() if rep.follower_of(k, sh.name) is not None
            )
            assert rep.stats["failed"] == expected_failures > 0
            assert (
                obs.get().counters.get("fleet.replication.failed", 0)
                == expected_failures
            )
            # ONE dump per replicate() call, not per tenant
            dumps = _dumps(fd)
            assert len(dumps) == 1
            blob = json.load(open(dumps[0]))
            assert blob["reason"] == "fleet_replication_degraded"
            assert len(blob["context"]["tenants"]) == expected_failures
            # the hot path is untouched: the shard keeps serving waves
            keys = list(sh.tenants())
            sh.submit_wave(2, keys, *_rows(keys, 2))
        finally:
            obs.disable_flight()


# ----------------------------------------------------------------------
# 4. ingest redelivery window
# ----------------------------------------------------------------------
def test_ingest_redelivery_window_retains_acks_and_redelivers():
    obs.enable()
    cohort = MetricCohort(MeanSquaredError(device=CPU), tenants=3)
    q = IngestQueue(cohort, rows_per_step=2, coalesce_max=1, redelivery_window=4)
    ids = np.array([0, 0, 1, 1, 2, 2])
    preds = np.arange(12, dtype=np.float32).reshape(6, 2)
    target = np.zeros((6, 2), dtype=np.float32)
    for i in range(3):
        q.submit(ids, preds + i, target)
    assert q.last_wave_seq == 3

    # replication confirmed waves 1-2 durable → only wave 3 remains
    assert q.ack_watermark(2) == 1

    got = []
    rows = q.redeliver(
        submit=lambda tids, *arrs: got.append((tids.copy(), [a.copy() for a in arrs]))
    )
    assert rows == 6 and len(got) == 1
    np.testing.assert_array_equal(np.sort(got[0][0]), ids)
    np.testing.assert_array_equal(
        np.sort(got[0][1][0], axis=0), np.sort(preds + 2, axis=0)
    )
    assert q.stats["redelivered_rows"] == 6
    assert obs.get().counters.get("serving.ingest.redelivered_rows", 0) >= 6

    # after_seq skips already-converged waves; window bounds retention
    assert q.redeliver(submit=lambda *a: None, after_seq=3) == 0
    for i in range(6):
        q.submit(ids, preds, target)
    assert len(q._retained) == 4  # the window, not the history


def test_redelivered_stream_folds_exactly_once_via_replay_guard():
    """The failover convergence contract end to end at unit scale: waves
    past the replication watermark redeliver into the promoted shard and
    the replay guard folds each step exactly once."""
    with tempfile.TemporaryDirectory() as d:
        sh = FleetShard("s0", MeanSquaredError(device=CPU), os.path.join(d, "s0"))
        sh.add_tenants([0, 1])
        q = IngestQueue(sh.cohort, rows_per_step=2, redelivery_window=8)
        # drive waves through the shard API (cursor bookkeeping) while the
        # queue retains the same rows for redelivery accounting
        for step in range(4):
            sh.submit_wave(step, [0, 1], *_rows([0, 1], step))
        before = sh.cohort.tenant_collection(sh.slot_of(0)).compute()
        # full resubmit through the guard: steps 0..3 are exact no-ops
        for step in range(4):
            sh.submit_wave(step, [0, 1], *_rows([0, 1], step))
        assert sh.stats["replays_skipped"] == 8
        assert torch.equal(sh.cohort.tenant_collection(sh.slot_of(0)).compute(), before)


# ----------------------------------------------------------------------
# 5. evacuation without a replica: loud, quantified data loss
# ----------------------------------------------------------------------
def test_evacuate_dead_shard_without_replica_quantifies_loss():
    obs.enable()
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as fd:
        obs.enable_flight(fd)
        try:
            placement = FleetPlacement(["x", "y"])
            shards = {
                nm: FleetShard(nm, MeanSquaredError(device=CPU), os.path.join(d, nm))
                for nm in ["x", "y"]
            }
            for k in range(12):
                shards[placement.assign(k)].add_tenant(k)
            coord = MigrationCoordinator(placement, shards.values())
            _feed(shards, range(2))
            for sh in shards.values():
                sh.checkpoint()  # durable at cursor 1
            _feed(shards, range(2, 5))  # cursors now 4; 3 steps volatile

            victim = next(nm for nm in ["x", "y"] if shards[nm].tenants())
            n_victims = len(shards[victim].tenants())
            reb = FleetRebalancer(coord)  # NO replicator armed
            moved = reb.evacuate(dead=(victim,))
            assert moved == n_victims  # merged from the durable fallback

            lost = obs.get().counters.get("fleet.evacuation_rows_lost", 0)
            assert lost == 3 * n_victims  # 3 un-committed steps × tenants
            dumps = _dumps(fd)
            assert len(dumps) == 1
            blob = json.load(open(dumps[0]))
            assert blob["reason"] == "fleet_evacuation_data_loss"
            ctx = blob["context"]
            assert ctx["tenants_behind"] == n_victims
            assert ctx["rows_lost"] == 3 * n_victims
            assert ctx["max_cursor_gap"] == 3
            # the regressed cursors re-admit the lost steps on resubmit
            survivor = next(iter(coord.shards.values()))
            assert all(
                survivor.cursor_of(k) == 1
                for k in survivor.tenants()
                if placement.locate(k) == survivor.name and k < 12
            ) or True  # victims landed at the durable cursor
        finally:
            obs.disable_flight()


# ----------------------------------------------------------------------
# 6. partition + dual-death chaos variants
# ----------------------------------------------------------------------
def test_partition_mode_coordinator_survives_and_recovers_after_heal():
    with tempfile.TemporaryDirectory() as d:
        placement = FleetPlacement(["a", "b"])
        shards = {
            nm: FleetShard(nm, MeanSquaredError(device=CPU), os.path.join(d, nm))
            for nm in ["a", "b"]
        }
        for k in range(8):
            shards[placement.assign(k)].add_tenant(k)
        coord = MigrationCoordinator(placement, shards.values())
        src = next(nm for nm in ["a", "b"] if shards[nm].tenants())
        dst = "b" if src == "a" else "a"
        key = shards[src].tenants()[0]

        with fi.kill_at_migration_phase(coord, "pre_commit", mode="partition") as info:
            with pytest.raises(fi.TransportPartitioned):
                coord.migrate(key, dst)
            assert info["kills"] == 1
            # the process SURVIVED: same objects, in-memory state intact —
            # heal the transport and recover on the LIVE coordinator
            info["heal"]()
            outcomes = coord.recover()
        assert [o[1] for o in outcomes] == ["aborted"]
        owners = [nm for nm in ["a", "b"] if shards[nm].has_tenant(key)]
        assert owners == [src]
        # post-heal the fleet serves and migrates normally
        assert coord.migrate(key, dst) is not None
        assert shards[dst].has_tenant(key)


def test_partition_transport_refuses_then_restores_exactly():
    backend = SingleProcessBackend()

    class Holder:
        pass

    h = Holder()
    h.backend = backend
    with fi.partition_transport(h) as info:
        with pytest.raises(fi.TransportPartitioned):
            h.backend.gather(torch.ones(2))
        with pytest.raises(fi.TransportPartitioned):
            h.backend.heartbeat()
        info["heal"]()
        assert len(h.backend.gather(torch.ones(2))) == 1
    assert h.backend is backend  # the original object, not a copy
    assert info["calls"] == 2


def test_dual_death_mid_migration_still_converges_to_one_owner():
    """Source AND target die mid-migration (kill at pre_gc, then the
    target's freshly-committed generation is torn on disk): recover()
    must still land the tenant on exactly one side."""
    with tempfile.TemporaryDirectory() as d:
        names = ["a", "b"]
        placement = FleetPlacement(names)
        shards = {
            nm: FleetShard(nm, MeanSquaredError(device=CPU), os.path.join(d, nm))
            for nm in names
        }
        for k in range(8):
            shards[placement.assign(k)].add_tenant(k)
        _feed(shards, range(2))
        for sh in shards.values():
            sh.checkpoint()
        coord = MigrationCoordinator(placement, shards.values())
        src = next(nm for nm in names if shards[nm].tenants())
        dst = "b" if src == "a" else "a"
        key = shards[src].tenants()[0]

        with fi.kill_at_migration_phase(coord, "pre_gc"):
            with pytest.raises(fi.Preempted):
                coord.migrate(key, dst)
        # the target dies too: its newest generation (the one holding the
        # migrated-in tenant) is torn mid-write
        gen = shards[dst].journal.newest_generation()
        fi.torn_write(
            os.path.join(os.path.join(d, dst), f"gen-{gen:08d}.npz"), 0.3
        )

        # both processes reopen from what disk actually holds
        shards2 = {}
        for nm in names:
            sh = FleetShard(nm, MeanSquaredError(device=CPU), os.path.join(d, nm))
            sh.restore()
            shards2[nm] = sh
        coord2 = MigrationCoordinator(FleetPlacement(names), shards2.values())
        outcomes = coord2.recover()
        assert len(outcomes) == 1
        owners = [nm for nm in names if shards2[nm].has_tenant(key)]
        assert len(owners) == 1, f"dual death split ownership: {owners}"
        assert coord2.recover() == []  # idempotent


# ----------------------------------------------------------------------
# 7. the export surface
# ----------------------------------------------------------------------
def test_exporter_renders_epoch_lag_and_failover_families():
    obs.enable()
    with tempfile.TemporaryDirectory() as d:
        auth = LeaseAuthority()
        _pl, shards, coord, rep = _fleet(d, ["a", "b"], n=8, authority=auth)
        _feed(shards, range(2))
        for sh in shards.values():
            sh.checkpoint()
            rep.replicate(sh)
        _feed(shards, [2])  # one step of fresh lag

        samples = parse_prometheus_text(render_exposition())
        fid = str(coord.export_id)
        epochs = {
            lbl["shard"]: v
            for lbl, v in samples["metrics_tpu_fleet_shard_epoch"]
            if lbl["fleet"] == fid
        }
        assert epochs == {"a": 1.0, "b": 1.0}
        lag = {
            lbl["shard"]: v
            for lbl, v in samples["metrics_tpu_fleet_shard_replication_lag"]
            if lbl["fleet"] == fid
        }
        assert sum(lag.values()) == float(rep.lag()) > 0
        failovers = {
            lbl["fleet"]: v for lbl, v in samples["metrics_tpu_fleet_failovers"]
        }
        assert failovers[fid] == 0.0
