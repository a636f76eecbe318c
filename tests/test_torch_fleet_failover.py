"""The port's shard-failure chaos bed against the JAX package's, on the CPU.

Every case of ``tests/reliability/test_fleet_failover.py`` is mirrored
under its name on ``metrics_tpu_torch.fleet``: with replication armed, a
shard is killed (or partitioned) mid-wave, mid-replication and
mid-migration, and after failover plus a full-stream resubmit the promoted
fleet is bit-identical to a never-failed twin fed the same rows; a
returning stale-epoch owner is fenced on commit and wave-ack; a healthy
run keeps every failure counter at zero and writes no dump. Beside them,
one seeded migrate → replicate → failover → redeliver sequence runs
through both packages (``bench.py:756-915`` at 600 tenants): per-tenant
MSE sums within 1e-6 relative, totals exact, and equal ``stats``
dictionaries.
"""
import gc
import glob
import json
import os
import tempfile

import numpy as np
import pytest

import metrics_tpu.observability as jobs
import metrics_tpu_torch.observability as obs
from metrics_tpu_torch import MeanSquaredError
from metrics_tpu_torch.fleet import (
    FleetPlacement,
    FleetRebalancer,
    FleetShard,
    LeaseAuthority,
    MigrationCoordinator,
    ShardReplicator,
    StaleEpochError,
)
from metrics_tpu_torch.parallel.hierarchy import QuorumSnapshot
from metrics_tpu_torch.reliability import faultinject as fi

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


N = 300
NAMES = ["s0", "s1", "s2"]


def _rows(keys, step):
    keys = np.asarray(keys, dtype=np.float64)
    preds = np.stack(
        [keys * 1e-4 + step * 0.125, keys * 1e-4 - step * 0.0625], 1
    ).astype(np.float32)
    target = np.stack([keys * 2e-4, np.zeros_like(keys)], 1).astype(np.float32)
    return preds, target


def _armed_fleet(root, names=NAMES, n=N, ttl_s=30.0):
    """A fleet with the full resilience stack: leases, replication,
    failover-capable rebalancer."""
    placement = FleetPlacement(names)
    shards = {
        nm: FleetShard(nm, MeanSquaredError(device=CPU), os.path.join(root, nm))
        for nm in names
    }
    keys_by = {nm: [] for nm in names}
    for k in range(n):
        keys_by[placement.assign(k)].append(k)
    for nm, keys in keys_by.items():
        if keys:
            shards[nm].add_tenants(keys)
    coord = MigrationCoordinator(placement, shards.values())
    auth = LeaseAuthority(ttl_s=ttl_s)
    for sh in shards.values():
        sh.attach_lease(auth)
    rep = ShardReplicator(coord, authority=auth)
    reb = FleetRebalancer(
        coord,
        shard_ranks={nm: i for i, nm in enumerate(names)},
        replicator=rep,
        authority=auth,
    )
    return placement, shards, coord, auth, rep, reb


def _twin(root, names=NAMES, n=N):
    placement = FleetPlacement(names)
    shards = {
        nm: FleetShard(nm, MeanSquaredError(device=CPU), os.path.join(root, nm))
        for nm in names
    }
    keys_by = {nm: [] for nm in names}
    for k in range(n):
        keys_by[placement.assign(k)].append(k)
    for nm, keys in keys_by.items():
        if keys:
            shards[nm].add_tenants(keys)
    return shards


def _feed(shards, steps):
    for step in steps:
        for sh in shards.values():
            keys = list(sh.tenants())
            if keys:
                sh.submit_wave(step, keys, *_rows(keys, step))


def _state_by_key(shards, n=N):
    """Per-tenant state keyed fleet-wide; asserts exactly-one-owner."""
    out = {}
    filled = np.zeros(n, dtype=bool)
    for sh in shards.values():
        keys = np.asarray(sh.tenants(), dtype=np.int64)
        if keys.size == 0:
            continue
        assert not filled[keys].any(), f"tenants double-counted on {sh.name!r}"
        filled[keys] = True
        slots = np.asarray([sh.slot_of(int(k)) for k in keys])
        for member, states in sh.cohort._states.items():
            for sname, arr in states.items():
                arr = arr.numpy()
                dest = out.setdefault(
                    f"{member}.{sname}", np.zeros((n,) + arr.shape[1:], arr.dtype)
                )
                dest[keys] = arr[slots]
    assert filled.all(), f"{int((~filled).sum())} tenants lost"
    return out


def _assert_bit_identical(shards, twin, n=N):
    got, want = _state_by_key(shards, n), _state_by_key(twin, n)
    assert set(got) == set(want)
    for sname in want:
        np.testing.assert_array_equal(got[sname], want[sname], err_msg=sname)


def _dumps(fd):
    return sorted(glob.glob(os.path.join(fd, "*.json")))


def _reasons(fd):
    return sorted(json.load(open(p))["reason"] for p in _dumps(fd))


# ----------------------------------------------------------------------
# 1. kill mid-wave: the victim folded rows its replicas never saw
# ----------------------------------------------------------------------
def test_kill_mid_wave_failover_resubmit_bit_identical():
    with tempfile.TemporaryDirectory() as d:
        _pl, shards, coord, auth, rep, reb = _armed_fleet(os.path.join(d, "v"))
        twin = _twin(os.path.join(d, "t"))

        _feed(shards, range(3))
        for sh in shards.values():
            sh.checkpoint()
            rep.replicate(sh)
        assert rep.lag() == 0

        # the victim folds one more wave — then dies before replicating it
        dead = "s0"
        dead_keys = list(shards[dead].tenants())
        assert dead_keys
        shards[dead].submit_wave(3, dead_keys, *_rows(dead_keys, 3))
        old_lease = shards[dead].lease
        assert rep.lag(dead) == len(dead_keys)  # the unreplicated wave

        with tempfile.TemporaryDirectory() as fd:
            obs.enable_flight(fd)
            try:
                promoted = reb.failover(dead)
                assert promoted == len(dead_keys)
                assert dead not in coord.shards
                # a pure process death + clean promotion dumps NOTHING
                assert _dumps(fd) == []
            finally:
                obs.disable_flight()

        # promoted tenants sit at the replication watermark (cursor 2);
        # the full-stream resubmit closes the gap exactly once per step
        for sh in coord.shards.values():
            for k in sh.tenants():
                if k in set(dead_keys):
                    assert sh.cursor_of(k) == 2
        _feed(coord.shards, range(6))
        _feed(twin, range(6))
        _assert_bit_identical(coord.shards, twin)

        # the partitioned owner comes back from disk: fenced, typed, loud
        with tempfile.TemporaryDirectory() as fd:
            obs.enable_flight(fd)
            try:
                ghost = FleetShard(
                    dead, MeanSquaredError(device=CPU), os.path.join(d, "v", dead)
                )
                assert ghost.restore()
                ghost.authority = auth
                ghost.lease = old_lease
                with pytest.raises(StaleEpochError):
                    ghost.checkpoint()
                with pytest.raises(StaleEpochError):
                    ghost.submit_wave(9, dead_keys, *_rows(dead_keys, 9))
                assert _reasons(fd) == ["fleet_fenced_write", "fleet_fenced_write"]
            finally:
                obs.disable_flight()
        # nothing merged: the live fleet is still identical to the twin
        _assert_bit_identical(coord.shards, twin)


# ----------------------------------------------------------------------
# 2. kill mid-replication: watermarks split across two cycles
# ----------------------------------------------------------------------
def test_kill_mid_replication_failover_resubmit_bit_identical():
    with tempfile.TemporaryDirectory() as d:
        _pl, shards, coord, auth, rep, reb = _armed_fleet(os.path.join(d, "v"))
        twin = _twin(os.path.join(d, "t"))

        # cycle 1: everyone fully replicated at cursor 1
        _feed(shards, range(2))
        for sh in shards.values():
            sh.checkpoint()
            rep.replicate(sh)

        # cycle 2: two more steps fold, but the victim dies HALFWAY
        # through shipping them — half its tenants at watermark 3, half
        # still at 1
        _feed(shards, range(2, 4))
        dead = "s1"
        dead_keys = list(shards[dead].tenants())
        half = dead_keys[: len(dead_keys) // 2]
        shards[dead].checkpoint()
        shipped = rep.replicate(shards[dead], keys=half)
        assert shipped == sum(
            1 for k in half if rep.follower_of(k, dead) is not None
        )

        with tempfile.TemporaryDirectory() as fd:
            obs.enable_flight(fd)
            try:
                promoted = reb.failover(dead)
                assert promoted == len(dead_keys)
                assert _dumps(fd) == []
            finally:
                obs.disable_flight()

        # mixed watermarks: replicated half at 3, the rest at 1
        cursors = {
            k: sh.cursor_of(k)
            for sh in coord.shards.values()
            for k in sh.tenants()
            if k in set(dead_keys)
        }
        assert {cursors[k] for k in half} == {3}
        assert {cursors[k] for k in dead_keys if k not in set(half)} == {1}

        _feed(coord.shards, range(5))
        _feed(twin, range(5))
        _assert_bit_identical(coord.shards, twin)


# ----------------------------------------------------------------------
# 3. partition mid-migration: heal, recover, automatic failover, fence
# ----------------------------------------------------------------------
def test_partition_mid_migration_auto_failover_fences_live_owner():
    with tempfile.TemporaryDirectory() as d:
        _pl, shards, coord, auth, rep, reb = _armed_fleet(
            os.path.join(d, "v"), n=120
        )
        twin = _twin(os.path.join(d, "t"), n=120)

        _feed(shards, range(2))
        for sh in shards.values():
            sh.checkpoint()
            rep.replicate(sh)

        dead = "s0"
        dead_keys = list(shards[dead].tenants())
        key = dead_keys[0]
        dst = next(nm for nm in NAMES if nm != dead)

        with tempfile.TemporaryDirectory() as fd:
            obs.enable_flight(fd)
            try:
                # the partition hits while the handoff is mid-protocol
                with fi.kill_at_migration_phase(
                    coord, "pre_commit", mode="partition"
                ) as info:
                    with pytest.raises(fi.TransportPartitioned):
                        coord.migrate(key, dst)
                    assert info["kills"] == 1
                    info["heal"]()
                    # live-object recovery after the heal: abort, one owner
                    assert [o[1] for o in coord.recover()] == ["aborted"]
                assert _reasons(fd) == ["fleet_migration_interrupted"]
            finally:
                obs.disable_flight()

        # the partition outlasted the lease: the quorum reports the
        # victim's rank lost and check_failover promotes automatically
        q = QuorumSnapshot(
            world_size=len(NAMES),
            num_slices=len(NAMES),
            slices_present=(1, 2),
            ranks_present=(1, 2),
        )
        live_victim = shards[dead]  # the process is STILL RUNNING
        failed_over = reb.check_failover(quorum=q)
        assert failed_over == [dead]
        assert dead not in coord.shards

        # the still-running old owner is fenced on every write path
        with tempfile.TemporaryDirectory() as fd:
            obs.enable_flight(fd)
            try:
                with pytest.raises(StaleEpochError):
                    live_victim.checkpoint()
                with pytest.raises(StaleEpochError):
                    live_victim.submit_wave(5, dead_keys, *_rows(dead_keys, 5))
                assert _reasons(fd) == [
                    "fleet_fenced_write",
                    "fleet_fenced_write",
                ]
            finally:
                obs.disable_flight()

        _feed(coord.shards, range(4))
        _feed(twin, range(4))
        _assert_bit_identical(coord.shards, twin, n=120)


# ----------------------------------------------------------------------
# 4. healthy run: zero failure counters, zero dumps, zero lag
# ----------------------------------------------------------------------
def test_healthy_armed_run_zero_failure_counters_zero_dumps():
    obs.enable()
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as fd:
        obs.enable_flight(fd)
        try:
            _pl, shards, coord, auth, rep, reb = _armed_fleet(d, n=96)
            _feed(shards, range(3))
            for sh in shards.values():
                sh.checkpoint()
                rep.replicate(sh)
            assert rep.lag() == 0

            # ordinary serving churn on the armed fleet
            src = next(nm for nm in NAMES if shards[nm].tenants())
            dst = next(nm for nm in NAMES if nm != src)
            for k in list(shards[src].tenants())[:2]:
                assert coord.migrate(k, dst) is not None
            assert coord.recover() == []
            assert reb.check_failover(quorum=None) == []

            counters = obs.get().counters
            for key in (
                "fleet.replication.failed",
                "fleet.lease.fenced_writes",
                "fleet.lease.expirations",
                "fleet.failovers",
                "fleet.failover.tenants_promoted",
                "fleet.evacuation_rows_lost",
            ):
                assert counters.get(key, 0) == 0, key
            assert counters.get("fleet.replication.replicated", 0) == 96
            assert _dumps(fd) == []
            _state_by_key(shards, n=96)
        finally:
            obs.disable_flight()


# ----------------------------------------------------------------------
# against the JAX package: migrate → replicate → failover → redeliver
# ----------------------------------------------------------------------
SEQ_N, SEQ_ROWS, SEQ_FEAT = 600, 2, 8


def _seq_wave(keys, step):
    base = np.asarray(keys, dtype=np.float64)[:, None, None]
    preds = (base * 1e-4 + step * 0.125 + np.arange(SEQ_FEAT) * 0.01).astype(np.float32)
    preds = np.broadcast_to(preds, (len(keys), SEQ_ROWS, SEQ_FEAT)).copy()
    target = np.broadcast_to((base * 2e-4).astype(np.float32), preds.shape).copy()
    return preds, target


def _sequence(fl, serving, metric, root):
    """The failover leg (``bench.py:756-915``) at ``SEQ_N`` tenants with a
    migration in it, through one package: returns the per-key states and
    every ``stats`` dictionary."""
    names = ["s0", "s1", "s2"]
    placement = fl.FleetPlacement(names)
    shards = {nm: fl.FleetShard(nm, metric(), os.path.join(root, nm)) for nm in names}
    by_shard = {nm: [] for nm in names}
    for k in range(SEQ_N):
        by_shard[placement.assign(k)].append(k)
    for nm, sh in shards.items():
        sh.add_tenants(by_shard[nm])
    coord = fl.MigrationCoordinator(placement, shards.values())
    auth = fl.LeaseAuthority(ttl_s=3600.0)
    for sh in shards.values():
        sh.attach_lease(auth)
    rep = fl.ShardReplicator(coord, authority=auth)
    reb = fl.FleetRebalancer(coord, replicator=rep, authority=auth)

    def feed(step, only=None):
        for nm, sh in coord.shards.items():
            if only is None or nm in only:
                keys = list(sh.tenants())
                sh.submit_wave(step, keys, *_seq_wave(keys, step))

    for step in (0, 1):
        feed(step)
    for sh in shards.values():
        sh.checkpoint()
        rep.replicate(sh)
    for key in by_shard["s1"][:5]:
        coord.migrate(key, "s0")
    for step in (2, 3):
        feed(step)
    for sh in shards.values():
        sh.checkpoint()
        rep.replicate(sh)
    assert rep.lag() == 0

    dead = "s0"
    dead_keys = list(shards[dead].tenants())
    key_of = {shards[dead].slot_of(k): k for k in dead_keys}
    q = serving.IngestQueue(shards[dead].cohort, rows_per_step=SEQ_ROWS, coalesce_max=1, redelivery_window=8)
    for step in (4, 5):
        preds, target = _seq_wave(dead_keys, step)
        ids = np.repeat(np.asarray([shards[dead].slot_of(k) for k in dead_keys], dtype=np.int64), SEQ_ROWS)
        q.submit(ids, preds.reshape(-1, SEQ_FEAT), target.reshape(-1, SEQ_FEAT))
        feed(step, only=[nm for nm in names if nm != dead])

    def resubmit(tids, *arrs):
        step = 4 + resubmit.waves
        resubmit.waves += 1
        order = np.argsort(np.asarray(tids), kind="stable")
        keys = [key_of[int(s)] for s in np.asarray(tids)[order][::SEQ_ROWS]]
        blocks = [np.asarray(a)[order].reshape(len(keys), SEQ_ROWS, -1) for a in arrs]
        owners = {}
        for j, k in enumerate(keys):
            owners.setdefault(coord.find_tenant(k), []).append(j)
        for nm, idx in owners.items():
            coord.shards[nm].submit_wave(step, [keys[j] for j in idx], *[b[idx] for b in blocks])

    resubmit.waves = 0
    assert reb.failover(dead) == len(dead_keys)
    redelivered = q.redeliver(submit=resubmit)
    assert redelivered == 2 * len(dead_keys) * SEQ_ROWS
    states = {}
    for sh in coord.shards.values():
        for k in sh.tenants():
            assert sh.cursor_of(k) == 5
            for member, d in sh.cohort._states.items():
                for sname, v in d.items():
                    states[(k, f"{member}.{sname}")] = np.asarray(v[sh.slot_of(k)])
    stats = {"coordinator": dict(coord.stats), "replicator": dict(rep.stats), "queue": dict(q.stats),
             "shards": {nm: dict(sh.stats) for nm, sh in coord.shards.items()}}
    return states, stats


def test_migrate_replicate_failover_redeliver_matches_jax(tmp_path):
    import metrics_tpu as jm
    import metrics_tpu.serving as jserving
    from metrics_tpu import fleet as jfleet
    from metrics_tpu_torch import fleet as tfleet
    from metrics_tpu_torch import serving as tserving

    jstates, jstats = _sequence(jfleet, jserving, jm.MeanSquaredError, str(tmp_path / "jax"))
    states, stats = _sequence(tfleet, tserving, lambda: MeanSquaredError(device=CPU), str(tmp_path / "port"))
    assert stats == jstats
    assert set(states) == set(jstates) and len(states) == SEQ_N * 2
    for key, want in jstates.items():
        got = states[key]
        assert got.dtype == want.dtype, key
        if key[1].endswith("total"):
            np.testing.assert_array_equal(got, want, err_msg=str(key))
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=str(key))
