"""The port's elastic-fleet chaos bed against the JAX package's, on the CPU.

Every case of ``tests/reliability/test_fleet_chaos.py`` is mirrored under
its name on ``metrics_tpu_torch.fleet`` at JAX's size: a 10,000-tenant
fleet killed at every migration phase and mid-rebalance, rebuilt from disk
after each kill, ``recover()``ed to exactly one owner per tenant, and a
resubmitted stream bit-identical to a never-migrated twin. Beside them, a
fleet directory crosses between the packages both ways: written by one
package's shards (journals, ``MIGRATIONS.json`` with a stranded handoff,
replica manifests), restored and ``recover()``ed by the other's, with the
same tenants, cursors, replica watermarks and states as the writer's own
recovery.
"""
import gc
import glob
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
    MigrationCoordinator,
)
from metrics_tpu_torch.reliability import faultinject as fi
from metrics_tpu_torch.reliability.faultinject import Preempted, kill_at_migration_phase

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


N = 10_000
NAMES = ["s0", "s1"]


def _rows(keys, step):
    """Deterministic per-(tenant, step) row batch: two samples per step."""
    keys = np.asarray(keys, dtype=np.float64)
    preds = np.stack(
        [keys * 1e-4 + step * 0.125, keys * 1e-4 - step * 0.0625], 1
    ).astype(np.float32)
    target = np.stack([keys * 2e-4, np.zeros_like(keys)], 1).astype(np.float32)
    return preds, target


def _build(root, names, n=N):
    placement = FleetPlacement(names)
    shards = {
        nm: FleetShard(nm, MeanSquaredError(device=CPU), os.path.join(root, nm)) for nm in names
    }
    keys_by = {nm: [] for nm in names}
    for k in range(n):
        keys_by[placement.assign(k)].append(k)
    for nm, keys in keys_by.items():
        if keys:
            shards[nm].add_tenants(keys)
    return placement, shards


def _reopen(root, names):
    """A fresh process: rebuild every shard from its journal alone."""
    shards = {}
    for nm in names:
        sh = FleetShard(nm, MeanSquaredError(device=CPU), os.path.join(root, nm))
        sh.restore()
        shards[nm] = sh
    return shards


def _feed(shards, steps):
    for step in steps:
        for sh in shards.values():
            keys = list(sh.tenants())
            if keys:
                sh.submit_wave(step, keys, *_rows(keys, step))


def _state_by_key(shards, n=N):
    """Vectorized per-tenant state fetch keyed by fleet-wide tenant key.
    Doubles as the exactly-once assertion: every key on exactly one
    shard, none lost, none duplicated."""
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


def _dumps(fd):
    return sorted(glob.glob(os.path.join(fd, "*.json")))


def test_kill_at_every_phase_and_mid_rebalance_10k():
    with tempfile.TemporaryDirectory() as d:
        vroot, troot = os.path.join(d, "victim"), os.path.join(d, "twin")

        # the victim fleet: 10k tenants over two shards, four steps
        # folded and durable before any fault is injected
        placement, shards = _build(vroot, NAMES)
        _feed(shards, range(4))
        for sh in shards.values():
            sh.checkpoint()

        # the never-migrated control twin (same placement, same rows)
        _twin_placement, twin = _build(troot, NAMES)
        _feed(twin, range(4))

        # ------------------------------------------------------------------
        # one kill per protocol phase; fresh process + recover() after each
        # ------------------------------------------------------------------
        for i, phase in enumerate(MigrationCoordinator.PHASES):
            coord = MigrationCoordinator(placement, list(shards.values()))
            victim = shards["s0"].tenants()[i]
            with tempfile.TemporaryDirectory() as fd:
                obs.enable_flight(fd)
                try:
                    with kill_at_migration_phase(coord, phase) as info:
                        with pytest.raises(Preempted):
                            coord.migrate(victim, "s1")
                    assert info["kills"] == 1
                    # exactly ONE flight dump per injected kill
                    dumps = _dumps(fd)
                    assert len(dumps) == 1, (phase, dumps)
                    with open(dumps[0]) as f:
                        blob = f.read()
                    assert "fleet_migration_interrupted" in blob
                    assert phase in blob
                finally:
                    obs.disable_flight()

            # the process dies: rebuild everything from durable state
            placement = FleetPlacement(NAMES)
            shards = _reopen(vroot, NAMES)
            coord = MigrationCoordinator(placement, list(shards.values()))
            outcomes = coord.recover()

            if phase == "prepare":
                # killed before anything durable — nothing to recover
                assert outcomes == []
                assert shards["s0"].has_tenant(victim)
            elif phase in ("in_flight", "pre_commit"):
                # prepared but no target generation → abort: tenant home
                assert [o[1] for o in outcomes] == ["aborted"]
                assert shards["s0"].has_tenant(victim)
                assert not shards["s1"].has_tenant(victim)
            else:  # pre_gc: the target's generation was durable → finish
                assert [o[1] for o in outcomes] == ["completed"]
                assert shards["s1"].has_tenant(victim)
                assert not shards["s0"].has_tenant(victim)
            assert coord.recover() == []  # recovery is idempotent
            _state_by_key(shards)  # every tenant on exactly one shard

        # ------------------------------------------------------------------
        # kill mid-rebalance: a third shard joins, converge() dies on its
        # 4th move's pre-commit
        # ------------------------------------------------------------------
        names3 = NAMES + ["s2"]
        shards["s2"] = FleetShard("s2", MeanSquaredError(device=CPU), os.path.join(vroot, "s2"))
        placement.add_shard("s2")
        coord = MigrationCoordinator(placement, list(shards.values()))
        reb = FleetRebalancer(coord)
        with tempfile.TemporaryDirectory() as fd:
            obs.enable_flight(fd)
            try:
                with kill_at_migration_phase(coord, "pre_commit", after=3) as info:
                    with pytest.raises(Preempted):
                        reb.converge(max_moves=8)
                assert info["kills"] == 1
                assert len(_dumps(fd)) == 1  # the 3 completed moves dump nothing
            finally:
                obs.disable_flight()

        placement = FleetPlacement(names3)
        shards = _reopen(vroot, names3)
        assert len(shards["s2"]) == 3  # the completed moves survived the kill
        coord = MigrationCoordinator(placement, list(shards.values()))
        outcomes = coord.recover()
        assert [o[1] for o in outcomes] == ["aborted"]
        _state_by_key(shards)

        # finish a bounded slice of the reshard cleanly, then serve on
        assert FleetRebalancer(coord).converge(max_moves=12) == 12
        assert len(shards["s2"]) == 15
        _state_by_key(shards)

        # ------------------------------------------------------------------
        # the resumed stream: resubmit EVERYTHING from step 0 — migrated
        # cursors make steps 0..3 exact no-ops, steps 4..5 fold once
        # ------------------------------------------------------------------
        _feed(shards, range(6))
        skipped = sum(sh.stats["replays_skipped"] for sh in shards.values())
        assert skipped == 4 * N  # four already-covered steps × every tenant
        assert all(
            sh.cursor_of(k) == 5 for sh in shards.values() for k in sh.tenants()
        )

        _feed(twin, [4, 5])  # the control just keeps streaming

        # bit-identical, tenant by tenant, across the whole fleet
        got = _state_by_key(shards)
        want = _state_by_key(twin)
        assert set(got) == set(want)
        for sname in want:
            np.testing.assert_array_equal(got[sname], want[sname], err_msg=sname)


def test_healthy_fleet_run_zero_failure_counters_zero_dumps():
    obs.enable()
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as fd:
        obs.enable_flight(fd)
        try:
            placement, shards = _build(d, NAMES, n=64)
            _feed(shards, range(2))
            for sh in shards.values():
                sh.checkpoint()
            coord = MigrationCoordinator(placement, list(shards.values()))
            for key in list(shards["s0"].tenants())[:3]:
                assert coord.migrate(key, "s1") is not None
            assert coord.recover() == []  # nothing stranded

            counters = obs.get().counters
            assert counters.get("fleet.migrations_failed", 0) == 0
            assert counters.get("fleet.evacuations", 0) == 0
            assert counters.get("fleet.migrations_done", 0) == 3
            assert _dumps(fd) == []
            _state_by_key(shards, n=64)
        finally:
            obs.disable_flight()


# ----------------------------------------------------------------------
# a fleet directory crosses between the packages, both ways
# ----------------------------------------------------------------------
CROSS_N = 64
CROSS_NAMES = ["a", "b"]


def _write_fleet(fl, fi_mod, metric, root):
    """Two leased, replicated shards of ``CROSS_N`` tenants, three steps
    folded and committed, two finished handoffs and one killed at
    ``pre_gc`` (a ``prepared`` record whose target committed)."""
    placement = fl.FleetPlacement(CROSS_NAMES)
    shards = {nm: fl.FleetShard(nm, metric(), os.path.join(root, nm)) for nm in CROSS_NAMES}
    for k in range(CROSS_N):
        shards[placement.assign(k)].add_tenant(k)
    coord = fl.MigrationCoordinator(placement, shards.values())
    auth = fl.LeaseAuthority(ttl_s=3600.0)
    for sh in shards.values():
        sh.attach_lease(auth)
    rep = fl.ShardReplicator(coord, authority=auth)
    _feed(shards, range(3))
    for sh in shards.values():
        sh.checkpoint()
        rep.replicate(sh)
    moving = list(shards["a"].tenants())[:3]
    for k in moving[:2]:
        coord.migrate(k, "b")
    with fi_mod.kill_at_migration_phase(coord, "pre_gc"):
        with pytest.raises(fi_mod.Preempted):
            coord.migrate(moving[2], "b")
    return moving[2]


def _reopen_and_recover(fl, metric, root):
    """A fresh process of either package over ``root``: every shard from
    its journal, then ``recover()``; returns what the fleet holds."""
    shards = {}
    for nm in CROSS_NAMES:
        sh = fl.FleetShard(nm, metric(), os.path.join(root, nm))
        assert sh.restore()
        shards[nm] = sh
    coord = fl.MigrationCoordinator(fl.FleetPlacement(CROSS_NAMES), shards.values())
    outcomes = [o[1] for o in coord.recover()]
    held = {}
    for nm, sh in shards.items():
        for k in sh.tenants():
            states = {f"{m}.{s}": np.asarray(v[sh.slot_of(k)]) for m, d in sh.cohort._states.items()
                      for s, v in d.items()}
            held[k] = (nm, sh.cursor_of(k), states)
    replicas = {(f, p): fl.ReplicaStore(os.path.join(root, f), p).watermarks()
                for f in CROSS_NAMES for p in CROSS_NAMES if f != p}
    return outcomes, held, replicas


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fleet_directory_crosses_between_packages(tmp_path, writer):
    import shutil

    import metrics_tpu as jm
    from metrics_tpu import fleet as jfleet
    from metrics_tpu.reliability import faultinject as jfi
    from metrics_tpu_torch import fleet as tfleet

    port_metric = lambda: MeanSquaredError(device=CPU)  # noqa: E731
    sides = {"jax": (jfleet, jfi, jm.MeanSquaredError), "port": (tfleet, fi, port_metric)}
    reader = "port" if writer == "jax" else "jax"
    root = str(tmp_path / "fleet")
    stranded = _write_fleet(*sides[writer], root)
    shutil.copytree(root, str(tmp_path / "copy"))
    want = _reopen_and_recover(sides[writer][0], sides[writer][2], str(tmp_path / "copy"))
    got = _reopen_and_recover(sides[reader][0], sides[reader][2], root)
    assert got[0] == want[0] == ["completed"]
    assert got[2] == want[2] and sum(len(w) for w in got[2].values()) > 0
    assert sorted(got[1]) == sorted(want[1]) == list(range(CROSS_N))
    assert got[1][stranded][0] == "b"
    for k, (nm, cursor, states) in want[1].items():
        assert got[1][k][:2] == (nm, cursor), k
        assert set(got[1][k][2]) == set(states)
        for s, v in states.items():
            np.testing.assert_array_equal(got[1][k][2][s], v, err_msg=f"{k} {s}")
