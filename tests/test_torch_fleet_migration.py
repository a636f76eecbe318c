"""The port's fleet migration machinery against the JAX package's, on the CPU.

Every case of ``tests/reliability/test_fleet_migration.py`` is mirrored
under its name on ``metrics_tpu_torch.fleet`` at JAX's sizes (every metric
family's tenant envelope, list ("cat") states and ``__qres`` residuals
included; placement; capacity growth and shrink on both sides of a
handoff; the ingest drain; the ``metrics_tpu_fleet_*`` families). Beside
them, against the JAX package on the same seeded numpy inputs:

* 10,000 keys placed on the same shards by both packages, and the churn
  ratio after a third shard equal (and at most 0.45);
* a JAX tenant envelope adopted by the port and the port's envelope of
  that state adopted back by JAX: counts exact, floats bit-equal;
* the partial wave: a tenant's state after a wave that folds only some of
  a 5,000-tenant shard's tenants (1, 3, half, all but one) equals its state
  after the full-shard dispatch bit for bit, also on shards whose capacity
  grew through migrations or shrank through a restore, and a full wave
  after a partial one reads the partial wave's rows;
* on a shard cohort served by an ``AsyncServingEngine`` whose worker sits
  inside a step, a handoff, a replication, a commit and a partial wave each
  wait for that step and hand on the state after ``drain()``.

Tolerance: none in the port's own cases (the port's states are compared
with the port's); the JAX comparisons are bit-equal where both packages
hold the same bits (envelopes, placement).
"""
import gc
import os
import tempfile
import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.observability as jobs
import metrics_tpu_torch as tm
import metrics_tpu_torch.observability as obs
from metrics_tpu import fleet as jfleet
from metrics_tpu.reliability import checkpoint as jckpt
from metrics_tpu_torch import MeanAbsoluteError, MeanSquaredError, Metric, MetricCohort
from metrics_tpu_torch.fleet import (
    TENANT_ENVELOPE_FORMAT,
    FleetPlacement,
    FleetShard,
    MigrationCoordinator,
    ShardReplicator,
    adopt_into,
    open_tenant_envelope,
    tenant_envelope,
)
from metrics_tpu_torch.observability.exporter import parse_prometheus_text, render_exposition
from metrics_tpu_torch.reliability import faultinject as fi
from metrics_tpu_torch.reliability.checkpoint import (
    CheckpointCorruptionError,
    CheckpointMismatchError,
    envelope_from_bytes,
    envelope_to_bytes,
)
from metrics_tpu_torch.serving import AsyncServingEngine, IngestQueue
from tests.test_torch_checkpoint_envelope import CASES, _filled, _values_equal

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


# ----------------------------------------------------------------------
# 1. the tenant envelope: every family rides, bit-identical
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name,kwargs,args", CASES, ids=[c[0] for c in CASES])
def test_tenant_envelope_roundtrip_every_family(name, kwargs, args):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = _filled(name, kwargs, args)  # two batches: list ("cat") states get len-2 lists

        env = tenant_envelope(m, 4242, cursor=7)
        assert env["format"] == TENANT_ENVELOPE_FORMAT
        key, cursor, payload, pending = open_tenant_envelope(env)
        assert (key, cursor, pending) == (4242, 7, None)
        assert payload  # the state universe rode along

        m2 = getattr(tm, name)(device=CPU, **kwargs)
        assert adopt_into(m2, env) == 7
        # the replay guard fast-forwarded: step 7 must now be a no-op
        assert m2._session_cursor == 7
        _values_equal(m.compute(), m2.compute(), name)


def test_tenant_envelope_rejects_foreign_metric():
    m = MeanSquaredError(device=CPU)
    m.update(torch.ones(4), torch.zeros(4))
    env = tenant_envelope(m, 1)
    with pytest.raises(CheckpointMismatchError, match="does not fit"):
        adopt_into(MeanAbsoluteError(device=CPU), env)


def test_tenant_envelope_checksum_catches_bit_rot():
    m = MeanSquaredError(device=CPU)
    m.update(torch.ones(4), torch.zeros(4))
    env = tenant_envelope(m, 1)
    bad = fi.corrupt_envelope(env, mode="payload")
    with pytest.raises(CheckpointCorruptionError):
        open_tenant_envelope(bad)


def test_cat_state_tenant_stays_eager_and_portable():
    """Curve metrics (list states) never enter a cohort: they migrate as
    standalone eager tenants, list chunks preserved chunk for chunk."""
    preds = torch.from_numpy(np.random.RandomState(7).rand(16).astype(np.float32))
    target = torch.from_numpy(np.random.RandomState(8).randint(2, size=16))
    m = tm.AUROC(device=CPU)
    m.update(preds, target)
    m.update(preds, target)
    list_states = [k for k, v in m._defaults.items() if isinstance(v, list)]
    assert list_states, "AUROC should carry list states"

    m2 = tm.AUROC(device=CPU)
    adopt_into(m2, tenant_envelope(m, 9, cursor=1))
    for sname in list_states:
        src_chunks, dst_chunks = getattr(m, sname), getattr(m2, sname)
        assert len(dst_chunks) == len(src_chunks) == 2
        for a, b in zip(src_chunks, dst_chunks):
            assert torch.equal(a, b)
    _values_equal(m.compute(), m2.compute(), "AUROC")


class _Int8Hist(Metric):
    """A quantized-sync-tier state: its ``hist__qres`` error-feedback
    residual is real accumulated state and must ride the envelope."""

    def __init__(self):
        super().__init__(device=CPU)
        self.add_state("hist", default=torch.zeros(8), dist_reduce_fx="sum", sync_precision="int8")

    def update(self, x):
        self.hist = self.hist + torch.as_tensor(x, dtype=torch.float32)

    def compute(self):
        return self.hist


def test_int8_residual_rides_the_envelope():
    m = _Int8Hist()
    m.update(torch.arange(8.0))
    m.hist__qres = torch.full((8,), 0.25)

    m2 = _Int8Hist()
    adopt_into(m2, tenant_envelope(m, 3))
    assert torch.equal(m2.hist, torch.arange(8.0))
    assert torch.equal(m2.hist__qres, torch.full((8,), 0.25))


# ----------------------------------------------------------------------
# 2. rendezvous placement
# ----------------------------------------------------------------------
def test_placement_is_deterministic_and_minimal_churn():
    names = ["shard-0", "shard-1", "shard-2"]
    a, b = FleetPlacement(names), FleetPlacement(list(reversed(names)))
    keys = list(range(2000))
    # deterministic across processes AND insertion orders
    assert [a.assign(k) for k in keys] == [b.assign(k) for k in keys]

    before = {k: a.assign(k) for k in keys}
    a.add_shard("shard-3")
    moved = [k for k in keys if a.assign(k) != before[k]]
    # every moved key landed on the NEW shard, and only ~1/N moved
    assert all(a.assign(k) == "shard-3" for k in moved)
    assert 0 < len(moved) / len(keys) < 0.45


def test_placement_overrides_follow_migrations():
    p = FleetPlacement(["a", "b"])
    key = next(k for k in range(64) if p.assign(k) == "a")
    g0 = p.generation
    p.record_location(key, "b")
    assert p.locate(key) == "b" and key in p.overrides
    assert p.generation > g0
    # recording the HOME shard clears the override instead of storing it
    p.record_location(key, "a")
    assert key not in p.overrides and p.locate(key) == "a"
    with pytest.raises(RuntimeError):
        FleetPlacement([]).assign(0)


# ----------------------------------------------------------------------
# 3. shard handoffs: capacity grows/shrinks on both sides, state exact
# ----------------------------------------------------------------------
def _rows(keys, step):
    keys = np.asarray(keys, dtype=np.float64)
    preds = np.stack([keys * 1e-3 + step, keys * 1e-3 - step], 1).astype(np.float32)
    target = np.stack([keys * 2e-3, np.zeros_like(keys)], 1).astype(np.float32)
    return preds, target


def _shard(name, root):
    return FleetShard(name, MeanSquaredError(device=CPU), os.path.join(root, name))


def test_migration_grows_target_and_shrinks_source_capacity():
    with tempfile.TemporaryDirectory() as d:
        src, dst = _shard("src", d), _shard("dst", d)
        keys = list(range(9))
        src.add_tenants(keys)
        for step in range(3):
            src.submit_wave(step, keys, *_rows(keys, step))
        src.checkpoint()
        cap_src0, cap_dst0 = src.cohort.capacity, dst.cohort.capacity
        assert cap_src0 >= 9 and cap_dst0 < 8

        placement = FleetPlacement(["src", "dst"])
        coord = MigrationCoordinator(placement, [src, dst])
        for k in keys[:8]:
            assert coord.migrate(k, "dst") is not None
        # the target grew to hold 8; the source keeps its bucket warm
        assert dst.cohort.capacity > cap_dst0 and src.cohort.capacity == cap_src0
        assert (len(src), len(dst)) == (1, 8)

        # the moved states are exact vs a never-migrated twin
        twin = _shard("twin", d)
        twin.add_tenants(keys)
        for step in range(3):
            twin.submit_wave(step, keys, *_rows(keys, step))
        for k in keys:
            shard = dst if dst.has_tenant(k) else src
            got = shard.cohort.tenant_collection(shard.slot_of(k)).compute()
            want = twin.cohort.tenant_collection(twin.slot_of(k)).compute()
            assert torch.equal(got, want)
            assert shard.cursor_of(k) == 2  # the replay cursor moved too

        # durable on both sides: fresh processes rebuild the same fleet
        src2, dst2 = _shard("src", d), _shard("dst", d)
        assert src2.restore() and dst2.restore()
        assert src2.tenants() == src.tenants()
        assert dst2.tenants() == dst.tenants()
        assert all(dst2.cursor_of(k) == 2 for k in dst2.tenants())


def test_restore_shrinks_an_overgrown_shard():
    """The load path resizes DOWN too: a shard that grew past its
    checkpointed capacity snaps back to the durable generation."""
    with tempfile.TemporaryDirectory() as d:
        tiny = _shard("tiny", d)
        tiny.add_tenants([5, 6])
        tiny.submit_wave(0, [5, 6], *_rows([5, 6], 0))
        tiny.checkpoint()
        small_cap = tiny.cohort.capacity

        grown = _shard("tiny", d)
        grown.add_tenants(range(100, 114))
        assert grown.cohort.capacity > small_cap
        assert grown.restore()
        assert grown.cohort.capacity == small_cap
        assert grown.tenants() == (5, 6)
        assert grown.cursor_of(5) == 0


def test_replay_guard_survives_migration():
    with tempfile.TemporaryDirectory() as d:
        src, dst = _shard("src", d), _shard("dst", d)
        src.add_tenants([0, 1])
        for step in range(2):
            src.submit_wave(step, [0, 1], *_rows([0, 1], step))
        coord = MigrationCoordinator(FleetPlacement(["src", "dst"]), [src, dst])
        coord.migrate(1, "dst")
        before = dst.cohort.tenant_collection(dst.slot_of(1)).compute()
        # re-feeding the already-folded steps is an exact no-op on the target
        for step in range(2):
            dst.submit_wave(step, [1], *_rows([1], step))
        assert dst.stats["replays_skipped"] == 2
        assert torch.equal(dst.cohort.tenant_collection(dst.slot_of(1)).compute(), before)


# ----------------------------------------------------------------------
# 4. ingest drain: admitted-but-undispatched rows ride the envelope
# ----------------------------------------------------------------------
def test_buffered_ingest_rows_migrate_instead_of_stranding():
    with tempfile.TemporaryDirectory() as d:
        src, dst = _shard("src", d), _shard("dst", d)
        src.add_tenants([0, 1])
        src.queue = IngestQueue(src.cohort, rows_per_step=64)
        dst.queue = IngestQueue(dst.cohort, rows_per_step=64)

        slot = src.slot_of(1)
        preds = np.asarray([0.5, 0.25], dtype=np.float32)
        target = np.asarray([0.0, 1.0], dtype=np.float32)
        src.queue.submit(np.full(2, slot, dtype=np.int32), preds, target)
        assert src.queue.buffered_rows == 2

        coord = MigrationCoordinator(FleetPlacement(["src", "dst"]), [src, dst])
        coord.migrate(1, "dst")
        # drained out of the source queue, resubmitted into the target's
        assert src.queue.buffered_rows == 0
        assert src.queue.stats["drained_rows"] == 2
        assert dst.queue.buffered_rows == 2

        # a queue-less target stashes them typed instead of dropping them
        src.add_tenant(7)
        src.queue.submit(np.full(1, src.slot_of(7), dtype=np.int32), preds[:1], target[:1])
        dst.queue = None
        coord.migrate(7, "dst")
        (p_rows, t_rows) = dst.pending_rows[7]
        np.testing.assert_array_equal(p_rows, preds[:1])
        np.testing.assert_array_equal(t_rows, target[:1])


def test_drain_tenant_is_exact_and_ordered():
    cohort = MetricCohort(MeanSquaredError(device=CPU), tenants=2)
    q = IngestQueue(cohort, rows_per_step=64)
    q.submit(np.zeros(2, dtype=np.int32), np.asarray([1.0, 2.0]), np.asarray([0.0, 0.0]))
    q.submit(np.zeros(1, dtype=np.int32), np.asarray([3.0]), np.asarray([0.0]))
    rows = q.drain_tenant(0)
    np.testing.assert_array_equal(rows[0], np.asarray([1.0, 2.0, 3.0]))
    assert q.buffered_rows == 0 and q.stats["drained_rows"] == 3
    assert q.drain_tenant(0) is None  # empty drain is a typed no-op


# ----------------------------------------------------------------------
# 5. the export surface
# ----------------------------------------------------------------------
def test_exporter_renders_fleet_families():
    obs.enable()
    with tempfile.TemporaryDirectory() as d:
        src, dst = _shard("src", d), _shard("dst", d)
        src.add_tenants([0, 1, 2])
        placement = FleetPlacement(["src", "dst"])
        coord = MigrationCoordinator(placement, [src, dst])
        coord.migrate(0, "dst")

        samples = parse_prometheus_text(render_exposition())
        fid = str(coord.export_id)
        gen = {tuple(sorted(lbl.items())): v for lbl, v in samples["metrics_tpu_fleet_placement_generation"]}
        assert gen[(("fleet", fid),)] == float(placement.generation)
        mig = {lbl["shard"]: v for lbl, v in samples["metrics_tpu_fleet_migrations_total"] if lbl["fleet"] == fid}
        assert mig == {"src": 1.0, "dst": 1.0}
        inflight = {lbl["shard"]: v for lbl, v in samples["metrics_tpu_fleet_tenants_in_flight"]
                    if lbl["fleet"] == fid}
        assert set(inflight.values()) == {0.0}  # nothing mid-handoff at rest


# ----------------------------------------------------------------------
# against the JAX package
# ----------------------------------------------------------------------
def test_placement_and_churn_equal_jax_at_10k():
    """The bench's fleet leg (``bench.py:699-707``): 10,000 keys over two
    shards, then a third; both packages place every key alike, so the churn
    ratio is the same number, and the follower order (rank 2) too."""
    n = 10_000
    port, jax_ = FleetPlacement(["shard-0", "shard-1"]), jfleet.FleetPlacement(["shard-0", "shard-1"])
    homes = [port.assign(k) for k in range(n)]
    assert homes == [jax_.assign(k) for k in range(n)]
    port.add_shard("shard-2")
    jax_.add_shard("shard-2")
    moved = sum(1 for k in range(n) if port.assign(k) != homes[k])
    jax_moved = sum(1 for k in range(n) if jax_.assign(k) != homes[k])
    assert moved == jax_moved and 0 < moved / n <= 0.45
    assert [port.assign_ranked(k) for k in range(0, n, 37)] == [jax_.assign_ranked(k) for k in range(0, n, 37)]
    assert port.generation == jax_.generation


_CROSS = [
    ("MeanSquaredError", {}, (np.float32, np.float32)),
    ("Accuracy", {}, (np.float32, np.int32)),
    ("AUROC", {}, (np.float32, np.int32)),
]


@pytest.mark.parametrize("name,kwargs,dtypes", _CROSS, ids=[c[0] for c in _CROSS])
def test_tenant_envelope_crosses_from_jax_and_back(name, kwargs, dtypes):
    """A JAX tenant (list states included) leaves JAX as envelope bytes, is
    adopted by the port, goes on through the port's envelope bytes and is
    adopted back by JAX: keys, cursor, pending rows and every state equal
    at each hop, and each side's compute equal to the other's."""
    rng = np.random.RandomState(11)
    preds = rng.rand(64).astype(dtypes[0])
    target = (rng.rand(64) > 0.5).astype(dtypes[1]) if dtypes[1] is np.int32 else rng.rand(64).astype(np.float32)
    pending = [rng.rand(3).astype(np.float32), rng.rand(3).astype(np.float32)]
    j = getattr(jm, name)(**kwargs)
    for _ in range(2):
        j.update(jnp.asarray(preds), jnp.asarray(target))
    jenv = jfleet.tenant_envelope(j, 77, cursor=5, pending_rows=pending)
    env = envelope_from_bytes(jckpt.envelope_to_bytes(jenv))
    assert env["checksum"] == jenv["checksum"]

    m = getattr(tm, name)(device=CPU, **kwargs)
    assert adopt_into(m, env) == 5
    key, cursor, payload, wire_pending = open_tenant_envelope(env)
    assert (key, cursor) == (77, 5)
    for a, b in zip(wire_pending, pending):
        np.testing.assert_array_equal(a, b)

    back = tenant_envelope(m, 77, cursor=5, pending_rows=pending)
    assert back["spec"] == jenv["spec"] and back["checksum"] == jenv["checksum"]
    j2 = getattr(jm, name)(**kwargs)
    assert jfleet.adopt_into(j2, jckpt.envelope_from_bytes(envelope_to_bytes(back))) == 5
    for sname in j._defaults:
        a, b = getattr(j, sname), getattr(j2, sname)
        if isinstance(a, list):
            assert len(a) == len(b) == len(getattr(m, sname))
            for x, y, z in zip(a, b, getattr(m, sname)):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
                np.testing.assert_array_equal(np.asarray(x), z.numpy())
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            np.testing.assert_array_equal(np.asarray(a), getattr(m, sname).numpy())
    np.testing.assert_array_equal(np.asarray(j.compute()), np.asarray(j2.compute()))
    np.testing.assert_allclose(m.compute().numpy(), np.asarray(j.compute()), rtol=1e-6)


# ----------------------------------------------------------------------
# the partial wave: bit for bit the full-shard dispatch
# ----------------------------------------------------------------------
PARTIAL_N = 5_000
ROWS, FEAT = 2, 8


def _wave(keys, step):
    """The failover leg's rows (``bench.py:829-838``): 2 rows x 8 features a
    tenant, distinct per tenant and step."""
    base = np.asarray(keys, dtype=np.float64)[:, None, None]
    preds = (base * 1e-4 + step * 0.125 + np.arange(FEAT) * 0.01).astype(np.float32)
    preds = np.broadcast_to(preds, (len(keys), ROWS, FEAT)).copy()
    preds[:, 1] *= 0.75
    target = np.broadcast_to((base * 2e-4).astype(np.float32), preds.shape).copy()
    return preds, target


def _states(shard, keys):
    return {f"{n}.{s}": v[[shard.slot_of(k) for k in keys]] for n, d in shard.cohort._states.items()
            for s, v in d.items()}


def _assert_states_equal(a, keys_a, b, keys_b=None):
    got, want = _states(a, keys_a), _states(b, keys_a if keys_b is None else keys_b)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("size", [1, 3, PARTIAL_N // 2, PARTIAL_N - 1], ids=["1", "3", "half", "all_but_one"])
def test_partial_wave_is_bit_identical_to_the_full_dispatch(size):
    with tempfile.TemporaryDirectory() as d:
        keys = list(range(PARTIAL_N))
        part, full = _shard("part", d), _shard("full", d)
        for sh in (part, full):
            sh.add_tenants(keys)
            sh.submit_wave(0, keys, *_wave(keys, 0))
        subset = sorted(np.random.RandomState(size).choice(PARTIAL_N, size, replace=False).tolist())
        rest = sorted(set(keys) - set(subset))
        # step 1 through two partial waves (the subset, then the rest, in
        # shuffled key order) against one full wave
        part.submit_wave(1, subset[::-1], *_wave(subset[::-1], 1))
        assert part.stats["waves"] == 2
        _assert_states_equal(part, rest, full, rest)  # untouched: still after step 0
        part.submit_wave(1, rest, *_wave(rest, 1))
        full.submit_wave(1, keys, *_wave(keys, 1))
        _assert_states_equal(part, keys, full)
        # a full wave after the partial ones reads their rows
        for sh in (part, full):
            sh.submit_wave(2, keys, *_wave(keys, 2))
        _assert_states_equal(part, keys, full)
        assert part.cursor_of(subset[0]) == 2


def test_partial_wave_bit_identical_after_capacity_grew_and_shrank():
    """Partial waves on a shard whose capacity grew through migrations in
    (2 → 64) and on one restored from a smaller generation than it had
    grown to: every tenant equal to a never-migrated twin fed full waves."""
    with tempfile.TemporaryDirectory() as d:
        keys = list(range(PARTIAL_N))
        src, dst, twin = _shard("src", d), _shard("dst", d), _shard("twin", d)
        for sh in (src, twin):
            sh.add_tenants(keys)
            sh.submit_wave(0, keys, *_wave(keys, 0))
        coord = MigrationCoordinator(FleetPlacement(["src", "dst"]), [src, dst])
        moved = keys[::97][:40]
        for k in moved:
            coord.migrate(k, "dst")
        assert dst.cohort.capacity == 64 and src.cohort.capacity == 8192
        stay = sorted(set(keys) - set(moved))
        # every shard folds step 1 in two partial waves; the twin in one full
        for sh, ks in ((dst, moved), (src, stay)):
            sh.submit_wave(1, ks[1::2], *_wave(ks[1::2], 1))
            sh.submit_wave(1, ks, *_wave(ks, 1))
        twin.submit_wave(1, keys, *_wave(keys, 1))
        _assert_states_equal(dst, moved, twin)
        _assert_states_equal(src, stay, twin)
        # shrink: the source's journal holds its generation at 8,192 slots
        # from the last migration; a shard that grew past it restores down
        grown = _shard("src", d)
        grown.add_tenants(range(10_000, 10_000 + 9_000))
        assert grown.cohort.capacity == 16384 and grown.restore()
        assert grown.cohort.capacity == 8192 and grown.tenants() == tuple(stay)
        grown.submit_wave(1, stay, *_wave(stay, 1))  # the restored generation predates step 1
        half = stay[: len(stay) // 2]
        grown.submit_wave(2, half, *_wave(half, 2))
        grown.submit_wave(2, stay, *_wave(stay, 2))
        twin.submit_wave(2, keys, *_wave(keys, 2))
        _assert_states_equal(grown, stay, twin)


# ----------------------------------------------------------------------
# a served shard: fleet verbs wait for the serving worker's step
# ----------------------------------------------------------------------
WAIT_S = 30.0


@pytest.mark.parametrize("verb", ["migrate", "replicate", "checkpoint", "partial_wave"])
def test_fleet_verbs_drain_a_served_shard_cohort(verb):
    """A shard cohort stepped by an ``AsyncServingEngine`` worker: a fleet
    verb started while the worker sits inside a step waits for that step,
    and what the verb hands on (the migrated tenant, the replicas, the
    committed generation, the partial wave's fold) holds the state after
    ``drain()``, equal to a twin stepped in order."""
    with tempfile.TemporaryDirectory() as d:
        keys = list(range(4))
        src, dst, twin = _shard("src", d), _shard("dst", d), _shard("twin", d)
        for sh in (src, twin):
            sh.add_tenants(keys)
            sh.submit_wave(0, keys, *_wave(keys, 0))
        coord = MigrationCoordinator(FleetPlacement(["src", "dst"]), [src, dst])
        replicator = ShardReplicator(coord)
        pipe = AsyncServingEngine(src.cohort)
        engine = src.cohort._engine
        real_run = engine._run
        inside, release = threading.Event(), threading.Event()

        def held(*args, **kwargs):
            if threading.current_thread() is pipe._worker:
                inside.set()
                release.wait(WAIT_S)
            return real_run(*args, **kwargs)

        engine._run = held
        try:
            for step in (1, 2):  # the first is built on the caller, the second goes to the worker
                served = [torch.from_numpy(a) for a in _wave(keys, step)]
                pipe.forward(*served)
                twin.cohort(*served)
            assert inside.wait(WAIT_S) and pipe.stats["inline_steps"] == 1
            late = _wave([2], 3)
            verbs = {
                "migrate": lambda: coord.migrate(0, "dst"),
                "replicate": lambda: replicator.replicate(src),
                "checkpoint": src.checkpoint,
                "partial_wave": lambda: src.submit_wave(1, [2], *late),
            }
            errors = []

            def run():
                try:
                    verbs[verb]()
                except BaseException as err:  # noqa: BLE001 - re-raised on the test thread
                    errors.append(err)

            fleet = threading.Thread(target=run, daemon=True)
            fleet.start()
            fleet.join(0.5)
            waited = fleet.is_alive()
            release.set()
            fleet.join(WAIT_S)
            assert not errors, errors
            assert waited, f"{verb} did not wait for the serving worker's step"
            pipe.drain()
        finally:
            release.set()
            engine._run = real_run
            pipe.close()
        if verb == "partial_wave":
            twin.submit_wave(1, [2], *late)
        if verb == "migrate":
            _assert_states_equal(dst, [0], twin)
            _assert_states_equal(src, keys[1:], twin)
        elif verb == "replicate":
            assert replicator.stats["replicated"] == len(keys)
            replicator.promote("src")
            _assert_states_equal(dst, keys, twin)
        elif verb == "checkpoint":
            restored = _shard("src", d)
            assert restored.restore()
            _assert_states_equal(restored, keys, twin)
        else:
            _assert_states_equal(src, keys, twin)
