"""Continuous tenant-state replication: the warm standby a failover
promotes.

Port of ``metrics_tpu/fleet/replication.py``; the replica directories,
manifests and envelopes are the JAX package's, so either package's
follower promotes the other's replicas.

A shard's journal makes its state durable on ITS OWN disk — useless
when the machine under that disk is the thing that died. The
:class:`ShardReplicator` closes the gap: after each committed shard
generation it ships every tenant whose replay cursor advanced since the
last shipment as a **delta tenant envelope** — the same checksummed
:func:`~metrics_tpu_torch.fleet.tenant_envelope` artifact migration uses,
``__qres`` error-feedback residuals, cat/list states and the replay
cursor included — to that tenant's **follower shard**, the rank-2
rendezvous choice from :class:`~metrics_tpu_torch.fleet.FleetPlacement`.
Transfer is exact-tier only (raw bytes over
:meth:`SyncBackend.stream`, re-checksummed on arrival); the follower
stores each envelope durably in its own :class:`ReplicaStore` beside —
never inside — its primary state.

Three disciplines keep the hot path honest:

* **Replication never blocks serving.** Every per-tenant shipment runs
  under the :class:`~metrics_tpu_torch.reliability.SyncPolicy` retry budget;
  a tenant that still fails degrades LOUDLY — ``fleet.replication.failed``
  counter, one ``fleet_replication_degraded`` flight dump per
  :meth:`ShardReplicator.replicate` call — and the wave pipeline moves
  on. The un-shipped delta stays visible as replication lag
  (``fleet.replication.lag`` gauge, in tenant·step units) until the next
  cycle ships it.
* **Epoch fencing at the store.** Every replication record carries the
  primary's ownership epoch; the :class:`ReplicaStore` refuses an
  envelope from an epoch older than the newest it has accepted
  (:class:`~metrics_tpu_torch.fleet.lease.StaleEpochError`) — a partitioned
  old owner cannot overwrite the replica either.
* **Watermarks are follower-durable.** The replicated cursor per tenant
  lives in the follower's replica manifest, not the (dead) primary's
  memory, so failover knows exactly which rows the promoted state
  already folds: everything after the watermark is the
  :class:`~metrics_tpu_torch.serving.IngestQueue` redelivery window, and the
  replay guard makes the overlap fold exactly once.

Failover itself lives on :meth:`FleetRebalancer.failover`; the promote
primitive here (:meth:`ShardReplicator.promote`) adopts the replicated
envelopes into the follower's cohort, fast-forwards cursors, and records
the new locations — ``tests/reliability/test_fleet_failover.py`` proves
the promoted shard converges bit-identically to a never-failed twin.
"""
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from metrics_tpu_torch.fleet.lease import LeaseError, StaleEpochError
from metrics_tpu_torch.fleet.migration import (
    TENANT_ENVELOPE_FORMAT,
    _nest_rows,
    _stream_bytes,
    open_tenant_envelope,
    tenant_envelope,
)
from metrics_tpu_torch.observability import flight as _flight
from metrics_tpu_torch.observability import telemetry as _obs
from metrics_tpu_torch.reliability.checkpoint import (
    _validate_envelope,
    envelope_from_bytes,
    envelope_to_bytes,
    read_envelope,
    write_envelope,
)
from metrics_tpu_torch.reliability.journal import atomic_write_json
from metrics_tpu_torch.reliability.sync import SyncPolicy

__all__ = ["REPLICA_DIRNAME", "ReplicaStore", "ShardReplicator"]

REPLICA_DIRNAME = "replica"
REPLICA_MANIFEST = "REPLICA.json"
REPLICA_FORMAT = "metrics_tpu.replica_manifest"


class ReplicaStore:
    """Follower-side durable store of one primary's replicated tenants:
    ``<follower_dir>/replica/<primary>/t<key>.npz`` per tenant (atomic
    envelope writes) plus an atomically-replaced manifest holding the
    per-tenant replicated cursors (the **watermarks**) and the newest
    primary epoch accepted. The store is beside, never inside, the
    follower's own journal — replica state must not be confusable with
    owned state until a failover explicitly promotes it."""

    def __init__(self, directory: Any, primary: str):
        self.primary = str(primary)
        self.directory = os.path.join(
            os.fspath(directory), REPLICA_DIRNAME, self.primary
        )
        os.makedirs(self.directory, exist_ok=True)

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.directory, REPLICA_MANIFEST)

    def tenant_path(self, key: int) -> str:
        return os.path.join(self.directory, f"t{int(key)}.npz")

    def _read_manifest(self) -> Dict[str, Any]:
        try:
            with open(self.manifest_path) as f:
                manifest = json.load(f)
            if manifest.get("format") != REPLICA_FORMAT:
                return {"epoch": -1, "tenants": {}}
            return manifest
        except FileNotFoundError:
            return {"epoch": -1, "tenants": {}}
        except Exception:  # noqa: BLE001 — a torn manifest reads as empty
            return {"epoch": -1, "tenants": {}}

    @property
    def epoch(self) -> int:
        """Newest primary ownership epoch accepted (-1 = never written)."""
        return int(self._read_manifest().get("epoch", -1))

    def watermarks(self) -> Dict[int, int]:
        """Per-tenant replicated cursor — the durable truth failover
        reads to size the redelivery window."""
        return {
            int(k): int(v) for k, v in self._read_manifest().get("tenants", {}).items()
        }

    def tenants(self) -> Tuple[int, ...]:
        return tuple(sorted(self.watermarks()))

    def store(self, envelope: Dict[str, Any], epoch: int = -1) -> Tuple[int, int]:
        """Durably accept one replicated tenant envelope; returns
        ``(tenant_key, cursor)``. The envelope is re-validated (format +
        checksum) and the write is epoch-fenced: an ``epoch`` older than
        the newest this store has accepted raises
        :class:`StaleEpochError` — a partitioned old primary's
        replication records are refused, never merged."""
        _validate_envelope(envelope, fmt=TENANT_ENVELOPE_FORMAT)
        key, cursor, _payload, _pending = open_tenant_envelope(envelope)
        manifest = self._read_manifest()
        have_epoch = int(manifest.get("epoch", -1))
        epoch = int(epoch)
        if epoch < have_epoch:
            raise StaleEpochError(self.primary, epoch, have_epoch)
        write_envelope(self.tenant_path(key), envelope)
        tenants = manifest.get("tenants", {})
        tenants[str(int(key))] = max(int(cursor), int(tenants.get(str(int(key)), -1)))
        atomic_write_json(
            self.manifest_path,
            {
                "format": REPLICA_FORMAT,
                "primary": self.primary,
                "epoch": max(epoch, have_epoch),
                "tenants": tenants,
            },
        )
        return int(key), int(cursor)

    def load(self, key: int) -> Dict[str, Any]:
        envelope = read_envelope(self.tenant_path(key))
        _validate_envelope(envelope, fmt=TENANT_ENVELOPE_FORMAT)
        return envelope

    def discard(self, key: Optional[int] = None) -> None:
        """Drop one tenant's replica (its primary migrated it away) or —
        with no key — the whole store (its primary was promoted away or
        retired)."""
        manifest = self._read_manifest()
        tenants = manifest.get("tenants", {})
        keys = [int(key)] if key is not None else [int(k) for k in tenants]
        for k in keys:
            tenants.pop(str(k), None)
            try:
                os.remove(self.tenant_path(k))
            except OSError:
                pass
        atomic_write_json(
            self.manifest_path,
            {
                "format": REPLICA_FORMAT,
                "primary": self.primary,
                "epoch": int(manifest.get("epoch", -1)),
                "tenants": tenants,
            },
        )

    @staticmethod
    def exists(directory: Any, primary: str) -> bool:
        """Does ``directory`` hold a (possibly empty) replica store for
        ``primary``? Cheap containment probe for failover planning."""
        return os.path.isfile(
            os.path.join(
                os.fspath(directory), REPLICA_DIRNAME, str(primary), REPLICA_MANIFEST
            )
        )

    def __repr__(self) -> str:
        return f"ReplicaStore(primary={self.primary!r}, tenants={len(self.watermarks())})"


class ShardReplicator:
    """The background replicator: drives post-commit delta shipment for
    every shard in a fleet and owns the promote primitive failover uses.

    Args:
        coordinator: the fleet's
            :class:`~metrics_tpu_torch.fleet.MigrationCoordinator` (supplies
            the placement, the shard map, and the exporter registration —
            the replicator attaches itself as ``coordinator.replicator``
            so one ``/metrics`` scrape covers both).
        backend: optional :class:`~metrics_tpu_torch.parallel.SyncBackend` the
            envelope bytes travel through (exact tier, re-checksummed);
            None ships through memory (single-process fleets, tests).
        policy: retry/degradation contract per tenant shipment; default
            ``SyncPolicy(max_retries=2, backoff_s=0.05)``.
        authority: optional :class:`~metrics_tpu_torch.fleet.LeaseAuthority`;
            when set, :meth:`replicate` refuses to ship for a shard whose
            lease is stale/expired (the fence covers replication, not
            just commits).
    """

    def __init__(
        self,
        coordinator: Any,
        backend: Optional[Any] = None,
        policy: Optional[SyncPolicy] = None,
        authority: Optional[Any] = None,
    ):
        self.coordinator = coordinator
        self.backend = backend
        self.policy = policy or SyncPolicy()
        self.authority = authority
        self.stats: Dict[str, int] = {
            "replicated": 0,
            "failed": 0,
            "failovers": 0,
            "tenants_promoted": 0,
        }
        coordinator.replicator = self

    # ------------------------------------------------------------------
    # topology
    # ------------------------------------------------------------------
    @property
    def placement(self) -> Any:
        return self.coordinator.placement

    @property
    def shards(self) -> Dict[str, Any]:
        return self.coordinator.shards

    def follower_of(self, key: int, primary: str) -> Optional[str]:
        """The tenant's replication target: the highest-ranked rendezvous
        choice that is neither the primary nor absent from the live shard
        map (None in a one-shard fleet — nobody to replicate to)."""
        for name in self.placement.assign_ranked(key):
            if name != str(primary) and name in self.shards:
                return name
        return None

    def _store(self, follower: str, primary: str) -> ReplicaStore:
        return ReplicaStore(self.shards[follower].directory, primary)

    def has_replicas(self, primary: str) -> bool:
        """Does any live shard durably hold replicas for ``primary``?"""
        return any(
            name != str(primary)
            and ReplicaStore.exists(shard.directory, primary)
            and self._store(name, primary).watermarks()
            for name, shard in self.shards.items()
        )

    # ------------------------------------------------------------------
    # the delta shipment
    # ------------------------------------------------------------------
    def replicate(self, shard: Any, keys: Optional[Sequence[int]] = None) -> int:
        """Ship every tenant of ``shard`` whose cursor advanced past its
        follower-side watermark (``keys`` restricts the sweep — the
        mid-replication kill points in the chaos bed use this); returns
        envelopes shipped. Call after :meth:`FleetShard.checkpoint` —
        the shipped state is then durable on BOTH sides.

        Never raises for transport trouble: each tenant gets the policy's
        retry budget, and terminal failures degrade loudly (counter + ONE
        dump per call) while serving continues. The one exception is the
        fence: a stale/expired lease is a typed refusal
        (:class:`LeaseError`), exactly like a fenced commit."""
        # the fence first: replicating under a stale epoch is a write
        # like any other (the shard's own dump + counter path applies)
        if self.authority is not None and getattr(shard, "lease", None) is not None:
            shard._check_fence("replicate")
        name = shard.name
        keys = [int(k) for k in (shard.tenants() if keys is None else keys)]
        shipped = 0
        failures: List[Tuple[int, str]] = []
        watermarks: Dict[str, Dict[int, int]] = {}
        for key in keys:
            follower = self.follower_of(key, name)
            if follower is None:
                continue
            if follower not in watermarks:
                watermarks[follower] = self._store(follower, name).watermarks()
            cursor = shard.cursor_of(key)
            if cursor <= watermarks[follower].get(key, -1):
                continue  # no delta since the last shipment
            try:
                self._ship(shard, key, cursor, follower)
                shipped += 1
            except StaleEpochError:
                raise  # the store fenced us: typed refusal, never degraded
            except Exception as err:  # noqa: BLE001 — degrade, never block serving
                failures.append((key, f"{type(err).__name__}: {err}"))
        if shipped:
            self.stats["replicated"] += shipped
            if _obs.enabled():
                _obs.get().count("fleet.replication.replicated", shipped)
        if failures:
            self.stats["failed"] += len(failures)
            if _obs.enabled():
                _obs.get().count("fleet.replication.failed", len(failures))
            _flight.dump_on_failure(
                "fleet_replication_degraded",
                shard=name,
                tenants=[k for k, _ in failures],
                errors=sorted({e for _, e in failures}),
            )
        if _obs.enabled():
            _obs.get().gauge("fleet.replication.lag", self.lag())
        return shipped

    def _ship(self, shard: Any, key: int, cursor: int, follower: str) -> None:
        """One tenant envelope, retried per the policy: build → bytes →
        (optional) exact-tier stream → re-checksum → follower-durable."""
        attempts = int(self.policy.max_retries) + 1
        backoff: Optional[float] = None
        for attempt in range(attempts):
            try:
                col = shard.cohort.tenant_collection(shard.slot_of(key))
                env = tenant_envelope(col, key, cursor=cursor)
                blob = envelope_to_bytes(env)
                if self.backend is not None:
                    blob = _stream_bytes(self.backend, blob, shard.cohort._device)
                env = envelope_from_bytes(blob)
                self._store(follower, shard.name).store(env, epoch=shard.epoch)
                _flight.record(
                    "fleet_replicated",
                    shard=shard.name,
                    tenant=int(key),
                    cursor=int(cursor),
                    follower=follower,
                )
                return
            except (LeaseError, KeyboardInterrupt):
                raise
            except Exception:  # noqa: BLE001 — retry within the policy budget
                if attempt + 1 >= attempts:
                    raise
                backoff = self.policy.next_backoff(backoff)
                time.sleep(backoff)

    # ------------------------------------------------------------------
    # lag
    # ------------------------------------------------------------------
    def lag(self, shard_name: Optional[str] = None) -> int:
        """Replication lag in tenant·step units: the sum over tenants of
        (live cursor − follower watermark), for one shard or the whole
        fleet. 0 = every follower holds state as fresh as its primary;
        the value after a clean ``checkpoint(); replicate()`` cycle.
        Tenants with no possible follower (one-shard fleet) contribute
        nothing — lag measures replication debt, not topology."""
        names = [str(shard_name)] if shard_name is not None else list(self.shards)
        total = 0
        marks: Dict[Tuple[str, str], Dict[int, int]] = {}
        for name in names:
            shard = self.shards.get(name)
            if shard is None:
                continue
            for key in shard.tenants():
                follower = self.follower_of(key, name)
                if follower is None:
                    continue
                pair = (follower, name)
                if pair not in marks:
                    marks[pair] = self._store(follower, name).watermarks()
                total += max(0, shard.cursor_of(key) - marks[pair].get(key, -1))
        return total

    # ------------------------------------------------------------------
    # promotion (driven by FleetRebalancer.failover)
    # ------------------------------------------------------------------
    def promote(self, dead_name: str) -> List[Tuple[int, str, int]]:
        """Adopt every replicated tenant of ``dead_name`` into the
        follower shard durably holding its replica: restore the envelope
        state into a fresh cohort slot, fast-forward the replay cursor to
        the watermark, pin the new location in the placement, and commit
        the follower (the promotion itself must be durable before the
        replica is discarded). Returns ``[(key, new_shard, watermark)]``.

        Tenants some OTHER live shard already owns are skipped — a
        mid-migration death can leave the tenant durably committed on its
        migration target while the stale replica still names the dead
        primary; the committed copy wins and only the routing is healed —
        so promotion can never mint a second owner."""
        dead_name = str(dead_name)
        promoted: List[Tuple[int, str, int]] = []
        for fname in sorted(self.shards):
            if fname == dead_name:
                continue
            fshard = self.shards[fname]
            if not ReplicaStore.exists(fshard.directory, dead_name):
                continue
            store = self._store(fname, dead_name)
            adopted_here = 0
            for key in store.tenants():
                # the dead primary still sits in the shard map here (the
                # rebalancer drops it after promotion) — it is precisely
                # the ownership being replaced, so only a THIRD shard
                # counts as an existing owner
                owner = self.coordinator.find_tenant(key)
                if owner is not None and owner != dead_name:
                    self.placement.record_location(key, owner)
                    store.discard(key)
                    continue
                envelope = store.load(key)
                wire_key, cursor, payload, pending = open_tenant_envelope(envelope)
                fshard.add_tenant(
                    wire_key,
                    state=_nest_rows(tuple(fshard.cohort._template), payload),
                    cursor=cursor,
                )
                if pending:
                    fshard.adopt_pending(wire_key, pending)
                self.placement.record_location(wire_key, fname)
                promoted.append((int(wire_key), fname, int(cursor)))
                adopted_here += 1
            if adopted_here:
                fshard.checkpoint(note=f"fleet-failover:{dead_name}")
            store.discard()
        if promoted:
            self.stats["tenants_promoted"] += len(promoted)
            if _obs.enabled():
                _obs.get().count("fleet.failover.tenants_promoted", len(promoted))
        return promoted

    def lag_by_shard(self) -> Dict[str, int]:
        """Per-primary lag — the exporter's labeled family."""
        return {name: self.lag(name) for name in sorted(self.shards)}

    def __repr__(self) -> str:
        return (
            f"ShardReplicator(shards={sorted(self.shards)},"
            f" replicated={self.stats['replicated']})"
        )
