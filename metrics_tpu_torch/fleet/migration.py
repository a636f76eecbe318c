"""Live tenant migration: portable tenant envelopes and the two-phase,
exactly-once handoff.

Port of ``metrics_tpu/fleet/migration.py``. A tenant's accumulated state
leaves its shard as a **tenant envelope** — the same checksummed
spec/payload artifact as a checkpoint
(:mod:`metrics_tpu_torch.reliability.checkpoint`) under its own format
marker, carrying three extras under the payload checksum: the fleet-wide
tenant key, the replay-guard cursor (so the target skips every step the
state already covers), and any rows the source's
:class:`~metrics_tpu_torch.serving.IngestQueue` had admitted but not yet
dispatched (drained, never shed — admitted rows must not vanish in a
move). The envelope's format, keys and bytes are the JAX package's, so a
tenant crosses between the two packages. Transfer is **exact-tier only**:
the envelope travels as raw bytes (a ``torch.uint8`` tensor on the shard's
device, so NCCL can carry it) through :meth:`SyncBackend.stream`, never
the quantized sync path, and the checksum is re-verified on the far side.

The handoff commits through a two-phase protocol whose durable artifacts
are ordered so a kill at ANY point leaves the tenant on exactly one side:

=========== ==================================================== =============================
phase       durable effect when it completes                     kill here → recovery
=========== ==================================================== =============================
prepare     envelope file + ``prepared`` record on the source    nothing durable yet: tenant
                                                                 still lives on the source
in-flight   (wire transfer only — nothing new durable)           ``prepared`` but target has
                                                                 no generation → **abort**:
                                                                 tenant stays on the source
pre-commit  target imported the tenant AND committed a journal   same as in-flight until the
            generation containing it                             target generation lands
pre-gc      source removed the tenant, committed its own         target generation is durable
            generation, marked the record ``done``               → **finish**: remove the
                                                                 source copy
=========== ==================================================== =============================

The commit witness is the REBUILT TARGET'S MEMBERSHIP, not a flag file:
recovery replays each source-side ``prepared`` record and asks whether
the tenant is present in the target restored from its own journal. If
yes, the target's generation was durable before the kill — finish the
removal; if no, nothing the target wrote survived — abort and keep the
source copy. Either way exactly one side holds the tenant, and the
cursor riding the envelope makes a resumed stream fold each step exactly
once (bit-identical to a never-migrated twin).

A shard's cohort lives where its template metric lives (the card unless
the caller asks for the CPU). Partial waves fold through the shard's own
CUDA graph: see :meth:`FleetShard.submit_wave`.
"""
import json
import os
from copy import deepcopy
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.cohort import MetricCohort
from metrics_tpu_torch.fleet.lease import LeaseError
from metrics_tpu_torch.metric import Metric, _decode_session_cursor, _encode_session_cursor
from metrics_tpu_torch.observability import exporter as _exporter
from metrics_tpu_torch.observability import flight as _flight
from metrics_tpu_torch.observability import telemetry as _obs
from metrics_tpu_torch.reliability.checkpoint import (
    CheckpointMismatchError,
    _to_tensor,
    _validate_envelope,
    envelope_from_bytes,
    envelope_from_pairs,
    envelope_to_bytes,
    read_envelope,
    write_envelope,
)
from metrics_tpu_torch.reliability.journal import CheckpointJournal, atomic_write_json
from metrics_tpu_torch.reliability.session import _SESSIONS

__all__ = [
    "TENANT_ENVELOPE_FORMAT",
    "FleetShard",
    "MigrationCoordinator",
    "adopt_into",
    "open_tenant_envelope",
    "tenant_envelope",
]

#: format marker of per-tenant migration envelopes — deliberately NOT the
#: checkpoint marker, so a tenant envelope can never strict-load as a full
#: checkpoint (or vice versa)
TENANT_ENVELOPE_FORMAT = "metrics_tpu.tenant_envelope"

_KEY_KEY = "__tenant_key__"
_CURSOR_KEY = Metric._SESSION_CURSOR_KEY  # "__session_cursor__"
_PENDING_KEY = "__tenant_pending__"

MIGRATION_LOG = "MIGRATIONS.json"


def _stream_bytes(backend: Any, blob: bytes, device: torch.device) -> bytes:
    """``blob`` through ``backend.stream`` as a ``torch.uint8`` tensor on
    ``device`` (NCCL carries CUDA tensors only), back on the host as bytes:
    the exact tier, every byte as it was sent."""
    wire = backend.stream(torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(device))
    return wire.cpu().numpy().tobytes()


# ----------------------------------------------------------------------
# the portable tenant envelope
# ----------------------------------------------------------------------
def tenant_envelope(
    obj: Any,
    tenant_key: int,
    cursor: Optional[int] = None,
    pending_rows: Optional[Sequence[np.ndarray]] = None,
) -> Dict[str, Any]:
    """Package one tenant's state (a metric/collection, typically from
    ``cohort.tenant_collection``) as a portable, checksummed envelope.
    Every registered state rides — ``__qres`` error-feedback residuals
    and list ("cat") states included; each is read to the host once.
    ``cursor`` is the replay-guard position (-1 / None = not
    session-tracked); ``pending_rows`` are drained-but-undispatched ingest
    rows, one array per input position."""
    pairs = [(k, v) for k, v in obj._named_states() if not k.endswith(_CURSOR_KEY)]
    pairs.append((_KEY_KEY, np.asarray(int(tenant_key), dtype=np.int64)))
    pairs.append((_CURSOR_KEY, _encode_session_cursor(-1 if cursor is None else int(cursor))))
    if pending_rows is not None:
        pairs.append((_PENDING_KEY, [np.asarray(a) for a in pending_rows]))
    return envelope_from_pairs(pairs, metric_type=type(obj).__name__, fmt=TENANT_ENVELOPE_FORMAT)


def open_tenant_envelope(
    envelope: Dict[str, Any],
) -> Tuple[int, int, Dict[str, Any], Optional[List[np.ndarray]]]:
    """Validate (format + schema + checksum) and unpack a tenant
    envelope: ``(tenant_key, cursor, state_payload, pending_rows)``."""
    _validate_envelope(envelope, fmt=TENANT_ENVELOPE_FORMAT)
    payload = dict(envelope["payload"])
    if _KEY_KEY not in payload:
        raise CheckpointMismatchError(f"tenant envelope is missing its {_KEY_KEY!r} entry")
    key = int(np.asarray(payload.pop(_KEY_KEY)))
    cursor = _decode_session_cursor(payload.pop(_CURSOR_KEY, -1))
    pending = payload.pop(_PENDING_KEY, None)
    return key, cursor, payload, pending


def adopt_into(obj: Any, envelope: Dict[str, Any]) -> int:
    """Restore a tenant envelope into a standalone metric/collection (the
    eager-tenant import path — cat-state metrics never enter a cohort),
    its states copied onto the object's device. Strict by construction:
    the payload's keys must exactly match the object's state universe.
    The embedded cursor fast-forwards the object's replay guard —
    including any live :class:`~metrics_tpu_torch.reliability.EvalSession`
    enrolling it — and is returned."""
    _key, cursor, payload, _pending = open_tenant_envelope(envelope)
    want = {k for k, _ in obj._named_states() if not k.endswith(_CURSOR_KEY)}
    have = set(payload)
    if have != want:
        raise CheckpointMismatchError(
            f"tenant envelope does not fit {type(obj).__name__}: missing"
            f" {sorted(want - have)}, unexpected {sorted(have - want)}"
        )
    obj.load_state_dict({k: _to_tensor(v) for k, v in payload.items()})
    if cursor >= 0:
        obj._session_cursor = max(cursor, obj._session_cursor or -1)
        for session in list(_SESSIONS):
            if session.metric is obj:
                session.adopt_cursor(cursor)
    return cursor


def _nest_rows(members: Sequence[str], payload: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Flat envelope keys → the nested ``{member: {state: value}}`` form
    ``MetricCohort._extract_states`` adopts. Bare-metric envelopes (no
    member prefix) map under the cohort's implicit ``"metric"`` member."""
    if set(members) == {"metric"}:
        return {"metric": dict(payload)}
    out: Dict[str, Dict[str, Any]] = {}
    for k, v in payload.items():
        member, _, sname = k.partition(".")
        out.setdefault(member, {})[sname] = v
    return out


# ----------------------------------------------------------------------
# one shard: a cohort + its journal + tenant bookkeeping
# ----------------------------------------------------------------------
class FleetShard:
    """One fleet member: a :class:`~metrics_tpu_torch.cohort.MetricCohort`
    (stacked per-tenant state, on the template metric's device), its
    :class:`CheckpointJournal` (the shard's durable truth), the
    tenant-key→slot map, per-tenant replay cursors, and an optional
    :class:`~metrics_tpu_torch.serving.IngestQueue` feeding the cohort.

    The shard's checkpoint payload is the cohort's stacked states plus
    two fleet-owned tables (``__fleet_tenants__``: the key living in each
    slot, -1 when free; ``__fleet_cursors__``: that tenant's replay
    cursor) — membership, identity and coverage travel under ONE
    checksum, so a restored shard knows exactly which tenants it owns and
    which steps their states already fold.

    A shard whose cohort an
    :class:`~metrics_tpu_torch.serving.AsyncServingEngine` steps is
    drained before any verb reads or writes its states (the cohort's own
    barrier, as at ``compute()``): an envelope, a replica, a commit or a
    partial wave holds every step staged before it."""

    _TENANTS_KEY = "__fleet_tenants__"
    _CURSORS_KEY = "__fleet_cursors__"

    def __init__(
        self,
        name: str,
        template: Any,
        directory: Any,
        keep_last: int = 3,
        track_health: Optional[bool] = None,
    ):
        self.name = str(name)
        self.directory = os.fspath(directory)
        self.cohort = MetricCohort(deepcopy(template), tenants=1, track_health=track_health)
        self.cohort.remove_tenant(0)  # shards start empty; tenants are placed
        self.journal = CheckpointJournal(self.directory, keep_last=keep_last)
        self.queue: Optional[Any] = None
        self._tenants: Dict[int, int] = {}  # tenant key -> cohort slot
        self._cursors: Dict[int, int] = {}  # tenant key -> replay cursor
        self.pending_rows: Dict[int, List[np.ndarray]] = {}
        self.lease: Optional[Any] = None
        self.authority: Optional[Any] = None
        self.stats: Dict[str, int] = {
            "migrations_in": 0,
            "migrations_out": 0,
            "replays_skipped": 0,
            "fenced_writes": 0,
            "waves": 0,
        }

    # ------------------------------------------------------------------
    # leased ownership (epoch fencing — see metrics_tpu_torch.fleet.lease)
    # ------------------------------------------------------------------
    def attach_lease(self, authority: Any, holder: Optional[str] = None) -> Any:
        """Acquire this shard's ownership lease from ``authority`` and arm
        fencing: from here on every generation commit and every wave ack
        validates the lease first, and a stale/expired epoch is refused
        with a typed error + one flight dump. Shards never attached stay
        unfenced (the single-owner deployments that need no authority)."""
        self.authority = authority
        self.lease = authority.acquire(self.name, holder=holder)
        return self.lease

    @property
    def epoch(self) -> int:
        """The ownership epoch this shard writes under (-1 = unleased)."""
        return self.lease.epoch if self.lease is not None else -1

    def _check_fence(self, what: str) -> None:
        """The fence: refuse ``what`` unless the held lease is current.
        The refusal is LOUD and typed — counter + one flight dump + the
        :class:`~metrics_tpu_torch.fleet.lease.LeaseError` re-raised — and
        the write never happens, so a fenced timeline cannot merge."""
        if self.authority is None or self.lease is None:
            return
        try:
            self.authority.check(self.lease)
        except LeaseError as err:
            self.stats["fenced_writes"] += 1
            if _obs.enabled():
                _obs.get().count("fleet.lease.fenced_writes")
            _flight.dump_on_failure(
                "fleet_fenced_write",
                shard=self.name,
                what=what,
                held_epoch=self.lease.epoch,
                current_epoch=self.authority.current_epoch(self.name),
                error=f"{type(err).__name__}: {err}",
            )
            raise

    # ------------------------------------------------------------------
    # membership
    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._tenants)

    def tenants(self) -> Tuple[int, ...]:
        return tuple(sorted(self._tenants))

    def has_tenant(self, key: int) -> bool:
        return int(key) in self._tenants

    def slot_of(self, key: int) -> int:
        return self._tenants[int(key)]

    def cursor_of(self, key: int) -> int:
        return self._cursors.get(int(key), -1)

    def add_tenant(self, key: int, state: Optional[Any] = None, cursor: int = -1) -> int:
        key = int(key)
        if key in self._tenants:
            raise ValueError(f"tenant {key} already lives on shard {self.name!r}")
        slot = self.cohort.add_tenant(state=state)
        self._tenants[key] = slot
        self._cursors[key] = int(cursor)
        return slot

    def add_tenants(self, keys: Sequence[int]) -> List[int]:
        """Bulk default-state admission (one capacity grow for the whole
        batch — the 10k-tenant population path)."""
        keys = [int(k) for k in keys]
        dup = [k for k in keys if k in self._tenants]
        if dup:
            raise ValueError(f"tenants {dup} already live on shard {self.name!r}")
        slots = self.cohort.add_tenants(len(keys))
        for k, s in zip(keys, slots):
            self._tenants[k] = s
            self._cursors[k] = -1
        return slots

    def remove_tenant(self, key: int, return_state: bool = False):
        key = int(key)
        slot = self._tenants.pop(key)
        self._cursors.pop(key, None)
        self.pending_rows.pop(key, None)
        return self.cohort.remove_tenant(slot, return_state=return_state)

    # ------------------------------------------------------------------
    # the replay-guarded stream
    # ------------------------------------------------------------------
    def submit_wave(self, step_index: int, keys: Sequence[int], *arrays: Any):
        """Fold batch ``step_index`` for ``keys`` (one leading-axis row
        batch per key in each array: numpy arrays or tensors, moved to the
        cohort's device). Per-tenant replay guard: a key whose cursor
        already covers ``step_index`` is skipped — counted as
        ``fleet.replays_skipped`` — which is what makes a
        resubmitted-from-scratch stream after a migration fold each step
        exactly once. When every key is admitted and the wave covers the
        whole shard, the fold is the cohort's single vmapped dispatch;
        partial waves fold the admitted tenants at their own slots through
        the same program at the same capacity
        (:meth:`MetricCohort.forward_slots`), the other slots kept on the
        device, so the next full wave reads them. A partial wave is
        bit-identical to the full-shard dispatch (an eager per-tenant fold
        is NOT, and would break failover convergence). Leased shards fence
        first: a stale-epoch owner cannot acknowledge a wave."""
        self._check_fence("wave_ack")
        step_index = int(step_index)
        keys = [int(k) for k in keys]
        for k in keys:
            if k not in self._tenants:
                raise KeyError(f"tenant {k} does not live on shard {self.name!r}")
        admitted = [i for i, k in enumerate(keys) if self._cursors.get(k, -1) < step_index]
        skipped = len(keys) - len(admitted)
        if skipped:
            self.stats["replays_skipped"] += skipped
            if _obs.enabled():
                _obs.get().count("fleet.replays_skipped", skipped)
        if not admitted:
            return None
        device = self.cohort._device
        rows = [a.to(device) if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a), device=device)
                for a in arrays]
        value = None
        live = self.cohort.tenant_ids()
        if len(admitted) == len(keys) and len(keys) == len(live) and {self._tenants[k] for k in keys} == set(live):
            slot_pos = {self._tenants[k]: i for i, k in enumerate(keys)}
            order = [slot_pos[slot] for slot in live]
            if order != list(range(len(order))):
                take = torch.as_tensor(order, device=device)
                rows = [a[take] for a in rows]
            value = self.cohort.forward(*rows)
        else:
            # forward_slots lays inputs out in slot order
            by_slot = sorted((self._tenants[keys[i]], i) for i in admitted)
            take = torch.as_tensor([i for _, i in by_slot], device=device)
            self.cohort.forward_slots([s for s, _ in by_slot], *[a[take] for a in rows])
        for i in admitted:
            self._cursors[keys[i]] = step_index
        self.stats["waves"] += 1
        return value

    # ------------------------------------------------------------------
    # durability
    # ------------------------------------------------------------------
    def _fleet_tables(self) -> List[Tuple[str, Any]]:
        cap = self.cohort.capacity
        tenants = np.full(cap, -1, dtype=np.int64)
        cursors = np.full(cap, -1, dtype=np.int64)
        for key, slot in self._tenants.items():
            tenants[slot] = key
            cursors[slot] = self._cursors.get(key, -1)
        return [
            (self._TENANTS_KEY, tenants),
            (self._CURSORS_KEY, cursors),
        ]

    def _named_states(self) -> List[Tuple[str, Any]]:
        return list(self.cohort._named_states()) + self._fleet_tables()

    def checkpoint(self, note: Optional[str] = None) -> Dict[str, Any]:
        """Commit the shard (stacked state + slot mask + tenant/cursor
        tables) as one journal generation; returns the manifest record.
        Leased shards fence first — a stale-epoch owner cannot commit —
        and stamp their epoch into the manifest record."""
        self._check_fence("commit")
        env = envelope_from_pairs(self._named_states(), metric_type="FleetShard")
        cursor = max(self._cursors.values(), default=-1)
        return self.journal.commit(
            env,
            cursor=cursor,
            note=note,
            epoch=self.epoch if self.lease is not None else None,
        )

    def restore(self) -> bool:
        """Rebuild the shard from its newest loadable generation; False
        when the journal is empty (a fresh shard). Torn newest
        generations fall back exactly as
        :meth:`CheckpointJournal.load_latest_good` documents."""
        envelope, _record, _skipped = self.journal.load_latest_good()
        if envelope is None:
            return False
        payload = dict(envelope["payload"])
        tenants = np.asarray(payload.pop(self._TENANTS_KEY)).ravel()
        cursors = np.asarray(payload.pop(self._CURSORS_KEY)).ravel()
        self.cohort.load_state_dict(payload)
        self._tenants = {}
        self._cursors = {}
        for slot in self.cohort.tenant_ids():
            key = int(tenants[slot])
            if key < 0:
                raise ValueError(
                    f"shard {self.name!r} checkpoint marks slot {slot} live"
                    " but its tenant table holds no key"
                )
            self._tenants[key] = slot
            self._cursors[key] = int(cursors[slot])
        return True

    # ------------------------------------------------------------------
    # per-shard migration log (the two-phase protocol's source-side truth)
    # ------------------------------------------------------------------
    @property
    def migration_log_path(self) -> str:
        return os.path.join(self.directory, MIGRATION_LOG)

    def mig_path(self, txn: str) -> str:
        return os.path.join(self.directory, f"{txn}.npz")

    def migration_records(self) -> List[Dict[str, Any]]:
        try:
            with open(self.migration_log_path) as f:
                return list(json.load(f).get("records", []))
        except FileNotFoundError:
            return []
        except Exception:  # noqa: BLE001 — a torn log reads as empty, like the manifest
            return []

    def record_migration(self, txn: str, status: str, **fields: Any) -> Dict[str, Any]:
        """Append one durable protocol record (atomic rewrite of the
        per-shard log; latest status per txn wins on replay). Leased
        shards stamp their ownership epoch into every record."""
        records = self.migration_records()
        if self.lease is not None and "epoch" not in fields:
            fields["epoch"] = self.epoch
        rec = {"txn": str(txn), "status": str(status), **fields}
        records.append(rec)
        atomic_write_json(self.migration_log_path, {"records": records})
        return rec

    def adopt_pending(self, key: int, rows: Sequence[np.ndarray]) -> None:
        """Hand a migrated tenant's drained ingest rows to this shard:
        resubmitted into the shard's queue when one is attached, else
        stashed typed in :attr:`pending_rows` for the caller."""
        key = int(key)
        if self.queue is not None:
            slot = self._tenants[key]
            n = int(np.asarray(rows[0]).shape[0])
            self.queue.submit(np.full(n, slot, dtype=np.int32), *rows)
        else:
            self.pending_rows[key] = [np.asarray(a) for a in rows]

    def __repr__(self) -> str:
        return f"FleetShard({self.name!r}, tenants={len(self)}, capacity={self.cohort.capacity})"


# ----------------------------------------------------------------------
# the coordinator: two-phase handoff + crash recovery
# ----------------------------------------------------------------------
class MigrationCoordinator:
    """Drives tenant handoffs between :class:`FleetShard`\\ s and replays
    interrupted ones to a consistent end state (see the module docstring
    for the protocol and its kill-point analysis)."""

    PHASES: Tuple[str, ...] = ("prepare", "in_flight", "pre_commit", "pre_gc")
    # every point the _phase seam fires at: the four protocol phases plus
    # the per-txn entry into recover() — the enumerable yield-point
    # schedule faultinject.kill_at_migration_phase drives
    YIELD_POINTS: Tuple[str, ...] = PHASES + ("recover",)

    def __init__(
        self,
        placement: Any,
        shards: Sequence[FleetShard],
        backend: Optional[Any] = None,
    ):
        self.placement = placement
        self.shards: Dict[str, FleetShard] = {s.name: s for s in shards}
        self.backend = backend
        self.replicator: Optional[Any] = None  # set by ShardReplicator
        self._seq = 0
        self._in_flight: Dict[str, int] = {}
        self._last_phase: Optional[str] = None
        self.stats: Dict[str, int] = {
            "migrations": 0,
            "failed": 0,
            "recovered_commits": 0,
            "recovered_aborts": 0,
        }
        self.export_id = _exporter.register_fleet(self)

    # ------------------------------------------------------------------
    # phase hook (the fault-injection seam)
    # ------------------------------------------------------------------
    def _phase(self, phase: str, txn: str) -> None:
        """No-op hook invoked at the START of each protocol phase —
        ``faultinject.kill_at_migration_phase`` patches exactly this to
        prove the kill-point table in the module docstring."""

    def _commit_target(self, dst: FleetShard, txn: str) -> None:
        """Phase-3 target commit, as a named seam: the durability step the
        pre-gc guard depends on."""
        dst.checkpoint(note=f"fleet-commit:{txn}")

    def _enter_phase(self, phase: str, txn: str) -> None:
        # _last_phase is set BEFORE the hook fires so the failure dump
        # names the phase the kill landed in even when the hook raises
        self._last_phase = phase
        _flight.record("fleet_migration_phase", txn=txn, phase=phase)
        self._phase(phase, txn)

    # ------------------------------------------------------------------
    # the handoff
    # ------------------------------------------------------------------
    def find_tenant(self, key: int) -> Optional[str]:
        for name, shard in self.shards.items():
            if shard.has_tenant(key):
                return name
        return None

    def migrate(self, key: int, dst_name: str, src_name: Optional[str] = None) -> Optional[str]:
        """Move tenant ``key`` to shard ``dst_name``; returns the txn id
        (None when the tenant already lives there). Any interruption —
        including an injected kill — re-raises after counting
        ``fleet.migrations_failed`` and writing ONE flight dump;
        :meth:`recover` then drives the txn to exactly-one-side."""
        key = int(key)
        src_name = src_name if src_name is not None else self.find_tenant(key)
        if src_name is None:
            raise KeyError(f"tenant {key} lives on no shard in this fleet")
        if src_name == str(dst_name):
            return None
        src = self.shards[src_name]
        dst = self.shards[str(dst_name)]
        # fence BEFORE any durable effect: a stale-epoch owner must not
        # even stage a prepare record (one typed refusal, one dump — from
        # _check_fence — not a second migration-interrupted dump)
        src._check_fence("migrate")
        txn = f"mig-{self._seq:06d}-t{key}"
        self._seq += 1
        self._last_phase = None
        self._in_flight[src.name] = self._in_flight.get(src.name, 0) + 1
        if _obs.enabled():
            _obs.get().gauge("fleet.in_flight", sum(self._in_flight.values()))
        try:
            # phase 1 — prepare: source-durable copy of the tenant
            self._enter_phase("prepare", txn)
            pending = src.queue.drain_tenant(src.slot_of(key)) if src.queue is not None else None
            col = src.cohort.tenant_collection(src.slot_of(key))
            env = tenant_envelope(col, key, cursor=src.cursor_of(key), pending_rows=pending)
            write_envelope(src.mig_path(txn), env)
            src.record_migration(txn, "prepared", tenant=key, dst=dst.name)

            # phase 2 — in-flight: exact-tier wire transfer + re-checksum
            self._enter_phase("in_flight", txn)
            blob = envelope_to_bytes(env)
            if self.backend is not None:
                blob = _stream_bytes(self.backend, blob, src.cohort._device)
            env = envelope_from_bytes(blob)

            # phase 3 — pre-commit: target imports + commits a generation
            self._enter_phase("pre_commit", txn)
            wire_key, cursor, payload, wire_pending = open_tenant_envelope(env)
            if wire_key != key:
                raise ValueError(f"txn {txn}: envelope carries tenant {wire_key}, expected {key}")
            dst.add_tenant(key, state=_nest_rows(tuple(dst.cohort._template), payload), cursor=cursor)
            self._commit_target(dst, txn)
            dst.record_migration(txn, "committed", tenant=key, src=src.name)
            if wire_pending:
                dst.adopt_pending(key, wire_pending)

            # phase 4 — pre-gc: source deletes ONLY after the target's
            # generation is durable
            self._enter_phase("pre_gc", txn)
            if dst.journal.newest_generation() is None:
                raise RuntimeError(
                    f"txn {txn}: target {dst.name!r} reports no durable"
                    " generation; refusing to delete the source copy"
                )
            src.remove_tenant(key)
            src.checkpoint(note=f"fleet-gc:{txn}")
            src.record_migration(txn, "done", tenant=key)
            self._finalize(src, txn, key, dst.name)
        except BaseException as err:
            self.stats["failed"] += 1
            if _obs.enabled():
                _obs.get().count("fleet.migrations_failed")
            _flight.dump_on_failure(
                "fleet_migration_interrupted",
                txn=txn,
                tenant=key,
                src=src.name,
                dst=dst.name,
                phase=self._last_phase,
                error=f"{type(err).__name__}: {err}",
            )
            raise
        finally:
            self._in_flight[src.name] = max(0, self._in_flight.get(src.name, 1) - 1)
            if _obs.enabled():
                _obs.get().gauge("fleet.in_flight", sum(self._in_flight.values()))
        return txn

    def _finalize(self, src: FleetShard, txn: str, key: int, dst_name: str) -> None:
        """Post-protocol bookkeeping shared by the live path and
        recovery: routing follows the tenant, stats/telemetry tick, the
        staged envelope file is GC'd."""
        self.placement.record_location(key, dst_name)
        src.stats["migrations_out"] += 1
        self.shards[dst_name].stats["migrations_in"] += 1
        self.stats["migrations"] += 1
        if _obs.enabled():
            _obs.get().count("fleet.migrations_done")
        if self.replicator is not None:
            # the tenant's replica under its OLD primary is now a stale
            # artifact (the new owner replicates under its own name) —
            # drop it so a later failover of the old primary cannot even
            # consider it. Best-effort: promotion double-checks ownership.
            follower = self.replicator.follower_of(key, src.name)
            if follower is not None and follower in self.shards:
                try:
                    self.replicator._store(follower, src.name).discard(key)
                except Exception:  # noqa: BLE001 — GC must not fail a handoff
                    pass
        try:
            os.remove(src.mig_path(txn))
        except OSError:
            pass

    # ------------------------------------------------------------------
    # crash recovery
    # ------------------------------------------------------------------
    def _open_prepared(self, src: FleetShard) -> List[Dict[str, Any]]:
        """Source-side txns whose LATEST record is ``prepared`` — the
        only protocol state an interrupted handoff can be stranded in."""
        latest: Dict[str, Dict[str, Any]] = {}
        for rec in src.migration_records():
            latest[rec["txn"]] = rec
        return [r for r in latest.values() if r.get("status") == "prepared"]

    def recover(self) -> List[Tuple[str, str]]:
        """Replay every stranded handoff to its deterministic end state;
        returns ``[(txn, "completed" | "aborted"), ...]``. Call AFTER the
        shards have been :meth:`FleetShard.restore`\\ d from disk: the
        commit witness is the restored target's membership. Idempotent —
        a kill during recovery re-runs it from the same durable facts."""
        out: List[Tuple[str, str]] = []
        for src in list(self.shards.values()):
            for rec in self._open_prepared(src):
                txn, key = str(rec["txn"]), int(rec["tenant"])
                # the recovery yield point: a kill HERE is the re-entrant
                # recover() drill — nothing replayed yet for this txn, so
                # the durable facts the next recover() reads are unchanged
                self._enter_phase("recover", txn)
                dst = self.shards.get(str(rec.get("dst")))
                if dst is not None and dst.has_tenant(key):
                    # target generation was durable → finish the removal
                    if src.has_tenant(key):
                        src.remove_tenant(key)
                        src.checkpoint(note=f"fleet-gc:{txn} (recovered)")
                    src.record_migration(txn, "done", tenant=key, recovered=True)
                    self._finalize(src, txn, key, dst.name)
                    self.stats["recovered_commits"] += 1
                    out.append((txn, "completed"))
                else:
                    # nothing durable on the target → the tenant stays home
                    if not src.has_tenant(key):
                        # defensive: only reachable if the source journal
                        # regressed past the prepare — the staged envelope
                        # is still the tenant's state of record
                        env = read_envelope(src.mig_path(txn))
                        ek, cursor, payload, pend = open_tenant_envelope(env)
                        src.add_tenant(ek, state=_nest_rows(tuple(src.cohort._template), payload), cursor=cursor)
                        if pend:
                            src.adopt_pending(ek, pend)
                        src.checkpoint(note=f"fleet-abort:{txn} (reimport)")
                    src.record_migration(txn, "aborted", tenant=key, recovered=True)
                    self.placement.clear_location(key)
                    try:
                        os.remove(src.mig_path(txn))
                    except OSError:
                        pass
                    self.stats["recovered_aborts"] += 1
                    out.append((txn, "aborted"))
        return out

    # ------------------------------------------------------------------
    # exporter surface
    # ------------------------------------------------------------------
    def in_flight_by_shard(self) -> Dict[str, int]:
        return {name: n for name, n in self._in_flight.items() if n}

    def migrations_by_shard(self) -> Dict[str, int]:
        return {name: s.stats["migrations_in"] + s.stats["migrations_out"] for name, s in self.shards.items()}

    def __repr__(self) -> str:
        return f"MigrationCoordinator(shards={sorted(self.shards)}, migrations={self.stats['migrations']})"
