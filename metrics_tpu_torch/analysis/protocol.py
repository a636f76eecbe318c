"""Pass 6 — fleet-protocol model checking: exhaustive crash/interleaving
exploration over the REAL migration/lease/replication/failover code.

Port of ``metrics_tpu/analysis/protocol.py``, driving the port's own fleet
(:mod:`metrics_tpu_torch.fleet`). The chaos beds
(``tests/test_torch_fleet_chaos.py`` and friends) *sample* the protocol's
failure space at hand-picked kill points. This pass *enumerates* it: a
deterministic single-process explorer drives the real
:class:`~metrics_tpu_torch.fleet.MigrationCoordinator`,
:class:`~metrics_tpu_torch.fleet.LeaseAuthority`,
:class:`~metrics_tpu_torch.fleet.replication.ShardReplicator` and
:class:`~metrics_tpu_torch.fleet.FleetRebalancer` over small on-disk fleets,
injecting a fault at every yield point of the migration state machine
(the ``_phase`` seam, generalized to ``MigrationCoordinator.
YIELD_POINTS`` — the four protocol phases plus the per-txn ``recover``
entry) and replaying recovery in every shard order. Explored crash
states are memoized by a hash of the durable bytes (journals, migration
logs, staged envelopes, replica stores), so schedules that crash into
the same durable world are explored once and counted as pruned.

Every shard's cohort lives on ``device`` (the explorers' and
:func:`check_protocol`'s argument): the card unless the caller asks for
the CPU, as the port's metrics do; asking for ``"cuda"`` without a card
raises. The durable bytes, and so the coverage counts, are the same on
either device.

Three rules ride the pass:

* **MTA013 crash-consistency** (:func:`explore_crash_consistency`) —
  DFS over every phase-boundary kill, double kill (a second kill landing
  at the re-entrant ``recover`` yield point), and partition × every
  recovery permutation, asserting on every path: exactly-one-owner,
  no-lost-tenant, replay cursors monotone, no-double-count under a
  full-stream resubmit, and journal-GC-only-after-durable.
* **MTA014 fencing linearizability** (:func:`explore_fencing`) — a
  stale-epoch owner's checkpoint / wave / replication / migration is
  interleaved against failover promotion at every point (post-fence,
  post-promote, post-failover, lease-expired) and must die typed with
  nothing durable; every committed manifest is then audited for
  per-shard epoch monotonicity.
* **MTL107 durability lint** (:func:`durability_findings`) — the AST
  leg, wired into pass 2's
  :func:`~metrics_tpu_torch.analysis.lint.lint_source` exactly like
  MTL106: any write-mode ``open()`` in the package outside the atomic
  primitives, and any ``os.rename``/``os.replace`` with no ``os.fsync``
  ordered before it in the same function. The standard
  ``# metrics-tpu: allow(MTL107)`` suppression applies, and MTL105 audits
  those allows for staleness.

Evidence (states explored, schedules, crash points, verdicts) gates
against the committed tighten-only ``PROTOCOL_BASELINE.json`` (the same
file, and schema, the JAX package gates on): coverage can only grow, and
an explored-state regression is itself a finding. A violation's
:class:`Finding` carries the minimal failing schedule — the
counterexample is a repro script, not just an existence proof.
"""
import ast
import hashlib
import itertools
import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from metrics_tpu_torch.analysis.rules import Finding
from metrics_tpu_torch.observability import telemetry as _obs

__all__ = [
    "PROTOCOL_BASELINE",
    "build_protocol_entry",
    "check_protocol",
    "counterexample_report",
    "durability_findings",
    "explore_crash_consistency",
    "explore_fencing",
    "load_protocol_baseline",
    "refresh_protocol_baseline",
    "tighten_protocol_baseline",
]

PROTOCOL_BASELINE = "PROTOCOL_BASELINE.json"
PROTOCOL_BASELINE_SCHEMA = "metrics_tpu.protocol_baseline"

# the explorer's fleet constants: small enough to enumerate in seconds,
# large enough that rendezvous spreads tenants over every shard
_CRASH_SHARDS = ("a", "b")
_FENCE_SHARDS = ("a", "b", "c")
_N_TENANTS = 8
_SEED_STEPS = 2

_INVARIANTS = (
    "exactly-one-owner",
    "no-lost-tenant",
    "cursor-monotone",
    "no-double-count",
    "gc-only-after-durable",
    "recover-idempotent",
)


# ---------------------------------------------------------------------------
# MTL107 — the durability lint (AST leg, wired into pass 2)
# ---------------------------------------------------------------------------
def _dotted(node: ast.AST) -> str:
    """``os.path.replace``-style dotted name of a call target, or ''."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class _DurabilityVisitor(ast.NodeVisitor):
    """Per-function-scope scan for non-atomic write patterns."""

    def __init__(self, rel_path: str):
        self.rel_path = rel_path
        self.findings: List[Finding] = []
        # one fsync-lineno list per enclosing function scope (module = [0])
        self._fsync: List[List[int]] = [[]]

    def _emit(self, node: ast.AST, message: str, **detail: Any) -> None:
        self.findings.append(Finding(
            "MTL107",
            f"{self.rel_path}:{node.lineno}",
            message,
            detail={"line": node.lineno, **detail},
        ))

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._fsync.append([])
        self.generic_visit(node)
        self._fsync.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    @staticmethod
    def _write_mode(node: ast.Call) -> Optional[str]:
        mode: Optional[ast.expr] = None
        if len(node.args) >= 2:
            mode = node.args[1]
        for kw in node.keywords:
            if kw.arg == "mode":
                mode = kw.value
        if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
            if any(c in mode.value for c in "wax+"):
                return mode.value
        return None

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        if name == "os.fsync":
            self._fsync[-1].append(node.lineno)
        elif name in ("os.rename", "os.replace"):
            if not any(line < node.lineno for line in self._fsync[-1]):
                self._emit(
                    node,
                    f"`{name}` with no `os.fsync` ordered before it in the"
                    " same function: a crash can land the NAME durably while"
                    " the bytes are still in the page cache — route the"
                    " write through `checkpoint.atomic_file` /"
                    " `journal.atomic_write_json` (tmp + fsync + rename)",
                    pattern="rename-without-fsync",
                )
        elif name in ("open", "io.open", "builtins.open"):
            mode = self._write_mode(node)
            if mode is not None:
                self._emit(
                    node,
                    f"write-mode `open(..., {mode!r})` bypasses the atomic"
                    " tmp+fsync+rename discipline: a kill mid-write leaves a"
                    " torn artifact at the final path — use"
                    " `journal.atomic_write_json` (JSON) or"
                    " `checkpoint.atomic_file` (bytes)",
                    pattern="non-atomic-open",
                    mode=mode,
                )
        self.generic_visit(node)


def durability_findings(tree: ast.AST, rel_path: str) -> List[Finding]:
    """The MTL107 scan over one parsed module: every write-mode ``open``
    and every rename-without-preceding-fsync, as pass-2 findings routed
    through :func:`~metrics_tpu_torch.analysis.lint.lint_source`'s suppression
    machinery (so ``# metrics-tpu: allow(MTL107)`` with a rationale is
    the escape hatch, and MTL105 audits it for staleness)."""
    visitor = _DurabilityVisitor(rel_path)
    visitor.visit(tree)
    return visitor.findings


# ---------------------------------------------------------------------------
# the explorer's fleet plumbing (mirrors the chaos beds' helpers, but
# deterministic, tiny, and cloned per schedule from one seed tree)
# ---------------------------------------------------------------------------
def _wave_rows(keys: Sequence[int], step: int):
    """Deterministic per-(tenant, step) MSE batch: two samples per step."""
    import numpy as np

    keys = np.asarray(keys, dtype=np.float64)
    preds = np.stack(
        [keys * 1e-3 + step * 0.25, keys * 1e-3 - step * 0.125], 1
    ).astype(np.float32)
    target = np.stack([keys * 2e-3, np.zeros_like(keys)], 1).astype(np.float32)
    return preds, target


def _feed(shards: Dict[str, Any], steps: Sequence[int]) -> None:
    for step in steps:
        for sh in shards.values():
            keys = list(sh.tenants())
            if keys:
                sh.submit_wave(step, keys, *_wave_rows(keys, step))


def _build_seed(root: str, names: Sequence[str], shard_cls: Any,
                n_tenants: int, seed_steps: int, device: Any = None):
    """One durable seed fleet: tenants rendezvous-spread, ``seed_steps``
    waves folded, every shard checkpointed. Per-schedule runs clone this
    tree instead of re-folding the waves."""
    from metrics_tpu_torch.fleet import FleetPlacement

    placement = FleetPlacement(list(names))
    shards = {
        nm: shard_cls(nm, _template(device), os.path.join(root, nm)) for nm in names
    }
    keys_by: Dict[str, List[int]] = {nm: [] for nm in names}
    for k in range(n_tenants):
        keys_by[placement.assign(k)].append(k)
    for nm, keys in keys_by.items():
        if keys:
            shards[nm].add_tenants(keys)
    _feed(shards, range(seed_steps))
    for sh in shards.values():
        sh.checkpoint(note="protocol-seed")
    return placement, shards


def _check_device(device: Any) -> None:
    """Refuse the card when there is none, before any fleet is built: the
    explorers run on the card unless the caller asks for the CPU."""
    import torch

    wants_card = device is None or torch.device(device).type == "cuda"
    if wants_card and not torch.cuda.is_available():
        raise RuntimeError(
            "the protocol explorers run every shard's cohort on a CUDA device"
            " by default and none is available; pass device='cpu'"
        )


def _template(device: Any = None):
    """The shards' template metric on ``device`` (None: the card)."""
    from metrics_tpu_torch import MeanSquaredError

    return MeanSquaredError(device=device)


def _reopen(root: str, order: Sequence[str], shard_cls: Any,
            device: Any = None) -> Dict[str, Any]:
    """A fresh "process": rebuild each shard from its journal alone, in
    ``order`` — dict insertion order IS the recovery order the
    coordinator replays in."""
    shards: Dict[str, Any] = {}
    for nm in order:
        sh = shard_cls(nm, _template(device), os.path.join(root, nm))
        sh.restore()
        shards[nm] = sh
    return shards


_VOLATILE_KEYS = frozenset({"written_at", "sha"})


def _scrub(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items() if k not in _VOLATILE_KEYS}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


def _file_digest(path: str) -> bytes:
    """Structural digest of one durable file. Wall-clock leaks into the
    raw bytes two ways — ``written_at`` stamps in manifests/records and
    mtimes in npz zip headers — so two schedules reaching the SAME
    protocol state would fingerprint differently across a second
    boundary; hash the parsed/extracted content instead. Torn or foreign
    files fall back to raw bytes (a carcass IS distinguishing state)."""
    import zipfile

    if path.endswith(".json"):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                obj = json.load(fh)
            payload = json.dumps(_scrub(obj), sort_keys=True).encode()
            return hashlib.blake2b(payload, digest_size=16).digest()
        except (OSError, ValueError):
            pass
    if zipfile.is_zipfile(path):
        try:
            h = hashlib.blake2b(digest_size=16)
            with zipfile.ZipFile(path) as zf:
                for name in sorted(zf.namelist()):
                    h.update(name.encode())
                    h.update(b"\0")
                    h.update(zf.read(name))
                    h.update(b"\1")
            return h.digest()
        except (OSError, zipfile.BadZipFile):
            pass
    with open(path, "rb") as fh:
        return hashlib.blake2b(fh.read(), digest_size=16).digest()


def _durable_fingerprint(root: str, names: Sequence[str]) -> str:
    """Hash of everything durable the protocol can read back — journals,
    migration logs, staged envelopes, replica stores — with wall-clock
    noise scrubbed (:func:`_file_digest`), so the count of distinct
    fingerprints is a deterministic, baselinable coverage measure. Two
    schedules that crash into the same fingerprint recover identically
    (recovery is a deterministic function of durable state + replay
    order), so the DFS memoizes on it."""
    h = hashlib.blake2b(digest_size=16)
    for nm in sorted(names):
        shard_dir = os.path.join(root, nm)
        for dirpath, dirnames, filenames in os.walk(shard_dir):
            dirnames.sort()
            for fname in sorted(filenames):
                path = os.path.join(dirpath, fname)
                h.update(os.path.relpath(path, root).encode())
                h.update(b"\0")
                h.update(_file_digest(path))
                h.update(b"\1")
    return h.hexdigest()


def _owners(shards: Dict[str, Any], key: int) -> List[str]:
    return [nm for nm, sh in shards.items() if sh.has_tenant(key)]


# ---------------------------------------------------------------------------
# MTA013 — crash-consistency DFS
# ---------------------------------------------------------------------------
def _check_crash_invariants(
    shards: Dict[str, Any],
    coord: Any,
    n_tenants: int,
    seed_steps: int,
    victim: int,
    src_name: str,
    dst_name: str,
) -> Optional[Tuple[str, str]]:
    """One recovered world against the exactly-once contract; returns
    ``(invariant, message)`` for the first violation, None when clean."""
    for key in range(n_tenants):
        owners = _owners(shards, key)
        if len(owners) == 0:
            return ("no-lost-tenant", f"tenant {key} lives on no shard")
        if len(owners) > 1:
            return (
                "exactly-one-owner",
                f"tenant {key} lives on {sorted(owners)} simultaneously",
            )
    # GC-only-after-durable: if the source durably dropped the victim,
    # the target's journal must durably hold it
    if not shards[src_name].has_tenant(victim):
        dst = shards[dst_name]
        if dst.journal.newest_generation() is None or not dst.has_tenant(victim):
            return (
                "gc-only-after-durable",
                f"source {src_name!r} GC'd tenant {victim} but target"
                f" {dst_name!r} holds no durable copy",
            )
    # cursors monotone: nothing recovered below the seed's durable cursor
    for key in range(n_tenants):
        owner = _owners(shards, key)[0]
        cursor = shards[owner].cursor_of(key)
        if cursor < seed_steps - 1:
            return (
                "cursor-monotone",
                f"tenant {key} recovered at cursor {cursor} <"
                f" seed cursor {seed_steps - 1} (replay would double-fold)",
            )
    # recovery idempotent: the same durable facts replay to a no-op
    if coord.recover() != []:
        return ("recover-idempotent", "second recover() replayed work")
    # no-double-count: a naive full-stream resubmit must skip every
    # already-folded (tenant, step) pair and move no cursor
    before = {
        key: shards[_owners(shards, key)[0]].cursor_of(key)
        for key in range(n_tenants)
    }
    skipped0 = sum(sh.stats["replays_skipped"] for sh in shards.values())
    _feed(shards, range(seed_steps))
    skipped = sum(sh.stats["replays_skipped"] for sh in shards.values()) - skipped0
    if skipped != n_tenants * seed_steps:
        return (
            "no-double-count",
            f"full-stream resubmit skipped {skipped} (tenant, step) pairs,"
            f" expected {n_tenants * seed_steps}: some wave re-folded",
        )
    for key in range(n_tenants):
        cursor = shards[_owners(shards, key)[0]].cursor_of(key)
        if cursor != before[key]:
            return (
                "no-double-count",
                f"tenant {key} cursor moved {before[key]} -> {cursor} on a"
                " fully-replayed stream",
            )
    return None


def explore_crash_consistency(
    coordinator_cls: Any = None,
    shard_cls: Any = None,
    phases: Optional[Sequence[str]] = None,
    modes: Optional[Sequence[str]] = None,
    recovery_orders: Optional[Sequence[Sequence[str]]] = None,
    n_tenants: int = _N_TENANTS,
    seed_steps: int = _SEED_STEPS,
    device: Any = None,
) -> Tuple[Dict[str, Any], List[Finding]]:
    """The MTA013 DFS: every migration yield point × {none, kill,
    double kill, partition} × every recovery permutation, invariants
    checked on each recovered world, memoized by durable-state hash.
    Returns ``(evidence, findings)``; a clean protocol returns no
    findings. ``coordinator_cls``/``shard_cls`` take the broken-by-design
    fixtures; ``phases``/``modes``/``recovery_orders`` shrink the
    schedule space for targeted tests (full space by default). Every
    shard's cohort lives on ``device`` (None: the card)."""
    from metrics_tpu_torch.fleet import FleetPlacement, MigrationCoordinator
    from metrics_tpu_torch.reliability.faultinject import (
        FaultInjected,
        kill_at_migration_phase,
    )

    _check_device(device)
    coordinator_cls = coordinator_cls or MigrationCoordinator
    shard_cls = shard_cls or _fleet_shard_cls()
    names = _CRASH_SHARDS
    phases = tuple(phases if phases is not None else MigrationCoordinator.PHASES)
    modes = tuple(modes if modes is not None else
                  ("none", "kill", "double_kill", "partition"))
    orders = [tuple(o) for o in (
        recovery_orders if recovery_orders is not None
        else itertools.permutations(names)
    )]

    schedules: List[Tuple[str, Optional[str], Tuple[str, ...]]] = []
    if "none" in modes:
        schedules.append(("none", None, orders[0]))
    for phase in phases:
        for mode in ("kill", "double_kill", "partition"):
            if mode not in modes:
                continue
            for order in orders:
                schedules.append((mode, phase, order))

    findings: List[Finding] = []
    memo: set = set()
    fingerprints: set = set()
    crash_points: set = set()
    pruned = 0
    explored = 0

    with tempfile.TemporaryDirectory() as workdir:
        seed_root = os.path.join(workdir, "seed")
        os.makedirs(seed_root)
        _, seed_shards = _build_seed(seed_root, names, shard_cls,
                                     n_tenants, seed_steps, device)
        src_name, dst_name = names[0], names[1]
        src_tenants = sorted(seed_shards[src_name].tenants())
        if not src_tenants:  # rendezvous starved the source: swap roles
            src_name, dst_name = dst_name, src_name
            src_tenants = sorted(seed_shards[src_name].tenants())
        victim = src_tenants[0]
        second_victim = src_tenants[1] if len(src_tenants) > 1 else victim

        for run, (mode, phase, order) in enumerate(schedules):
            root = os.path.join(workdir, f"run{run:03d}")
            shutil.copytree(seed_root, root)
            trace: List[str] = [
                f"seed: {len(names)} shards, {n_tenants} tenants,"
                f" {seed_steps} waves folded + checkpointed",
            ]
            shards = _reopen(root, names, shard_cls, device)
            coord = coordinator_cls(FleetPlacement(list(names)),
                                    list(shards.values()))

            if mode == "none":
                trace.append(f"migrate(t{victim}: {src_name}->{dst_name})"
                             " runs to completion")
                coord.migrate(victim, dst_name)
            else:
                trace.append(
                    f"migrate(t{victim}: {src_name}->{dst_name}) —"
                    f" {'partition' if mode == 'partition' else 'kill'}"
                    f" injected at phase {phase!r}"
                )
                inject = "partition" if mode == "partition" else "kill"
                with kill_at_migration_phase(coord, phase, mode=inject) as info:
                    try:
                        coord.migrate(victim, dst_name)
                    except FaultInjected:
                        pass
                if info["kills"] == 0:
                    trace.append(f"(phase {phase!r} never entered)")
                else:
                    crash_points.add(f"{phase}/{mode}")

            if mode == "partition":
                # the process SURVIVES a partition: recovery runs on the
                # live objects after the heal, then the durable story is
                # re-checked from a fresh reopen
                trace.append("partition heals; recover() on the live fleet")
                coord.recover()

            if mode == "double_kill":
                trace.append(f"reopen {list(order)}; second kill at the"
                             " re-entrant 'recover' yield point")
                shards = _reopen(root, order, shard_cls, device)
                coord = coordinator_cls(FleetPlacement(list(names)),
                                        list(shards.values()))
                with kill_at_migration_phase(coord, "recover") as info2:
                    try:
                        coord.recover()
                    except FaultInjected:
                        pass
                if info2["kills"]:
                    crash_points.add("recover/kill")
                else:
                    # nothing stranded (a prepare-phase kill): land the
                    # second kill in a follow-up migration instead
                    trace.append(
                        f"(nothing stranded; second kill lands in"
                        f" migrate(t{second_victim}) at phase {phase!r})"
                    )
                    with kill_at_migration_phase(coord, phase) as info3:
                        try:
                            coord.migrate(second_victim, dst_name)
                        except FaultInjected:
                            pass
                    if info3["kills"]:
                        crash_points.add(f"{phase}/second-migration")

            fp = _durable_fingerprint(root, names)
            fingerprints.add(fp)
            memo_key = (fp, order, mode)
            if memo_key in memo:
                pruned += 1
                shutil.rmtree(root, ignore_errors=True)
                continue
            memo.add(memo_key)
            explored += 1

            trace.append(f"reopen {list(order)} from durable state;"
                         " recover()")
            shards = _reopen(root, order, shard_cls, device)
            coord = coordinator_cls(FleetPlacement(list(names)),
                                    list(shards.values()))
            coord.recover()

            violation = _check_crash_invariants(
                shards, coord, n_tenants, seed_steps,
                victim, src_name, dst_name,
            )
            if violation is not None:
                invariant, message = violation
                trace.append(f"INVARIANT VIOLATED: {invariant}")
                findings.append(Finding(
                    "MTA013",
                    f"{coordinator_cls.__name__}/{phase or 'none'}",
                    f"{invariant} violated after"
                    f" {mode} at {phase or 'completion'}: {message}",
                    detail={
                        "schedule": trace,
                        "invariant": invariant,
                        "phase": phase,
                        "mode": mode,
                        "recovery_order": list(order),
                    },
                ))
            shutil.rmtree(root, ignore_errors=True)

    evidence = {
        "schedules": len(schedules),
        "explored": explored,
        "pruned": pruned,
        "states_explored": len(fingerprints),
        "crash_points": sorted(crash_points),
        "phases": list(phases),
        "modes": list(modes),
        "recovery_orders": len(orders),
        "invariants": list(_INVARIANTS),
        "violations": len(findings),
    }
    _note_protocol_audit(coordinator_cls.__name__, findings)
    return evidence, findings


def _fleet_shard_cls():
    from metrics_tpu_torch.fleet import FleetShard

    return FleetShard


# ---------------------------------------------------------------------------
# MTA014 — fencing linearizability
# ---------------------------------------------------------------------------
_STALE_WRITES = ("checkpoint", "submit_wave", "replicate", "migrate")
_FENCE_POINTS = ("after_fence", "after_promote", "after_failover", "expired")


def _manifest_epochs_monotone(root: str, names: Sequence[str]) -> Optional[str]:
    """Audit every committed journal manifest for per-shard epoch
    monotonicity — the linearizability witness. Returns a message for the
    first regression, None when every record sequence is non-decreasing."""
    from metrics_tpu_torch.reliability.journal import MANIFEST_NAME

    for nm in sorted(names):
        path = os.path.join(root, nm, MANIFEST_NAME)
        try:
            with open(path) as fh:
                records = json.load(fh).get("records", [])
        except (OSError, ValueError):
            continue
        last: Optional[int] = None
        for rec in records:
            epoch = rec.get("epoch")
            if epoch is None:
                continue
            if last is not None and int(epoch) < last:
                return (
                    f"shard {nm!r} manifest records epoch {epoch} after"
                    f" epoch {last} (generation {rec.get('generation')}):"
                    " a fenced writer committed out of order"
                )
            last = int(epoch)
    return None


def explore_fencing(
    shard_cls: Any = None,
    writes: Optional[Sequence[str]] = None,
    points: Optional[Sequence[str]] = None,
    n_tenants: int = _N_TENANTS + 4,
    seed_steps: int = _SEED_STEPS,
    device: Any = None,
) -> Tuple[Dict[str, Any], List[Finding]]:
    """The MTA014 interleaver: a stale-epoch owner attempts each write
    (``checkpoint`` / ``submit_wave`` / ``replicate`` / ``migrate``) at
    each interleaving point against failover (post-fence, post-promote,
    post-complete-failover, and the lease-expired variant). Every attempt
    must raise a typed :class:`~metrics_tpu_torch.fleet.lease.LeaseError`
    with not one durable byte changed, and every committed manifest must
    keep per-shard epochs monotone. Every shard's cohort lives on
    ``device`` (None: the card). Returns ``(evidence, findings)``."""
    from metrics_tpu_torch.fleet import (
        FleetPlacement,
        FleetRebalancer,
        LeaseAuthority,
        MigrationCoordinator,
    )
    from metrics_tpu_torch.fleet.lease import LeaseError
    from metrics_tpu_torch.fleet.replication import ShardReplicator

    _check_device(device)
    shard_cls = shard_cls or _fleet_shard_cls()
    names = _FENCE_SHARDS
    writes = tuple(writes if writes is not None else _STALE_WRITES)
    points = tuple(points if points is not None else _FENCE_POINTS)

    findings: List[Finding] = []
    fingerprints: set = set()
    checked = 0
    schedules = [(w, p) for w in writes for p in points]

    with tempfile.TemporaryDirectory() as workdir:
        seed_root = os.path.join(workdir, "seed")
        os.makedirs(seed_root)
        _build_seed(seed_root, names, shard_cls, n_tenants, seed_steps, device)

        for run, (write, point) in enumerate(schedules):
            root = os.path.join(workdir, f"run{run:03d}")
            shutil.copytree(seed_root, root)
            trace: List[str] = [
                f"seed: {len(names)} leased shards, {n_tenants} tenants,"
                f" replicated + checkpointed",
            ]
            authority = LeaseAuthority(ttl_s=3600.0)
            shards = _reopen(root, names, shard_cls, device)
            for sh in shards.values():
                sh.attach_lease(authority)
            placement = FleetPlacement(list(names))
            coord = MigrationCoordinator(placement, list(shards.values()))
            replicator = ShardReplicator(coord, authority=authority)
            rebalancer = FleetRebalancer(
                coord, replicator=replicator, authority=authority
            )
            for sh in shards.values():
                sh.checkpoint(note="protocol-fence-seed")
                replicator.replicate(sh)
            # the stale owner's pre-failover view of the world: its own
            # coordinator object, still naming every shard
            stale = shards["a"]
            stale_coord = MigrationCoordinator(
                FleetPlacement(list(names)), list(shards.values())
            )
            stale_tenants = sorted(stale.tenants())

            if point == "expired":
                trace.append("lease on 'a' expires (TTL elapsed, no"
                             " failover yet)")
                authority.expire("a")
            else:
                trace.append("failover('a'): fence epoch")
                authority.fence("a")
                if point in ("after_promote", "after_failover"):
                    trace.append("failover('a'): promote replicas onto"
                                 " followers")
                    promoted = replicator.promote("a")
                    if point == "after_failover":
                        trace.append("failover('a'): drop carcass, re-pin"
                                     " placement")
                        coord.shards.pop("a", None)
                        if "a" in placement.shards:
                            placement.remove_shard("a")
                        for key, fname, _cursor in promoted:
                            placement.record_location(key, fname)

            before = _durable_fingerprint(root, names)
            trace.append(f"stale owner 'a' attempts {write} at {point}")
            refused = False
            untyped: Optional[BaseException] = None
            try:
                if write == "checkpoint":
                    stale.checkpoint(note="stale-write")
                elif write == "submit_wave":
                    keys = stale_tenants
                    stale.submit_wave(seed_steps, keys,
                                      *_wave_rows(keys, seed_steps))
                elif write == "replicate":
                    replicator.replicate(stale)
                else:  # migrate
                    stale_coord.migrate(stale_tenants[0], "b", src_name="a")
            except LeaseError:
                refused = True
            except Exception as err:  # noqa: BLE001 — an unfenced write
                # colliding with the promoted world dies UNTYPED (e.g. an
                # add-tenant conflict): the contract is a typed refusal
                # BEFORE any protocol step runs, so this is a violation,
                # not an explorer crash
                untyped = err
            checked += 1
            after = _durable_fingerprint(root, names)
            fingerprints.add(after)

            if not refused:
                how = (
                    f"died untyped ({type(untyped).__name__}: {untyped})"
                    if untyped is not None else "was accepted"
                )
                trace.append(f"VIOLATION: the stale write {how}")
                findings.append(Finding(
                    "MTA014",
                    f"{shard_cls.__name__}.{write}",
                    f"stale-epoch {write} at {point} {how}"
                    " (expected a typed LeaseError refusal before any"
                    " protocol step ran)",
                    detail={"schedule": trace, "write": write,
                            "point": point, "invariant": "fenced-write-refused"},
                ))
            if after != before:
                trace.append("VIOLATION: durable state changed under a"
                             " fenced epoch")
                findings.append(Finding(
                    "MTA014",
                    f"{shard_cls.__name__}.{write}",
                    f"stale-epoch {write} at {point} left durable bytes"
                    " behind: no fenced-epoch write may ever be durable",
                    detail={"schedule": trace, "write": write,
                            "point": point, "invariant": "no-fenced-durability"},
                ))
            epoch_message = _manifest_epochs_monotone(root, names)
            if epoch_message is not None:
                findings.append(Finding(
                    "MTA014",
                    f"{shard_cls.__name__}.{write}",
                    f"manifest epoch regression after {write} at {point}:"
                    f" {epoch_message}",
                    detail={"schedule": trace, "write": write,
                            "point": point, "invariant": "epoch-monotone"},
                ))
            # survivors must keep serving under their own (current) epochs
            survivor = shards["b"]
            survivor.checkpoint(note="survivor-write")
            shutil.rmtree(root, ignore_errors=True)
            del rebalancer

    evidence = {
        "schedules": len(schedules),
        "stale_writes_checked": checked,
        "states_explored": len(fingerprints),
        "writes": list(writes),
        "points": list(points),
        "violations": len(findings),
    }
    _note_protocol_audit(shard_cls.__name__, findings)
    return evidence, findings


# ---------------------------------------------------------------------------
# hints: the watchdog cross-link, keyed like every other audit
# ---------------------------------------------------------------------------
def _note_protocol_audit(cls_name: str, findings: List[Finding]) -> None:
    """Register the run's findings under the driven class's bare name so
    ``hint_for_watch_key`` resolves protocol rules exactly like pass-1/4
    ones (same name-keyed, latest-audit-wins caveat)."""
    from metrics_tpu_torch.analysis import program as _program

    _program._note_audit(cls_name, findings)


# ---------------------------------------------------------------------------
# the committed tighten-only baseline
# ---------------------------------------------------------------------------
_BASELINE_CACHE: Dict[str, Dict[str, Any]] = {}
_BASELINE_LOCK = threading.Lock()

_COVERAGE_KEYS = ("states_explored", "schedules", "crash_points")


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def load_protocol_baseline(path: Optional[str] = None) -> Dict[str, Any]:
    """The committed ``PROTOCOL_BASELINE.json`` (cached per path; the
    bare default resolves against the repo root, not the CWD). Missing or
    torn files read as empty — the gate then has nothing to hold
    coverage against, which the refresh path refuses to bootstrap over."""
    path = path or os.path.join(_repo_root(), PROTOCOL_BASELINE)
    with _BASELINE_LOCK:
        if path in _BASELINE_CACHE:
            return _BASELINE_CACHE[path]
    try:
        with open(path, "r", encoding="utf-8") as fh:
            baseline = json.load(fh)
        if baseline.get("schema") != PROTOCOL_BASELINE_SCHEMA:
            baseline = {}
    except (OSError, ValueError):
        baseline = {}
    with _BASELINE_LOCK:
        _BASELINE_CACHE[path] = baseline
    return baseline


def build_protocol_entry(evidence: Dict[str, Any]) -> Dict[str, int]:
    """One baseline entry from one scenario's fresh evidence: the
    coverage counters that may only grow."""
    crash_points = evidence.get("crash_points")
    return {
        "states_explored": int(evidence.get("states_explored", 0)),
        "schedules": int(evidence.get("schedules", 0)),
        "crash_points": len(crash_points) if isinstance(crash_points, list)
        else int(evidence.get("stale_writes_checked", 0)),
    }


def tighten_protocol_baseline(
    baseline: Dict[str, Any], fresh: Dict[str, Dict[str, int]]
) -> Tuple[Dict[str, Any], List[str]]:
    """Merge fresh coverage into the committed baseline, tighten-only:
    per scenario each counter takes ``max(committed, fresh)`` (coverage
    can only grow), entries named in ``fixtures`` keep their committed
    values verbatim, and scenarios the fresh run no longer produces are
    pruned. Returns ``(merged, pruned_names)``."""
    out = dict(baseline)
    old = dict(baseline.get("entries", {}))
    keep = set(baseline.get("fixtures", []))
    entries: Dict[str, Any] = {
        name: old[name] for name in sorted(keep) if name in old
    }
    for name, entry in sorted(fresh.items()):
        if name in keep:
            continue
        committed = old.get(name, {})
        entries[name] = {
            key: max(int(committed.get(key, 0)), int(entry.get(key, 0)))
            for key in _COVERAGE_KEYS
        }
    pruned = sorted(set(old) - set(entries))
    out["entries"] = entries
    return out, pruned


def refresh_protocol_baseline(path: str, protocol: Dict[str, Any], skipped: bool) -> str:
    """Apply (or refuse) one baseline refresh request and return the
    human-readable outcome line; writes ``path`` and nothing else. A skipped
    pass has no coverage to merge, a red exploration would launder a
    violated invariant (or a coverage regression) into the committed file,
    and a missing file means bootstrap-by-hand (the committed file carries
    the fixture entries). A permitted refresh is TIGHTEN-ONLY: per-scenario
    coverage counters take ``max(committed, fresh)`` via
    :func:`tighten_protocol_baseline`."""
    from metrics_tpu_torch.reliability.journal import atomic_write_json

    if skipped:
        return (
            "protocol baseline NOT refreshed: a run that skipped the protocol"
            " pass has no exploration to merge; refresh requires the full pass"
        )
    findings = protocol["summary"]["findings"]
    if findings:
        return (
            "protocol baseline NOT refreshed: the exploration reported"
            f" {findings} unsuppressed finding(s); fix them (or hand-edit"
            " PROTOCOL_BASELINE.json for an intended coverage change)"
            " and re-run"
        )
    try:
        with open(path, "r", encoding="utf-8") as fh:
            baseline = json.load(fh)
    except (OSError, ValueError) as err:
        return (
            f"protocol baseline NOT refreshed: {path} is missing or"
            f" unreadable ({err}); restore the committed file (git checkout)"
            " before refreshing"
        )
    fresh = protocol["evidence"]["baseline_entries"]
    baseline, pruned = tighten_protocol_baseline(baseline, fresh)
    atomic_write_json(path, baseline)
    with _BASELINE_LOCK:
        _BASELINE_CACHE.pop(path, None)
    return (
        f"refreshed {path} ({len(fresh)} scenario entries"
        + (f"; pruned {pruned}" if pruned else "")
        + ")"
    )


def _baseline_findings(
    fresh: Dict[str, Dict[str, int]], baseline: Dict[str, Any]
) -> List[Finding]:
    """The tighten-only gate: fresh coverage below a committed counter is
    a finding (MTA013 for the crash scenario, MTA014 for fencing) — an
    explored-state regression means schedules the protocol used to
    survive are no longer even attempted."""
    rules = {"crash_consistency": "MTA013", "fencing": "MTA014"}
    findings: List[Finding] = []
    for name, committed in sorted(baseline.get("entries", {}).items()):
        if name in set(baseline.get("fixtures", [])):
            continue
        entry = fresh.get(name)
        if entry is None:
            continue
        for key in _COVERAGE_KEYS:
            have, want = int(entry.get(key, 0)), int(committed.get(key, 0))
            if have < want:
                findings.append(Finding(
                    rules.get(name, "MTA013"),
                    f"protocol/{name}",
                    f"explored-coverage regression: {key} {have} <"
                    f" committed {want} (PROTOCOL_BASELINE.json is"
                    " tighten-only; coverage can only grow)",
                    detail={"scenario": name, "key": key,
                            "fresh": have, "committed": want},
                ))
    return findings


# ---------------------------------------------------------------------------
# the pass-6 entry point
# ---------------------------------------------------------------------------
def check_protocol(
    baseline: Optional[Dict[str, Any]] = None,
    baseline_path: Optional[str] = None,
    device: Any = None,
) -> Dict[str, Any]:
    """Run the full pass: both explorers over the REAL fleet classes at
    full schedule scope, the tighten-only baseline gate, telemetry
    (``analysis.protocol.states_explored`` gauge; the healthy-run-zero
    ``analysis.protocol.violations`` counter ticks only on violations),
    and the watchdog hint registration. Returns the ``report["protocol"]``
    payload a gate folds into its report: ``{"findings", "evidence",
    "summary"}``. Every shard's cohort lives on ``device`` (None: the
    card)."""
    crash_ev, crash_findings = explore_crash_consistency(device=device)
    fence_ev, fence_findings = explore_fencing(device=device)
    findings = crash_findings + fence_findings
    fresh = {
        "crash_consistency": build_protocol_entry(crash_ev),
        "fencing": build_protocol_entry(fence_ev),
    }
    if baseline is None:
        baseline = load_protocol_baseline(baseline_path)
    findings.extend(_baseline_findings(fresh, baseline))

    states = int(crash_ev["states_explored"]) + int(fence_ev["states_explored"])
    violations = len(findings)
    if _obs.enabled():
        _obs.get().gauge("analysis.protocol.states_explored", states)
        if violations:
            _obs.get().count("analysis.protocol.violations", violations)

    evidence = {
        "crash_consistency": crash_ev,
        "fencing": fence_ev,
        "baseline_entries": fresh,
        "states_explored": states,
    }
    return {
        "findings": [f.to_dict() for f in findings],
        "evidence": evidence,
        "summary": {
            "findings": violations,
            "states_explored": states,
            "schedules": int(crash_ev["schedules"]) + int(fence_ev["schedules"]),
            "violations": violations,
        },
    }


def counterexample_report(findings: Sequence[Any]) -> str:
    """Human-readable counterexample traces, MINIMAL schedule first: the
    shortest failing schedule is the repro an operator replays (see the
    worked example in ``docs/static_analysis.md``). Accepts Finding
    objects or their ``to_dict()`` form; empty input reads as clean."""
    dicts = [f.to_dict() if isinstance(f, Finding) else dict(f) for f in findings]
    if not dicts:
        return "protocol explorer: no counterexamples (all schedules clean)\n"
    dicts.sort(key=lambda d: (len((d.get("detail") or {}).get("schedule", [])),
                              d.get("rule", ""), d.get("subject", "")))
    lines = [f"protocol explorer: {len(dicts)} counterexample(s);"
             " minimal schedule first"]
    for i, d in enumerate(dicts):
        detail = d.get("detail") or {}
        lines.append(
            f"[{i}] {d.get('rule')} {d.get('subject')}"
            f" — {detail.get('invariant', '?')}"
        )
        for step, action in enumerate(detail.get("schedule", [])):
            lines.append(f"    {step}. {action}")
        lines.append(f"    => {d.get('message')}")
    return "\n".join(lines) + "\n"
