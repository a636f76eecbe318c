"""Failure flight recorder: what happened in the last N steps.

Port of ``metrics_tpu/observability/flight.py``, unchanged in behaviour and
in its ``"metrics_tpu.flight_dump"`` schema 1. When the library survives a
failure (an engine step demoted to eager, the recompilation watchdog
flagging churn), the warning says what recovered, never what the pipeline
was doing in the steps leading up to it. The :class:`FlightRecorder` is the
black box for that question: a cheap ring buffer of the last N step events
that dumps to disk (through ``reliability.journal.atomic_write_json``: a
crash mid-dump leaves the previous dump, never a torn one) at exactly those
failure points.

Every dump names the failing step range (``step_range: [first, last]`` over
the buffered events), the trigger reason, the trigger's context and, when
telemetry is also enabled, the current counter snapshot.

The default is off: each hook reads one module global and branches. Enable
with :func:`enable_flight` (pass the dump directory), :func:`flight_scope`,
or ``METRICS_TPU_FLIGHT=<dir>``. One dump per failure occurrence, capped
per reason; keep-last-K files in the directory.
"""
import glob
import os
import re
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

from metrics_tpu_torch.observability import identity as _identity
from metrics_tpu_torch.observability import trace as _trace
from metrics_tpu_torch.utilities.env import flight_dir
from metrics_tpu_torch.utilities.prints import warn_once

__all__ = [
    "FlightRecorder",
    "enable_flight",
    "disable_flight",
    "flight_enabled",
    "flight_scope",
    "get_flight",
    "record",
    "dump_on_failure",
]

_DEFAULT_CAPACITY = 2048
_DEFAULT_MAX_DUMPS_PER_REASON = 8
_DEFAULT_KEEP_DUMPS = 32
_REASON_RE = re.compile(r"[^A-Za-z0-9_.-]+")
_DUMP_FILE_RE = re.compile(r"^flight-(\d{4,})-.*\.json$")


class FlightRecorder:
    """Ring buffer of step events + the dump protocol.

    Args:
        directory: where failure dumps land (created on first dump).
        capacity: events retained (the "last N steps" window; one step
            usually contributes one to a few events).
        max_dumps_per_reason: automatic (failure-hook) dumps admitted per
            trigger reason — a persistently-poisoned input stream must not
            turn every step into a full dump write (one warn_once when a
            reason hits its cap; manual :meth:`dump` calls are uncapped).
        keep_dumps: ``flight-*.json`` files retained in the directory
            (keep-last-K GC, same ordering discipline as
            ``CheckpointJournal``: the new dump is committed atomically
            FIRST, then the oldest files beyond K are removed — a crash
            between the two steps leaves an extra old dump, never a
            missing new one). Bounds the disk a flapping fault (or many
            distinct reasons, each under its per-reason cap) can consume.
    """

    def __init__(
        self,
        directory: Any,
        capacity: int = _DEFAULT_CAPACITY,
        max_dumps_per_reason: int = _DEFAULT_MAX_DUMPS_PER_REASON,
        keep_dumps: int = _DEFAULT_KEEP_DUMPS,
    ):
        if keep_dumps < 1:
            raise ValueError("keep_dumps must be >= 1")
        self.directory = os.fspath(directory)
        self.capacity = int(capacity)
        self.max_dumps_per_reason = int(max_dumps_per_reason)
        self.keep_dumps = int(keep_dumps)
        self._lock = threading.RLock()
        self.events: "deque[Dict[str, Any]]" = deque(maxlen=self.capacity)
        self.dumps = 0
        self.dumps_by_reason: Dict[str, int] = {}
        self.dump_paths: List[str] = []
        self._origin = time.time()

    # ------------------------------------------------------------------
    # recording (the always-cheap side)
    # ------------------------------------------------------------------
    def record(self, kind: str, step: Optional[int] = None, **fields: Any) -> None:
        """Append one event (a dict append into a bounded deque)."""
        with self._lock:
            self.events.append(
                {
                    "t": round(time.time() - self._origin, 6),
                    "step": _trace.current_step() if step is None else int(step),
                    "kind": kind,
                    **fields,
                }
            )

    def step_range(self) -> Optional[List[int]]:
        """``[first, last]`` step index across buffered events."""
        with self._lock:
            steps = [e["step"] for e in self.events if e.get("step") is not None]
        return [min(steps), max(steps)] if steps else None

    # ------------------------------------------------------------------
    # the dump protocol (the cold failure side)
    # ------------------------------------------------------------------
    def dump(self, reason: str, hint: Optional[str] = None, **context: Any) -> str:
        """Write the current ring buffer as one atomic JSON dump; returns
        the dump path. Called by the failure hooks; safe to call manually
        (a live drill)."""
        # lazy import: the reliability package's later modules import
        # observability at their top, so observability must stay importable
        # before it
        from metrics_tpu_torch.reliability.journal import atomic_write_json

        with self._lock:
            self.dumps += 1
            seq = self.dumps
            events = list(self.events)
        steps = [e["step"] for e in events if e.get("step") is not None]
        payload = {
            "format": "metrics_tpu.flight_dump",
            "schema_version": 1,
            "identity": _identity.process_identity(),
            "reason": reason,
            "hint": hint,
            "context": context,
            "step_range": [min(steps), max(steps)] if steps else None,
            "current_step": _trace.current_step(),
            "dumped_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "events": events,
            "telemetry": _telemetry_snapshot(),
            "cost_ledger": _cost_ledger_brief(),
        }
        slug = _REASON_RE.sub("-", reason).strip("-") or "failure"
        os.makedirs(self.directory, exist_ok=True)
        # a re-armed recorder over a directory holding earlier dumps must
        # extend the sequence PAST the newest existing file, not fill the
        # first free slot: keep-last-K GC frees LOW numbers, and reusing
        # one would make the fresh dump sort oldest — the next GC pass
        # would then delete the newest evidence first
        existing = [
            int(m.group(1))
            for m in (
                _DUMP_FILE_RE.match(os.path.basename(p))
                for p in glob.glob(os.path.join(self.directory, "flight-*.json"))
            )
            if m
        ]
        if existing:
            seq = max(seq, max(existing) + 1)
        with self._lock:
            self.dumps = max(self.dumps, seq)
        path = os.path.join(self.directory, f"flight-{seq:04d}-{slug}.json")
        atomic_write_json(path, payload)
        with self._lock:
            self.dump_paths.append(path)
        self._gc_dumps()
        warn_once(
            f"flight recorder: dumped the last-{len(events)}-event window to"
            f" {path!r} (reason: {reason}); further dumps for this reason are"
            " written silently",
            key=f"flight-dump:{slug}",
        )
        return path

    def _gc_dumps(self) -> None:
        """Keep-last-``keep_dumps`` GC over the dump directory, ordered
        like ``CheckpointJournal``'s rotation: the new dump is already
        durable (atomic write) before anything is deleted, deletion walks
        oldest-first, and only files matching the recorder's own
        ``flight-NNNN-*.json`` naming are ever touched — a crash anywhere
        leaves at worst an extra old dump for the next GC pass. Never
        raises: GC is housekeeping, not part of the failure path."""
        try:
            entries = []
            for fname in os.listdir(self.directory):
                m = _DUMP_FILE_RE.match(fname)
                if m:
                    entries.append((int(m.group(1)), fname))
            entries.sort()
            for _, fname in entries[: max(0, len(entries) - self.keep_dumps)]:
                victim = os.path.join(self.directory, fname)
                try:
                    os.remove(victim)
                except OSError:
                    continue
                with self._lock:
                    if victim in self.dump_paths:
                        self.dump_paths.remove(victim)
        except OSError:  # noqa: PERF203 — directory listing raced a cleanup
            pass

    def _admit_failure_dump(self, reason: str) -> bool:
        """Per-reason admission for the automatic failure hooks: beyond
        ``max_dumps_per_reason`` occurrences the window stops being news —
        record the event stream, keep the early dumps, stop paying an
        atomic write per step."""
        with self._lock:
            n = self.dumps_by_reason[reason] = self.dumps_by_reason.get(reason, 0) + 1
        if n > self.max_dumps_per_reason:
            warn_once(
                f"flight recorder: reason {reason!r} hit its"
                f" {self.max_dumps_per_reason}-dump cap; further occurrences"
                " are buffered but not dumped (raise max_dumps_per_reason to"
                " keep more)",
                key=f"flight-dump-cap:{reason}",
            )
            return False
        return True

    def reset(self) -> None:
        with self._lock:
            self.events.clear()
            self.dumps = 0
            self.dumps_by_reason = {}
            self.dump_paths = []


def _telemetry_snapshot() -> Optional[Dict[str, Any]]:
    """Counter snapshot riding the dump when telemetry is also on (the
    dump is a cold path; one snapshot is cheap there)."""
    from metrics_tpu_torch.observability import telemetry as _obs

    if not _obs.enabled():
        return None
    snap = _obs.get().snapshot()
    return {"counters": snap["counters"], "gauges": snap["gauges"]}


def _cost_ledger_brief() -> Optional[Dict[str, Any]]:
    """The compiled-program cost ledger riding the dump when armed
    (``costledger.py``'s brief: one row per program); None when disarmed
    or empty, so the field is always present; never raises."""
    try:
        from metrics_tpu_torch.observability import costledger as _cl

        if not _cl.cost_ledger_enabled():
            return None
        return _cl.get_ledger().brief() or None
    except Exception:  # noqa: BLE001 — diagnostics must not crash the dump
        return None


# ----------------------------------------------------------------------
# module-level singleton + enable/disable switch (telemetry's shape)
# ----------------------------------------------------------------------
_recorder: Optional[FlightRecorder] = None
_enabled = False


def get_flight() -> Optional[FlightRecorder]:
    """The active recorder (None when never enabled)."""
    return _recorder


def flight_enabled() -> bool:
    """The ONE check every hook makes; keep it a plain global read."""
    return _enabled


def enable_flight(
    directory: Any,
    capacity: int = _DEFAULT_CAPACITY,
    keep_dumps: int = _DEFAULT_KEEP_DUMPS,
) -> FlightRecorder:
    """Arm the flight recorder: buffer events, dump to ``directory`` on
    the reliability layer's failure paths (at most ``keep_dumps`` dump
    files retained, oldest GC'd first)."""
    global _recorder, _enabled
    _recorder = FlightRecorder(directory, capacity=capacity, keep_dumps=keep_dumps)
    _enabled = True
    return _recorder


def disable_flight() -> None:
    """Disarm. The last recorder stays readable via :func:`get_flight`."""
    global _enabled
    _enabled = False


@contextmanager
def flight_scope(directory: Any, capacity: int = _DEFAULT_CAPACITY) -> Iterator[FlightRecorder]:
    """Arm the recorder for a ``with`` block, restoring the prior
    recorder/enabled state on exit."""
    global _recorder, _enabled
    prev_rec, prev_enabled = _recorder, _enabled
    rec = enable_flight(directory, capacity=capacity)
    try:
        yield rec
    finally:
        _recorder = prev_rec
        _enabled = prev_enabled


# ----------------------------------------------------------------------
# hook helpers (cheap no-ops when disabled)
# ----------------------------------------------------------------------
def record(kind: str, **fields: Any) -> None:
    """Buffer one step event; no-op unless the recorder is armed."""
    if _enabled and _recorder is not None:
        _recorder.record(kind, **fields)


def dump_on_failure(reason: str, hint: Optional[str] = None, **context: Any) -> Optional[str]:
    """One atomic dump of the event window; no-op unless armed, capped at
    ``max_dumps_per_reason`` per trigger reason. Never raises — a failed
    dump must not break the recovery it documents."""
    if not (_enabled and _recorder is not None):
        return None
    if not _recorder._admit_failure_dump(reason):
        return None
    try:
        return _recorder.dump(reason, hint=hint, **context)
    except Exception as err:  # noqa: BLE001 — diagnostics must not crash recovery
        warn_once(
            f"flight recorder: dump for {reason!r} failed"
            f" ({type(err).__name__}: {err}); continuing without it",
            key=f"flight-dump-failed:{reason}",
        )
        return None


_env_dir = flight_dir()
if _env_dir:
    enable_flight(_env_dir)
