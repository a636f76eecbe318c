"""Step-structured tracing: where inside a step the time goes.

Port of ``metrics_tpu/observability/trace.py``, unchanged in behaviour and
format but for one field: a span's ``tid`` is the thread's native id
(``threading.get_native_id()``), where the JAX package keeps the low 16 bits
of ``threading.get_ident()``, a stack address whose low bits few threads
tell apart (two threads then share a Perfetto track). The telemetry registry (``telemetry.py``) counts and totals; the
:class:`TraceRecorder` records step-indexed spans:

* every span carries a **step index** (the engine's dispatch counter, or a
  step pinned with :func:`step_scope`), a **phase** from the canonical
  attribution set (:data:`PHASES`), its host wall-clock start and duration,
  and its parent (a per-thread span stack);
* recording is a ring buffer (``deque(maxlen=...)``): bounded memory, the
  newest spans win;
* the recording exports as Chrome/Perfetto ``trace_event`` JSON through
  :meth:`TraceRecorder.to_perfetto` (https://ui.perfetto.dev or
  ``chrome://tracing``), in the JAX package's ``"metrics_tpu.trace"``
  schema 2, so ``scripts/trace_export.py`` converts either package's dumps.

The default is off: every hook reads one module global and branches, and a
disabled :func:`span` returns a shared null context. Enable with
:func:`enable_tracing`, :func:`tracing_scope`, or ``METRICS_TPU_TRACE=1``.

Spans measure the **host** clock and read nothing on the device. Under the
compiled step engine the update and compute hooks fire once per build (the
step function's first run; a CUDA graph replay runs no Python); the
host-visible per-step phases (cache lookup, the state copies, the replay)
are spans at their host call sites. For device-side attribution use
``profile_span`` (``telemetry.py``), which names a ``torch.profiler`` range.
"""
import itertools
import json
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Any, Dict, Iterator, List, Optional

from metrics_tpu_torch.observability import identity as _identity
from metrics_tpu_torch.utilities.env import trace_requested

__all__ = [
    "PHASES",
    "TraceRecorder",
    "enable_tracing",
    "disable_tracing",
    "tracing_enabled",
    "tracing_scope",
    "get_tracer",
    "span",
    "instant",
    "complete_span",
    "step_scope",
    "advance_step",
    "current_step",
    "next_batch_id",
    "flow_scope",
    "current_flow",
    "spans_to_perfetto",
    "muted",
    "hooks_muted",
]

# the canonical phase-attribution set: where inside a metric step work can
# go. "dispatch" covers the engine's host-side step machinery (cache
# lookup, the state copies, the graph replay itself); "queue" is time a staged
# batch spends between admission and its worker pop (the continuous-
# serving pipeline); "ingest" is streaming-admission work (buffering,
# wave assembly, routing); "other" is the explicit bucket for spans that
# predate a phase assignment.
PHASES = (
    "canonicalize",
    "update",
    "compute",
    "sync",
    "checkpoint",
    "dispatch",
    "queue",
    "ingest",
    "other",
)

_DEFAULT_MAX_SPANS = 8192


class TraceRecorder:
    """Bounded recorder of step-indexed, phase-attributed, nested spans.

    Thread-safe: completed spans commit under a lock; the open-span stack
    (parent/child nesting) is per-thread, so concurrent sync workers and
    the main loop nest independently.
    """

    def __init__(self, max_spans: int = _DEFAULT_MAX_SPANS):
        self._lock = threading.RLock()
        self.max_spans = int(max_spans)
        self.spans: "deque[Dict[str, Any]]" = deque(maxlen=self.max_spans)
        self.dropped = 0
        self._ids = itertools.count(1)
        self._origin_ns = time.perf_counter_ns()
        self._tls = threading.local()

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------
    def _stack(self) -> List[int]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _commit(self, record: Dict[str, Any]) -> None:
        with self._lock:
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
            self.spans.append(record)

    @contextmanager
    def span(
        self,
        name: str,
        phase: str = "other",
        step: Optional[int] = None,
        flow: Any = None,
        **attrs: Any,
    ) -> Iterator[None]:
        """Record one nested span around a ``with`` block. ``flow`` (an
        explicit batch id / tuple of batch ids, else whatever
        :func:`flow_scope` pinned on this thread) links the span into a
        cross-thread causal chain rendered as Perfetto flow arrows."""
        sid = next(self._ids)
        stack = self._stack()
        parent = stack[-1] if stack else None
        stack.append(sid)
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            dur = time.perf_counter_ns() - t0
            stack.pop()
            record = {
                "name": name,
                "phase": phase if phase in PHASES else "other",
                "step": current_step() if step is None else int(step),
                "ts_us": (t0 - self._origin_ns) / 1e3,
                "dur_us": dur / 1e3,
                "tid": threading.get_native_id(),
                "id": sid,
                "parent": parent,
                "args": attrs,
            }
            flow_ids = _normalize_flow(flow if flow is not None else current_flow())
            if flow_ids:
                record["flow"] = list(flow_ids)
            self._commit(record)

    def instant(
        self,
        name: str,
        phase: str = "other",
        step: Optional[int] = None,
        flow: Any = None,
        **attrs: Any,
    ) -> None:
        """Record one zero-duration point event."""
        record = {
            "name": name,
            "phase": phase if phase in PHASES else "other",
            "step": current_step() if step is None else int(step),
            "ts_us": (time.perf_counter_ns() - self._origin_ns) / 1e3,
            "dur_us": None,
            "tid": threading.get_native_id(),
            "id": next(self._ids),
            "parent": None,
            "args": attrs,
        }
        flow_ids = _normalize_flow(flow if flow is not None else current_flow())
        if flow_ids:
            record["flow"] = list(flow_ids)
        self._commit(record)

    def complete_span(
        self,
        name: str,
        phase: str = "other",
        *,
        t0_ns: int,
        t1_ns: int,
        step: Optional[int] = None,
        flow: Any = None,
        **attrs: Any,
    ) -> None:
        """Commit one already-finished span from raw ``perf_counter_ns``
        stamps — for intervals no single ``with`` block can wrap, e.g. the
        queue-wait leg between a batch's admission on the submitter thread
        and its pop on the serving worker. No nesting (parent is None);
        the committing thread's tid is stamped, so a queue-wait span
        renders on the worker track immediately before its dispatch."""
        record = {
            "name": name,
            "phase": phase if phase in PHASES else "other",
            "step": current_step() if step is None else int(step),
            "ts_us": (int(t0_ns) - self._origin_ns) / 1e3,
            "dur_us": max(0, int(t1_ns) - int(t0_ns)) / 1e3,
            "tid": threading.get_native_id(),
            "id": next(self._ids),
            "parent": None,
            "args": attrs,
        }
        flow_ids = _normalize_flow(flow if flow is not None else current_flow())
        if flow_ids:
            record["flow"] = list(flow_ids)
        self._commit(record)

    # ------------------------------------------------------------------
    # reading / export
    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable native dump: ``{"format": ..., "spans": [...]}``,
        stamped with the process/rank identity so per-rank dumps stay
        attributable (and mergeable — ``scripts/trace_export.py --merge``
        aligns N rank dumps on the step index)."""
        with self._lock:
            return {
                "format": "metrics_tpu.trace",
                # v2: spans may carry a "flow" list of batch ids (the
                # causal cross-thread chain); absent on spans recorded
                # outside any flow, so v1 consumers keep working
                "schema_version": 2,
                "identity": _identity.process_identity(),
                "max_spans": self.max_spans,
                "dropped": self.dropped,
                "spans": list(self.spans),
            }

    def to_perfetto(self) -> Dict[str, Any]:
        """The recording as Chrome/Perfetto ``trace_event`` JSON (loadable
        in https://ui.perfetto.dev and ``chrome://tracing``); the process
        track is named after the rank identity."""
        with self._lock:
            return spans_to_perfetto(
                list(self.spans), identity=_identity.process_identity()
            )

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def step_range(self) -> Optional[List[int]]:
        """``[first, last]`` step index seen across recorded spans (None
        when nothing step-attributed was recorded)."""
        with self._lock:
            steps = [s["step"] for s in self.spans if s.get("step") is not None]
        return [min(steps), max(steps)] if steps else None

    def reset(self) -> None:
        with self._lock:
            self.spans.clear()
            self.dropped = 0
            self._origin_ns = time.perf_counter_ns()


def spans_to_perfetto(
    spans: List[Dict[str, Any]],
    identity: Optional[Dict[str, Any]] = None,
    ts_offset_us: float = 0.0,
) -> Dict[str, Any]:
    """Convert native span records to the ``trace_event`` JSON schema —
    shared by :meth:`TraceRecorder.to_perfetto` and the
    ``scripts/trace_export.py`` CLI (one converter, no format drift).

    Complete events (``ph: "X"``) carry microsecond ``ts``/``dur``;
    instants are ``ph: "i"`` with thread scope. The step index and span
    attrs ride in ``args`` so Perfetto's query/selection UI can group by
    step; the phase is the event category (``cat``).

    Spans carrying a ``flow`` list (batch ids issued by
    :func:`next_batch_id` and threaded via :func:`flow_scope`) are linked
    by synthesized **flow events** (``ph: "s"/"t"/"f"``): per batch id,
    one start at the chronologically first flow-carrying span, steps
    through the middles, a finish (binding to the enclosing slice,
    ``bp: "e"``) at the last — the arrows that make one admitted batch
    followable across the submitter, worker, and checkpoint-writer
    threads. Flow ids are namespaced per process track (``pid:batch``),
    so merged multi-rank timelines never join two ranks' unrelated
    batches.

    ``identity`` (a :func:`~metrics_tpu_torch.observability.identity
    .process_identity` stamp) names the process track ``metrics_tpu
    rank R/W`` and keys it on the rank, so several ranks' conversions
    compose into one timeline with one track per rank;
    ``ts_offset_us`` shifts every timestamp (the ``--merge`` aligner
    uses it to put all ranks on a common step-anchored clock).
    """
    rank = int(identity["rank"]) if identity else 0
    pname = (
        f"metrics_tpu rank {rank}/{identity['world_size']}"
        if identity
        else "metrics_tpu"
    )
    # perfetto keys tracks on pid; rank+1 keeps pid 0 (reserved-ish in
    # some viewers) out of the picture while staying stable per rank
    pid = rank + 1
    events: List[Dict[str, Any]] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": pname},
        }
    ]
    # flow anchors: per batch id, the (ts, mid-span bind point, tid) of
    # every flow-carrying COMPLETE span (instants cannot anchor arrows)
    flow_points: Dict[Any, List[Dict[str, Any]]] = {}
    for s in spans:
        args = {"step": s.get("step"), "rank": rank}
        if s.get("flow"):
            args["batch"] = list(s["flow"])
        args.update(s.get("args") or {})
        ev: Dict[str, Any] = {
            "name": s["name"],
            "cat": s.get("phase", "other"),
            "pid": pid,
            "tid": s.get("tid", 0),
            "ts": round(float(s["ts_us"]) + ts_offset_us, 3),
            "args": args,
        }
        if s.get("dur_us") is None:
            ev["ph"] = "i"
            ev["s"] = "t"
        else:
            ev["ph"] = "X"
            ev["dur"] = round(float(s["dur_us"]), 3)
            for fid in s.get("flow") or ():
                flow_points.setdefault(fid, []).append(
                    {
                        "ts": ev["ts"],
                        # bind inside the slice so the arrow attaches to
                        # THIS span, not an adjacent one on the track
                        "bind_ts": round(ev["ts"] + ev["dur"] / 2.0, 3),
                        "tid": ev["tid"],
                    }
                )
        events.append(ev)
    for fid, points in sorted(flow_points.items(), key=lambda kv: str(kv[0])):
        if len(points) < 2:
            continue  # an arrow needs two ends
        points.sort(key=lambda p: p["ts"])
        for i, p in enumerate(points):
            ev = {
                "name": "batch",
                "cat": "flow",
                "id": f"{pid}:{fid}",
                "pid": pid,
                "tid": p["tid"],
                "ts": p["bind_ts"],
                "ph": "s" if i == 0 else ("f" if i == len(points) - 1 else "t"),
                "args": {"batch": fid},
            }
            if ev["ph"] == "f":
                ev["bp"] = "e"
            events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ----------------------------------------------------------------------
# module-level singleton + enable/disable switch (telemetry's shape)
# ----------------------------------------------------------------------
_recorder = TraceRecorder()
_enabled = False

# step attribution: a process-wide monotone dispatch counter, overridable
# per host op by a caller pinning its own step cursor (step_scope).
# The lock keeps concurrent engine dispatches (each engine holds only its
# own instance lock) from losing or duplicating step indices.
_auto_step = 0
_auto_step_lock = threading.Lock()
_step_tls = threading.local()

# causal batch identity: a process-wide monotone id issued once per
# admitted batch/wave (the continuous-serving pipeline), threaded through
# every span the batch touches (flow_scope / span(flow=)) and rendered as
# Perfetto flow arrows. Separate from the step counter: a step numbers a
# dispatch GENERATION, a batch id names one admitted unit of work — an
# ingest wave coalescing several submissions carries several batch ids
# into one generation.
_batch_seq = 0
_batch_lock = threading.Lock()
_flow_tls = threading.local()


def _normalize_flow(flow: Any) -> Optional[tuple]:
    """Canonical tuple-of-ints form for a flow spec (an int, an iterable
    of ints, or None)."""
    if flow is None:
        return None
    if isinstance(flow, int):
        return (flow,)
    ids = tuple(int(f) for f in flow)
    return ids or None


def get_tracer() -> TraceRecorder:
    """The process-local recorder (valid whether or not tracing is on)."""
    return _recorder


def tracing_enabled() -> bool:
    """The ONE check every hook makes; keep it a plain global read."""
    return _enabled


def enable_tracing(max_spans: Optional[int] = None) -> TraceRecorder:
    """Turn span recording on (idempotent); ``max_spans`` resizes the ring
    buffer, preserving the newest spans."""
    global _enabled
    if max_spans is not None and max_spans != _recorder.max_spans:
        with _recorder._lock:
            _recorder.max_spans = int(max_spans)
            _recorder.spans = deque(_recorder.spans, maxlen=_recorder.max_spans)
    _enabled = True
    return _recorder


def disable_tracing() -> None:
    """Turn recording off. Recorded spans stay readable via
    :func:`get_tracer`."""
    global _enabled
    _enabled = False


@contextmanager
def tracing_scope(max_spans: Optional[int] = None, fresh: bool = True) -> Iterator[TraceRecorder]:
    """Enable tracing for a ``with`` block::

        with obs.tracing_scope() as tracer:
            run_eval()
        json.dump(tracer.to_perfetto(), open("step.trace.json", "w"))

    ``fresh=True`` (default) clears the recorder on entry so the yielded
    recording covers exactly the block; prior enabled/disabled state is
    restored on exit.
    """
    global _enabled
    prior = _enabled
    rec = enable_tracing(max_spans)
    if fresh:
        rec.reset()
    try:
        yield rec
    finally:
        _enabled = prior


# ----------------------------------------------------------------------
# step attribution
# ----------------------------------------------------------------------
def current_step() -> int:
    """The step index new spans are attributed to: the session-pinned step
    inside a :func:`step_scope`, else the process-wide dispatch counter."""
    pinned = getattr(_step_tls, "pinned", None)
    return pinned if pinned is not None else _auto_step


def advance_step() -> int:
    """Advance the process-wide step counter (one call per engine dispatch
    / top-level metric forward). Inside a :func:`step_scope` the pinned
    step wins and the auto counter is left untouched — the session, not
    the engine, owns step numbering then."""
    global _auto_step
    pinned = getattr(_step_tls, "pinned", None)
    if pinned is not None:
        return pinned
    with _auto_step_lock:
        _auto_step += 1
        return _auto_step


@contextmanager
def step_scope(step_index: int) -> Iterator[None]:
    """Pin the step index for every span/event recorded in the block (an
    evaluation session wraps each forward so spans carry its durable step
    cursor, not the raw dispatch count; an async serving worker wraps each
    staged batch's dispatch so spans carry the batch's own generation,
    allocated at admission)."""
    prev = getattr(_step_tls, "pinned", None)
    _step_tls.pinned = int(step_index)
    try:
        yield
    finally:
        _step_tls.pinned = prev


# ----------------------------------------------------------------------
# causal batch attribution (flows)
# ----------------------------------------------------------------------
def next_batch_id() -> int:
    """Issue one monotone batch id (process-wide, thread-safe). The
    serving pipeline stamps every admitted batch/wave with one; spans
    recorded under its :func:`flow_scope` link into one Perfetto flow."""
    global _batch_seq
    with _batch_lock:
        _batch_seq += 1
        return _batch_seq


def current_flow() -> Optional[tuple]:
    """The batch ids pinned on this thread by :func:`flow_scope` (None
    outside any flow)."""
    return getattr(_flow_tls, "flow", None)


@contextmanager
def flow_scope(flow: Any) -> Iterator[None]:
    """Pin a batch-id flow for every span/event recorded in the block:
    the submitter pins it while staging, the worker re-pins the staged
    batch's ids around its dispatch, the checkpoint writer around its
    commit — one causal chain across all three threads. ``flow`` is an
    int or an iterable of ints (a coalesced wave carries every submission
    id it folded); ``None`` is accepted and pins nothing."""
    prev = getattr(_flow_tls, "flow", None)
    _flow_tls.flow = _normalize_flow(flow)
    try:
        yield
    finally:
        _flow_tls.flow = prev


# ----------------------------------------------------------------------
# build-time hooks: the step engine runs a built step function again (every
# step on the CPU, the graph capture on the card); the hooks inside it fire
# on the build's first run only, as the JAX package's fire at trace time
# ----------------------------------------------------------------------
_mute_tls = threading.local()


@contextmanager
def muted() -> Iterator[None]:
    """Mute the span and metric-scope hooks on this thread for a ``with``
    block: the engine wraps every run of a step function but the build's
    first."""
    prev = getattr(_mute_tls, "muted", False)
    _mute_tls.muted = True
    try:
        yield
    finally:
        _mute_tls.muted = prev


def hooks_muted() -> bool:
    """True inside :func:`muted` on this thread."""
    return getattr(_mute_tls, "muted", False)


# ----------------------------------------------------------------------
# hook helpers (cheap no-ops when disabled)
# ----------------------------------------------------------------------
_NULL_CM = nullcontext()


def span(name: str, phase: str = "other", **attrs: Any):
    """A recorder span when tracing is enabled, a shared null context
    otherwise (and inside :func:`muted`) — the hook every instrumented call
    site uses."""
    if not _enabled or hooks_muted():
        return _NULL_CM
    return _recorder.span(name, phase=phase, **attrs)


def instant(name: str, phase: str = "other", **attrs: Any) -> None:
    """A point event when tracing is enabled; no-op otherwise."""
    if _enabled:
        _recorder.instant(name, phase=phase, **attrs)


def complete_span(name: str, phase: str = "other", **kwargs: Any) -> None:
    """Commit an already-finished span (see
    :meth:`TraceRecorder.complete_span`); no-op when tracing is off."""
    if _enabled:
        _recorder.complete_span(name, phase=phase, **kwargs)


if trace_requested():
    enable_tracing()
