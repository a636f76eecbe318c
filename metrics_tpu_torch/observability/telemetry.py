"""Process-local telemetry registry: counters, timers, bounded event log.

Port of ``metrics_tpu/observability/telemetry.py``: the same registry keys,
event kinds, histogram buckets, JSON snapshot and Prometheus 0.0.4 text, so
a dashboard or a scraper reads either package's output the same way (the
counter glossary is the JAX package's ``docs/observability.md``). Design
constraints, in order:

1. **Zero overhead when disabled.** Every hook in the metric runtime is
   guarded by :func:`enabled`: one module-global read and a branch.
2. **Build-time, not per-run.** The hooks inside the compiled step engine's
   step function (``note_trace``, the metrics' update and compute scopes)
   fire once per build of a signature: on the card at the warm-up (the
   capture and every graph replay run none of them), on the CPU at the
   step's first run. That is what the JAX package's trace-time hooks count,
   and what makes them recompilation detectors: a steady-state loop stops
   producing them. The engine mutes the later runs with
   :func:`~metrics_tpu_torch.observability.trace.muted`.
3. **Nothing touches the device.** No hook reads a tensor's value or
   synchronizes: byte counts come from tensor metadata
   (:func:`array_nbytes`) and timers from the host clock, so a timer around
   an asynchronous launch measures the enqueue, as the JAX package's timers
   do under asynchronous dispatch.
4. **Bounded memory.** Events live in a ``deque(maxlen=...)``; counters and
   timers are flat dicts keyed by dotted names.

Enable with ``metrics_tpu_torch.observability.enable()``, the
:func:`telemetry_scope` context manager, or ``METRICS_TPU_TELEMETRY=1`` in
the environment (parsed once at import by ``utilities/env.py``).
"""
import atexit
import bisect
import json
import math
import os
import re
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Any, Dict, Iterator, List, Optional

import torch

from metrics_tpu_torch.observability import identity as _identity
from metrics_tpu_torch.observability import trace as _trace
from metrics_tpu_torch.observability.watchdog import RecompilationWatchdog
from metrics_tpu_torch.utilities.data import _is_concrete
from metrics_tpu_torch.utilities.env import telemetry_requested
from metrics_tpu_torch.utilities.prints import warn_once

__all__ = [
    "Telemetry",
    "enable",
    "disable",
    "enabled",
    "get",
    "telemetry_scope",
    "note_trace",
    "metric_scope",
    "profile_span",
    "percentile",
    "LATENCY_BUCKETS_MS",
    "PAYLOAD_BUCKETS_BYTES",
]

_DEFAULT_MAX_EVENTS = 1024

# fixed histogram bucket edges (upper bounds; one implicit +Inf bucket at
# the end). FIXED by design: per-collective latency/payload distributions
# recorded on different hosts/rounds must merge bucket-by-bucket, and the
# BENCH trajectory's sentinel can only compare like against like when the
# edges never move. Latency spans the observed sync range (sub-ms local
# gathers to the 50–125 ms 8-dev legs and beyond); payload spans one
# scalar state to a gathered 1M-row cat buffer.
LATENCY_BUCKETS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0)
PAYLOAD_BUCKETS_BYTES = (64, 256, 1024, 4096, 16384, 65536, 262144, 1048576, 4194304, 16777216, 67108864)


class Telemetry:
    """Registry of counters, timers, and a bounded structured event log.

    Thread-safe; all mutation goes through a reentrant lock (hooks fire
    from trace-time callbacks which may nest).
    """

    def __init__(self, max_events: int = _DEFAULT_MAX_EVENTS):
        self._lock = threading.RLock()
        self.max_events = int(max_events)
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        # name -> [total_seconds, count]
        self._timers: Dict[str, list] = {}
        # name -> {"buckets": [...edges...], "counts": [len(edges)+1],
        #          "sum": float, "count": int} — fixed-bucket histograms
        self.histograms: Dict[str, Dict[str, Any]] = {}
        self.events: "deque[Dict[str, Any]]" = deque(maxlen=self.max_events)
        # events evicted by the bounded log wrapping — surfaced in
        # report() so "the log looks complete" is never silently false
        self.dropped_events = 0
        self.watchdog = RecompilationWatchdog(telemetry=self)

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------
    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            slot = self._timers.setdefault(name, [0.0, 0])
            slot[0] += float(seconds)
            slot[1] += 1

    def event(self, kind: str, **fields: Any) -> None:
        with self._lock:
            if len(self.events) == self.events.maxlen:
                self.dropped_events += 1
            self.events.append({"kind": kind, **fields})

    def observe_hist(self, name: str, value: float, buckets: tuple) -> None:
        """Record ``value`` into the fixed-bucket histogram ``name``
        (``buckets`` are inclusive upper bounds; overflow lands in the
        implicit +Inf bucket). The bucket edges are set by the FIRST
        observation of a name and never change after — fixed buckets are
        what makes histograms mergeable across hosts and bench rounds."""
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = {
                    "buckets": list(buckets),
                    "counts": [0] * (len(buckets) + 1),
                    "sum": 0.0,
                    "count": 0,
                }
            idx = bisect.bisect_left(h["buckets"], value)
            h["counts"][idx] += 1
            h["sum"] += float(value)
            h["count"] += 1

    @contextmanager
    def timer(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def percentile(self, name: str, q: float) -> Optional[float]:
        """Estimated ``q``-th percentile (0–100) of histogram ``name``;
        None when the histogram is empty or unknown. See :func:`percentile`
        for the estimation contract."""
        with self._lock:
            h = self.histograms.get(name)
            return percentile(h, q) if h else None

    # ------------------------------------------------------------------
    # reading / export
    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable view of everything recorded so far."""
        with self._lock:
            return {
                "identity": _identity.process_identity(),
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "timers": {
                    name: {"total_s": total, "count": count}
                    for name, (total, count) in self._timers.items()
                },
                "histograms": {
                    name: dict(h, counts=list(h["counts"]), buckets=list(h["buckets"]))
                    for name, h in self.histograms.items()
                },
                "events": list(self.events),
                "dropped_events": self.dropped_events,
                "watchdog": self.watchdog.snapshot(),
            }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_jsonl(self) -> str:
        """The bounded event log as JSON-lines (one event per line)."""
        with self._lock:
            return "\n".join(json.dumps(e, sort_keys=True) for e in self.events)

    def report(self) -> str:
        """Human-readable summary (counters, timers, watchdog verdicts)."""
        snap = self.snapshot()
        lines = ["metrics_tpu telemetry report", "=" * 28]
        lines.append("counters:")
        for name in sorted(snap["counters"]):
            lines.append(f"  {name:<48} {snap['counters'][name]:>12g}")
        if not snap["counters"]:
            lines.append("  (none)")
        if snap["gauges"]:
            lines.append("gauges:")
            for name in sorted(snap["gauges"]):
                lines.append(f"  {name:<48} {snap['gauges'][name]:>12g}")
        lines.append("timers (total ms / calls):")
        for name in sorted(snap["timers"]):
            t = snap["timers"][name]
            lines.append(f"  {name:<48} {t['total_s'] * 1e3:>10.3f} / {t['count']}")
        if not snap["timers"]:
            lines.append("  (none)")
        if snap["histograms"]:
            # fixed-bucket estimates, not raw bucket dumps: an operator
            # scanning the report wants the distribution's shape (tail
            # percentiles), and the shared percentile() helper is the same
            # estimator the export surface documents
            lines.append("histograms (count / mean / p50 / p95 / p99):")
            for name in sorted(snap["histograms"]):
                h = snap["histograms"][name]
                mean = h["sum"] / h["count"] if h["count"] else 0.0
                ps = " ".join(
                    f"p{q:g}={percentile(h, q):.4g}" for q in (50, 95, 99)
                )
                lines.append(f"  {name:<48} n={h['count']} mean={mean:.4g} {ps}")
        wd = snap["watchdog"]
        lines.append("recompilation watchdog:")
        if not wd["keys"]:
            lines.append("  (no traced functions observed)")
        for key, entry in sorted(wd["keys"].items()):
            verdict = "RETRACING" if entry["retraces"] else "steady"
            lines.append(
                f"  {key:<48} traces={entry['traces']}"
                f" retraces={entry['retraces']} [{verdict}]"
            )
        dropped = (
            f", {snap['dropped_events']} dropped by the bounded log"
            if snap["dropped_events"]
            else ""
        )
        lines.append(
            f"events recorded: {len(snap['events'])} (cap {self.max_events}{dropped})"
        )
        return "\n".join(lines)

    def to_prometheus(
        self,
        extra_lines: Optional[List[str]] = None,
        identity: Optional[Dict[str, Any]] = None,
    ) -> str:
        """The registry in Prometheus text exposition format (version
        0.0.4 — what every fleet scraper speaks).

        Rendering contract:

        * counters: sanitized dotted names with the conventional
          ``_total`` suffix (``engine.dispatches`` →
          ``metrics_tpu_engine_dispatches_total``), typed ``counter``.
          The suffix is not just idiom (OpenMetrics requires it): several
          registry keys exist as BOTH a counter and a histogram
          (``sync.payload_bytes`` et al.), and one exposition must never
          declare one family name with two types — a real scraper
          rejects the whole scrape;
        * gauges: sanitized dotted names, typed ``gauge``;
        * timers (total seconds + call count): rendered as a ``summary``
          pair ``<name>_sum`` / ``<name>_count``;
        * fixed-bucket histograms: native Prometheus ``histogram`` —
          the registry's inclusive per-bucket upper bounds map DIRECTLY
          onto cumulative ``le=`` buckets (that is why the edges are
          fixed by design), with the implicit overflow bucket as
          ``le="+Inf"`` plus ``_sum``/``_count``;
        * one ``metrics_tpu_identity`` gauge carries the rank/world/host
          labels every other artifact is stamped with.

        The whole exposition is rendered from ONE locked :meth:`snapshot`,
        so a scrape racing a step sees a consistent registry, never a
        half-updated one. ``extra_lines`` lets the export surface append
        already-rendered families (cohort health, session gauges) to the
        same exposition; ``identity`` overrides the stamp — offline
        renderers (``scripts/metrics_exporter.py --snapshot``) pass the
        ARTIFACT's recorded identity so the exposition names the process
        that produced the numbers, not the one rendering them.
        """
        snap = self.snapshot()
        out: List[str] = []
        ident = {"rank": 0, "world_size": 1, "host": "unknown"}
        ident.update(identity if identity is not None else snap["identity"])
        out.append("# TYPE metrics_tpu_identity gauge")
        out.append(
            "metrics_tpu_identity{"
            f'rank="{ident["rank"]}",world_size="{ident["world_size"]}",'
            f'host="{_escape_label(str(ident["host"]))}"' "} 1"
        )
        for name in sorted(snap["counters"]):
            pname = prometheus_name(name) + "_total"
            out.append(f"# TYPE {pname} counter")
            out.append(f"{pname} {_format_value(snap['counters'][name])}")
        for name in sorted(snap["gauges"]):
            pname = prometheus_name(name)
            out.append(f"# TYPE {pname} gauge")
            out.append(f"{pname} {_format_value(snap['gauges'][name])}")
        for name in sorted(snap["timers"]):
            t = snap["timers"][name]
            pname = prometheus_name(name)
            out.append(f"# TYPE {pname} summary")
            out.append(f"{pname}_sum {_format_value(t['total_s'])}")
            out.append(f"{pname}_count {t['count']}")
        for name in sorted(snap["histograms"]):
            h = snap["histograms"][name]
            pname = prometheus_name(name)
            out.append(f"# TYPE {pname} histogram")
            cumulative = 0
            for edge, c in zip(h["buckets"], h["counts"]):
                cumulative += c
                out.append(
                    f'{pname}_bucket{{le="{_format_value(edge)}"}} {cumulative}'
                )
            out.append(f'{pname}_bucket{{le="+Inf"}} {h["count"]}')
            out.append(f"{pname}_sum {_format_value(h['sum'])}")
            out.append(f"{pname}_count {h['count']}")
        if extra_lines:
            out.extend(extra_lines)
        return "\n".join(out) + "\n"

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self._timers.clear()
            self.histograms.clear()
            self.events.clear()
            self.dropped_events = 0
            self.watchdog.reset()


# ----------------------------------------------------------------------
# histogram percentile estimation (shared by report() and the exporter)
# ----------------------------------------------------------------------
def percentile(histogram: Dict[str, Any], q: float) -> float:
    """Estimated ``q``-th percentile (0–100) of a fixed-bucket histogram
    (the ``{"buckets", "counts", "sum", "count"}`` shape ``observe_hist``
    accumulates).

    Standard monitoring-stack estimator (what PromQL's
    ``histogram_quantile`` computes from the same ``le=`` buckets):
    find the bucket where the cumulative count crosses ``q`` percent and
    interpolate linearly inside it, taking 0 as the first bucket's lower
    edge. Mass in the overflow (+Inf) bucket clamps to the last finite
    edge — fixed buckets cannot see beyond their last boundary, and
    reporting the edge is honest where inventing a tail value is not.
    Returns 0.0 for an empty histogram.
    """
    if not 0 <= q <= 100:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    total = histogram.get("count", 0)
    if not total:
        return 0.0
    edges = list(histogram["buckets"])
    counts = list(histogram["counts"])
    target = q / 100.0 * total
    cumulative = 0.0
    for i, c in enumerate(counts):
        prev_cum = cumulative
        cumulative += c
        if cumulative < target or c == 0:
            continue
        if i >= len(edges):  # overflow bucket: clamp to the last edge
            return float(edges[-1]) if edges else 0.0
        lo = float(edges[i - 1]) if i > 0 else 0.0
        hi = float(edges[i])
        frac = (target - prev_cum) / c
        return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
    return float(edges[-1]) if edges else 0.0


# ----------------------------------------------------------------------
# Prometheus text-format helpers (shared with observability/exporter.py)
# ----------------------------------------------------------------------
_PROM_INVALID = re.compile(r"[^a-zA-Z0-9_:]")


def prometheus_name(name: str) -> str:
    """Dotted registry key → valid Prometheus metric name, namespaced
    under ``metrics_tpu_`` (``sync.latency_ms`` →
    ``metrics_tpu_sync_latency_ms``)."""
    sanitized = _PROM_INVALID.sub("_", name)
    if sanitized and sanitized[0].isdigit():
        sanitized = "_" + sanitized
    return "metrics_tpu_" + sanitized


def _escape_label(value: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_value(v: Any) -> str:
    """Sample-value formatting: integers stay integral, floats use repr
    (full precision), non-finite values use the exposition spellings."""
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


# ----------------------------------------------------------------------
# module-level singleton + enable/disable switch
# ----------------------------------------------------------------------
_telemetry = Telemetry()
_enabled = False


def get() -> Telemetry:
    """The process-local registry (valid whether or not recording is on)."""
    return _telemetry


def enabled() -> bool:
    """The ONE check every hook makes; keep it a plain global read."""
    return _enabled


def enable(max_events: Optional[int] = None) -> Telemetry:
    """Turn recording on (idempotent). ``max_events`` resizes the event
    log cap, preserving the newest events."""
    global _enabled, _telemetry
    if max_events is not None and max_events != _telemetry.max_events:
        with _telemetry._lock:
            _telemetry.max_events = int(max_events)
            _telemetry.events = deque(_telemetry.events, maxlen=_telemetry.max_events)
    _enabled = True
    return _telemetry


def disable() -> None:
    """Turn recording off. Recorded data stays readable via :func:`get`."""
    global _enabled
    _enabled = False


@contextmanager
def telemetry_scope(max_events: Optional[int] = None) -> Iterator[Telemetry]:
    """Enable telemetry for the duration of a ``with`` block::

        with metrics_tpu_torch.observability.telemetry_scope() as tel:
            run_eval()
        print(tel.report())

    Restores the prior enabled/disabled state on exit; recorded data is
    NOT cleared (read it from the yielded registry).
    """
    global _enabled
    prior = _enabled
    enable(max_events)
    try:
        yield _telemetry
    finally:
        _enabled = prior


# ----------------------------------------------------------------------
# hook helpers (cheap no-ops when disabled)
# ----------------------------------------------------------------------
def note_trace(key: str, budget: Optional[int] = None) -> None:
    """Build counter: call once per build of a step program keyed ``key``
    (the JAX package calls it from inside a jitted function, where it runs
    at trace time only).

    A steady-state loop stops producing calls, so the per-key count is the
    build count. Feeds the recompilation watchdog (churn beyond the budget
    fires one rate-limited verdict per key). Pass ``budget`` for keys that
    legitimately aggregate many distinct signatures.
    """
    if not _enabled:
        return
    _telemetry.count(f"trace.{key}")
    _telemetry.watchdog.note_trace(key, budget=budget)


_NULL_CM = nullcontext()


class _Span:
    """``torch.profiler.record_function`` (a range in a ``torch.profiler``
    trace: kernels launched inside it fall under its name, as XLA ops fall
    under the JAX package's ``named_scope``) stacked with an NVTX range (the
    same name in Nsight Systems). The range is entered only while a
    profiler records (entering one costs a dispatcher call, ~10 us), the
    NVTX range only once CUDA is initialized."""

    __slots__ = ("name", "_range", "_nvtx")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name) if torch.autograd._profiler_enabled() else None
        if self._range is not None:
            self._range.__enter__()
        self._nvtx = torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def profile_span(name: str):
    """Device-profile attribution span; no-op when telemetry is disabled.

    Span naming convention: ``metrics_tpu.<MetricName>.<update|compute>``;
    the step engine names its graph replays by its watch key
    (``engine[Accuracy,Precision]``).
    """
    if not _enabled:
        return _NULL_CM
    return _Span(name)


def _in_traced_region() -> bool:
    """True while this thread builds a step (the engine's ``tracing()``
    scope) or one of its CUDA streams captures a graph: what is timed then
    is the build, not a step."""
    return not _is_concrete()


# host-timing phases attributed to the canonical trace-phase set; forward
# folds update+merge, so its span files under "update"
_TRACE_PHASE = {"update": "update", "compute": "compute", "forward": "update"}


@contextmanager
def _metric_scope_impl(metric: Any, phase: str) -> Iterator[None]:
    name = type(metric).__name__
    if _enabled and _in_traced_region():
        # while a step is built the counters stay useful (they are the
        # rebuild signal), but the perf_counter delta below measures the
        # build, not a step: say so once instead of letting a meaningless
        # timer pass for a hot-path measurement
        warn_once(
            f"metrics_tpu telemetry: metric_scope({name}.{phase}) entered"
            " while a step is being built (the step engine's tracing scope"
            " or a CUDA graph capture) — the recorded host wall-time is"
            " trace-time cost, not step cost (lint rule MTL103 covers the"
            " same hazard for step-rate warnings; see"
            " docs/static_analysis.md)",
            key=f"host-timing-under-trace:{name}.{phase}",
        )
    t0 = time.perf_counter()
    with profile_span(f"metrics_tpu.{name}.{phase}"), _trace.span(
        f"metrics_tpu.{name}.{phase}", phase=_TRACE_PHASE.get(phase, "other")
    ):
        try:
            yield
        finally:
            if _enabled:
                _telemetry.count(f"metric.{name}.{phase}_calls")
                _telemetry.observe(f"metric.{name}.{phase}_s", time.perf_counter() - t0)
                if phase == "forward":
                    nbytes = _state_nbytes(metric)
                    if nbytes is not None:
                        _telemetry.gauge(f"metric.{name}.state_nbytes", nbytes)


def metric_scope(metric: Any, phase: str):
    """Lifecycle hook for ``Metric`` update/compute/forward: wall time,
    call count, and (on forward) accumulated-state bytes, plus a
    step-structured trace span when span tracing is on. Returns a shared
    null context when both recorders are off (the hot path pays two global
    reads) and inside the engine's muted runs of a built step."""
    if not _enabled and not _trace.tracing_enabled():
        return _NULL_CM
    if _trace.hooks_muted():
        return _NULL_CM
    return _metric_scope_impl(metric, phase)


def _state_nbytes(metric: Any) -> Optional[int]:
    """Total bytes of the metric's registered states (list states sum
    elementwise, through :func:`array_nbytes`); None when sizing fails."""
    total = 0
    try:
        for name in metric._defaults:
            val = getattr(metric, name)
            vals = val if isinstance(val, list) else [val]
            for v in vals:
                total += array_nbytes(v)
    except Exception:
        return None
    return total


def array_nbytes(x: Any) -> int:
    """Payload bytes of a tensor from its metadata (``numel`` times the
    element size): nothing is read from the device, and under
    ``torch.func.vmap`` a tensor counts its per-tenant shape, as a JAX tracer
    under ``vmap`` does. 0 for anything else."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return 0


# ----------------------------------------------------------------------
# env-driven startup + failure-dump hook
# ----------------------------------------------------------------------
if telemetry_requested():
    enable()

_DUMP_ENV = "METRICS_TPU_TELEMETRY_DUMP"


def _dump_at_exit() -> None:
    """When ``METRICS_TPU_TELEMETRY_DUMP=<path>`` is set and telemetry ran,
    write the final registry snapshot there at interpreter exit. Atomic
    (tmp, fsync and ``os.replace`` through ``journal.atomic_write_json``): a
    crash landing mid-dump must leave the previous dump, never a torn JSON.
    A process that imports both packages with the variable set has two
    at-exit writers, each writing its own registry to the same path."""
    path = os.environ.get(_DUMP_ENV)
    if not path or not (_enabled or _telemetry.counters or _telemetry.events):
        return
    try:
        # lazy import: the reliability package's later modules import this
        # one, so it must stay importable before them
        from metrics_tpu_torch.reliability.journal import atomic_write_json

        atomic_write_json(path, _telemetry.snapshot())
    except Exception:  # noqa: BLE001 — interpreter is exiting; best-effort
        try:
            # metrics-tpu: allow(MTL107) — deliberate last-resort fallback
            # when the atomic path itself failed at interpreter exit: a
            # possibly-torn dump beats no dump, and readers already treat
            # this file as best-effort (parse failures are tolerated)
            with open(path, "w") as f:
                f.write(_telemetry.to_json(indent=1))
        except OSError:
            pass


atexit.register(_dump_at_exit)
