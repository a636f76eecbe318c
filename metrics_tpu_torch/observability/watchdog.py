"""Recompilation watchdog: detect silent steady-state rebuilding.

Port of ``metrics_tpu/observability/watchdog.py``. With the compiled step
engine the dominant production failures are invisible ones: a
shape-polymorphic input pipeline builds a new CUDA graph every step, a
signature cache too small for the live signatures rebuilds evicted
programs, and nothing in the loop's output changes, only the wall clock.
The watchdog turns both into counters and one rate-limited warning.

Two signals, two detection rules:

* :meth:`note_trace`: called once per build of a step program (the JAX
  package's trace: on the card a warm-up plus a CUDA graph capture, on the
  CPU the step's first run). More builds of one key than the
  ``trace_budget`` means the signature cache is not converging: shape
  polymorphism. A steady-state loop builds once per signature and stays far
  under budget.
* :meth:`note_compile`: called by the engine at the build decision with
  full signature knowledge. ``new_signature=False`` means a signature built
  before is being built again (LRU eviction thrash): a retrace at once.

The watchdog is owned by the :class:`~metrics_tpu_torch.observability.
telemetry.Telemetry` registry and only hears anything while telemetry is
enabled.
"""
from typing import Any, Dict, Optional

from metrics_tpu_torch.observability import flight as _flight
from metrics_tpu_torch.utilities.prints import warn_once

__all__ = ["RecompilationWatchdog"]

_DEFAULT_TRACE_BUDGET = 8
_MAX_KEYS = 256


def _analysis_hint(key: str) -> Optional[str]:
    """Best-effort attribution from the static analyzer's last audit
    (``metrics_tpu_torch.analysis.program``'s registry, which the protocol
    explorers fill today). The import is lazy and never raises, so
    observability stays importable before analysis and a watchdog warning
    never crashes on the cross-link."""
    try:
        from metrics_tpu_torch.analysis.program import hint_for_watch_key

        return hint_for_watch_key(key)
    except Exception:  # noqa: BLE001 — advisory only
        return None


class RecompilationWatchdog:
    """Per-key build and retrace bookkeeping (keys are engine labels such as
    ``engine[Accuracy,Precision]``)."""

    def __init__(self, telemetry: Optional[Any] = None, trace_budget: int = _DEFAULT_TRACE_BUDGET):
        self.trace_budget = int(trace_budget)
        self._telemetry = telemetry
        # key -> {"traces": n, "retraces": n}
        self._keys: Dict[str, Dict[str, int]] = {}

    def _entry(self, key: str) -> Dict[str, int]:
        entry = self._keys.get(key)
        if entry is None:
            if len(self._keys) >= _MAX_KEYS:
                # bounded: collapse the overflow into one bucket rather
                # than growing without limit (a key that embeds shapes is
                # itself a polymorphism bug this makes visible)
                key = "<overflow>"
                if key in self._keys:
                    return self._keys[key]
            entry = self._keys[key] = {"traces": 0, "retraces": 0, "flagged": 0}
        return entry

    def note_steady(self, key: str) -> None:
        """Register ``key`` without counting anything — a cache hit on an
        engine compiled before telemetry was enabled still deserves a
        ``traces=0 retraces=0 [steady]`` row in the report instead of
        "(no traced functions observed)"."""
        self._entry(key)

    def note_trace(self, key: str, budget: Optional[int] = None) -> None:
        """A step program keyed ``key`` is being built (again).

        The trace-budget verdict is **one-shot per key**: crossing the
        budget fires one retrace verdict (one event, one rate-limited
        warning); further traces only raise the ``traces`` tally in the
        report. Keys that legitimately aggregate many distinct signatures
        (the per-functional hooks) pass a larger per-call ``budget``.
        """
        entry = self._entry(key)
        entry["traces"] += 1
        limit = self.trace_budget if budget is None else budget
        if entry["traces"] > limit and not entry["flagged"]:
            entry["flagged"] = 1
            self._fire(
                key,
                entry,
                f"traced {entry['traces']}x (budget {limit}) —"
                " input signatures are not converging (shape-polymorphic"
                " loop?)",
            )

    def note_compile(self, key: str, new_signature: bool) -> None:
        """The step engine decided to build. A build for a signature it has
        built before is cache thrash: a retrace at once (an exact signal, so
        every occurrence counts; builds are slow enough that this cannot
        flood the event log)."""
        entry = self._entry(key)
        if not new_signature:
            self._fire(
                key,
                entry,
                "recompiled a previously compiled signature — the compiled"
                " cache is thrashing (too many live signatures for its"
                " LRU capacity?)",
            )

    def _fire(self, key: str, entry: Dict[str, int], reason: str) -> None:
        entry["retraces"] += 1
        # static-analysis cross-link: when the auditor has findings for the
        # metrics behind this key (e.g. MTA001 accumulator-dtype churn),
        # name the rule — the watchdog sees the symptom, the analyzer names
        # the cause
        hint = _analysis_hint(key)
        if hint is not None:
            reason = f"{reason}; {hint}"
        if self._telemetry is not None:
            self._telemetry.count("watchdog.retraces")
            self._telemetry.event("retrace", key=key, reason=reason)
        # a watchdog verdict is a failure the loop survives — exactly what
        # the flight recorder's last-N-steps window is for. The dump
        # carries the analyzer-rule hint so the reader gets symptom
        # (churn), context (the steps before it), and likely cause (rule)
        # in one artifact.
        _flight.record("watchdog_retrace", key=key)
        if entry["retraces"] == 1:  # one dump per key — thrash fires per occurrence
            # "verdict", not "reason": the positional dump reason is the
            # trigger kind; the watchdog's sentence rides as context
            _flight.dump_on_failure("watchdog_retrace", hint=hint, key=key, verdict=reason)
        warn_once(
            f"metrics_tpu recompilation watchdog: {key}: {reason}"
            " (warning once; see observability report for counts)",
            key=f"watchdog:{key}",
        )

    def retrace_count(self, key: Optional[str] = None) -> int:
        """Total retraces (for one key, or across all keys)."""
        if key is not None:
            entry = self._keys.get(key)
            return entry["retraces"] if entry else 0
        return sum(e["retraces"] for e in self._keys.values())

    def snapshot(self) -> Dict[str, Any]:
        return {
            "trace_budget": self.trace_budget,
            "retraces": self.retrace_count(),
            "keys": {k: dict(v) for k, v in self._keys.items()},
        }

    def reset(self) -> None:
        self._keys.clear()
