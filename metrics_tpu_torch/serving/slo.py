"""Declarative serving SLOs: latency targets, burn gauges, verdicts.

Port of ``metrics_tpu/serving/slo.py``, plain host code over the port's
telemetry registry. The latency histograms (``serving.latency.*``) and the
queue-age gauge say what the pipeline is doing; a :class:`ServingSLO` says
what it is supposed to do and turns the gap into:

1. **burn gauges**: ``serving.slo.e2e_burn`` (observed e2e p99 over the
   ``e2e_p99_ms`` target) and ``serving.slo.queue_age_burn`` (queue age over
   ``max_queue_age_ms``), refreshed at every evaluation; above 1.0 the
   target is being missed now;
2. **a verdict**: :func:`healthz_payload` is the ``serving_slo`` object a
   liveness probe embeds, ``breaching`` while any SLO misses its target;
3. **one flight dump per sustained breach**: after ``sustain`` consecutive
   breaching evaluations, one ``serving_slo_breach`` dump and a
   ``serving.slo.breaches`` count; a non-breaching evaluation re-arms it.

The pipeline evaluates its SLO after every staged and served batch; while
telemetry is off an evaluation is a no-op. Percentiles come from the shared
fixed-bucket estimator. As in the JAX package the histograms and gauges are
process-wide and cumulative over the process lifetime: attach one SLO per
process; a windowed view is the exporter's (``/healthz`` carries the verdict
of every live SLO: ``observability/exporter.py``).
"""
import threading
import weakref
from typing import Any, Dict, List, Optional

from metrics_tpu_torch.observability import flight as _flight
from metrics_tpu_torch.observability import telemetry as _obs

__all__ = ["ServingSLO", "active_slos", "healthz_payload"]

#: every live SLO, weakly held — the /healthz handler renders verdicts
#: from here without keeping a dropped SLO (or its pipeline) alive
_ACTIVE: "weakref.WeakSet" = weakref.WeakSet()


class ServingSLO:
    """A declarative latency SLO for one serving process (see the module
    docstring's scope note: the underlying histograms/gauges are
    process-wide registry keys, so attach ONE SLO per process — distinct
    ``name=``s keep /healthz verdicts readable when several exist, but
    they evaluate the same distribution).

    Args:
        e2e_p99_ms: target p99 of ``serving.latency.e2e_ms`` (admission
            → write-back, in wall ms); None = not part of this SLO.
        max_queue_age_ms: target ceiling on the ``serving.queue.age_ms``
            gauge (age of the oldest staged-but-unserved batch); None =
            not part of this SLO.
        sustain: consecutive breaching evaluations before the one
            ``serving_slo_breach`` flight dump fires (a single slow batch
            is noise; ``sustain`` of them is an incident).
        name: label for /healthz and flight dumps (several pipelines can
            carry distinct SLOs).

    Usage::

        slo = ServingSLO(e2e_p99_ms=50.0, max_queue_age_ms=200.0)
        pipe = AsyncServingEngine(collection, slo=slo)
        ...
        slo.breaching          # True while any burn > 1.0
    """

    def __init__(
        self,
        e2e_p99_ms: Optional[float] = None,
        max_queue_age_ms: Optional[float] = None,
        sustain: int = 3,
        name: str = "serving",
    ):
        if e2e_p99_ms is None and max_queue_age_ms is None:
            raise ValueError(
                "ServingSLO needs at least one target (e2e_p99_ms or"
                " max_queue_age_ms)"
            )
        for label, v in (("e2e_p99_ms", e2e_p99_ms), ("max_queue_age_ms", max_queue_age_ms)):
            if v is not None and float(v) <= 0:
                raise ValueError(f"{label} must be > 0, got {v}")
        self.name = str(name)
        self.e2e_p99_ms = None if e2e_p99_ms is None else float(e2e_p99_ms)
        self.max_queue_age_ms = (
            None if max_queue_age_ms is None else float(max_queue_age_ms)
        )
        self.sustain = max(1, int(sustain))
        self._lock = threading.Lock()
        # sustained-breach state machine (written on whichever thread
        # evaluates — submitter or worker — hence the lock)
        self._breach_run = 0
        self._dumped = False
        self._last: Dict[str, Any] = {"burns": {}, "breaching": False}
        _ACTIVE.add(self)

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def targets(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if self.e2e_p99_ms is not None:
            out["e2e_p99_ms"] = self.e2e_p99_ms
        if self.max_queue_age_ms is not None:
            out["max_queue_age_ms"] = self.max_queue_age_ms
        return out

    def evaluate(self) -> Optional[Dict[str, Any]]:
        """One evaluation against the live telemetry registry: refresh
        the burn gauges, advance the sustained-breach state machine, and
        return ``{"burns", "breaching"}``. No-op (returns None) while
        telemetry is disabled — there is nothing to evaluate against and
        nothing may be recorded."""
        if not _obs.enabled():
            return None
        tel = _obs.get()
        burns: Dict[str, float] = {}
        if self.e2e_p99_ms is not None:
            p99 = tel.percentile("serving.latency.e2e_ms", 99)
            if p99 is not None:
                burns["e2e"] = p99 / self.e2e_p99_ms
                tel.gauge("serving.slo.e2e_burn", burns["e2e"])
        if self.max_queue_age_ms is not None:
            age = tel.gauges.get("serving.queue.age_ms")
            if age is not None:
                burns["queue_age"] = float(age) / self.max_queue_age_ms
                tel.gauge("serving.slo.queue_age_burn", burns["queue_age"])
        breaching = any(b > 1.0 for b in burns.values())
        dump = False
        with self._lock:
            if breaching:
                self._breach_run += 1
                if self._breach_run >= self.sustain and not self._dumped:
                    # one dump per sustained excursion: armed again only
                    # after a recovery evaluation below
                    self._dumped = True
                    dump = True
            else:
                self._breach_run = 0
                self._dumped = False
            self._last = {
                "burns": dict(burns),
                "breaching": breaching,
                "breach_run": self._breach_run,
            }
            snapshot = dict(self._last)
        if dump:
            tel.count("serving.slo.breaches")
            _flight.dump_on_failure(
                "serving_slo_breach",
                slo=self.name,
                targets=self.targets(),
                burns={k: round(v, 4) for k, v in burns.items()},
                sustained_evaluations=self.sustain,
            )
        return snapshot

    @property
    def breaching(self) -> bool:
        """True while the last evaluation missed at least one target."""
        with self._lock:
            return bool(self._last.get("breaching"))

    def snapshot(self) -> Dict[str, Any]:
        """JSON-shaped verdict for /healthz: name, targets, last burns,
        breaching flag."""
        with self._lock:
            last = dict(self._last)
        return {
            "name": self.name,
            "targets": self.targets(),
            "burns": {k: round(v, 4) for k, v in last.get("burns", {}).items()},
            "breaching": bool(last.get("breaching")),
        }

    def __repr__(self) -> str:
        state = "BREACHING" if self.breaching else "ok"
        return f"ServingSLO({self.name}, targets={self.targets()}, {state})"


def active_slos() -> List[ServingSLO]:
    """Every live SLO, sorted by name (weak registry — dropped SLOs
    vanish with their pipelines)."""
    return sorted(_ACTIVE, key=lambda s: s.name)


def healthz_payload() -> Optional[Dict[str, Any]]:
    """The ``serving_slo`` object the /healthz probe embeds: per-SLO
    verdicts plus the aggregate breaching flag that flips the probe's
    status to ``degraded``. None when no SLO exists (the probe payload
    stays byte-stable for processes that never import serving)."""
    slos = active_slos()
    if not slos:
        return None
    verdicts = [s.snapshot() for s in slos]
    return {
        "breaching": any(v["breaching"] for v in verdicts),
        "slos": verdicts,
    }
