"""Runtime telemetry for the metric pipeline.

Port of the core of ``metrics_tpu/observability/``: counters, timers,
fixed-bucket histograms and a bounded event log (``telemetry.py``),
step-indexed nested spans exported as Perfetto JSON (``trace.py``), the
recompilation watchdog (``watchdog.py``), the failure flight recorder
(``flight.py``) and the rank identity stamp (``identity.py``), wired
through the ``Metric`` lifecycle, the step engine, the cohort and the
collectives, the Prometheus export surface (``exporter.py``: ``/metrics``
and ``/healthz`` on a daemon thread, scraping the registry, every live
cohort's per-tenant health, the sessions, the sync quorum and the cost
ledger) and the compiled-program cost ledger (``costledger.py``: cold and
warm builds of the engine's CUDA graphs). Everything is off by default, and
a disabled hook costs one global read. The registry keys, span names, event
kinds, flag names, exposition families and artifact formats are the JAX
package's (glossary: its ``docs/observability.md``).

Quick start::

    import metrics_tpu_torch.observability as obs

    obs.enable()                 # or METRICS_TPU_TELEMETRY=1 in the env
    ... run the eval loop ...
    print(obs.report())          # human-readable summary
    blob = obs.to_json()         # machine-readable, json.loads-able

    with obs.telemetry_scope() as tel:   # scoped alternative
        ... one eval pass ...
        assert tel.watchdog.retrace_count() == 0

    with obs.exporter_scope(port=0) as ex, obs.cost_ledger_scope() as ledger:
        ... serve ...               # scrape http://127.0.0.1:<ex.port>/metrics
        print(ledger.report())      # one row per built program

Timers are the host clock and no hook synchronizes with the card: a timer
around asynchronous work measures its enqueue.
"""
from metrics_tpu_torch.observability.costledger import (  # noqa: F401
    CostLedger,
    cost_ledger_enabled,
    cost_ledger_scope,
    disable_cost_ledger,
    enable_cost_ledger,
    get_ledger,
)
from metrics_tpu_torch.observability.exporter import (  # noqa: F401
    MetricsExporter,
    disable_exporter,
    enable_exporter,
    exporter_enabled,
    exporter_scope,
    get_exporter,
    parse_prometheus_text,
    render_exposition,
)
from metrics_tpu_torch.observability.flight import (  # noqa: F401
    FlightRecorder,
    disable_flight,
    enable_flight,
    flight_enabled,
    flight_scope,
    get_flight,
)
from metrics_tpu_torch.observability.identity import (  # noqa: F401
    identity_scope,
    process_identity,
    set_process_identity,
)
from metrics_tpu_torch.observability.telemetry import (  # noqa: F401
    LATENCY_BUCKETS_MS,
    PAYLOAD_BUCKETS_BYTES,
    Telemetry,
    disable,
    enable,
    enabled,
    get,
    metric_scope,
    note_trace,
    percentile,
    profile_span,
    telemetry_scope,
)
from metrics_tpu_torch.observability.trace import (  # noqa: F401
    PHASES,
    TraceRecorder,
    current_flow,
    disable_tracing,
    enable_tracing,
    flow_scope,
    get_tracer,
    next_batch_id,
    step_scope,
    tracing_enabled,
    tracing_scope,
)
from metrics_tpu_torch.observability.watchdog import RecompilationWatchdog  # noqa: F401

__all__ = [
    "Telemetry",
    "TraceRecorder",
    "FlightRecorder",
    "RecompilationWatchdog",
    "enable",
    "disable",
    "enabled",
    "get",
    "telemetry_scope",
    "note_trace",
    "metric_scope",
    "profile_span",
    "enable_tracing",
    "disable_tracing",
    "tracing_enabled",
    "tracing_scope",
    "get_tracer",
    "step_scope",
    "flow_scope",
    "current_flow",
    "next_batch_id",
    "PHASES",
    "enable_flight",
    "disable_flight",
    "flight_enabled",
    "flight_scope",
    "get_flight",
    "LATENCY_BUCKETS_MS",
    "PAYLOAD_BUCKETS_BYTES",
    "percentile",
    "process_identity",
    "set_process_identity",
    "identity_scope",
    "report",
    "to_json",
    "to_prometheus",
    "MetricsExporter",
    "enable_exporter",
    "disable_exporter",
    "exporter_enabled",
    "exporter_scope",
    "get_exporter",
    "render_exposition",
    "parse_prometheus_text",
    "CostLedger",
    "enable_cost_ledger",
    "disable_cost_ledger",
    "cost_ledger_enabled",
    "cost_ledger_scope",
    "get_ledger",
]


def report() -> str:
    """Shorthand for ``get().report()``."""
    return get().report()


def to_json(indent=None) -> str:
    """Shorthand for ``get().to_json()``."""
    return get().to_json(indent=indent)


def to_prometheus() -> str:
    """Shorthand for ``get().to_prometheus()``: the registry alone; see
    :func:`render_exposition` for the full ``/metrics`` payload (registry,
    cohort health, session gauges, quorum, cost ledger)."""
    return get().to_prometheus()
