"""Pull-based Prometheus export surface: ``/metrics`` for a fleet scraper.

Port of ``metrics_tpu/observability/exporter.py``: the same families, the
same ``/healthz`` payload and the same text-format validator. The cohorts'
per-tenant health is read as :meth:`~metrics_tpu_torch.cohort.MetricCohort
.health` reads it on the card: after an event the cohort's last step
recorded, into pinned memory on a stream of its own, so a scrape beside a
live serve loop never stalls that loop's launches.

Everything the observability layer records is process-local; a fleet
monitor watching thousands of serving processes needs the numbers to
*leave* the process in a form it can scrape. This module serves exactly
that, with the subsystem's standing constraints:

* **Zero sockets, zero overhead when off.** Nothing here binds a port,
  spawns a thread, or even imports ``http.server`` until
  :func:`enable_exporter` runs (or ``METRICS_TPU_EXPORTER=<port>`` is set
  at import). Registration of scrape sources is one weak reference at
  construction time; unscraped processes pay nothing else.
* **Pull, not push.** A stdlib ``http.server`` daemon thread serves

  - ``/metrics`` — the Prometheus text exposition:
    :meth:`~metrics_tpu_torch.observability.telemetry.Telemetry.to_prometheus`
    (counters / gauges / timer summaries / fixed-bucket histograms whose
    edges map directly onto cumulative ``le=`` buckets), plus per-tenant
    cohort health from every live :class:`~metrics_tpu_torch.cohort
    .MetricCohort` and cursor/generation gauges from every live
    :class:`~metrics_tpu_torch.reliability.EvalSession`;
  - ``/healthz`` — a JSON liveness probe carrying the rank identity.

* **Consistent scrapes.** The telemetry half renders from one locked
  snapshot; each auxiliary source renders inside its own guard, and a
  source that fails mid-scrape degrades to an exposition comment instead
  of a 500 — a half-broken process is exactly when you want the scrape
  to still answer.

Arm with :func:`enable_exporter` (``port=0`` = OS-assigned, returned on
the exporter object), :func:`exporter_scope`, or
``METRICS_TPU_EXPORTER=<port>``; disarm with :func:`disable_exporter`,
which shuts the server down and releases the port. (The JAX package's
command-line wrapper, ``scripts/metrics_exporter.py``, has no port yet.)
"""
import itertools
import json
import re
import sys
import threading
import weakref
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

from metrics_tpu_torch.observability import identity as _identity
from metrics_tpu_torch.observability import telemetry as _telemetry
from metrics_tpu_torch.observability.telemetry import _escape_label, _format_value
from metrics_tpu_torch.utilities.env import exporter_port
from metrics_tpu_torch.utilities.prints import warn_once

__all__ = [
    "MetricsExporter",
    "enable_exporter",
    "disable_exporter",
    "exporter_enabled",
    "exporter_scope",
    "get_exporter",
    "register_cohort",
    "register_fleet",
    "render_exposition",
    "parse_prometheus_text",
]

DEFAULT_PORT = 9464  # the OpenTelemetry Prometheus-exporter convention

# scrape sources, weakly held: a dropped cohort/session must not be kept
# alive (or scraped) by the exporter. Sessions come from the reliability
# registry (session._SESSIONS) lazily — no import-time coupling.
_COHORT_SEQ = itertools.count()
_COHORTS: "weakref.WeakValueDictionary[int, Any]" = weakref.WeakValueDictionary()


def register_cohort(cohort: Any) -> int:
    """Enroll a :class:`~metrics_tpu_torch.cohort.MetricCohort` as a scrape
    source (called by its constructor; one weak reference, nothing else).
    Returns the stable ``cohort=`` label value used in the exposition."""
    cid = next(_COHORT_SEQ)
    _COHORTS[cid] = cohort
    return cid


_FLEET_SEQ = itertools.count()
_FLEETS: "weakref.WeakValueDictionary[int, Any]" = weakref.WeakValueDictionary()


def register_fleet(coordinator: Any) -> int:
    """Enroll a fleet's ``MigrationCoordinator`` as a scrape source (called
    by its constructor; weak reference — a dropped fleet disappears from the
    exposition). Returns the stable ``fleet=`` label value; the fleet
    families render each live coordinator's placement, shards and
    replicator."""
    fid = next(_FLEET_SEQ)
    _FLEETS[fid] = coordinator
    return fid


# ----------------------------------------------------------------------
# exposition rendering
# ----------------------------------------------------------------------
class _GaugeFamilies:
    """Accumulator for auxiliary gauge families: collect samples per
    family across sources, then emit each family's ``# TYPE`` header
    before ALL its samples (the text format forbids interleaving
    families). A source that fails mid-render degrades to an exposition
    comment — a half-broken process is exactly when the scrape must
    still answer."""

    def __init__(self) -> None:
        self._families: "Dict[str, List[str]]" = {}
        self._comments: List[str] = []

    def sample(self, family: str, labels: str, value: Any) -> None:
        self._families.setdefault(family, []).append(
            f"{family}{{{labels}}} {_format_value(value)}"
        )

    def degrade(self, what: str, err: Exception) -> None:
        self._comments.append(
            f"# metrics_tpu exporter: {what} unavailable ({type(err).__name__})"
        )

    def lines(self) -> List[str]:
        out = list(self._comments)
        for family in sorted(self._families):
            out.append(f"# TYPE {family} gauge")
            out.extend(self._families[family])
        return out


def _render_cohorts() -> List[str]:
    """Per-tenant health families across every live cohort."""
    fam = _GaugeFamilies()
    for cid in sorted(_COHORTS.keys()):
        cohort = _COHORTS.get(cid)
        if cohort is None:
            continue
        try:
            clabel = f'cohort="{cid}"'
            # NOT metrics_tpu_cohort_size/_capacity: those family names
            # belong to the registry gauges cohort.size/cohort.capacity
            # already rendered by to_prometheus(), and one exposition
            # must not declare a family twice
            fam.sample("metrics_tpu_cohort_live_tenants", clabel, len(cohort))
            fam.sample("metrics_tpu_cohort_slot_capacity", clabel, cohort.capacity)
            health = cohort.health()
            if health is None:
                continue
            fam.sample("metrics_tpu_cohort_step", clabel, health["step"])
            per_tenant = (
                "rows_seen",
                "updates",
                "last_step",
                "staleness",
                "nonfinite",
                "guard_verdicts",
            )
            for i, slot in enumerate(health["tenants"]):
                tlabel = f'{clabel},tenant="{slot}"'
                for key in per_tenant:
                    fam.sample(
                        f"metrics_tpu_cohort_tenant_{key}", tlabel, health[key][i]
                    )
        except Exception as err:  # noqa: BLE001 — a scrape must answer
            fam.degrade(f"cohort {cid} health", err)
    return fam.lines()


def _render_fleet() -> List[str]:
    """Placement + migration families for every live fleet coordinator:
    the placement-map generation (per fleet) and migration/in-flight
    tallies (per shard). Gauges all — ``migrations_total`` is
    monotonically increasing by construction (per-shard in+out
    completions), but rendered from reconstructed state, not a scraped
    counter registry."""
    fam = _GaugeFamilies()
    for fid in sorted(_FLEETS.keys()):
        coord = _FLEETS.get(fid)
        if coord is None:
            continue
        try:
            flabel = f'fleet="{fid}"'
            fam.sample(
                "metrics_tpu_fleet_placement_generation",
                flabel,
                coord.placement.generation,
            )
            in_flight = coord.in_flight_by_shard()
            migrations = coord.migrations_by_shard()
            replicator = getattr(coord, "replicator", None)
            lag_by_shard = (
                replicator.lag_by_shard() if replicator is not None else {}
            )
            for name in sorted(coord.shards):
                slabel = f'{flabel},shard="{_escape_label(name)}"'
                fam.sample(
                    "metrics_tpu_fleet_migrations_total",
                    slabel,
                    migrations.get(name, 0),
                )
                fam.sample(
                    "metrics_tpu_fleet_tenants_in_flight",
                    slabel,
                    in_flight.get(name, 0),
                )
                # ownership epoch: -1 = unleased (fencing not armed)
                fam.sample(
                    "metrics_tpu_fleet_shard_epoch",
                    slabel,
                    getattr(coord.shards[name], "epoch", -1),
                )
                if replicator is not None:
                    # NOT metrics_tpu_fleet_replication_lag: that family
                    # name belongs to the registry gauge
                    # fleet.replication.lag (whole-fleet); this one is
                    # per shard, reconstructed at scrape time
                    fam.sample(
                        "metrics_tpu_fleet_shard_replication_lag",
                        slabel,
                        lag_by_shard.get(name, 0),
                    )
            if replicator is not None:
                # monotonic by construction (like migrations_total) but
                # reconstructed state, not the fleet.failovers counter —
                # whose registry family already owns the _total name
                fam.sample(
                    "metrics_tpu_fleet_failovers",
                    flabel,
                    replicator.stats.get("failovers", 0),
                )
        except Exception as err:  # noqa: BLE001 — a scrape must answer
            fam.degrade(f"fleet {fid}", err)
    return fam.lines()


def _render_sessions() -> List[str]:
    """Cursor/generation/accounting gauges for every live
    :class:`~metrics_tpu_torch.reliability.EvalSession`, labeled by journal
    directory (the session's durable identity)."""
    try:
        from metrics_tpu_torch.reliability import session as _session
    except Exception:  # noqa: BLE001 — reliability package unavailable
        return []
    sessions = sorted(
        list(_session._SESSIONS), key=lambda s: str(s.journal.directory)
    )
    fam = _GaugeFamilies()
    for s in sessions:
        try:
            label = f'journal="{_escape_label(str(s.journal.directory))}"'
            generation = -1
            records = s.journal.records()
            if records:
                generation = int(records[-1].get("generation", -1))
            fam.sample("metrics_tpu_session_cursor", label, s.cursor)
            fam.sample("metrics_tpu_session_generation", label, generation)
            fam.sample(
                "metrics_tpu_session_checkpoints", label, s.stats["checkpoints"]
            )
            fam.sample(
                "metrics_tpu_session_replays_skipped",
                label,
                s.stats["replays_skipped"],
            )
        except Exception as err:  # noqa: BLE001 — a scrape must answer
            fam.degrade("session gauges", err)
    return fam.lines()


def _render_quorum() -> List[str]:
    """Membership of the most recent hierarchical (two-level) exchange:
    the dropped-pod gauge and quorum size, so an external scraper sees a
    dropped pod without reading logs. Renders nothing until a
    :class:`~metrics_tpu_torch.parallel.hierarchy.HierarchicalSyncBackend`
    exchange has run in this process — and renders regardless of whether
    telemetry recording is on (the quorum is state, not a counter)."""
    try:
        from metrics_tpu_torch.parallel.hierarchy import last_quorum

        q = last_quorum()
    except Exception:  # noqa: BLE001 — a scrape must answer
        return []
    if q is None:
        return []
    fam = _GaugeFamilies()
    label = f'source="{_escape_label(q.source)}"'
    fam.sample("metrics_tpu_sync_degraded_pods", label, q.dropped_pods)
    fam.sample("metrics_tpu_sync_quorum_slices", label, len(q.slices_present))
    fam.sample("metrics_tpu_sync_world_slices", label, q.num_slices)
    return fam.lines()


def _render_cost_ledger() -> List[str]:
    """Per-compiled-program families from the cost ledger (rendered
    whenever entries exist — like the quorum, the ledger is state, not a
    counter): compile counts, cold-compile counts, last compile wall
    time, and cost-model flops / bytes-accessed where an entry has them
    (the port's entries have none), labeled by the program's fingerprint
    prefix."""
    try:
        from metrics_tpu_torch.observability import costledger as _cl

        entries = _cl.get_ledger().entries()
    except Exception:  # noqa: BLE001 — a scrape must answer
        return []
    if not entries:
        return []
    fam = _GaugeFamilies()
    for e in entries:
        label = (
            f'program="{e["fingerprint"][:16]}",'
            f'engine="{_escape_label(e["engine"])}",kind="{e["kind"]}"'
        )
        fam.sample("metrics_tpu_engine_program_compiles", label, e["compiles"])
        fam.sample(
            "metrics_tpu_engine_program_cold_compiles", label, e["cold_compiles"]
        )
        fam.sample(
            "metrics_tpu_engine_program_compile_ms", label, e["last_compile_ms"]
        )
        if e.get("flops") is not None:
            fam.sample("metrics_tpu_engine_program_flops", label, e["flops"])
        if e.get("bytes_accessed") is not None:
            fam.sample(
                "metrics_tpu_engine_program_bytes_accessed",
                label,
                e["bytes_accessed"],
            )
    return fam.lines()


def render_exposition() -> str:
    """The full ``/metrics`` payload: telemetry registry + cohort health
    + session gauges + sync quorum + compiled-program cost ledger, one
    consistent text exposition. Valid (and useful: the identity line
    still answers "who is this") even when telemetry recording is
    disabled."""
    # auxiliary sources FIRST: cohort.health() refreshes the
    # cohort.tenant.* gauges, and rendering the registry afterwards means
    # one scrape sees both the per-tenant samples and the refreshed
    # aggregate gauges
    extra = (
        _render_cohorts()
        + _render_fleet()
        + _render_sessions()
        + _render_quorum()
        + _render_cost_ledger()
    )
    return _telemetry.get().to_prometheus(extra_lines=extra)


# ----------------------------------------------------------------------
# the HTTP surface
# ----------------------------------------------------------------------
class MetricsExporter:
    """A bound ``/metrics`` + ``/healthz`` server on a daemon thread.

    Constructed by :func:`enable_exporter`; :meth:`close` shuts the
    listener down and releases the port (pinned by
    ``tests/test_torch_exporter.py``).
    """

    def __init__(self, port: int = DEFAULT_PORT, host: str = "127.0.0.1"):
        # the ONLY place the http machinery is imported: zero-sockets-
        # when-off includes zero import cost
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: ARG002 — silence stderr
                pass

            def do_GET(self):  # noqa: N802 — http.server contract
                if self.path.split("?", 1)[0] == "/metrics":
                    if _telemetry.enabled():
                        _telemetry.get().count("exporter.scrapes")
                    try:
                        body = render_exposition().encode()
                        status, ctype = 200, "text/plain; version=0.0.4; charset=utf-8"
                    except Exception as err:  # noqa: BLE001 — degrade, don't die
                        body = f"# exporter error: {type(err).__name__}: {err}\n".encode()
                        status, ctype = 500, "text/plain; charset=utf-8"
                elif self.path.split("?", 1)[0] == "/healthz":
                    ident = _identity.process_identity()
                    payload = {"status": "ok", **ident}
                    try:
                        # liveness probes double as quorum probes: a
                        # dropped pod is visible from the outside even
                        # when nothing scrapes /metrics
                        from metrics_tpu_torch.parallel.hierarchy import last_quorum

                        q = last_quorum()
                        if q is not None:
                            payload["sync_quorum"] = q.as_dict()
                    except Exception:  # noqa: BLE001 — liveness must answer
                        pass
                    try:
                        # serving-SLO verdict: a sustained latency breach
                        # flips the probe to "degraded" so an external
                        # health checker reacts without scraping
                        # histograms. sys.modules gate, not an import —
                        # a process that never constructed a ServingSLO
                        # must not pull the serving package in here.
                        slo_mod = sys.modules.get("metrics_tpu_torch.serving.slo")
                        if slo_mod is not None:
                            verdict = slo_mod.healthz_payload()
                            if verdict is not None:
                                payload["serving_slo"] = verdict
                                if verdict.get("breaching"):
                                    payload["status"] = "degraded"
                    except Exception:  # noqa: BLE001 — liveness must answer
                        pass
                    body = json.dumps(payload).encode()
                    status, ctype = 200, "application/json"
                else:
                    body = b"not found: try /metrics or /healthz\n"
                    status, ctype = 404, "text/plain; charset=utf-8"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.host = host
        self._server = ThreadingHTTPServer((host, int(port)), _Handler)
        self._server.daemon_threads = True
        self.port = int(self._server.server_address[1])
        server = self._server  # close() nulls the attribute; bind locally
        self._thread = threading.Thread(
            # short poll interval: serve_forever's default 0.5s poll makes
            # every shutdown() (disarm, scope exit) block half a second
            target=lambda: server.serve_forever(poll_interval=0.05),
            name=f"metrics-tpu-exporter:{self.port}",
            daemon=True,
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        """Stop serving and release the port (idempotent)."""
        server, self._server = self._server, None
        if server is None:
            return
        server.shutdown()
        server.server_close()
        self._thread.join(timeout=5)

    def __repr__(self) -> str:
        state = "closed" if self._server is None else "serving"
        return f"MetricsExporter({self.url}, {state})"


_exporter: Optional[MetricsExporter] = None
_lock = threading.Lock()


def get_exporter() -> Optional[MetricsExporter]:
    """The active exporter (None when disarmed — the default)."""
    return _exporter


def exporter_enabled() -> bool:
    """Is the export surface armed (a listener bound and serving)?"""
    return _exporter is not None


def enable_exporter(
    port: Optional[int] = None, host: Optional[str] = None
) -> MetricsExporter:
    """Arm the export surface (idempotent): bind ``port`` (default
    :data:`DEFAULT_PORT`; 0 = OS-assigned, read the actual port off the
    returned exporter) on ``host`` (default loopback) and serve
    ``/metrics`` + ``/healthz`` from a daemon thread. Calling again while
    armed returns the live exporter unchanged when the requested binding
    is compatible (unspecified or matching host, and an unspecified,
    matching, or 0 port); an explicitly *different* port or host restarts
    the listener there — a caller asking to open the surface to the
    fleet (``host="0.0.0.0"``) must never silently keep a loopback-only
    listener."""
    global _exporter
    with _lock:
        if _exporter is not None:
            port_ok = port is None or int(port) in (0, _exporter.port)
            host_ok = host is None or host == _exporter.host
            if port_ok and host_ok:
                return _exporter
            _exporter.close()
            _exporter = None
        _exporter = MetricsExporter(
            DEFAULT_PORT if port is None else int(port),
            host="127.0.0.1" if host is None else host,
        )
        return _exporter


def disable_exporter() -> None:
    """Disarm: stop the server, release the port. Safe to call when
    already off."""
    global _exporter
    with _lock:
        exporter, _exporter = _exporter, None
    if exporter is not None:
        exporter.close()


@contextmanager
def exporter_scope(
    port: int = 0, host: str = "127.0.0.1"
) -> Iterator[MetricsExporter]:
    """Arm the exporter for a ``with`` block (port 0 = OS-assigned),
    restoring the prior armed/disarmed state — and releasing the block's
    port — on exit (a previously-armed exporter is re-bound on its old
    port)."""
    prev = get_exporter()
    prev_binding = (prev.port, prev.host) if prev is not None else None
    disable_exporter()
    exporter = enable_exporter(port, host=host)
    try:
        yield exporter
    finally:
        disable_exporter()
        if prev_binding is not None:
            enable_exporter(prev_binding[0], host=prev_binding[1])


# ----------------------------------------------------------------------
# text-format validation (shared by the tests and the card's smoke run)
# ----------------------------------------------------------------------
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>NaN|[+-]Inf|[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)"
    r"(?:\s+[0-9]+)?$"
)
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse_label_block(block: str, lineno: int) -> Dict[str, str]:
    """Strict tokenization of one ``{...}`` label block: label pairs
    separated by single commas, nothing else. A findall-based extraction
    would silently skip junk between pairs — this walks the block
    position by position and rejects anything the grammar doesn't
    produce (an optional trailing comma is legal per the format spec)."""
    labels: Dict[str, str] = {}
    pos = 0
    while pos < len(block):
        m = _LABEL_PAIR_RE.match(block, pos)
        if not m:
            raise ValueError(
                f"malformed label block on line {lineno}: {block!r} (at"
                f" offset {pos})"
            )
        labels[m.group(1)] = m.group(2)
        pos = m.end()
        if pos < len(block):
            if block[pos] != ",":
                raise ValueError(
                    f"malformed label separator on line {lineno}: {block!r}"
                    f" (at offset {pos})"
                )
            pos += 1
    return labels


def parse_prometheus_text(text: str) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """Validate a Prometheus text exposition and return
    ``{metric_name: [(labels_dict, value), ...]}``.

    Raises ``ValueError`` on any malformed line, malformed label pair, a
    metric family declared twice (one ``# TYPE`` line per name is the
    rule a real scraper enforces — duplicate or conflicting declarations
    fail the whole scrape), or a histogram whose cumulative ``le=``
    buckets decrease or whose ``+Inf`` bucket disagrees with ``_count``
    — the structural invariants a real scraper depends on. The exporter
    tests and ``chip_smoke.py`` run it against every scrape.
    """
    samples: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    declared_types: Dict[str, str] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4:
                raise ValueError(f"malformed TYPE line {lineno}: {raw!r}")
            _, _, fname, ftype = parts
            if fname in declared_types:
                raise ValueError(
                    f"family {fname!r} declared twice (line {lineno}:"
                    f" {declared_types[fname]!r} then {ftype!r}) — one TYPE"
                    " line per metric name"
                )
            declared_types[fname] = ftype
            continue
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"malformed exposition line {lineno}: {raw!r}")
        labels: Dict[str, str] = {}
        if m.group("labels"):
            labels = _parse_label_block(m.group("labels"), lineno)
        value = m.group("value")
        fval = float("nan") if value == "NaN" else float(value.replace("Inf", "inf"))
        samples.setdefault(m.group("name"), []).append((labels, fval))
    # histogram invariants
    for name, entries in samples.items():
        if not name.endswith("_bucket"):
            continue
        base = name[: -len("_bucket")]
        prev = None
        total = None
        for labels, value in entries:
            le = labels.get("le")
            if le is None:
                raise ValueError(f"histogram sample without le= label: {name}")
            if le == "+Inf":
                total = value
            elif prev is not None and value < prev:
                raise ValueError(
                    f"histogram {base}: cumulative buckets decrease at le={le}"
                )
            if le != "+Inf":
                prev = value
        counts = samples.get(base + "_count")
        if total is None:
            raise ValueError(f"histogram {base}: missing le=\"+Inf\" bucket")
        if counts and abs(counts[0][1] - total) > 0:
            raise ValueError(
                f"histogram {base}: +Inf bucket {total} != _count {counts[0][1]}"
            )
    return samples


# ----------------------------------------------------------------------
# env-driven startup (the import-time twin of METRICS_TPU_TELEMETRY)
# ----------------------------------------------------------------------
_env_port = exporter_port()
if _env_port is not None:
    if _env_port < 0:
        warn_once(
            "METRICS_TPU_EXPORTER is set but not a port number; the"
            " Prometheus exporter stays OFF (use e.g."
            " METRICS_TPU_EXPORTER=9464, or 0 for an OS-assigned port)",
            key="exporter-bad-port",
        )
    else:
        try:
            enable_exporter(_env_port)
        except OSError as err:
            warn_once(
                f"METRICS_TPU_EXPORTER={_env_port}: could not bind the"
                f" exporter port ({err}); continuing without the export"
                " surface",
                key="exporter-bind-failed",
            )
