"""Compiled-program cost ledger: what each program cost to build.

Port of ``metrics_tpu/observability/costledger.py``. How many programs a
process builds, which of them are *cold* (a signature this process never
built: what a fresh process pays on every deploy, preemption or autoscale)
and which *warm* (a signature built before and evicted from the engine's
LRU since), and how long each build took. Two tiers:

1. **With telemetry** (no extra work): every signature-cache miss the
   engine resolves counts ``engine.compile.cold`` or
   ``engine.compile.warm``, observes the build's wall time into the
   ``engine.compile_ms`` histogram (on the card: the warm-up, the capture
   and the first replay's enqueue; on the CPU: the first run of the step
   function), and mirrors the running totals as the
   ``engine.programs.{cold,warm}`` gauges for the export surface.
2. **The armed ledger** (:func:`enable_cost_ledger` /
   ``METRICS_TPU_COST_LEDGER=1``): one entry per program with its build
   wall times and warm/cold classification. Read it back with
   :meth:`CostLedger.report` / :meth:`CostLedger.to_json`; the export
   surface renders one ``metrics_tpu_engine_program_*`` family set per
   program, and flight dumps attach :meth:`CostLedger.brief`.

Where the JAX package keys an entry by its jaxpr fingerprint, the port has
no jaxpr: an entry is keyed by a 16-hex digest of what defines the program,
the kind of step, the member metrics' names, classes, configurations and
sync tiers, the guard's token, and the call's shapes, dtypes and static
arguments (:func:`shape_tree`). Nothing of the engine that built it enters
the digest, so the same program built by two engines is one entry. There
is no XLA cost model either: ``flops`` and ``bytes_accessed`` stay None, as
JAX records them when ``cost_analysis()`` fails.

Off by default; the disarmed ledger adds nothing to a step (a cache hit
never reaches this module); recording never raises into the dispatch path.
"""
import hashlib
import inspect
import json
import threading
import time
from collections import namedtuple
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from metrics_tpu_torch.observability import telemetry as _obs
from metrics_tpu_torch.utilities.env import cost_ledger_requested

__all__ = [
    "CostLedger",
    "enable_cost_ledger",
    "disable_cost_ledger",
    "cost_ledger_enabled",
    "cost_ledger_scope",
    "get_ledger",
    "note_compile",
    "shape_tree",
]

#: a tensor's shape and dtype without its data (what :func:`shape_tree` makes)
TensorSpec = namedtuple("TensorSpec", ["shape", "dtype"])


def shape_tree(tree: Any) -> Any:
    """``tree`` with every tensor leaf replaced by its :class:`TensorSpec`
    (shape and dtype only); dicts, lists and tuples keep their structure,
    anything else passes through. Valid after the tensors are freed."""
    if isinstance(tree, torch.Tensor):
        return TensorSpec(tuple(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return {k: shape_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(shape_tree(v) for v in tree)
    return tree


def _canonical(x: Any) -> Any:
    """A deterministic, process-independent form of a definition or a
    :func:`shape_tree`: dict keys sorted, values by type and repr (a
    callable by its qualified name, never its address)."""
    if isinstance(x, TensorSpec):
        return ("tensor", x.shape, str(x.dtype))
    if isinstance(x, dict):
        return ("dict", tuple(sorted((str(k), _canonical(v)) for k, v in x.items())))
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return (type(x).__name__, tuple(_canonical(v) for v in x))
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype, torch.device)):
        return (type(x).__name__, repr(x))
    if isinstance(x, type) or callable(x):
        return ("callable", getattr(x, "__qualname__", type(x).__qualname__))
    return ("object", type(x).__qualname__)


def metric_config(metric: Any) -> Dict[str, Any]:
    """A metric's class and configuration: the values it keeps under the
    names of its constructor's parameters, and its sync tiers."""
    config: Dict[str, Any] = {}
    try:
        params = inspect.signature(type(metric).__init__).parameters
    except (TypeError, ValueError):
        params = {}
    for name, p in params.items():
        if name != "self" and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD) and hasattr(metric, name):
            config[name] = getattr(metric, name)
    config["__sync_precisions__"] = dict(getattr(metric, "_sync_precisions", {}) or {})
    return {"class": f"{type(metric).__module__}.{type(metric).__qualname__}", "config": config}


def fingerprint(definition: Any, example_inputs: Any) -> str:
    """The 16-hex digest an entry is keyed by (module docstring)."""
    blob = repr(_canonical((definition, example_inputs))).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


class CostLedger:
    """Per-program build records, keyed by :func:`fingerprint`.

    Thread-safe (the engine notes builds from whichever thread dispatched:
    the serve loop, an asynchronous server's worker).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict[str, Any]] = {}

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------
    def record(
        self,
        engine: str,
        kind: str,
        signature: tuple,
        wall_s: float,
        cold: bool,
        program: Callable[[], Any],
        example_inputs: Optional[Any],
    ) -> Optional[str]:
        """One built signature: fingerprint what defines the program
        (``program()`` returns that definition) on ``example_inputs``, fold
        into the program's entry. Best-effort: a failure degrades to an
        ``unanalyzable:`` key and never raises. Returns the entry key."""
        try:
            if example_inputs is None:
                raise ValueError("no example inputs captured")
            key = fingerprint(program(), example_inputs)
        except Exception as err:  # noqa: BLE001 - diagnostics must not raise
            key = f"unanalyzable:{type(err).__name__}"
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = self._entries[key] = {
                    "fingerprint": key,
                    "engine": engine,
                    "kind": kind,
                    "compiles": 0,
                    "cold_compiles": 0,
                    "warm_compiles": 0,
                    "compile_ms_total": 0.0,
                    "last_compile_ms": 0.0,
                    "flops": None,
                    "bytes_accessed": None,
                    "signatures": set(),
                    "first_compiled_at": time.time(),
                }
            e["compiles"] += 1
            e["cold_compiles" if cold else "warm_compiles"] += 1
            e["compile_ms_total"] += wall_s * 1e3
            e["last_compile_ms"] = wall_s * 1e3
            e["signatures"].add(hash(signature))
        return key

    # ------------------------------------------------------------------
    # reading
    # ------------------------------------------------------------------
    def entries(self) -> List[Dict[str, Any]]:
        """JSON-shaped records, most-built first (``signatures`` collapses
        to its distinct count)."""
        with self._lock:
            out = []
            for e in self._entries.values():
                rec = dict(e)
                rec["signatures"] = len(e["signatures"])
                rec["compile_ms_total"] = round(rec["compile_ms_total"], 3)
                rec["last_compile_ms"] = round(rec["last_compile_ms"], 3)
                out.append(rec)
        out.sort(key=lambda r: (-r["compiles"], r["fingerprint"]))
        return out

    def snapshot(self) -> Dict[str, Any]:
        entries = self.entries()
        return {
            "format": "metrics_tpu.cost_ledger",
            "schema_version": 1,
            "programs": len(entries),
            "cold_compiles": sum(e["cold_compiles"] for e in entries),
            "warm_compiles": sum(e["warm_compiles"] for e in entries),
            "entries": entries,
        }

    def brief(self) -> Dict[str, Any]:
        """The compact form flight dumps carry: one row per program."""
        return {
            e["fingerprint"][:16]: {
                "engine": e["engine"],
                "kind": e["kind"],
                "compiles": e["compiles"],
                "cold": e["cold_compiles"],
                "last_compile_ms": e["last_compile_ms"],
                "flops": e["flops"],
                "bytes_accessed": e["bytes_accessed"],
            }
            for e in self.entries()
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def report(self) -> str:
        """Human-readable per-program table."""
        entries = self.entries()
        lines = ["metrics_tpu compiled-program cost ledger", "=" * 40]
        if not entries:
            lines.append("(no compiles recorded — is the ledger armed?)")
            return "\n".join(lines)
        lines.append(
            f"{'program':<18} {'kind':<12} {'compiles':>8} {'cold':>5}"
            f" {'last ms':>9} {'Mflops':>9} {'MB acc':>8}  engine"
        )
        for e in entries:
            mflops = "-" if e["flops"] is None else f"{e['flops'] / 1e6:.2f}"
            mb = "-" if e["bytes_accessed"] is None else f"{e['bytes_accessed'] / 1e6:.2f}"
            lines.append(
                f"{e['fingerprint'][:16]:<18} {e['kind']:<12}"
                f" {e['compiles']:>8} {e['cold_compiles']:>5}"
                f" {e['last_compile_ms']:>9.2f} {mflops:>9} {mb:>8}"
                f"  {e['engine']}"
            )
        lines.append(
            f"{len(entries)} program(s);"
            f" cold={sum(e['cold_compiles'] for e in entries)}"
            f" warm={sum(e['warm_compiles'] for e in entries)}"
        )
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()


# ----------------------------------------------------------------------
# module-level singleton + enable/disable switch (telemetry's shape)
# ----------------------------------------------------------------------
_ledger = CostLedger()
_enabled = False


def get_ledger() -> CostLedger:
    """The process-local ledger (valid whether or not recording is on)."""
    return _ledger


def cost_ledger_enabled() -> bool:
    """The one check the engine's miss path makes; a plain global read."""
    return _enabled


def enable_cost_ledger() -> CostLedger:
    """Arm per-program recording (idempotent). The ``engine.compile.*``
    counters ride the telemetry switch regardless; arming buys the
    per-program entries (one digest per new build, never on a replay)."""
    global _enabled
    _enabled = True
    return _ledger


def disable_cost_ledger() -> None:
    """Disarm. Recorded entries stay readable via :func:`get_ledger`."""
    global _enabled
    _enabled = False


@contextmanager
def cost_ledger_scope(fresh: bool = True) -> Iterator[CostLedger]:
    """Arm the ledger for a ``with`` block, restoring the prior state on
    exit; ``fresh=True`` (default) clears it on entry."""
    global _enabled
    prior = _enabled
    ledger = enable_cost_ledger()
    if fresh:
        ledger.reset()
    try:
        yield ledger
    finally:
        _enabled = prior


# ----------------------------------------------------------------------
# the engine hook
# ----------------------------------------------------------------------
def note_compile(
    engine: str,
    kind: str,
    signature: tuple,
    wall_s: float,
    cold: bool,
    program: Callable[[], Any],
    example_inputs: Optional[Any],
) -> None:
    """Called by the engine once per signature-cache miss, after the
    build's first successful run (``wall_s``: the build and that run). The
    counters, the build-time histogram and the warm/cold gauges record
    whenever telemetry is on; the per-program entry only when the ledger
    is armed."""
    if _obs.enabled():
        tel = _obs.get()
        tel.count("engine.compile.cold" if cold else "engine.compile.warm")
        tel.observe_hist("engine.compile_ms", wall_s * 1e3, _obs.LATENCY_BUCKETS_MS)
        # gauge mirrors of the running totals: plain gauges a dashboard reads
        # without rate()
        tel.gauge("engine.programs.cold", tel.counters.get("engine.compile.cold", 0))
        tel.gauge("engine.programs.warm", tel.counters.get("engine.compile.warm", 0))
    if _enabled:
        _ledger.record(engine, kind, signature, wall_s, cold, program, example_inputs)


if cost_ledger_requested():
    enable_cost_ledger()
