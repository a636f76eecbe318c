"""Pass 4 — concurrency soundness: the host-seam auditor, the double-buffer
prover and the thread-shared-state analysis.

Port of ``metrics_tpu/analysis/concurrency.py``, over the FX graphs of the
port's step programs (:func:`~metrics_tpu_torch.engine.fake_trace`) where the
JAX package reads jaxprs:

* **MTA008 — host-seam budget.** For every engine-eligible family (and its
  ``@cohort`` / ``@int8`` / ``@bf16`` variants) the count of host↔device
  crossings per serving-loop phase (:func:`host_seam_budget`): the host
  transfers inside the traced step graph, one host collective per
  non-residual state per sync, the device fetch per compute and per
  checkpointed state, the per-level rounds of a two-level sync. It rides
  ``evidence["host_seam"]`` and is gated against the committed
  ``SEAM_BASELINE.json`` at the repo root (:func:`check_host_seam`), the JAX
  package's file, which the port only reads. :func:`host_seam_sites` names
  where in the port's own host paths each crossing lives (the AST leg).
* **MTA009 — double-buffer prover.** On the single step graph
  (:func:`check_double_buffer`) and on the traced two-generation graph
  (:func:`composed_generation_hazards`, over
  :meth:`~metrics_tpu_torch.engine.CompiledStepEngine.abstract_double_buffer_step`):
  the state outputs generation N+1 steps from must be fresh (no input state
  returned, no tensor constant of the graph, no two outputs on one
  storage) and disjoint from every value the host reads. The port copies
  states into graph buffers where the JAX package donates them, so the
  "donated" inputs are the graph's first ``n_donated`` placeholders and an
  executable-owned constant is an output whose storage root
  (:func:`~metrics_tpu_torch.analysis.program._storage_root`, which follows
  views and in-place writes) is a ``get_attr`` tensor constant. Its AST
  legs — :func:`_host_reference_hazards` (a registered state stashed bare
  into a plain attribute, or reseeded bare from one) and
  :func:`writeback_generation_monotonic` (``CompiledStepEngine.step``
  reads the states it steps from and installs the new ones inside one
  ``with self._lock`` extent) — are shared with the admission checks of
  ``AsyncServingEngine``, which adds :func:`first_dispatch_hazards`: the
  same four hazard kinds read off the real tensors after the first step
  (the storages of the installed states, the engine's graph buffers
  (:func:`engine_owned`), the metrics' defaults and the returned values).
* **MTL106 — thread-shared-state lint** (wired into
  :mod:`metrics_tpu_torch.analysis.lint`). Per module, walk the call graph
  from every thread entry point (``Thread(target=...)``,
  ``threading.Timer`` bodies, ``do_GET``-style handler methods, worker
  closures) and flag writes to instance attributes / module globals that
  both the thread side and the main side touch, when the write is not
  under a ``with <lock>:`` block. ``__init__`` writes are exempt (they
  happen-before the spawn). The same analysis exports the
  *thread-shared model* (:func:`thread_shared_model`) and the runtime
  target registry a thread sanitizer arms.
"""
import ast
import inspect
import json
import os
import textwrap
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import torch

from metrics_tpu_torch.analysis.rules import Finding

__all__ = [
    "SEAM_BASELINE_FILENAME",
    "check_double_buffer",
    "check_host_seam",
    "composed_generation_hazards",
    "engine_owned",
    "first_dispatch_hazards",
    "flatten_seam_budget",
    "host_seam_budget",
    "host_seam_sites",
    "load_seam_baseline",
    "register_threadsan_target",
    "tensor_leaves",
    "thread_findings",
    "thread_shared_model",
    "threadsan_targets",
    "writeback_generation_monotonic",
]


#: the committed per-family seam baseline at the repo root (next to
#: FINGERPRINTS.json): the JAX package's file, read here and never written
SEAM_BASELINE_FILENAME = "SEAM_BASELINE.json"


# ---------------------------------------------------------------------------
# MTA008 — host-seam budget
# ---------------------------------------------------------------------------
def host_seam_budget(metric, step_closed: Any = None, cohort: bool = False) -> Dict[str, Any]:
    """The family's host↔device crossings per serving-loop phase, derived
    from its registered state metadata plus the traced step graph.

    Phases and what each crossing is:

    * ``per_dispatch`` — crossings every step pays: the host transfers in
      the step graph (:func:`~metrics_tpu_torch.analysis.program._callback_eqns`;
      on a CPU program a ``.cpu()`` is no transfer). The unguarded program
      is the budgeted one; a StateGuard adds exactly one fused flag fetch (a
      library constant, see :func:`host_seam_sites`).
    * ``per_sync`` — one host collective per non-residual state (stacked
      cohort states sync as one gather each, whatever the tenant count),
      the device put re-installing each merged state, the quantized-payload
      count, and the two rounds per state a two-level sync pays.
    * ``per_compute`` — the epoch-end value fetch plus the sync the compute
      triggers when a backend is installed.
    * ``per_checkpoint`` — one device fetch per registered state (residual
      companions included).
    * ``per_health`` (cohort variants) — the one device fetch of a
      ``MetricCohort.health()`` snapshot, tenant-count independent.
    """
    from metrics_tpu_torch.analysis.program import _callback_eqns

    residuals = set(metric._sync_residual_names())
    reductions = getattr(metric, "_reductions", {})
    synced = [s for s in reductions if s not in residuals]
    precisions = metric.sync_precisions()
    quantized = [s for s in synced if precisions.get(s, "exact") != "exact"]
    callbacks = len(_callback_eqns(step_closed)) if step_closed is not None else 0
    budget: Dict[str, Any] = {
        # the state inventory the counts derive from: the gate binds only a
        # matching configuration (one class can register other states under
        # another configuration)
        "states": sorted(metric._defaults),
        "per_dispatch": {"callbacks": callbacks},
        "per_sync": {
            "host_collectives": len(synced),
            "quantized_payloads": len(quantized),
            "device_puts": len(synced),
            "two_level": {"level0_rounds": len(synced), "level1_rounds": len(synced)},
        },
        "per_compute": {"device_fetches": 1, "host_collectives": len(synced)},
        "per_checkpoint": {"device_fetches": len(metric._defaults)},
        # what a step costs in crossings when nothing syncs, computes or
        # checkpoints: the number a device-resident serving loop keeps at 0
        "steady_per_step": callbacks,
    }
    if cohort:
        budget["per_health"] = {"device_fetches": 1}
    return budget


def flatten_seam_budget(budget: Dict[str, Any], prefix: str = "") -> Dict[str, int]:
    """``{"per_sync.host_collectives": 2, ...}``: the flat numeric keys the
    committed baseline compares against (the ``states`` inventory is
    compared separately, not counted)."""
    flat: Dict[str, int] = {}
    for key, value in budget.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(flatten_seam_budget(value, prefix=f"{name}."))
        elif isinstance(value, (int, float)) and not isinstance(value, bool):
            flat[name] = int(value)
    return flat


def _repo_root() -> str:
    import metrics_tpu_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(metrics_tpu_torch.__file__)))


_BASELINE_CACHE: Dict[str, Optional[Dict[str, Dict[str, Any]]]] = {}


def load_seam_baseline(path: Optional[str] = None) -> Optional[Dict[str, Dict[str, Any]]]:
    """The committed per-family seam budgets (``family -> {"states",
    "budget"}``), or None when no baseline is committed. Cached per path."""
    path = path or os.path.join(_repo_root(), SEAM_BASELINE_FILENAME)
    if path not in _BASELINE_CACHE:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                _BASELINE_CACHE[path] = json.load(fh).get("budgets") or {}
        except (OSError, ValueError):
            _BASELINE_CACHE[path] = None
    return _BASELINE_CACHE[path]


def check_host_seam(
    metric,
    findings: List[Finding],
    infos: List[str],
    family: Optional[str] = None,
    step_closed: Any = None,
    cohort: bool = False,
    baseline: Optional[Dict[str, Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """MTA008: derive the family's host-seam budget and gate it against the
    committed baseline. Returns the budget (the ``evidence["host_seam"]``
    entry). Families with no committed entry are measured but not gated;
    the registry tests pin that every audited family has one."""
    cls = type(metric).__name__
    family = family or cls
    budget = host_seam_budget(metric, step_closed=step_closed, cohort=cohort)
    base = load_seam_baseline() if baseline is None else baseline
    entry = (base or {}).get(family)
    if entry is None:
        return budget
    # the lookup is name-keyed: a configuration that registers another
    # state inventory than the recorded one is another seam, measured but
    # not gated here
    recorded_states = entry.get("states")
    if recorded_states is not None and list(recorded_states) != budget["states"]:
        infos.append(
            f"{cls}: committed seam baseline for {family!r} records states"
            f" {list(recorded_states)} but this configuration registers"
            f" {budget['states']}; budget measured, not gated"
        )
        return budget
    allowed_budget = entry.get("budget", entry)
    flat = flatten_seam_budget(budget)
    regressed = False
    for key in sorted(flat):
        allowed = int(allowed_budget.get(key, 0))
        if flat[key] > allowed:
            regressed = True
            findings.append(Finding(
                "MTA008", f"{cls}.{key}",
                f"host-seam budget regression: {flat[key]} {key} crossings"
                f" vs the committed baseline of {allowed} — a new"
                " host<->device crossing entered this family's serving"
                " loop. If intended, hand-edit this family's entry in"
                " SEAM_BASELINE.json and justify the crossing in review"
                " (`make lint` only auto-refreshes DECREASES: it refuses"
                " to rewrite the baseline over a red audit)",
                detail={"family": family, "key": key, "got": flat[key], "baseline": allowed},
            ))
    if regressed:
        from metrics_tpu_torch.observability import telemetry as _obs

        if _obs.enabled():
            _obs.get().count("analysis.seam.regressions")
    return budget


# -- the host-side crossing sites (AST leg; library-level, cached) ----------
#: PyTorch's crossing calls, where the JAX package names ``device_get``,
#: ``device_put`` and its backend's ``gather``: reads of a tensor's values on
#: the host (and the engine's pinned reads), copies onto a device, and the
#: collectives a sync routes through its policy
_CROSSING_CALLS = {
    "item": "device_fetch",
    "cpu": "device_fetch",
    "tolist": "device_fetch",
    "numpy": "device_fetch",
    "asarray": "device_fetch",
    "_flags_to_host": "device_fetch",
    "_read_after": "device_fetch",
    "as_tensor": "device_put",
    "copy_": "device_put",
    "gather_all_tensors": "host_collective",
    "all_gather": "host_collective",
    "all_gather_object": "host_collective",
    "apply_sync_policy": "host_collective",
}

_SITES_CACHE: List[Dict[str, str]] = []


def _to_kind(node: ast.Call) -> Optional[str]:
    """The crossing of a ``.to(...)`` call: to the CPU is a device fetch, to
    a device named by a variable (``device=dev``, ``.to(self.device)``) a
    device put; a dtype cast is no crossing."""
    targets = list(node.args) + [kw.value for kw in node.keywords if kw.arg == "device"]
    for arg in targets:
        if isinstance(arg, ast.Constant) and arg.value == "cpu":
            return "device_fetch"
        name = arg.attr if isinstance(arg, ast.Attribute) else arg.id if isinstance(arg, ast.Name) else ""
        if "dev" in name.lower():
            return "device_put"
    return "device_put" if any(kw.arg == "device" for kw in node.keywords) else None


def host_seam_sites() -> List[Dict[str, str]]:
    """Every host↔device crossing call site on the port's serving-loop host
    paths, classified by phase: the AST leg of the seam audit. The budgets
    count how often a phase crosses; this table names where in the port
    each crossing lives.

    Crossing kinds: ``device_fetch`` (``.item()``, ``.cpu()``,
    ``.tolist()``, ``.numpy()``, ``np.asarray``, ``.to("cpu")``, the
    engine's pinned reads), ``device_put`` (``torch.as_tensor``,
    ``.to(device)``, ``copy_``) and ``host_collective`` (the backend's
    gathers and the sync policy that wraps them). Cached per process."""
    if _SITES_CACHE:
        return list(_SITES_CACHE)
    from metrics_tpu_torch import cohort as _cohort
    from metrics_tpu_torch import engine as _engine
    from metrics_tpu_torch import metric as _metric
    from metrics_tpu_torch.reliability import checkpoint as _ckpt

    surfaces = [
        ("dispatch", _engine.CompiledStepEngine.step),
        ("dispatch", _engine.CompiledStepEngine._apply_guard_verdicts),
        ("sync", _metric.Metric._sync_dist_impl),
        ("sync", _cohort.MetricCohort._sync_stacked),
        ("compute", _metric.Metric._wrap_compute),
        ("checkpoint", _ckpt.save_envelope),
        ("checkpoint", _ckpt._np),
        ("health", _cohort.MetricCohort.health),
    ]
    for phase, fn in surfaces:
        try:
            src = textwrap.dedent(inspect.getsource(fn))
            base_line = inspect.getsourcelines(fn)[1]
            rel = os.path.relpath(inspect.getsourcefile(fn), _repo_root())
            tree = ast.parse(src)
        except (OSError, TypeError, SyntaxError):
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = (
                node.func.attr if isinstance(node.func, ast.Attribute)
                else node.func.id if isinstance(node.func, ast.Name) else None
            )
            kind = _to_kind(node) if name == "to" else _CROSSING_CALLS.get(name or "")
            if kind is None:
                continue
            _SITES_CACHE.append({
                "phase": phase,
                "site": f"{rel}:{base_line + node.lineno - 1}",
                "call": name,
                "kind": kind,
            })
    return list(_SITES_CACHE)


# ---------------------------------------------------------------------------
# MTA009 — double-buffer prover
# ---------------------------------------------------------------------------
_WRITEBACK_CACHE: Dict[str, bool] = {}


def writeback_generation_monotonic() -> bool:
    """True iff ``CompiledStepEngine.step`` calls ``_current_states`` (the
    states generation N steps from) and ``_write_back`` (installing
    generation N+1) inside one ``with self._lock`` extent. AST-checked once
    per process against the shipped engine source."""
    if "locked" in _WRITEBACK_CACHE:
        return _WRITEBACK_CACHE["locked"]
    from metrics_tpu_torch.engine import CompiledStepEngine

    verdict = False
    try:
        tree = ast.parse(textwrap.dedent(inspect.getsource(CompiledStepEngine.step)))
    except (OSError, TypeError, SyntaxError):
        _WRITEBACK_CACHE["locked"] = False
        return False

    def _is_engine_lock(expr: ast.AST) -> bool:
        return (
            isinstance(expr, ast.Attribute)
            and expr.attr == "_lock"
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
        )

    for node in ast.walk(tree):
        if not isinstance(node, ast.With):
            continue
        if not any(_is_engine_lock(item.context_expr) for item in node.items):
            continue
        called = {n.func.attr for n in ast.walk(node) if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
        if {"_current_states", "_write_back"} <= called:
            verdict = True
            break
    _WRITEBACK_CACHE["locked"] = verdict
    return verdict


def _bare_self_attrs(value: ast.AST) -> List[str]:
    """Attribute names read as bare ``self.<attr>`` expressions at the top
    level of an assignment value (the whole value, or the elements of a
    tuple / list / dict literal). Wrapped reads (``torch.sum(self.acc)``,
    ``self.acc + 0``) make new tensors and are no reference escape."""
    out: List[str] = []
    candidates: List[ast.AST] = [value]
    if isinstance(value, (ast.Tuple, ast.List)):
        candidates = list(value.elts)
    elif isinstance(value, ast.Dict):
        candidates = [v for v in value.values if v is not None]
    for node in candidates:
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) and node.value.id == "self":
            out.append(node.attr)
    return out


def _host_reference_hazards(cls: type, state_names: Set[str]) -> List[Tuple[str, str, str, int]]:
    """``(flavor, method, attr, lineno)`` for every assignment in the metric
    class's own methods (the package's base classes excluded) that

    * ``state_ref_escape``: stashes a registered state bare into a non-state
      attribute (``self._cache = self.acc``): a host reference to a state
      the next generation replaces;
    * ``host_cached_seed``: (re)seeds a registered state bare from a
      non-state attribute (``self.acc = self._zeros``): every generation
      after it starts on the same held tensor.

    ``__init__`` is exempt: it runs before any step."""
    hazards: List[Tuple[str, str, str, int]] = []
    skip_modules = ("metrics_tpu_torch.metric", "metrics_tpu_torch.collections", "builtins")
    for klass in cls.__mro__:
        if klass.__module__ in skip_modules or klass is object:
            continue
        try:
            tree = ast.parse(textwrap.dedent(inspect.getsource(klass)))
        except (OSError, TypeError, SyntaxError):
            continue
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) or fn.name == "__init__":
                continue
            for node in ast.walk(fn):
                # plain assignments only: an AugAssign computes a new tensor
                if not isinstance(node, ast.Assign):
                    continue
                sources = _bare_self_attrs(node.value)
                if not sources:
                    continue
                for target in node.targets:
                    if not (
                        isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"
                    ):
                        continue
                    tname = target.attr
                    if tname not in state_names and any(s in state_names for s in sources):
                        hazards.append(("state_ref_escape", fn.name, tname, node.lineno))
                    elif (
                        tname in state_names
                        and any(s not in state_names and not s.startswith("_defaults") for s in sources)
                        and not any(s in state_names for s in sources)
                    ):
                        hazards.append(("host_cached_seed", fn.name, tname, node.lineno))
    return hazards


def _storage(t: Any) -> Any:
    """The storage address of a non-empty tensor, else None."""
    if isinstance(t, torch.Tensor) and t.numel():
        return t.untyped_storage().data_ptr()
    return None


def tensor_leaves(tree: Any) -> Iterable[torch.Tensor]:
    """Every tensor in a tree of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensor_leaves(v)


def engine_owned(engine: Any) -> Set[int]:
    """Storages the step engine owns and writes on a later step: its state
    buffers and every graph's static inputs, state buffers and captured
    outputs."""
    owned = {_storage(b) for b in engine._state_buffers.values()}
    for program in list(engine._compiled.values()):
        if program is not None:
            owned |= {_storage(t) for t in tensor_leaves((program.inputs, program.states, program.merged,
                                                          program.outputs))}
    owned.discard(None)
    return owned


def first_dispatch_hazards(
    states: List[Tuple[str, torch.Tensor]], owned: Set[int], defaults: Set[int], values: Any
) -> List[Dict[str, Any]]:
    """Hazards after the first step, on real tensors: each installed state
    must own its storage (no engine buffer: ``donated_passthrough``; no
    default: ``const_state_output``; no other state:
    ``duplicate_state_output``), and no value the step returned may share
    storage with a state or an engine buffer (``cross_generation_alias``).
    An empty list: the next generation cannot write what this one holds."""
    hazards: List[Dict[str, Any]] = []
    seen: Dict[int, str] = {}
    for pos, (name, t) in enumerate(states):
        ptr = _storage(t)
        if ptr is None:
            continue
        if ptr in defaults:
            hazards.append({"kind": "const_state_output", "position": pos, "state": name})
            continue
        if ptr in owned:
            hazards.append({"kind": "donated_passthrough", "position": pos, "state": name})
        if ptr in seen:
            hazards.append({"kind": "duplicate_state_output", "position": pos, "state": name, "shares": seen[ptr]})
        seen.setdefault(ptr, name)
    for off, t in enumerate(tensor_leaves(values)):
        ptr = _storage(t)
        if ptr is not None and (ptr in seen or ptr in owned):
            hazards.append({"kind": "cross_generation_alias", "position": len(states) + off, "state": seen.get(ptr)})
    return hazards


def _graph_roles(closed: Any, n_donated: int, n_state_outputs: int):
    """``(donated, state_out, rest)`` of a step graph: the storage roots of
    its first ``n_donated`` placeholders (the states it steps from, copied
    into graph buffers where the JAX package donates them), and its first
    ``n_state_outputs`` outputs and the rest, each as ``(output, storage
    root)``; a non-node output (a literal) has root None."""
    from metrics_tpu_torch.analysis.program import _outputs, _placeholders, _storage_root

    donated = set(_placeholders(closed)[:n_donated])
    roots = [(v, _storage_root(v) if isinstance(v, torch.fx.Node) else None) for v in _outputs(closed)]
    return donated, roots[:n_state_outputs], roots[n_state_outputs:]


def _is_constant(root: Any) -> bool:
    """A literal output, or one whose storage is a tensor constant of the
    graph (a ``get_attr``): storage the program owns and hands back on
    every call."""
    return root is None or (isinstance(root, torch.fx.Node) and root.op == "get_attr")


def check_double_buffer(
    metric,
    findings: List[Finding],
    infos: List[str],
    step_closed: Any = None,
    n_donated: int = 0,
    n_state_outputs: int = 0,
    engine_eligible: bool = False,
) -> Optional[Dict[str, Any]]:
    """MTA009: prove (or refute) two-generation safety for one family.
    Returns the ``evidence["double_buffer"]`` verdict, or None for families
    that never run compiled (eager-only).

    Generation N steps from buffer set A (the first ``n_donated``
    placeholders), produces state outputs B (the first ``n_state_outputs``
    outputs: what ``_write_back`` installs and generation N+1 steps from)
    and host-read outputs V (the rest). Safe iff B is fully fresh and
    disjoint from A ∪ V. A hazard a pass-1/3 rule already diagnoses (an
    input state in B: MTA007's passthrough; duplicates: MTA003) marks the
    verdict unsafe without a second finding. MTA009 findings are the
    hazards only this pass sees: a graph constant in B, a host-read output
    aliased into B beyond what MTA003 reported, and the AST-level host
    references."""
    if not engine_eligible:
        return None
    cls = type(metric).__name__
    evidence: Dict[str, Any] = {"safe": True, "hazards": [], "writeback_locked": writeback_generation_monotonic()}
    # a buffer-lifetime defect (MTA007) already voids two generations: fold
    # it into the verdict without a second finding
    for f in findings:
        if f.rule == "MTA007":
            evidence["safe"] = False
            evidence["hazards"].append({"kind": "donation_lifetime", "subject": f.subject, "diagnosed_as": "MTA007"})
    if not evidence["writeback_locked"]:
        evidence["safe"] = False
        evidence["hazards"].append({"kind": "writeback_unordered"})
        findings.append(Finding(
            "MTA009", f"{cls}.step",
            "the engine's donate->dispatch->write_back sequence is not"
            " serialized under the engine lock: two concurrent steps could"
            " install generations out of order",
        ))
    if step_closed is None:
        # nothing traced, nothing proven — but a verdict already refuted
        # stays refuted
        if evidence["safe"] is True:
            evidence["safe"] = None
        infos.append(f"{cls}: MTA009 double-buffer verdict not provable from the step program — it did not trace")
    else:
        donated, state_out, value_out = _graph_roles(step_closed, n_donated, n_state_outputs)
        seen: Dict[Any, int] = {}
        for pos, (v, root) in enumerate(state_out):
            if _is_constant(root):
                # every generation hands back the same buffer
                evidence["safe"] = False
                evidence["hazards"].append({"kind": "const_state_output", "position": pos, "var": str(v)})
                findings.append(Finding(
                    "MTA009", f"{cls}.step",
                    f"state output position {pos} is an executable-owned"
                    f" constant ({v}): generation N and N+1 share (and"
                    " double-donate) one buffer — ping-pong generations can"
                    " never be disjoint for this state",
                    detail={"position": pos, "var": str(v)},
                ))
                continue
            if root in donated:
                evidence["safe"] = False
                evidence["hazards"].append(
                    {"kind": "donated_passthrough", "position": pos, "var": str(v), "diagnosed_as": "MTA007"}
                )
            if root in seen:
                evidence["safe"] = False
                evidence["hazards"].append(
                    {"kind": "duplicate_state_output", "position": pos, "var": str(v), "diagnosed_as": "MTA003"}
                )
            seen[root] = pos
        mta003_reported = any(f.rule == "MTA003" and f.subject.endswith(".step") for f in findings)
        for off, (v, root) in enumerate(value_out):
            if root is None:
                continue
            if root in seen or root in donated:
                position = n_state_outputs + off
                evidence["safe"] = False
                evidence["hazards"].append({"kind": "host_read_of_donated", "position": position, "var": str(v)})
                if not (mta003_reported and root in seen):
                    findings.append(Finding(
                        "MTA009", f"{cls}.step",
                        f"host-read output (position {position},"
                        f" var {v}) aliases a buffer the next generation"
                        " donates: reading the batch value while dispatch N+1"
                        " is enqueued touches an in-flight donated buffer",
                        detail={"position": position, "var": str(v)},
                    ))
    for flavor, method, attr, lineno in _host_reference_hazards(type(metric), set(metric._defaults)):
        evidence["safe"] = False
        evidence["hazards"].append({"kind": flavor, "method": method, "attr": attr})
        if flavor == "state_ref_escape":
            message = (
                f"{method}() stashes registered state into plain attribute"
                f" {attr!r} (line {lineno}): a host reference the next"
                " donated dispatch kills — any later read (guard epilogue,"
                " health fetch, telemetry gauge, user code) touches an"
                " in-flight donated buffer"
            )
        else:
            message = (
                f"{method}() reseeds registered state {attr!r} from a"
                f" host-cached attribute (line {lineno}): generation N+1's"
                " state buffer aliases storage generation N donated — the"
                " two generations ping-pong requires to be disjoint share"
                " one buffer"
            )
        findings.append(Finding(
            "MTA009", f"{cls}.{attr}", message, detail={"method": method, "attr": attr, "flavor": flavor},
        ))
    return evidence


def composed_generation_hazards(closed: Any, n_donated: int, n_state_outputs: int) -> List[Dict[str, Any]]:
    """Hazards of the two-generation graph
    (:meth:`~metrics_tpu_torch.engine.CompiledStepEngine.abstract_double_buffer_step`):
    generation N's state outputs (the first ``n_state_outputs`` outputs,
    what generation N+1 steps from) must be fresh (no input state, no graph
    constant, pairwise distinct storage) and disjoint from every later
    output (either generation's host-read values, generation N+1's states).
    An empty list: the interleave is alias-free. The cross-check of
    :func:`check_double_buffer` on the real composition."""
    donated, state_out, rest = _graph_roles(closed, n_donated, n_state_outputs)
    hazards: List[Dict[str, Any]] = []
    seen: Set[Any] = set()
    for pos, (v, root) in enumerate(state_out):
        if _is_constant(root):
            hazards.append({"kind": "const_state_output", "position": pos, "var": str(v)})
            continue
        if root in donated:
            hazards.append({"kind": "donated_passthrough", "position": pos, "var": str(v)})
        if root in seen:
            hazards.append({"kind": "duplicate_state_output", "position": pos, "var": str(v)})
        seen.add(root)
    for off, (v, root) in enumerate(rest):
        if root is not None and (root in seen or root in donated):
            hazards.append({"kind": "cross_generation_alias", "position": n_state_outputs + off, "var": str(v)})
    return hazards


# ---------------------------------------------------------------------------
# MTL106 — thread-shared-state lint
# ---------------------------------------------------------------------------
_HANDLER_METHODS = {"do_GET", "do_POST", "do_PUT", "do_DELETE", "do_HEAD", "do_PATCH"}


def _lockish(expr: ast.AST) -> bool:
    """Does this ``with`` context expression name a lock? Matched by name
    — a ``Name``/``Attribute`` whose final component contains "lock"
    (``self._lock``, ``_REGISTRY_LOCK``, ``cv.lock``) — or an
    ``acquire()`` call on one."""
    if isinstance(expr, ast.Call):
        return _lockish(expr.func)
    name = None
    if isinstance(expr, ast.Attribute):
        name = expr.attr
    elif isinstance(expr, ast.Name):
        name = expr.id
    return name is not None and "lock" in name.lower()


@dataclass
class _Access:
    attr: str
    lineno: int
    write: bool
    locked: bool


@dataclass
class _ScopeInfo:
    """Accesses and calls of one function scope."""

    node: Any
    name: str
    cls: Optional[str]  # nearest enclosing class name, if any
    self_accesses: List[_Access] = field(default_factory=list)
    global_writes: List[_Access] = field(default_factory=list)
    global_reads: Set[str] = field(default_factory=set)
    self_calls: Set[str] = field(default_factory=set)
    name_calls: Set[str] = field(default_factory=set)
    # names this scope BINDS locally (params, non-`global` assignments):
    # a load of one of these shadows any same-named module global
    local_names: Set[str] = field(default_factory=set)

    def touched_globals(self) -> Set[str]:
        return (self.global_reads - self.local_names) | {
            a.attr for a in self.global_writes
        }


class _ScopeWalker(ast.NodeVisitor):
    """Collects one function's accesses, stopping at nested scopes (each
    nested def/lambda is its own :class:`_ScopeInfo`)."""

    def __init__(self, info: _ScopeInfo, module_globals: Set[str]):
        self.info = info
        self.module_globals = module_globals
        self._lock_depth = 0
        self._declared_global: Set[str] = set()
        self._root = info.node
        args = getattr(info.node, "args", None)
        if args is not None:  # parameters are local bindings
            for a in args.posonlyargs + args.args + args.kwonlyargs:
                info.local_names.add(a.arg)
            for va in (args.vararg, args.kwarg):
                if va is not None:
                    info.local_names.add(va.arg)

    def visit(self, node):  # noqa: D102 — scope barrier
        if node is not self._root and isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)
        ):
            return  # nested scope: analyzed separately
        super().visit(node)

    def visit_Global(self, node: ast.Global) -> None:
        self._declared_global.update(node.names)

    def visit_With(self, node: ast.With) -> None:
        locked = any(_lockish(item.context_expr) for item in node.items)
        for item in node.items:
            self.visit(item.context_expr)
        if locked:
            self._lock_depth += 1
        for child in node.body:
            self.visit(child)
        if locked:
            self._lock_depth -= 1

    visit_AsyncWith = visit_With

    def _note_target(self, target: ast.AST, lineno: int) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._note_target(elt, lineno)
        elif (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
        ):
            self.info.self_accesses.append(
                _Access(target.attr, lineno, True, self._lock_depth > 0)
            )
        elif isinstance(target, ast.Name):
            if target.id in self._declared_global:
                self.info.global_writes.append(
                    _Access(target.id, lineno, True, self._lock_depth > 0)
                )
            else:
                # an undeclared assignment makes the name LOCAL for the
                # whole scope: its loads shadow any module global
                self.info.local_names.add(target.id)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._note_target(t, node.lineno)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._note_target(node.target, node.lineno)
        self.visit(node.value)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.value, ast.Name) and node.value.id == "self" and isinstance(
            node.ctx, ast.Load
        ):
            self.info.self_accesses.append(
                _Access(node.attr, node.lineno, False, self._lock_depth > 0)
            )
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Load):
            if node.id in self.module_globals:
                self.info.global_reads.add(node.id)
        elif node.id not in self._declared_global:
            # Store/Del of an undeclared name: a local binding (for-loop
            # targets, with-as, comprehensions) shadowing any global
            self.info.local_names.add(node.id)

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if (
            isinstance(fn, ast.Attribute)
            and isinstance(fn.value, ast.Name)
            and fn.value.id == "self"
        ):
            self.info.self_calls.add(fn.attr)
        elif isinstance(fn, ast.Name):
            self.info.name_calls.add(fn.id)
        self.generic_visit(node)


class _ModuleThreadModel:
    """The per-module thread-reachability model behind MTL106 and the
    ThreadSan arm-time instrumentation."""

    def __init__(self, tree: ast.Module):
        self.tree = tree
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.module_globals = {
            t.id
            for node in tree.body
            if isinstance(node, (ast.Assign, ast.AnnAssign))
            for t in (node.targets if isinstance(node, ast.Assign) else [node.target])
            if isinstance(t, ast.Name)
        }
        self.scopes: Dict[ast.AST, _ScopeInfo] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                name = getattr(node, "name", "<lambda>")
                info = _ScopeInfo(node, name, self._owner_class(node))
                _ScopeWalker(info, self.module_globals).visit(node)
                self.scopes[node] = info
        # one pass builds every lookup table the reachability walk needs —
        # rebuilding them per resolved call would make the lint quadratic
        # in module size
        self._methods_by_class: Dict[str, Dict[str, ast.AST]] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                methods = self._methods_by_class.setdefault(node.name, {})
                for child in node.body:
                    if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        methods[child.name] = child
        self._module_fns: Dict[str, ast.AST] = {
            node.name: node
            for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        self.entries = self._thread_entries()
        self.thread_scopes = self._reachable(self.entries)

    # -- structure ------------------------------------------------------
    def _owner_class(self, node: ast.AST) -> Optional[str]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur.name
            cur = self.parents.get(cur)
        return None

    def _enclosing_scope(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return cur
            cur = self.parents.get(cur)
        return None

    def _class_methods(self, cls_name: str) -> Dict[str, ast.AST]:
        return self._methods_by_class.get(cls_name, {})

    def _module_functions(self) -> Dict[str, ast.AST]:
        return self._module_fns

    def _resolve_name(self, name: str, from_scope: Optional[ast.AST]) -> Optional[ast.AST]:
        # nested defs of the enclosing scope first (worker closures), then
        # module-level functions
        if from_scope is not None:
            for node in ast.walk(from_scope):
                if (
                    isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node is not from_scope
                    and node.name == name
                ):
                    return node
        return self._module_functions().get(name)

    # -- thread entries -------------------------------------------------
    def _thread_entries(self) -> List[ast.AST]:
        entries: List[ast.AST] = []
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef):
                for child in node.body:
                    if (
                        isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and child.name in _HANDLER_METHODS
                    ):
                        entries.append(child)
            if not isinstance(node, ast.Call):
                continue
            callee = (
                node.func.attr if isinstance(node.func, ast.Attribute)
                else node.func.id if isinstance(node.func, ast.Name) else None
            )
            if callee not in ("Thread", "Timer"):
                continue
            target: Optional[ast.AST] = None
            for kw in node.keywords:
                if kw.arg in ("target", "function"):
                    target = kw.value
            if target is None and callee == "Timer" and len(node.args) >= 2:
                target = node.args[1]
            if target is None:
                continue
            scope = self._enclosing_scope(node)
            resolved: Optional[ast.AST] = None
            if isinstance(target, ast.Lambda):
                resolved = target
            elif isinstance(target, ast.Name):
                resolved = self._resolve_name(target.id, scope)
            elif (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
            ):
                owner = self._owner_class(node)
                if owner is not None:
                    resolved = self._class_methods(owner).get(target.attr)
            if resolved is not None:
                entries.append(resolved)
        return entries

    def _reachable(self, entries: Sequence[ast.AST]) -> Set[ast.AST]:
        seen: Set[ast.AST] = set()
        stack = list(entries)
        while stack:
            node = stack.pop()
            if node in seen or node not in self.scopes:
                continue
            seen.add(node)
            info = self.scopes[node]
            # nested defs of a thread entry run on the thread too
            for sub in ast.walk(node):
                if sub is not node and isinstance(
                    sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    stack.append(sub)
            if info.cls is not None:
                methods = self._class_methods(info.cls)
                stack.extend(
                    methods[m] for m in info.self_calls if m in methods
                )
            for name in info.name_calls:
                resolved = self._resolve_name(name, node)
                if resolved is not None:
                    stack.append(resolved)
        return seen

    # -- the verdicts ---------------------------------------------------
    def shared_attrs(self) -> Dict[str, Dict[str, List[_Access]]]:
        """``{class: {attr: [accesses]}}`` for every instance attribute
        accessed (outside ``__init__``) from both the thread side and the
        main side of a class that participates in threading."""
        per_class: Dict[str, Dict[str, Dict[str, List[_Access]]]] = {}
        for node, info in self.scopes.items():
            if info.cls is None or info.name == "__init__":
                continue
            side = "thread" if node in self.thread_scopes else "main"
            for acc in info.self_accesses:
                per_class.setdefault(info.cls, {}).setdefault(
                    acc.attr, {"thread": [], "main": []}
                )[side].append(acc)
        shared: Dict[str, Dict[str, List[_Access]]] = {}
        for cls_name, attrs in per_class.items():
            for attr, sides in attrs.items():
                if sides["thread"] and sides["main"]:
                    shared.setdefault(cls_name, {})[attr] = (
                        sides["thread"] + sides["main"]
                    )
        return shared

    def shared_globals(self) -> Dict[str, List[_Access]]:
        """Module globals written from a thread-reachable scope and also
        touched from the main side (or vice versa)."""
        thread_touch: Set[str] = set()
        main_touch: Set[str] = set()
        writes: Dict[str, List[_Access]] = {}
        for node, info in self.scopes.items():
            side_thread = node in self.thread_scopes
            (thread_touch if side_thread else main_touch).update(
                info.touched_globals()
            )
            for acc in info.global_writes:
                writes.setdefault(acc.attr, []).append(acc)
        return {
            name: accs
            for name, accs in writes.items()
            if name in thread_touch and name in main_touch
        }

    def lock_attr_for(self, cls_name: str) -> Optional[str]:
        """The owning lock of a class: the first ``self.<attr> =
        threading.Lock()/RLock()/Condition()`` assignment in its
        ``__init__`` (or any method)."""
        for node, info in self.scopes.items():
            if info.cls != cls_name:
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Assign):
                    continue
                if not (
                    isinstance(sub.value, ast.Call)
                    and isinstance(sub.value.func, (ast.Attribute, ast.Name))
                ):
                    continue
                fn = sub.value.func
                ctor = fn.attr if isinstance(fn, ast.Attribute) else fn.id
                if ctor not in ("Lock", "RLock", "Condition"):
                    continue
                for t in sub.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        return t.attr
        return None


def _spawns_threads(tree: ast.Module) -> bool:
    """One cheap walk: does this module contain ANY candidate thread
    entry point (a `Thread`/`Timer` call or a `do_*` handler method)?
    The full scope/access model is only worth building when it does —
    the overwhelmingly common threadless module costs one walk, not the
    whole reachability analysis."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            callee = (
                node.func.attr if isinstance(node.func, ast.Attribute)
                else node.func.id if isinstance(node.func, ast.Name) else None
            )
            if callee in ("Thread", "Timer"):
                return True
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name in _HANDLER_METHODS:
                return True
    return False


def thread_findings(tree: ast.Module, rel_path: str) -> List[Finding]:
    """MTL106 over one module: unlocked writes to thread-shared instance
    attributes and module globals. Zero findings for modules that spawn
    no threads."""
    if not _spawns_threads(tree):
        return []
    model = _ModuleThreadModel(tree)
    if not model.entries:
        return []
    findings: List[Finding] = []
    for cls_name, attrs in sorted(model.shared_attrs().items()):
        for attr, accesses in sorted(attrs.items()):
            for acc in accesses:
                if acc.write and not acc.locked:
                    findings.append(Finding(
                        "MTL106", f"{rel_path}:{acc.lineno}",
                        f"`self.{attr}` of {cls_name} is shared across"
                        " thread entry points but this write holds no lock:"
                        " a cross-thread data race (torn update / lost"
                        " increment); guard it with the owning lock or give"
                        " the attribute a single owning thread",
                        detail={"line": acc.lineno, "class": cls_name, "attr": attr},
                    ))
    for name, accesses in sorted(model.shared_globals().items()):
        for acc in accesses:
            if not acc.locked:
                findings.append(Finding(
                    "MTL106", f"{rel_path}:{acc.lineno}",
                    f"module global `{name}` is written here without a lock"
                    " and is reachable from a thread entry point in this"
                    " module: a cross-thread data race",
                    detail={"line": acc.lineno, "global": name},
                ))
    return findings


# ---------------------------------------------------------------------------
# the ThreadSan model + runtime target registry
# ---------------------------------------------------------------------------
_MODEL_CACHE: List[Dict[str, Any]] = []
_MODEL_BUILT = [False]

# explicitly registered runtime targets (fixtures, user classes):
# (cls, attrs, lock_attr)
_EXTRA_TARGETS: List[Tuple[type, Tuple[str, ...], Optional[str]]] = []
_TARGET_LOCK = threading.Lock()


def thread_shared_model(root: Optional[str] = None) -> List[Dict[str, Any]]:
    """The statically inferred thread-shared surface of the package:
    ``[{"module", "qualname", "attrs", "lock"}]`` for every class whose
    instance attributes are reachable from more than one thread entry
    point — locked or not. This is what ThreadSan
    (:mod:`metrics_tpu_torch.analysis.sanitizer`) instruments at arm
    time: properly locked attrs verify their discipline
    dynamically, flagged ones reproduce the static finding when the race
    actually happens. Classes
    defined inside function bodies (``<locals>`` qualnames) cannot be
    resolved at run time and are skipped."""
    if _MODEL_BUILT[0] and root is None:
        return list(_MODEL_CACHE)
    from metrics_tpu_torch.analysis.lint import default_lint_root

    base = root or default_lint_root()
    pkg_parent = os.path.dirname(base)
    model: List[Dict[str, Any]] = []
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    tree = ast.parse(fh.read())
            except (OSError, SyntaxError):
                continue
            if not _spawns_threads(tree):
                continue
            mod = _ModuleThreadModel(tree)
            if not mod.entries:
                continue
            shared = mod.shared_attrs()
            if not shared:
                continue
            rel = os.path.relpath(path, pkg_parent)
            dotted = rel[:-3].replace(os.sep, ".")
            # nested (method-local) classes are unresolvable at run time
            toplevel = {
                n.name for n in tree.body if isinstance(n, ast.ClassDef)
            }
            for cls_name, attrs in sorted(shared.items()):
                if cls_name not in toplevel:
                    continue
                model.append({
                    "module": dotted,
                    "qualname": cls_name,
                    "attrs": tuple(sorted(attrs)),
                    "lock": mod.lock_attr_for(cls_name),
                })
    if root is None:
        _MODEL_CACHE[:] = model
        _MODEL_BUILT[0] = True
    return list(model)


def register_threadsan_target(
    cls: type, attrs: Sequence[str], lock_attr: Optional[str] = "_lock"
) -> None:
    """Register a class for thread-sanitizer instrumentation the next
    time a sanitizer arms (idempotent per class). For classes outside the
    statically scanned package — test fixtures, user serving code — that
    want the same cross-thread write check."""
    with _TARGET_LOCK:
        for i, (existing, _, _) in enumerate(_EXTRA_TARGETS):
            if existing is cls:
                _EXTRA_TARGETS[i] = (cls, tuple(attrs), lock_attr)
                return
        _EXTRA_TARGETS.append((cls, tuple(attrs), lock_attr))


def threadsan_targets() -> List[Tuple[type, Tuple[str, ...], Optional[str]]]:
    """Every runtime instrumentation target: the statically inferred
    package model (resolved to live classes) plus explicit
    registrations, merged per class — a class in both contributes the
    UNION of its watched attrs (an explicit lock wins over the inferred
    one), so :func:`register_threadsan_target` can always extend the
    watched set. Resolution failures are skipped silently — the model is
    advisory input to a sanitizer, not a gate."""
    import importlib

    raw: List[Tuple[type, Tuple[str, ...], Optional[str]]] = []
    for spec in thread_shared_model():
        try:
            module = importlib.import_module(spec["module"])
            cls = getattr(module, spec["qualname"])
        except Exception:  # noqa: BLE001 — advisory resolution
            continue
        if isinstance(cls, type):
            raw.append((cls, tuple(spec["attrs"]), spec["lock"]))
    with _TARGET_LOCK:
        raw.extend(_EXTRA_TARGETS)
    merged: Dict[int, Tuple[type, Set[str], Optional[str]]] = {}
    order: List[int] = []
    for cls, attrs, lock in raw:
        key = id(cls)
        if key not in merged:
            merged[key] = (cls, set(attrs), lock)
            order.append(key)
        else:
            prev_cls, prev_attrs, prev_lock = merged[key]
            merged[key] = (prev_cls, prev_attrs | set(attrs), lock or prev_lock)
    return [
        (cls, tuple(sorted(attrs)), lock)
        for cls, attrs, lock in (merged[k] for k in order)
    ]
