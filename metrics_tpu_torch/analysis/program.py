"""Pass 1 — trace-time audit of metric programs (FX graph level).

Port of ``metrics_tpu/analysis/program.py``. The runtime promises every
metric safe accumulation, sound cross-replica reduction, and copy-safe
engine buffers — and enforces them *dynamically*: the StateGuard catches
the NaN after it lands, the watchdog counts the rebuild after it happened,
the engine demotes to eager after a build dies. This pass proves (or
refutes) the same contracts **before dispatch** by tracing each metric's
program abstractly, with ``make_fx`` over fake tensors (shape, dtype and
device, no data):

* ``update`` on fresh default state with representative batch inputs —
  one abstract trace, nothing runs on a device;
* for engine-eligible metrics, the **step function the engine would build**
  via :meth:`CompiledStepEngine.abstract_step` — shared canonicalization,
  update, batch-local compute, and the reduction merge, exactly what a
  CUDA graph of a production step captures.

Both traces run with value checks off (``tracing()``), as the engine's
warm-up runs them; a host read left over (``.item()``, ``float()`` of a
tensor, ``.numpy()``) raises out of the fake trace and is reported as
MTA002's "host-sync" kind. A device→host copy that traces (``.cpu()`` of a
card tensor) is MTA002's "callback" kind: on a program whose device is the
CPU such a copy is no transfer, so that kind binds on the card.

The graph walker (:func:`iter_eqns`) recurses into every nested
``GraphModule`` a node reaches — the bodies of ``torch.cond``,
``while_loop`` and ``map`` — so a host transfer three levels deep is still
found.

Metrics that are *eager-only by design* (list/"cat" states, host-side
densification) are not held to compiled-path rules: their update programs
never run in a CUDA graph, so a host op there is architecture, not a
violation. They are reported as ``infos`` for visibility.

:func:`audit_registry` runs the audit over every metric family in
:func:`registry_cases` (the JAX package's 29 families, its factories and
its inputs) on a device (the card unless the caller asks for the CPU) and
returns a JSON-able report. For every engine-eligible family (and its
``@cohort`` / ``@int8`` / ``@bf16`` variants) pass 4
(:mod:`metrics_tpu_torch.analysis.concurrency`) adds
``AuditResult.evidence = {"host_seam": ..., "double_buffer": ...}``: the
host-seam budget gated against ``SEAM_BASELINE.json`` (MTA008) and the
double-buffer verdict over the step graph (MTA009); the report names the
port's host crossing sites (``host_seam_sites``). Pass 5
(:mod:`metrics_tpu_torch.analysis.numerics`) adds ``evidence["numerics"]``
to every entry, eager-only families included: overflow horizons (MTA010),
cancellation sites and the float64-measured error budget (MTA011) and the
equivariance verdict (MTA012), gated against ``NUMERICS_BASELINE.json``.

Differences from the JAX package, by design: tensors carry no
``weak_type``, so MTA001 has no weak-type check (PyTorch's 0-dim type
promotion shows up as dtype drift instead); MTA003 also flags an output
that is a view of, or an in-place write into, another output's storage;
the audit registry also feeds the fleet-protocol explorer's findings to
the watchdog's cross-link.
"""
import operator
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.analysis.rules import (
    RULES,
    Finding,
    class_allowed_rules,
    own_class_allowed_rules,
    state_allowed_rules,
)
from metrics_tpu_torch.parallel import quantize as _q
from metrics_tpu_torch.utilities.data import (
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
)

__all__ = [
    "AuditResult",
    "audit_collection",
    "audit_metric",
    "audit_registry",
    "hint_for_watch_key",
    "iter_eqns",
]

# names that mark a sum-reduced companion count for a "mean" state
_COUNT_STATE_HINTS = ("total", "count", "n_obs", "num", "weight", "denom", "support")

_KNOWN_REDUCTIONS = {
    dim_zero_sum: "sum",
    dim_zero_mean: "mean",
    dim_zero_cat: "cat",
    dim_zero_min: "min",
    dim_zero_max: "max",
}

#: ops that read a device value to the host inside a program
_SCALAR_READS = ("aten._local_scalar_dense",)
#: copies whose output device is the CPU: a transfer when their input is not
_COPIES = ("aten._to_copy", "aten.copy_", "aten.copy")


# ---------------------------------------------------------------------------
# FX graph plumbing
# ---------------------------------------------------------------------------
def _op_name(node: Any) -> str:
    """``aten.add.Tensor`` for an ATen overload; the name of anything else."""
    target = node.target
    if isinstance(target, torch._ops.OpOverload):
        return str(target)
    return getattr(target, "__name__", None) or getattr(target, "name", None) or str(target)


def _subgraphs(node: Any, owner: Any) -> Iterator[Any]:
    """Every ``GraphModule`` a node reaches through a ``get_attr`` argument
    of ``owner``: the branches of ``torch.cond``, the bodies of
    ``while_loop`` and ``map``, and anything later that stores a graph the
    same way."""
    if owner is None:
        return
    for arg in node.all_input_nodes:
        if arg.op != "get_attr":
            continue
        sub = owner
        for part in str(arg.target).split("."):
            sub = getattr(sub, part, None)
        if isinstance(sub, torch.fx.GraphModule):
            yield sub


def iter_eqns(graph: Any) -> Iterator[Any]:
    """Depth-first walk over every ``call_function`` node of ``graph`` (an
    FX ``GraphModule`` or ``Graph``) in program order, each followed by the
    nodes of every nested graph it reaches (``torch.cond`` branches,
    ``while_loop`` and ``map`` bodies)."""
    owner = graph if isinstance(graph, torch.fx.GraphModule) else None
    g = graph.graph if owner is not None else graph
    for node in g.nodes:
        if node.op != "call_function":
            continue
        yield node
        for sub in _subgraphs(node, owner):
            yield from iter_eqns(sub)


def _device_type(node: Any) -> Optional[str]:
    v = node.meta.get("val") if isinstance(node, torch.fx.Node) else None
    return v.device.type if isinstance(v, torch.Tensor) else None


def _is_transfer(node: Any) -> bool:
    """A device→host read: a scalar read, or a copy whose output lies on
    the CPU while its input does not."""
    name = _op_name(node)
    if name.startswith(_SCALAR_READS):
        return True
    if not name.startswith(_COPIES):
        return False
    src = node.args[1] if name.startswith("aten.copy_") and len(node.args) > 1 else node.args[0]
    return _device_type(node) == "cpu" and _device_type(src) not in (None, "cpu")


def _callback_eqns(graph: Any) -> List[str]:
    """Names of the host transfers in ``graph``, subgraphs included."""
    return [_op_name(n) for n in iter_eqns(graph) if _is_transfer(n)]


def _outputs(graph: Any) -> List[Any]:
    """The flat output list of a traced program."""
    g = graph.graph if isinstance(graph, torch.fx.GraphModule) else graph
    out = next(n for n in reversed(g.nodes) if n.op == "output")
    res = out.args[0]
    return list(res) if isinstance(res, (tuple, list)) else [res]


def _placeholders(graph: Any) -> List[Any]:
    g = graph.graph if isinstance(graph, torch.fx.GraphModule) else graph
    return [n for n in g.nodes if n.op == "placeholder"]


def _aliases_first_arg(node: Any) -> bool:
    """True when ``node``'s output shares its first argument's storage: a
    view op, or an op whose schema marks its first argument as written (an
    in-place op)."""
    target = node.target
    if not isinstance(target, torch._ops.OpOverload) or not node.args:
        return False
    if target.is_view:
        return True
    args = target._schema.arguments
    return bool(args) and args[0].alias_info is not None and args[0].alias_info.is_write


def _storage_root(node: Any) -> Any:
    """The node whose storage ``node``'s output lives in: views and in-place
    writes followed back to their base (an item of a multi-output view op,
    such as ``split``, too)."""
    while isinstance(node, torch.fx.Node) and node.op == "call_function":
        if node.target is operator.getitem:
            base = node.args[0]
            if isinstance(base, torch.fx.Node) and _aliases_first_arg(base):
                node = base.args[0]
                continue
            return node
        if _aliases_first_arg(node) and isinstance(node.args[0], torch.fx.Node):
            node = node.args[0]
            continue
        return node
    return node


def _duplicate_outvars(graph: Any) -> List[Tuple[int, List[int]]]:
    """Output positions backed by one storage: ``(count, positions)`` for
    every node that backs more than one output, itself or through a view or
    an in-place write. Two outputs sharing a buffer leave two live states
    aliased (or, under donation, double-donate it)."""
    seen: Dict[Any, List[int]] = {}
    for pos, n in enumerate(_outputs(graph)):
        if not isinstance(n, torch.fx.Node):
            continue
        seen.setdefault(_storage_root(n), []).append(pos)
    return [(len(p), p) for p in seen.values() if len(p) > 1]


def _trace_error_kind(err: BaseException) -> Optional[str]:
    """Classify a trace failure: a read of a fake tensor's value (``.item()``,
    ``float()``, ``.numpy()``, a data-dependent output shape) or the sync
    debug mode's refusal is a host sync; anything else is a generic trace
    failure."""
    from torch._subclasses.fake_tensor import (
        DataDependentOutputException,
        DynamicOutputShapeException,
    )
    from torch.fx.experimental.symbolic_shapes import GuardOnDataDependentSymNode

    if isinstance(err, (GuardOnDataDependentSymNode, DataDependentOutputException, DynamicOutputShapeException)):
        return "host-sync"
    msg = str(err)
    if isinstance(err, RuntimeError) and (
        ".numpy() is not supported for tensor subclasses" in msg
        or "synchronizing CUDA operation" in msg
    ):
        return "host-sync"
    return "trace-failure"


def _fake_trace(fn: Callable, call: tuple) -> Tuple[Any, Any]:
    """:func:`~metrics_tpu_torch.engine.fake_trace` with value checks off and
    the telemetry hooks muted: an analysis trace is no step."""
    from metrics_tpu_torch.engine import fake_trace
    from metrics_tpu_torch.observability import trace as _trace
    from metrics_tpu_torch.utilities.data import tracing

    with tracing(), _trace.muted():
        return fake_trace(fn, call)


def _np(x: Any) -> np.ndarray:
    """A tensor's values on the host (bfloat16 widened to float32, which
    holds every bfloat16 exactly)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.to(torch.float32)
    return x.cpu().numpy()


# ---------------------------------------------------------------------------
# single-metric audit
# ---------------------------------------------------------------------------
@dataclass
class AuditResult:
    """Findings for one metric program."""

    name: str
    engine_eligible: bool
    eager_reason: Optional[str] = None
    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    infos: List[str] = field(default_factory=list)
    # pass-3 evidence: MTA005 replica counts verified, bit-identity, and
    # worst state/value deltas (None when the metric was not equivalence-
    # probed — eager-only families, unshardable batches)
    distributed: Optional[Dict[str, Any]] = None
    # graph digests (ops × dtypes × shapes) of the update and compiled
    # step programs, when fingerprinting was requested
    fingerprints: Optional[Dict[str, Optional[str]]] = None
    # pass-4 evidence of engine-eligible families ({"host_seam": budget,
    # "double_buffer": verdict}) and pass 5's {"numerics": ...} on every
    # family (eager-only families carry only that key)
    evidence: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "engine_eligible": self.engine_eligible,
            "eager_reason": self.eager_reason,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "infos": list(self.infos),
            "distributed": self.distributed,
            "fingerprints": self.fingerprints,
            "evidence": self.evidence,
        }


def _update_program(metric) -> Callable:
    """The metric's update as a pure ``states, args, kwargs -> new_states``
    function (the same temporary-attribute reuse the engine's step function
    performs), restorable even when tracing raises."""

    def fn(states, args, kwargs):
        saved = metric._snapshot_state()
        try:
            for k, v in states.items():
                setattr(metric, k, v)
            metric.update(*args, **metric._filter_kwargs(**kwargs))
            return {k: getattr(metric, k) for k in metric._defaults}
        finally:
            metric._restore_state(saved)
            metric._computed = None

    return fn


def _default_states(metric) -> Dict[str, Any]:
    """Fresh default states: copies, so an update that writes in place
    never reaches a registered default."""
    return {k: ([] if isinstance(d, list) else d.clone()) for k, d in metric._defaults.items()}


def _tensor_leaves(tree: Any) -> List[torch.Tensor]:
    from metrics_tpu_torch.engine import _flatten

    leaves: List[Any] = []
    _flatten(tree, leaves)
    return [x for x in leaves if isinstance(x, torch.Tensor)]


def _widest_float_input(args: tuple, kwargs: dict) -> Optional[torch.dtype]:
    widest = None
    for leaf in _tensor_leaves((args, kwargs)):
        if leaf.is_floating_point():
            if widest is None or leaf.dtype.itemsize > widest.itemsize:
                widest = leaf.dtype
    return widest


def _audit_reductions(metric, findings: List[Finding]) -> None:
    """MTA004: is every declared ``dist_reduce_fx`` a sound cross-replica
    merge for its state?

    Quantized-tier awareness: error-feedback residual companions
    (``<state>__qres``, registered by ``sync_precision=``) are library-
    managed LOCAL compensation state — never synced, so no reduction rule
    (including the mean-without-count pairing scan) binds them. States on a
    quantized tier are additionally probed through the quantize → gather →
    dequantize → sum composite: commutativity is checked on the DEQUANTIZED
    result and the merge must preserve magnitude within the tier's error
    bound (an *unscaled* int8 psum fails that and flags)."""
    cls = type(metric).__name__
    reductions = metric._reductions
    precisions = getattr(metric, "_sync_precisions", {}) or {}
    residual_names = set(metric._sync_residual_names())
    has_paired_count = any(
        reductions.get(s) is dim_zero_sum
        and s not in residual_names
        and any(h in s.lower() for h in _COUNT_STATE_HINTS)
        for s in metric._defaults
    )
    for sname, red in reductions.items():
        if sname in residual_names:
            continue  # local-only error-feedback state: never crosses the wire
        default = metric._defaults[sname]
        is_list = isinstance(default, list)
        subject = f"{cls}.{sname}"
        if precisions.get(sname, "exact") != "exact":
            note = _quantized_merge_probe(_q.quantized_sum_reduction(precisions[sname]), default)
            if note is not None:
                findings.append(Finding("MTA004", subject, note))
        if red is None:
            if not is_list:
                findings.append(Finding(
                    "MTA004", subject,
                    "array state declares no dist_reduce_fx; cross-replica sync"
                    " would leave it as a stacked (world, ...) array",
                ))
            continue  # list state: rank-order concat is the implied reduction
        kind = _KNOWN_REDUCTIONS.get(red)
        if kind == "mean":
            if not has_paired_count:
                findings.append(Finding(
                    "MTA004", subject,
                    "'mean' reduction with no paired sum-reduced count state:"
                    " mean-of-means is wrong whenever replicas see different"
                    " batch counts",
                ))
        elif kind is None:  # custom callable: probe commutativity
            if getattr(red, "quantized_precision", None) is not None:
                # a reduction that declares itself quantized is held to the
                # quantized contract: commutative on the dequantized result
                # AND magnitude-preserving within its precision's bound
                note = _quantized_merge_probe(red, default)
            else:
                note = _commutativity_probe(red, default)
            if note is not None:
                findings.append(Finding("MTA004", subject, note))
        if metric._fused_forward and not is_list and not type(metric)._merge_reduction_supported(red):
            findings.append(Finding(
                "MTA004", subject,
                f"fused-forward metric declares a non-mergeable"
                f" '{kind or getattr(red, '__name__', red)}' reduction; the"
                " one-update forward's (accumulated, batch) fold is undefined"
                " for it",
            ))
    # cat-state metrics must demote in compiled engines, never compile
    from metrics_tpu_torch.engine import CompiledStepEngine

    has_list_state = any(isinstance(d, list) for d in metric._defaults.values())
    if has_list_state and CompiledStepEngine._static_ineligibility(metric) is None:
        findings.append(Finding(
            "MTA004", cls,
            "cat-state metric reports as engine-compilable; per-step list"
            " growth cannot run as a fixed-signature donated program",
        ))


def _commutativity_probe(red: Callable, default: Any) -> Optional[str]:
    """Property-probe a custom reduction on a stacked 2-replica state:
    ``red(stack([a, b]))`` must equal ``red(stack([b, a]))`` (two-element
    folds of IEEE sum/min/max are bitwise order-independent, so a mismatch
    is structural, not rounding)."""
    if isinstance(default, list):
        return None  # list states concat rank-ordered; custom fx sees the flat list
    rng = np.random.RandomState(0xA4)
    shape = tuple(default.shape)
    if default.is_floating_point():
        raw = rng.rand(*((2,) + shape)).astype(np.float32) + 0.25
    else:
        raw = rng.randint(1, 17, size=(2,) + shape)
    a = torch.as_tensor(raw).to(device=default.device, dtype=default.dtype)
    try:
        fwd = red(a)
        rev = red(torch.flip(a, [0]))
    except Exception as err:  # noqa: BLE001 — the probe's failure is its finding
        return (
            f"custom reduction {getattr(red, '__name__', red)!r} failed the"
            f" commutativity probe outright ({type(err).__name__}: {err})"
        )
    if not np.allclose(_np(fwd), _np(rev), equal_nan=True):
        return (
            f"custom reduction {getattr(red, '__name__', red)!r} is"
            " order-dependent: red(stack([a, b])) != red(stack([b, a])), so"
            " every replica layout computes a different merged state"
        )
    return None


def _quantized_merge_probe(red: Callable, default: Any) -> Optional[str]:
    """Property-probe a quantized cross-replica merge on a stacked
    2-replica state. Two contracts, both on the DEQUANTIZED result:

    * **commutativity** — ``red(stack([a, b])) == red(stack([b, a]))``
      within the precision's error bound (per-row quantization makes a
      sound tier bitwise order-independent; the tolerance only forgives
      accumulation-order rounding);
    * **magnitude preservation** — ``red(stack([a, b])) ≈ a + b`` within
      the bound. This is what separates block-SCALED quantization from a
      bare low-precision cast: an unscaled int8 psum truncates fractional
      values to zero and saturates at ±127, destroying the very magnitudes
      the sum exists to accumulate — and must still flag.
    """
    if isinstance(default, list):
        return None
    precision = getattr(red, "quantized_precision", "int8")
    name = getattr(red, "__name__", repr(red))
    rng = np.random.RandomState(0x51)
    shape = tuple(default.shape)
    raw = rng.rand(*((2,) + shape)).astype(np.float32) * 2.0 + 0.25
    a = torch.as_tensor(raw, device=default.device)
    exact = (raw[0] + raw[1]).astype(np.float32)
    # per-replica error ≤ absmax_block/254 (int8, half a step) or a bf16
    # round (2^-8 relative); 2 replicas, ×4 safety for block padding edges
    absmax = float(np.abs(raw).max())
    per_row = absmax / 254.0 if precision == "int8" else absmax * 2.0 ** -8
    tol = 4.0 * 2 * per_row + 1e-6
    try:
        fwd = _np(red(a)).astype(np.float32)
        rev = _np(red(torch.flip(a, [0]))).astype(np.float32)
    except Exception as err:  # noqa: BLE001 — the probe's failure is its finding
        return (
            f"quantized reduction {name!r} failed the soundness probe outright"
            f" ({type(err).__name__}: {err})"
        )
    if not np.allclose(fwd, rev, atol=tol, equal_nan=True):
        return (
            f"quantized reduction {name!r} is order-dependent beyond its"
            f" precision's error bound ({precision}): the dequantized merge"
            " gives every replica layout a different state"
        )
    drift = float(np.abs(fwd - exact).max())
    if drift > tol:
        return (
            f"quantized reduction {name!r} is not magnitude-preserving:"
            f" |merged - exact sum| = {drift:.4g} exceeds the {precision}"
            f" error bound {tol:.4g} — an unscaled low-precision psum"
            " (no block scales) truncates/saturates the contributions it"
            " claims to sum"
        )
    return None


def _trace_update(metric, args: tuple, kwargs: dict) -> Tuple[Any, Any]:
    """``(graph, out_shapes)`` of ``update`` on fresh default state, over
    fake tensors on the metric's device."""
    return _fake_trace(_update_program(metric), (_default_states(metric), args, kwargs))


def _audit_traced_update(metric, args: tuple, kwargs: dict, findings: List[Finding],
                         infos: List[str], traceable_contract: bool) -> Optional[Any]:
    """Trace ``update`` abstractly; apply MTA001/MTA002/MTA003 to the
    resulting graph. ``traceable_contract`` is True when this metric claims
    it can run compiled (then any trace failure is a violation, not a
    design note). Returns the update graph (for fingerprinting), or None
    when the update is untraceable."""
    cls = type(metric).__name__
    try:
        graph, out_shape = _trace_update(metric, args, kwargs)
    except Exception as err:  # noqa: BLE001 — classify below
        kind = _trace_error_kind(err)
        msg = str(err).splitlines()[0] if str(err) else type(err).__name__
        if traceable_contract:
            findings.append(Finding(
                "MTA002", f"{cls}.update",
                ("host synchronization while tracing update"
                 if kind == "host-sync" else "update failed to trace")
                + f" ({type(err).__name__}: {msg}); the first compiled step"
                " will silently demote this metric to eager",
                detail={"kind": kind},
            ))
        else:
            infos.append(
                f"{cls}.update is untraceable ({type(err).__name__});"
                " eager-only by design, compiled-path rules not applied"
            )
        return None

    # compiled-path rules only bind metrics that claim they can compile:
    # an eager-only metric's update never runs in a captured step, so a
    # host transfer there is architecture and aliasing is harmless sharing
    callbacks = _callback_eqns(graph)
    if traceable_contract:
        if callbacks:
            findings.append(Finding(
                "MTA002", f"{cls}.update",
                f"host callback primitive(s) {sorted(set(callbacks))} inside the"
                " traced update program; every step dispatch will block on the"
                " host",
                detail={"primitives": sorted(set(callbacks))},
            ))

        for count, positions in _duplicate_outvars(graph):
            findings.append(Finding(
                "MTA003", f"{cls}.update",
                f"one buffer is aliased into {count} state outputs (output"
                f" positions {positions}); donation would double-donate it or"
                " leave live states sharing storage",
            ))
    elif callbacks:
        infos.append(
            f"{cls}.update contains host callback(s)"
            f" {sorted(set(callbacks))}; eager-only by design, so the"
            " compiled-path MTA002 rule is not applied"
        )

    widest_in = _widest_float_input(args, kwargs)
    for sname, default in metric._defaults.items():
        if isinstance(default, list):
            continue
        out = out_shape[sname]
        if out.dtype != default.dtype:
            findings.append(Finding(
                "MTA001", f"{cls}.{sname}",
                f"state dtype drifts {_dtype_name(default.dtype)} -> {_dtype_name(out.dtype)}"
                " across one update: every later step sees a new input"
                " signature and recompiles",
                detail={"before": _dtype_name(default.dtype), "after": _dtype_name(out.dtype)},
            ))
        if (
            widest_in is not None
            and default.is_floating_point()
            and default.dtype.itemsize < widest_in.itemsize
        ):
            findings.append(Finding(
                "MTA001", f"{cls}.{sname}",
                f"floating accumulator ({_dtype_name(default.dtype)}) is narrower than the"
                f" floating input it accumulates ({_dtype_name(widest_in)}): precision is"
                " silently destroyed at accumulation",
                detail={"state": _dtype_name(default.dtype), "input": _dtype_name(widest_in)},
            ))
    return graph


def _dtype_name(dtype: torch.dtype) -> str:
    """``float32`` for ``torch.float32``: the JAX package's dtype names."""
    return str(dtype).replace("torch.", "")


def _audit_engine_program(
    metric, args: tuple, kwargs: dict, findings: List[Finding]
) -> Optional[Tuple[Any, int, int]]:
    """Trace the step function the engine would build (update + batch-local
    compute + merge) and audit it: host transfers (MTA002) and buffers
    aliased across outputs (MTA003). Returns ``(graph, n_donated,
    n_state_outputs)`` for the donation-lifetime and double-buffer passes,
    or None when the step does not trace."""
    from metrics_tpu_torch.engine import CompiledStepEngine, _count_specs

    cls = type(metric).__name__
    engine = CompiledStepEngine(metric, observe=False)
    try:
        graph, out_shapes, n_donated = engine.abstract_step(*args, **kwargs)
    except Exception as err:  # noqa: BLE001 — the trace failure is the finding
        kind = _trace_error_kind(err)
        msg = str(err).splitlines()[0] if str(err) else type(err).__name__
        findings.append(Finding(
            "MTA002", f"{cls}.step",
            ("host synchronization while tracing the compiled step"
             if kind == "host-sync" else "compiled step failed to trace")
            + f" ({type(err).__name__}: {msg}); the engine will demote this"
            " metric to eager on its first dispatch",
            detail={"kind": kind},
        ))
        return None

    callbacks = _callback_eqns(graph)
    if callbacks:
        findings.append(Finding(
            "MTA002", f"{cls}.step",
            f"host callback primitive(s) {sorted(set(callbacks))} inside the"
            " compiled step program",
            detail={"primitives": sorted(set(callbacks))},
        ))
    for count, positions in _duplicate_outvars(graph):
        findings.append(Finding(
            "MTA003", f"{cls}.step",
            f"one buffer is aliased into {count} outputs of the donated step"
            f" program (output positions {positions}): donation double-books"
            " the buffer (state/state or state/batch-value alias)",
        ))
    # the state leaves lead the outputs: what _write_back installs and the
    # next generation steps from
    return graph, n_donated, _count_specs(out_shapes[0])


def _pass4_evidence(
    metric, findings: List[Finding], infos: List[str], graph: Any, n_donated: int, n_state_outs: int,
    family: Optional[str] = None, cohort: bool = False,
) -> Dict[str, Any]:
    """``{"host_seam": ..., "double_buffer": ...}`` of an engine-eligible
    family's step graph (None when it did not trace): MTA008 and MTA009."""
    from metrics_tpu_torch.analysis import concurrency as _conc

    return {
        "host_seam": _conc.check_host_seam(
            metric, findings, infos, family=family, step_closed=graph, cohort=cohort
        ),
        "double_buffer": _conc.check_double_buffer(
            metric, findings, infos, step_closed=graph,
            n_donated=n_donated if graph is not None else 0,
            n_state_outputs=n_state_outs, engine_eligible=True,
        ),
    }


def _add_pass5_evidence(
    result: AuditResult, metric, findings: List[Finding], args: tuple, kwargs: Optional[dict] = None,
    family: Optional[str] = None, cache: Optional[Dict[str, Any]] = None,
) -> None:
    """Adds ``evidence["numerics"]`` (pass 5: MTA010–MTA012) to any family's
    result; ``cache`` is the family's probe cache, shared by its variants."""
    from metrics_tpu_torch.analysis import numerics as _num

    result.evidence = {**(result.evidence or {}), "numerics": _num.check_numerics(
        metric, findings, result.infos, args=args, kwargs=kwargs, family=family, cache=cache,
    )}


def _route_suppressions(
    metric, findings: List[Finding], result: AuditResult, check_staleness: bool = True
) -> None:
    """Split raw findings into the result's ``findings``/``suppressed``
    buckets per the class-level and state-scoped allow sets, then flag
    stale suppressions (MTL105): allow entries declared on this class
    itself that suppressed nothing in this audit.

    ``check_staleness=False`` routes only — used by the slimmed
    ``sync_precision=`` variant audits, which deliberately skip whole rule
    passes (MTA001, the non-residual MTA006 checks): an allow earning its
    keep on the base audit must not read as stale in an audit that never
    ran the rule it suppresses."""
    allowed = class_allowed_rules(type(metric))
    scoped = state_allowed_rules(metric)  # instance-resolved: dynamic states
    for f in findings:
        state = f.subject.split(".", 1)[1] if "." in f.subject else None
        if f.rule in allowed or (state is not None and state in scoped.get(f.rule, ())):
            f.suppressed = True
            result.suppressed.append(f)
        else:
            result.findings.append(f)
    if not check_staleness:
        return
    # MTL105 (program-audit side): staleness is judged only against the
    # allows THIS class declares (own body / own attribute) — an inherited
    # allow may be earning its keep on the parent, which audits separately
    cls = type(metric).__name__
    used_rules = {f.rule for f in result.suppressed}
    used_states: Dict[str, set] = {}
    for f in result.suppressed:
        if "." in f.subject:
            used_states.setdefault(f.rule, set()).add(f.subject.split(".", 1)[1])
    own = own_class_allowed_rules(type(metric)) - {"MTL105"}
    for rule_id in sorted(own - used_rules):
        result.findings.append(Finding(
            "MTL105", cls,
            f"stale suppression: allow({rule_id}) declared on {cls}"
            " suppressed nothing in this audit — the violation it excused"
            " is gone; delete the allow before it hides a real one",
        ))
    own_attr = type(metric).__dict__.get("_analysis_allow", None)
    inst_attr = metric.__dict__.get("_analysis_allow", None)
    mapping = inst_attr if isinstance(inst_attr, dict) else (
        own_attr if isinstance(own_attr, dict) else None
    )
    if mapping:
        for rule_id, names in sorted(mapping.items()):
            stale = sorted(set(names) - used_states.get(rule_id, set()))
            if stale:
                result.findings.append(Finding(
                    "MTL105", cls,
                    f"stale state-scoped suppression: _analysis_allow"
                    f" {rule_id} names {stale} but no finding on those"
                    " states was suppressed in this audit",
                    detail={"rule": rule_id, "states": stale},
                ))


def audit_metric(
    metric,
    args: Sequence[Any] = (),
    kwargs: Optional[dict] = None,
    distributed: bool = True,
    fingerprint: bool = False,
    _probe_cache: Optional[Dict[str, Any]] = None,
) -> AuditResult:
    """Run the static audit over one metric with representative batch
    inputs (tensors on the metric's device).

    Rules applied — pass 1: MTA001 (accumulator dtype), MTA002 (host sync
    in traced regions), MTA003 (buffer aliasing), MTA004 (reduction
    soundness); pass 3 (``distributed=True``): MTA005 (N-replica
    equivalence on concrete probes), MTA006 (state lifecycle: reset
    identity, compute purity, residual coherence), MTA007 (donation
    lifetime); pass 4 (engine-eligible metrics): MTA008 (host-seam budget
    against ``SEAM_BASELINE.json``) and MTA009 (double-buffer safety);
    pass 5 (every metric): MTA010 (overflow horizons), MTA011 (cancellation
    sites and the float64-measured error budget) and MTA012 (equivariance),
    gated against ``NUMERICS_BASELINE.json``; their evidence in
    ``evidence``. ``fingerprint=True`` additionally digests the update and
    step graphs for the drift sentinel.

    Suppression: any rule named in a ``# metrics-tpu: allow(...)`` comment
    at class-body level (or in an iterable ``_analysis_allow`` attribute)
    is reported under ``suppressed`` instead of ``findings``; a mapping
    ``_analysis_allow = {rule_id: (state_name, ...)}`` — on the class or
    set per-instance by state-registration code — suppresses a rule for
    exactly the named states. Allows that suppress nothing are themselves
    flagged (MTL105).
    """
    from metrics_tpu_torch.analysis import distributed as _dist
    from metrics_tpu_torch.engine import CompiledStepEngine

    args = tuple(args)
    kwargs = dict(kwargs or {})
    cls = type(metric).__name__
    eager_reason = CompiledStepEngine._static_ineligibility(metric)
    result = AuditResult(name=cls, engine_eligible=eager_reason is None, eager_reason=eager_reason)

    findings: List[Finding] = []
    _audit_reductions(metric, findings)
    update_graph = _audit_traced_update(
        metric, args, kwargs, findings, result.infos,
        traceable_contract=eager_reason is None,
    )
    engine_graph, n_donated, n_state_outs = None, 0, 0
    if eager_reason is None:
        traced = _audit_engine_program(metric, args, kwargs, findings)
        if traced is not None:
            engine_graph, n_donated, n_state_outs = traced
    elif not any(isinstance(d, list) for d in metric._defaults.values()):
        result.infos.append(f"{cls} runs eager in engines: {eager_reason}")

    if distributed:
        if eager_reason is None:
            result.distributed = _dist.check_replica_equivalence(
                metric, args, kwargs, findings, result.infos,
                probe_cache=_probe_cache,
            )
        _dist.check_lifecycle(
            metric, args, kwargs, findings, result.infos,
            probe_cache=_probe_cache,
        )
        _dist.check_donation_lifetime(
            metric, args, kwargs, findings, result.infos,
            engine_closed=engine_graph, n_donated=n_donated,
            engine_eligible=eager_reason is None,
            update_closed=update_graph,
        )
    # pass 4 — concurrency soundness (engine-eligible families: only the
    # compiled serving loop has a host seam and state generations)
    if eager_reason is None:
        result.evidence = _pass4_evidence(
            metric, findings, result.infos, engine_graph, n_donated, n_state_outs
        )
    # pass 5 — numerical soundness (every family: eager-only accumulators
    # saturate just as surely as compiled ones)
    _add_pass5_evidence(result, metric, findings, args, kwargs, cache=_probe_cache)
    if fingerprint:
        result.fingerprints = {
            "update": _dist.fingerprint_jaxpr(update_graph) if update_graph is not None else None,
            "step": _dist.fingerprint_jaxpr(engine_graph) if engine_graph is not None else None,
        }

    _route_suppressions(metric, findings, result)
    _note_audit(cls, result)
    return result


def audit_collection(collection, args: Sequence[Any] = (), kwargs: Optional[dict] = None) -> Dict[str, Any]:
    """Audit every member of a :class:`~metrics_tpu_torch.MetricCollection`
    plus the cross-metric step program a ``compiled=True`` forward would
    build (one program over ALL compilable members — the surface where a
    buffer aliased *between* metrics double-books).

    Returns ``{"members": {name: AuditResult}, "engine": [Finding, ...],
    "eager_fallbacks": {name: reason}}``.
    """
    from metrics_tpu_torch.engine import CompiledStepEngine

    args = tuple(args)
    kwargs = dict(kwargs or {})
    members = {
        name: audit_metric(m, args, kwargs) for name, m in collection.items()
    }
    # audit_metric registers results by class name; engine watch keys for
    # collections are built from the collection's own keys ("engine[acc,mse]"
    # when members carry custom names), so register under those too or the
    # watchdog cross-link silently never resolves for renamed members
    for name, result in members.items():
        _note_audit(name, result)
    engine_findings: List[Finding] = []
    engine = CompiledStepEngine(dict(collection.items()), observe=False)
    if engine._compiled_names():
        names = "+".join(engine._compiled_names())
        try:
            graph, _shapes, _n_donated = engine.abstract_step(*args, **kwargs)
        except Exception as err:  # noqa: BLE001 — the trace failure is the finding
            msg = str(err).splitlines()[0] if str(err) else type(err).__name__
            engine_findings.append(Finding(
                "MTA002", f"collection[{names}].step",
                f"collection step failed to trace ({type(err).__name__}:"
                f" {msg}); a compiled collection forward will demote these"
                " members to eager",
            ))
        else:
            for prim in sorted(set(_callback_eqns(graph))):
                engine_findings.append(Finding(
                    "MTA002", f"collection[{names}].step",
                    f"host callback primitive {prim!r} inside the compiled"
                    " collection step",
                ))
            for count, positions in _duplicate_outvars(graph):
                engine_findings.append(Finding(
                    "MTA003", f"collection[{names}].step",
                    f"one buffer aliased into {count} outputs of the donated"
                    f" collection step (positions {positions}) — possibly"
                    " across two member metrics",
                ))
    return {
        "members": members,
        "engine": engine_findings,
        "eager_fallbacks": engine.eager_fallbacks,
    }


# ---------------------------------------------------------------------------
# the registry: one representative config per metric family
# ---------------------------------------------------------------------------
def _registry_cases(device: torch.device) -> List[Tuple[str, Callable, tuple]]:
    """(family, factory, sample update args) — the JAX package's 29
    families, factories and deterministic inputs, on ``device``."""
    import metrics_tpu_torch as M

    def on(a: np.ndarray) -> torch.Tensor:
        # contiguous on every device, as JAX arrays are: a strided CPU view
        # (a column of `probs`) would trace other reshapes than its copy on
        # the card
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)

    rng = np.random.RandomState(0x7B0)
    n, c = 32, 4
    probs = rng.rand(n, c).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    mc = (on(probs), on(rng.randint(c, size=n)))
    binary = (on(probs[:, 1]), on(rng.randint(2, size=n)))
    reg = (
        on(rng.rand(n).astype(np.float32)),
        on(rng.rand(n).astype(np.float32)),
    )
    ret = (
        on(rng.randint(6, size=n)),
        on(rng.rand(n).astype(np.float32)),
        on(rng.randint(2, size=n)),
    )
    hinge = (on(rng.randn(n).astype(np.float32)), binary[1])
    line = np.linspace(0.0, 1.0, 16).astype(np.float32)
    curve = (on(line), on(line))
    d = {"device": device}
    return [
        ("Accuracy", lambda: M.Accuracy(**d), mc),
        ("Precision", lambda: M.Precision(num_classes=c, average="macro", **d), mc),
        ("Recall", lambda: M.Recall(num_classes=c, average="macro", **d), mc),
        ("F1", lambda: M.F1(num_classes=c, average="macro", **d), mc),
        ("FBeta", lambda: M.FBeta(num_classes=c, beta=0.5, average="macro", **d), mc),
        ("StatScores", lambda: M.StatScores(reduce="micro", **d), mc),
        ("ConfusionMatrix", lambda: M.ConfusionMatrix(num_classes=c, **d), mc),
        ("IoU", lambda: M.IoU(num_classes=c, **d), mc),
        ("MatthewsCorrcoef", lambda: M.MatthewsCorrcoef(num_classes=c, **d), mc),
        ("CohenKappa", lambda: M.CohenKappa(num_classes=c, **d), mc),
        ("HammingDistance", lambda: M.HammingDistance(**d), binary),
        ("Hinge", lambda: M.Hinge(**d), hinge),
        ("AUROC", lambda: M.AUROC(**d), binary),
        ("AveragePrecision", lambda: M.AveragePrecision(**d), binary),
        ("PrecisionRecallCurve", lambda: M.PrecisionRecallCurve(**d), binary),
        ("ROC", lambda: M.ROC(**d), binary),
        ("AUC", lambda: M.AUC(reorder=True, **d), curve),
        ("BinnedAUROC", lambda: M.BinnedAUROC(num_bins=16, **d), binary),
        ("BinnedAveragePrecision", lambda: M.BinnedAveragePrecision(num_bins=16, **d), binary),
        ("MeanSquaredError", lambda: M.MeanSquaredError(**d), reg),
        ("MeanAbsoluteError", lambda: M.MeanAbsoluteError(**d), reg),
        ("MeanSquaredLogError", lambda: M.MeanSquaredLogError(**d), reg),
        ("R2Score", lambda: M.R2Score(**d), reg),
        ("ExplainedVariance", lambda: M.ExplainedVariance(**d), reg),
        ("PSNR", lambda: M.PSNR(data_range=1.0, **d), reg),
        ("RetrievalMAP", lambda: M.RetrievalMAP(**d), ret),
        ("RetrievalMRR", lambda: M.RetrievalMRR(**d), ret),
        ("RetrievalPrecision", lambda: M.RetrievalPrecision(k=2, **d), ret),
        ("RetrievalRecall", lambda: M.RetrievalRecall(k=2, **d), ret),
    ]


_REGISTRY_CACHE: Dict[torch.device, List[Tuple[str, Callable, tuple]]] = {}


def _resolve_device(device: Any) -> torch.device:
    """The card unless the caller asks for the CPU; refuse the card when
    there is none, before anything is built."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the program audit runs the metric families on a CUDA device by"
            " default and none is available; pass device='cpu'"
        )
    return dev


def registry_cases(device: Any = None) -> List[Tuple[str, Callable, tuple]]:
    """The audited family universe, ``(family, factory, sample args)``, on
    ``device`` (None: the card). Built lazily on first call: importing the
    analyzer must not import every metric family (the watchdog cross-link
    imports this module before the package finishes initializing)."""
    dev = _resolve_device(device)
    if dev not in _REGISTRY_CACHE:
        _REGISTRY_CACHE[dev] = _registry_cases(dev)
    return list(_REGISTRY_CACHE[dev])


#: quantized wire tiers the registry audit re-proves per eligible family
QUANTIZED_AUDIT_TIERS = ("int8", "bf16")

#: cohort capacity the registry audit traces the vmapped step at; the
#: program shape is capacity-independent (vmap batches the same per-tenant
#: program), so one small bucket proves the structural invariants for all
_COHORT_AUDIT_CAPACITY = 4


def _audit_cohort_variant(
    metric, args: tuple, fingerprint: bool = False, family: Optional[str] = None,
    probe_cache: Optional[Dict[str, Any]] = None,
) -> AuditResult:
    """A slim audit of the vmapped cohort step of an engine-eligible
    family (reported as ``<Family>@cohort``): the per-tenant math is the
    already-audited base program, so what the cohort changes — and what is
    re-proved here on the STACKED states — is the step program's shape:
    MTA002 (no host transfer survives the vmap), MTA003 (no buffer aliased
    into two outputs of the stacked step), MTA007 (no stacked input state
    returned unchanged — two disjoint buffer generations must stay
    structurally possible for cohorts too), and pass 4: the host-seam budget
    of the stacked serving loop (MTA008: one collective per state whatever
    the tenant count, plus the health fetch) and the double-buffer verdict
    on the stacked step (MTA009), and pass 5 from the family's shared
    ``probe_cache`` (the stacked states hold the same math). ``fingerprint=True``
    digests the vmapped step graph for the drift sentinel."""
    from metrics_tpu_torch.analysis import distributed as _dist
    from metrics_tpu_torch.engine import CompiledStepEngine, _count_specs

    cls = type(metric).__name__
    engine = CompiledStepEngine(metric, observe=False)
    result = AuditResult(name=cls, engine_eligible=True, eager_reason=None)
    findings: List[Finding] = []
    graph, n_donated, n_state_outs = None, 0, 0
    try:
        graph, shapes, n_donated = engine.abstract_cohort_step(
            *args, capacity=_COHORT_AUDIT_CAPACITY
        )
        n_state_outs = _count_specs(shapes[0])
    except Exception as err:  # noqa: BLE001 — the trace failure is the finding
        kind = _trace_error_kind(err)
        msg = str(err).splitlines()[0] if str(err) else type(err).__name__
        findings.append(Finding(
            "MTA002", f"{cls}.cohort_step",
            ("host synchronization while tracing the vmapped cohort step"
             if kind == "host-sync" else "vmapped cohort step failed to trace")
            + f" ({type(err).__name__}: {msg}); a MetricCohort of this"
            " family cannot dispatch",
            detail={"kind": kind},
        ))
    else:
        for prim in sorted(set(_callback_eqns(graph))):
            findings.append(Finding(
                "MTA002", f"{cls}.cohort_step",
                f"host callback primitive {prim!r} inside the vmapped cohort"
                " step program",
            ))
        for count, positions in _duplicate_outvars(graph):
            findings.append(Finding(
                "MTA003", f"{cls}.cohort_step",
                f"one buffer is aliased into {count} outputs of the donated"
                f" cohort step (output positions {positions}): donation of"
                " the stacked pytree double-books the buffer",
            ))
        for pos in _dist._donated_passthrough_positions(graph, n_donated):
            findings.append(Finding(
                "MTA007", f"{cls}.cohort_step",
                f"the donated cohort step returns donated stacked input"
                f" buffer (output position {pos}) unchanged — the cohort"
                " would hand freshly-donated storage back as live stacked"
                " state",
                detail={"position": pos},
            ))
    result.evidence = _pass4_evidence(
        metric, findings, result.infos, graph, n_donated, n_state_outs,
        family=family or f"{cls}@cohort", cohort=True,
    )
    _add_pass5_evidence(result, metric, findings, args, family=family or f"{cls}@cohort", cache=probe_cache)
    if fingerprint:
        result.fingerprints = {
            "cohort_step": _dist.fingerprint_jaxpr(graph) if graph is not None else None,
        }
    _route_suppressions(metric, findings, result, check_staleness=False)
    return result


def _audit_quantized_variant(
    metric, args: tuple, probe_cache: Optional[Dict[str, Any]] = None, family: Optional[str] = None
) -> AuditResult:
    """A slimmer audit for a ``sync_precision=`` variant of an already-
    audited family: the *update program* is unchanged by the tier (the
    residual companion is registered, never written), so re-running
    MTA001 would re-prove the base audit — what the tier changes is the
    state tree, the step program, and the merge. Audited here: MTA004
    (quantized merge probes), MTA002/MTA003 on the variant's step
    (residuals ride the states), MTA005 at the tier's documented bound
    through the real codec, MTA006 (residual coherence), MTA007, and pass 4:
    the tier's own host-seam budget (MTA008: the residual companion raises
    the checkpoint fetch count, the payloads count as quantized), the
    double-buffer verdict on the variant's step (MTA009) and pass 5 from the
    family's shared ``probe_cache`` (the residual companions are exempt)."""
    from metrics_tpu_torch.analysis import distributed as _dist
    from metrics_tpu_torch.engine import CompiledStepEngine

    cls = type(metric).__name__
    eager_reason = CompiledStepEngine._static_ineligibility(metric)
    result = AuditResult(
        name=cls, engine_eligible=eager_reason is None, eager_reason=eager_reason
    )
    findings: List[Finding] = []
    _audit_reductions(metric, findings)
    engine_graph, n_donated, n_state_outs = None, 0, 0
    if eager_reason is None:
        traced = _audit_engine_program(metric, args, {}, findings)
        if traced is not None:
            engine_graph, n_donated, n_state_outs = traced
        result.distributed = _dist.check_replica_equivalence(
            metric, args, {}, findings, result.infos, probe_cache=probe_cache
        )
    _dist.check_lifecycle(metric, args, {}, findings, result.infos, residuals_only=True)
    _dist.check_donation_lifetime(
        metric, args, {}, findings, result.infos,
        engine_closed=engine_graph, n_donated=n_donated,
        engine_eligible=eager_reason is None,
    )
    if eager_reason is None:
        result.evidence = _pass4_evidence(
            metric, findings, result.infos, engine_graph, n_donated, n_state_outs, family=family
        )
    _add_pass5_evidence(result, metric, findings, args, family=family, cache=probe_cache)
    _route_suppressions(metric, findings, result, check_staleness=False)
    return result


def audit_registry(
    write_path: Optional[str] = None,
    quantized: bool = True,
    cohort: bool = True,
    fingerprints: bool = False,
    device: Any = None,
) -> Dict[str, Any]:
    """The static audit over every registered metric family, its metrics
    and inputs on ``device`` (None: the card; ``"cpu"`` runs it on the
    CPU; ``"cuda"`` without a card raises before anything is built);
    returns (and optionally atomically writes) the JSON report.

    ``quantized=True`` additionally audits the ``sync_precision="int8"``
    and ``"bf16"`` variants of every engine-eligible family with
    quantizable states (reported as ``"<Family>@<tier>"``) — the engine
    keys programs on the precision map, so the variants ARE different
    programs. ``cohort=True`` audits every engine-eligible family's
    vmapped cohort step (``"<Family>@cohort"``): MTA003 aliasing and MTA007
    passthrough must hold on the STACKED states, not just the per-tenant
    program. ``fingerprints=True`` digests each family's update/step (and
    cohort-step) graphs into ``report["fingerprints"]``; the digests carry
    no device, so the card's and the CPU's agree.

    The clean-baseline contract: ``report["summary"]["findings"] == 0``.
    Suppressed findings and design notes (eager-only families) stay
    visible in the report without failing the gate. Every engine-eligible
    entry carries pass 4's ``evidence`` (``host_seam``, ``double_buffer``),
    and every entry pass 5's (``numerics``);
    ``report["host_seam_sites"]`` names the port's host crossing sites. With
    telemetry on, the ``analysis.seam.crossings`` gauge sums the registry's
    per-sync collectives and steady per-step crossings, the
    ``analysis.numerics.horizon_min`` gauge holds the shortest finite
    horizon and ``analysis.numerics.findings`` counts unsuppressed pass-5
    findings.
    """
    cases = registry_cases(device)
    from metrics_tpu_torch.engine import CompiledStepEngine

    families: Dict[str, Any] = {}
    prints: Dict[str, Any] = {}
    totals = {"findings": 0, "suppressed": 0}

    def note(name: str, result: AuditResult) -> None:
        families[name] = result.to_dict()
        totals["findings"] += len(result.findings)
        totals["suppressed"] += len(result.suppressed)
        if result.fingerprints is not None:
            prints[name] = dict(result.fingerprints)

    for name, factory, args in cases:
        # one probe cache per family: the per-replica update states and
        # the full-batch compute are tier-invariant, so the base audit
        # pays for them once and the int8/bf16 variants reuse them (only
        # the merge composite differs per tier)
        probe_cache: Dict[str, Any] = {}
        base = audit_metric(
            factory(), args, fingerprint=fingerprints, _probe_cache=probe_cache
        )
        note(name, base)
        if cohort and base.engine_eligible:
            note(f"{name}@cohort", _audit_cohort_variant(
                factory(), args, fingerprint=fingerprints, family=f"{name}@cohort",
                probe_cache=probe_cache,
            ))
        if not quantized:
            continue
        for tier in QUANTIZED_AUDIT_TIERS:
            variant = factory()
            try:
                tier_map = variant.set_sync_precision(tier)
            except Exception:  # noqa: BLE001 — family has no eligible state
                continue
            if not tier_map:
                continue
            if CompiledStepEngine._static_ineligibility(variant) is not None:
                continue  # the tier only matters where the engine compiles
            note(f"{name}@{tier}", _audit_quantized_variant(
                variant, args, probe_cache=probe_cache, family=f"{name}@{tier}"
            ))
    from metrics_tpu_torch.analysis import concurrency as _conc
    from metrics_tpu_torch.observability import telemetry as _obs

    report = {
        "schema": "metrics_tpu.analysis_report",
        "version": 4,
        "rules": {rid: r.to_dict() for rid, r in sorted(RULES.items())},
        "families": families,
        # the AST leg of the seam audit: where each host<->device crossing
        # lives in the port's serving-loop host paths; the budgets above
        # count how often each phase crosses
        "host_seam_sites": _conc.host_seam_sites(),
        "summary": {
            "families": len(families),
            "findings": totals["findings"],
            "suppressed": totals["suppressed"],
        },
    }
    if _obs.enabled():
        # the registry's per-sync host collectives plus steady per-step
        # crossings: the number a device-resident serving loop drives to 0
        crossings = 0
        for entry in families.values():
            flat = _conc.flatten_seam_budget((entry.get("evidence") or {}).get("host_seam") or {})
            crossings += flat.get("per_sync.host_collectives", 0) + flat.get("steady_per_step", 0)
        _obs.get().gauge("analysis.seam.crossings", crossings)
        # numerics evidence: the registry's shortest finite horizon (rows)
        # and the count of unsuppressed pass-5 findings
        from metrics_tpu_torch.analysis import numerics as _num

        horizon_min = _num.min_horizon_rows({
            fam: (entry.get("evidence") or {}).get("numerics") for fam, entry in families.items()
        })
        numerics_findings = sum(
            1 for entry in families.values() for f in entry["findings"]
            if f.get("rule") in ("MTA010", "MTA011", "MTA012")
        )
        if horizon_min is not None:
            _obs.get().gauge("analysis.numerics.horizon_min", horizon_min)
        if numerics_findings:
            _obs.get().count("analysis.numerics.findings", numerics_findings)
    if fingerprints:
        report["fingerprints"] = prints
    if write_path is not None:
        from metrics_tpu_torch.reliability.journal import atomic_write_json

        atomic_write_json(write_path, report)
    return report


# ---------------------------------------------------------------------------
# watchdog cross-link
# ---------------------------------------------------------------------------
# class name -> unsuppressed findings from the most recent audit of that
# class (any entry point: audit_metric, audit_registry, the protocol
# explorers, tests). The RecompilationWatchdog consults this when it fires
# so its warning can name the analyzer rule likely responsible for the
# churn it observed.
_LAST_AUDIT: Dict[str, List[Finding]] = {}


def _note_audit(cls_name: str, result: Union[AuditResult, List[Finding]]) -> None:
    """Register the unsuppressed findings of the latest audit of
    ``cls_name``: an :class:`AuditResult`, or the findings themselves (the
    fleet-protocol explorer's)."""
    findings = result.findings if isinstance(result, AuditResult) else result
    _LAST_AUDIT[cls_name] = list(findings)


def hint_for_watch_key(key: str) -> Optional[str]:
    """A one-line analyzer attribution for a watchdog key (an engine label
    like ``engine[Accuracy,MeanSquaredError]`` or a bare metric-class
    name), or None when the last audit holds nothing relevant. MTA001
    findings front the list: signature churn is exactly what the watchdog
    measures.

    Best-effort by construction: the lookup is keyed by bare class name
    and reflects the *most recent* audit of any class with that name —
    two same-named classes collide, and a finding fixed in source still
    hints until the class is re-audited. The hint's "a likely cause"
    phrasing is the contract; treat it as a lead, not a verdict."""
    # cohort engines suffix their watch key ("engine[A,B]@cohort"): the
    # suffix routes trace-budget accounting per cohort, not attribution —
    # strip it so churn on a cohort key still resolves to its members'
    # findings (MTA001 fronted: unbucketed cohort churn IS signature churn)
    if key.endswith("@cohort"):
        key = key[: -len("@cohort")]
    inner = key
    if "[" in key and key.endswith("]"):
        inner = key[key.index("[") + 1:-1]
    names = [p.strip() for p in inner.split(",") if p.strip()]
    relevant: List[Finding] = []
    for n in names:
        relevant.extend(_LAST_AUDIT.get(n, ()))
    if not relevant:
        return None
    relevant.sort(key=lambda f: (f.rule != "MTA001", f.rule))
    f = relevant[0]
    slug = RULES[f.rule].slug if f.rule in RULES else ""
    more = f" (+{len(relevant) - 1} more)" if len(relevant) > 1 else ""
    return (
        f"static analysis flagged {f.rule} ({slug}) on {f.subject}{more} —"
        " a likely cause; see docs/static_analysis.md"
    )
