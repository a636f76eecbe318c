"""Compiled step engine: one CUDA graph replay per forward.

Port of ``metrics_tpu/engine.py``. Eagerly, a ``MetricCollection`` forward
runs every member's update, batch-local compute and state merge as a string
of small kernel launches, each with its host-side Python: at a 4-metric
classification forward over 100,000 rows the device is idle most of the
step. :class:`CompiledStepEngine` makes the whole forward of a metric or of
a mapping of metrics (shared input canonicalization, every member's
``update`` on fresh state, the batch-local ``compute`` and the merge of the
batch's state into the accumulated state) one pure step function::

    step(states, args, kwargs) -> (new_states, batch_values)

and, on a CUDA device, captures it into one ``torch.cuda.CUDAGraph`` per
call signature (the structure of the inputs, each tensor's shape, dtype and
device, Python scalars by value, and each state's shape and dtype), kept
in a small LRU. A step then copies its inputs into the graph's static
input tensors, replays the graph and clones the values out.

* *Warm-up.* A new signature first runs the step function uncaptured, on a
  side stream, with value checks off (``_is_concrete`` False) and PyTorch's
  sync debug mode set to ``"error"``: shape errors, data-dependent raises
  and hidden host reads surface there, before a capture begins. The sync
  debug mode is process-global: while a warm-up runs, a synchronizing call
  on any other thread (an ``.item()`` in a second training thread) raises
  too. The capture itself is thread-local.
* *States.* The captured program writes the merged states in place into
  state tensors the engine owns, allocated outside the capture. Before
  every replay the engine copies each state attribute into them; after it,
  the merged states are cloned out and installed on the metrics. A metric
  attribute, a ``state_dict()`` value or a ``compute()`` result that
  returns a state (``ConfusionMatrix``) is therefore never the engine's
  buffer, and a registered default is never aliased.
* *Values.* Cloned out after the replay: a value returned by one step
  outlives the next.
* *The state guard* (``reliability.guard``). With a guard installed, the
  step function also computes one all-finite flag per member over its
  merged float states and, under ``raise`` / ``quarantine``, selects the
  member's prior state where the flag is false (``torch.where``): the
  check and the rollback run inside the CUDA graph, and the flags of every
  member come back stacked in one tensor, read to the host once per
  replay. The guard's token (``None``, ``"select"``, ``"flag"``) is part of
  the call signature: switching a guard on builds another graph and the
  unguarded graph stays as it was. The JAX package donates the states to
  its dispatch and copies them first when a guard is on, so the live
  attributes survive a failed dispatch as the last-good snapshot; here
  every step copies the states into the graph's buffers, so that holds on
  every step, guarded or not (``_check_states_alive`` asserts it after a
  failure).

On the CPU (``device="cpu"``) each step runs the same step function
directly with value checks off: the engine's plain version.

*Observability* (``metrics_tpu_torch.observability``, off by default): the
engine counts hits, misses, evictions, dispatches, builds and demotions,
feeds the recompilation watchdog one ``note_trace`` per build, records the
``engine.cache_lookup`` / ``engine.donate`` / ``engine.dispatch`` spans and
the flight recorder's ``engine_dispatch`` events, and wraps a replay in a
profiler range named after the engine. The hooks inside the step function
(the members' update and compute scopes) fire on a build's first run only,
the warm-up on the card and the miss step on the CPU, as the JAX package's
fire once per trace: the capture and every later run are muted.

Members whose forward cannot be one pure step (list states, a registered
reduction with no pure merge, no fused one-update forward, host-level sync)
keep their eager forward from the start. When a signature's build fails,
the batch is rerun eagerly: if that fails too the batch was bad, the error
propagates and the engine stays compiled; otherwise the members whose
warm-up fails alone are demoted to eager with the reason (the JAX package
demotes the whole compiled group; a member's warm-up touches no metric
state, so each can be tried alone), and the rest stay compiled; the next
step captures them. ``eager_fallbacks`` names every demoted member and
why. In a ``torch.distributed`` world every member runs eager, as in the
JAX package (the step does not sync).

The cohort step (:meth:`CompiledStepEngine.cohort_step`, driven by
:class:`~metrics_tpu_torch.cohort.MetricCohort`) is the same step function
under ``torch.func.vmap`` over a leading tenant axis of the states and of
every tensor input: one CUDA graph per (signature, capacity bucket),
sharing the LRU with the plain signatures. Its states are the stacked ones
it is given, copied into buffers keyed by the stacked shape. It has no
eager fallback: a failed build or replay drops the program and raises.
"""
import gc
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager, nullcontext
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import torch
import torch.utils._pytree as pytree

from metrics_tpu_torch.functional.regression.sufficient_stats import regression_family_sharing
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.observability import costledger as _costledger
from metrics_tpu_torch.observability import flight as _flight
from metrics_tpu_torch.observability import telemetry as _obs
from metrics_tpu_torch.observability import trace as _trace
from metrics_tpu_torch.parallel.backend import is_distributed_initialized
from metrics_tpu_torch.reliability import guard as _rguard
from metrics_tpu_torch.utilities import env as _env
from metrics_tpu_torch.utilities.checks import shared_canonicalization
from metrics_tpu_torch.utilities.data import apply_to_collection, tracing
from metrics_tpu_torch.utilities.prints import warn_once

__all__ = ["CompiledStepEngine"]

_DEFAULT_CACHE_SIZE = 16

#: the cohort's build budget before the watchdog's verdict: one build per
#: capacity bucket is a warming ramp (1 to 10,000 tenants: 14 buckets)
_COHORT_TRACE_BUDGET = 16

#: reserved key of the per-tenant health accumulators among the cohort
#: step's states (a cohort rejects dunder member names)
_COHORT_HEALTH_KEY = "__cohort_health__"


def _flatten(tree: Any, leaves: list) -> tuple:
    """Append the leaves of a tuple/list/dict tree to ``leaves``; returns the
    tree's structure (dict keys sorted, as a JAX treedef sorts them)."""
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        return (type(tree), tuple(_flatten(x, leaves) for x in tree))
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return (dict, keys, tuple(_flatten(tree[k], leaves) for k in keys))
    leaves.append(tree)
    return None


def _unflatten(structure: tuple, leaves) -> Any:
    """Rebuild a tree of :func:`_flatten`'s structure from an iterator of leaves."""
    if structure is None:
        return next(leaves)
    if structure[0] is dict:
        return {k: _unflatten(s, leaves) for k, s in zip(structure[1], structure[2])}
    return structure[0](_unflatten(s, leaves) for s in structure[1])


class LeafSpec:
    """A tensor leaf's shape, dtype and device without its data: what a
    signature keys on, for asking whether a step is built
    (:meth:`CompiledStepEngine.cohort_is_built`)."""

    __slots__ = ("shape", "dtype", "device")

    def __init__(self, shape: Tuple[int, ...], dtype: torch.dtype, device: torch.device):
        self.shape, self.dtype, self.device = tuple(shape), dtype, device


def _count_specs(tree: Any) -> int:
    """The :class:`LeafSpec` leaves of a traced output tree (its tensors)."""
    leaves: List[Any] = []
    _flatten(tree, leaves)
    return sum(isinstance(x, LeafSpec) for x in leaves)


def _abstract_leaf(x: Any) -> tuple:
    """Cache-key atom of one input leaf: tensors key on (shape, dtype,
    device); anything else on its type and value (a capture bakes it in)."""
    if isinstance(x, (torch.Tensor, LeafSpec)):
        return ("arr", tuple(x.shape), x.dtype, x.device)
    return ("val", type(x), x)


def fake_trace(fn: Callable, call: tuple) -> Tuple[Any, Any]:
    """Trace ``fn(*call)`` with ``make_fx`` over fake tensors: every tensor
    leaf of ``call`` becomes a fake tensor of its shape, dtype and device
    (the card's, for a step on the card), so nothing runs, launches or
    allocates on a device. Returns ``(graph_module, out)``: the graph has
    one placeholder per tensor leaf of ``call`` and returns the tensor
    leaves of ``fn``'s output, both in :func:`_flatten` order (dict keys
    sorted, as a JAX treedef sorts them); ``out`` is that output with its
    tensors as :class:`LeafSpec`. A host read inside ``fn`` raises out of
    the trace (a fake tensor has no value); it is never caught here.
    :class:`LeafSpec` leaves of ``call`` stand for tensors of their spec."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    leaves: List[Any] = []
    structure = _flatten(call, leaves)
    is_tensor = [isinstance(x, (torch.Tensor, LeafSpec)) for x in leaves]
    with FakeTensorMode(allow_non_fake_inputs=True):
        fakes = [
            torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device)
            if isinstance(x, torch.Tensor) else torch.empty(x.shape, dtype=x.dtype, device=x.device)
            for x, t in zip(leaves, is_tensor) if t
        ]
    traced: Dict[str, Any] = {}

    def flat_fn(*tensors):
        it = iter(tensors)
        out = fn(*_unflatten(structure, iter([next(it) if t else x for x, t in zip(leaves, is_tensor)])))
        out_leaves: List[Any] = []
        traced["structure"] = _flatten(out, out_leaves)
        traced["leaves"] = [LeafSpec(x.shape, x.dtype, x.device) if isinstance(x, torch.Tensor) else x
                            for x in out_leaves]
        return [x for x in out_leaves if isinstance(x, torch.Tensor)]

    graph = make_fx(flat_fn, tracing_mode="fake", _allow_non_fake_inputs=True)(*fakes)
    return graph, _unflatten(traced["structure"], iter(traced["leaves"]))


def _cohort_call(states: dict, args: tuple, kwargs: dict, health_state: Optional[dict]) -> Tuple[dict, tuple]:
    """The cohort step's states and call tree: with health accounting the
    accumulators ride among the states and the validity mask and step index
    in an extra ``aux`` argument."""
    if health_state is None:
        return states, (args, kwargs)
    health_state = dict(health_state)
    aux = {"valid": health_state.pop("valid"), "step": health_state.pop("step")}
    return {**states, _COHORT_HEALTH_KEY: health_state}, (args, kwargs, aux)


def _cohort_in_dims(tree: Any) -> Any:
    """``vmap`` in_dims of one input container of the cohort step: tensors
    map over the leading tenant axis, anything else (Python scalars,
    strings) is broadcast, as the signature keys it by value."""
    return pytree.tree_map(lambda x: 0 if isinstance(x, torch.Tensor) else None, tree)


def _cohort_rows_per_tenant(args: tuple, kwargs: dict) -> int:
    """Rows each tenant contributes this step, read off the stacked input
    shapes: the second dim of the first tensor with two or more dims;
    1 when every tensor input is per-tenant scalar, 0 without tensors."""
    saw_tensor = False
    for leaf in pytree.tree_leaves((args, kwargs)):
        if isinstance(leaf, torch.Tensor):
            if leaf.ndim >= 2:
                return int(leaf.shape[1])
            saw_tensor = True
    return 1 if saw_tensor else 0


def _tenant_finite_flags(state_rows: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
    """Per-tenant all-finite flag over one member's stacked float states
    (``(capacity,)`` bool); None when the member has no float state."""
    flags = None
    for v in state_rows.values():
        if v.is_floating_point():
            flag = torch.isfinite(v).reshape(v.shape[0], -1).all(1)
            flags = flag if flags is None else flags & flag
    return flags


def _flags_to_host(flags: torch.Tensor) -> torch.Tensor:
    """The guard's stacked flags on the host: one read, one synchronization.
    On the card they land in pinned memory and the thread waits on its
    current stream: a copy into pageable memory would, for as long as it
    waits for the device, stall every other thread's launches and
    allocations (an asynchronous server's serve loop behind its worker's
    guarded step)."""
    if flags.device.type != "cuda":
        return flags
    host = torch.empty(flags.shape, dtype=flags.dtype, pin_memory=True)
    host.copy_(flags, non_blocking=True)
    torch.cuda.current_stream(flags.device).synchronize()
    return host


class _HostMirror:
    """Pinned host rows that mirror a few same-shaped device tensors, read
    after an event: each :meth:`read` makes the mirror's own stream wait on
    the event a writer recorded after its step wrote the tensors, copies
    each tensor into its pinned row on that stream, and waits for that
    stream alone. It never waits on the device or on another stream's later
    work, and it allocates nothing on the card: a device allocation on a
    new stream (the caching allocator's first segment) or a copy into
    pageable memory would, while the card is busy, stall every other
    thread's allocations and launches (a scrape thread beside a serve
    loop). The buffer and the stream are made once, by the writer; reads
    are serialized."""

    def __init__(self, rows: int, like: torch.Tensor):
        self.shape = (rows,) + tuple(like.shape)
        # the high-priority pool: never a serving worker's or a background
        # writer's stream, whose later work a read must not wait for
        self.stream = torch.cuda.Stream(device=like.device, priority=-1)
        self.host = torch.empty(self.shape, dtype=like.dtype, pin_memory=True)
        self._lock = threading.Lock()

    def read(self, tensors: List[torch.Tensor], ready: "torch.cuda.Event") -> torch.Tensor:
        """``tensors`` (of the mirror's shape) stacked on the host, in a
        tensor of the caller's own."""
        with self._lock:
            self.stream.wait_event(ready)
            with torch.cuda.stream(self.stream):
                for row, t in zip(self.host, tensors):
                    row.copy_(t, non_blocking=True)
            self.stream.synchronize()
            return self.host.clone()


@contextmanager
def _host_reads_raise():
    """Make every synchronizing CUDA call raise (PyTorch's sync debug mode),
    so a host read in a step fails its warm-up instead of its capture."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextmanager
def _no_cyclic_gc():
    """Python's cyclic garbage collector off for the block (as it was after)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class _Graph:
    """One captured signature: the graph, its static inputs, the state
    buffers the states are copied into, where a replay leaves the merged
    states (those buffers, or a captured tensor for a state the step gives
    another dtype or shape, as float32 batches promote bfloat16 states), its
    captured outputs after the states (the values, and with a guard the
    stacked finite flags), and the tensors it reads that live outside its
    pool (pinned, so they outlive every replay)."""

    __slots__ = ("graph", "inputs", "states", "merged", "outputs", "pins", "pool_bytes", "build_ms",
                 "_storage_ptrs")

    def __init__(self, graph, inputs, states, merged, outputs, pins, pool_bytes, build_ms):
        self.graph = graph
        self.inputs = inputs
        self.states = states
        self.merged = merged
        self.outputs = outputs
        self.pins = pins
        self.pool_bytes = pool_bytes
        self.build_ms = build_ms
        self._storage_ptrs = None

    def storage_ptrs(self) -> frozenset:
        """Storage pointers of the static inputs, state buffers and outputs:
        what a replay writes (fixed for the graph's life; made on first
        request)."""
        if self._storage_ptrs is None:
            self._storage_ptrs = frozenset(
                t.untyped_storage().data_ptr()
                for t in pytree.tree_leaves((self.inputs, self.states, self.merged, self.outputs))
                if isinstance(t, torch.Tensor) and t.numel()
            )
        return self._storage_ptrs


class CompiledStepEngine:
    """Run the forward of a metric (or mapping of metrics) as one CUDA graph
    replay per step (module docstring).

    Args:
        metrics: a single :class:`Metric` or an ordered mapping
            ``name -> Metric`` (what :class:`MetricCollection` holds).
        cache_size: max distinct call signatures kept (LRU).

    Example:
        >>> from metrics_tpu_torch import MeanSquaredError
        >>> metric = MeanSquaredError(device="cpu")
        >>> engine = CompiledStepEngine(metric)
        >>> engine(torch.tensor([0.0, 1.0, 2.0]), torch.tensor([0.0, 1.0, 4.0]))
        tensor(1.3333)
        >>> engine(torch.tensor([1.0]), torch.tensor([2.0])), metric.compute()
        (tensor(1.), tensor(1.2500))
        >>> engine.trace_count  # one per signature: two batch shapes
        2
    """

    def __init__(
        self,
        metrics: Union[Metric, Mapping[str, Metric]],
        cache_size: int = _DEFAULT_CACHE_SIZE,
        observe: bool = True,
    ):
        """``observe=False`` records no ``eager_fallback`` events at
        construction (the cohort's engine: an ineligible member raises
        there instead)."""
        if isinstance(metrics, Metric):
            self._single = True
            self._metrics: "OrderedDict[str, Metric]" = OrderedDict([("metric", metrics)])
        else:
            self._single = False
            self._metrics = OrderedDict(metrics.items())
        if not self._metrics:
            raise ValueError("CompiledStepEngine needs at least one metric")
        self._cache_size = int(cache_size)
        if self._cache_size < 1:
            raise ValueError("cache_size must be >= 1")
        self._device = next(iter(self._metrics.values())).device
        self._compiled: "OrderedDict[tuple, Optional[_Graph]]" = OrderedDict()
        # metric names running eager (static ineligibility or a failed
        # build); once eager, always eager for this engine
        self._eager_names: Dict[str, str] = {}
        for name, m in self._metrics.items():
            reason = self._static_ineligibility(m)
            if reason is not None:
                self._eager_names[name] = reason
        # one build per signature on steady-state shapes
        self.trace_count = 0
        # advanced under the lock at every write-back: step N's values
        # describe state generation N
        self.dispatch_generation = 0
        self._lock = threading.Lock()
        # engine-owned state buffers the graphs merge into, one per
        # (member, state, shape, dtype)
        self._state_buffers: Dict[tuple, torch.Tensor] = {}
        # telemetry: signatures ever built (tells a new signature from LRU
        # thrash for the recompilation watchdog) and this engine's key in
        # the registry; a single metric is labelled by its class name
        self._seen_signatures = set()
        labels = [type(m).__name__ for m in self._metrics.values()] if self._single else list(self._metrics)
        self._watch_key = "engine[" + ",".join(labels) + "]"
        if observe and _obs.enabled() and self._eager_names:
            tel = _obs.get()
            for name, reason in self._eager_names.items():
                tel.event("eager_fallback", engine=self._watch_key, metric=name, reason=reason)

    # ------------------------------------------------------------------
    # eligibility
    # ------------------------------------------------------------------
    @staticmethod
    def _static_ineligibility(m: Metric) -> Optional[str]:
        """Reason this metric can never run compiled, or None if it can."""
        if not m._defaults:
            return "no registered state (composition/wrapper metrics sync per-operand)"
        if not m._fused_forward:
            # the engine's one-update + reduction-merge step is exactly the
            # fused-forward contract; a metric that has not opted in may
            # accumulate non-additively behind a 'sum' reduction
            return "metric does not opt into fused one-update forward semantics"
        for sname, default in m._defaults.items():
            if isinstance(default, list) or isinstance(getattr(m, sname), list):
                return f"list ('cat') state {sname!r} grows per step"
            if not Metric._merge_reduction_supported(m._reductions.get(sname)):
                return f"state {sname!r} has a non-mergeable reduction"
        if m.dist_sync_on_step:
            return "dist_sync_on_step forwards sync through a host backend"
        if m.dist_sync_fn is not None:
            return "custom dist_sync_fn runs at host level"
        return None

    def _compiled_names(self) -> Tuple[str, ...]:
        for name, m in self._metrics.items():
            if name not in self._eager_names and m.device != self._device:
                self._eager_names[name] = f"device {m.device} differs from the engine's {self._device}"
        return tuple(n for n in self._metrics if n not in self._eager_names)

    @property
    def eager_fallbacks(self) -> Dict[str, str]:
        """``name -> reason`` for every metric running eager (diagnostics)."""
        return dict(self._eager_names)

    # ------------------------------------------------------------------
    # the pure step function (closed over the metric objects; all state
    # flows through ``states``, so it is pure despite the temporary
    # attribute changes that reuse the update/compute code)
    # ------------------------------------------------------------------
    def _make_step_fn(self, names: Tuple[str, ...], guard_token: Optional[str] = None) -> Callable:
        """The step function of ``names``: ``(new_states, values)``, and with
        a guard token also the members' all-finite flags over their merged
        float states, stacked in ``names`` order (``"select"`` rolls a
        member whose flag is false back to its prior state)."""
        metrics = self._metrics
        device = self._device

        def step_fn(states, args, kwargs):
            new_states = {}
            values = {}
            finites = []
            with shared_canonicalization(), regression_family_sharing():
                for name in names:
                    m = metrics[name]
                    saved = m._snapshot_state()
                    try:
                        m.reset()  # defaults: fresh state for the batch stats
                        m.update(*args, **m._filter_kwargs(**kwargs))
                        batch = {s: getattr(m, s) for s in m._defaults}
                        if m.compute_on_step:
                            m._batch_local_compute = True
                            try:
                                values[name] = m.compute()
                            finally:
                                m._batch_local_compute = False
                        merged = {
                            s: Metric._merge_state_value(m._reductions[s], states[name][s], batch[s])
                            for s in m._defaults
                        }
                        if guard_token is not None:
                            # the fused all-finite flag over the MERGED float
                            # states (a NaN batch and an accumulator overflow
                            # alike), in the same step; "select" folds the
                            # rollback in: a poisoned merge yields the prior
                            finite = None
                            for v in merged.values():
                                if v.is_floating_point():
                                    flag = torch.isfinite(v).all()
                                    finite = flag if finite is None else finite & flag
                            if finite is None:
                                finite = torch.ones((), dtype=torch.bool, device=device)
                            elif guard_token == "select":
                                merged = {s: torch.where(finite, v, states[name][s]) for s, v in merged.items()}
                            finites.append(finite)
                        new_states[name] = merged
                    finally:
                        m._restore_state(saved)
                        m._computed = None
            if guard_token is not None:
                return new_states, values, torch.stack(finites)
            return new_states, values

        return step_fn

    def _program_definition(self, names: Tuple[str, ...], guard_token: Optional[str], health: Optional[bool] = None):
        """What defines the step function of ``names`` apart from its call
        (the cost ledger's digest): each member's name, class and
        configuration, the guard's token and, for a cohort step, whether
        the health accounting rides it. Nothing of this engine."""
        members = tuple((n, _costledger.metric_config(self._metrics[n])) for n in names)
        return {"members": members, "guard": guard_token, "health": health}

    @staticmethod
    def _guard_token(guard) -> Optional[str]:
        """Step-function token of the active guard: None (no guard, the
        unguarded step), ``"select"`` (raise / quarantine: the rollback
        inside the step) or ``"flag"`` (warn: flags only, the state kept).
        raise and quarantine share one graph; only the host verdict differs."""
        if guard is None:
            return None
        return "select" if guard.policy in ("raise", "quarantine") else "flag"

    # ------------------------------------------------------------------
    # the cohort step function: the same step, vmapped over a leading
    # tenant axis
    # ------------------------------------------------------------------
    def _make_cohort_step_fn(
        self, names: Tuple[str, ...], health: bool = False, guard_token: Optional[str] = None
    ) -> Callable:
        """The step function of ``names`` under ``torch.func.vmap`` over the
        leading tenant axis of the states and of every tensor input. Each
        tenant's new state depends only on its own rows, so padding slots
        stay inert. ``health=True`` also advances the per-tenant health
        accumulators (``states[_COHORT_HEALTH_KEY]``) outside the vmap, in
        the same step, from ``aux`` (the ``valid`` slot mask and the
        cohort's ``step`` index). With a guard token the flags come back as
        one ``(capacity, members)`` tensor: one flag per tenant and member,
        and a ``"select"`` rollback per tenant."""
        base = self._make_step_fn(names, guard_token)

        def cohort_step_fn(states, args, kwargs):
            in_dims = (0, _cohort_in_dims(args), _cohort_in_dims(kwargs))
            return torch.func.vmap(base, in_dims=in_dims)(states, args, kwargs)

        if not health:
            return cohort_step_fn

        def cohort_health_step_fn(states, args, kwargs, aux):
            new_states, values, *finites = cohort_step_fn({n: states[n] for n in names}, args, kwargs)
            new_states = dict(new_states)
            new_states[_COHORT_HEALTH_KEY] = self._advance_health(
                states[_COHORT_HEALTH_KEY], new_states, names, aux, args, kwargs, finites[0] if finites else None
            )
            return (new_states, values, *finites)

        return cohort_health_step_fn

    @staticmethod
    def _advance_health(
        h: Dict[str, torch.Tensor],
        new_states: Dict[str, Dict[str, torch.Tensor]],
        names: Tuple[str, ...],
        aux: Dict[str, torch.Tensor],
        args: tuple,
        kwargs: dict,
        finites: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """One elementwise advance of the int32 ``(capacity,)`` health
        accumulators: rows seen, updates and the last active step of every
        live slot, and the slots whose merged float states are not all
        finite. ``aux["valid"]`` masks the padding slots. With a guard the
        guard's own per-tenant flags (``finites``, ``(capacity, members)``)
        are counted: under a rollback they flag the update the step undid."""
        valid = aux["valid"].to(torch.bool)
        count = h["updates"].dtype
        nonfinite = torch.zeros(valid.shape, dtype=count, device=valid.device)
        for i, name in enumerate(names):
            flag = _tenant_finite_flags(new_states[name]) if finites is None else finites[:, i]
            if flag is not None:
                nonfinite = nonfinite + (valid & ~flag).to(count)
        live = valid.to(count)
        return {
            "rows_seen": h["rows_seen"] + live * _cohort_rows_per_tenant(args, kwargs),
            "updates": h["updates"] + live,
            "last_step": torch.where(valid, aux["step"].to(count), h["last_step"]),
            "nonfinite": h["nonfinite"] + nonfinite,
        }

    # ------------------------------------------------------------------
    # signature cache
    # ------------------------------------------------------------------
    def _signature(self, names: Tuple[str, ...], states: dict, leaves: list, structure: tuple,
                   guard_token: Optional[str] = None, extra: tuple = ()) -> tuple:
        # the quantized sync tier is part of the program's identity, as in
        # the JAX package: a precision flip adds or drops residual states,
        # and a graph built for one tier is never replayed for another; so
        # is the guard's token: a guarded graph never serves an unguarded step
        precisions = tuple(
            (n, tuple(sorted(getattr(self._metrics[n], "_sync_precisions", {}).items()))) for n in names
        )
        state_sig = tuple((n, s, tuple(v.shape), v.dtype) for n, d in states.items() for s, v in d.items())
        return (names, precisions, guard_token, state_sig, structure, tuple(_abstract_leaf(x) for x in leaves)) + extra

    def _lookup(self, signature: tuple) -> Tuple[Optional[_Graph], bool, bool]:
        """``(program, cache_hit, cold)``: the signature's program on a hit
        (None on the CPU, where the step function runs directly). A miss
        returns no program after its bookkeeping: counters, the watchdog's
        thrash verdict for a signature built before, the LRU eviction the
        build's insert needs; ``cold`` says the signature was never built by
        this engine (the cost ledger's classification; False on a hit)."""
        if signature in self._compiled:
            self._compiled.move_to_end(signature)
            if _obs.enabled():
                tel = _obs.get()
                tel.count("engine.cache_hits")
                tel.watchdog.note_steady(self._watch_key)
            return self._compiled[signature], True, False
        cold = signature not in self._seen_signatures
        if _obs.enabled():
            tel = _obs.get()
            tel.count("engine.cache_misses")
            # a miss for a signature built before is LRU thrash, which the
            # watchdog flags at once; a new signature is a legitimate build
            tel.watchdog.note_compile(self._watch_key, cold)
        if len(self._seen_signatures) >= 4096:
            self._seen_signatures.clear()  # polymorphic caller: stay bounded
        self._seen_signatures.add(signature)
        if len(self._compiled) >= self._cache_size:
            self._compiled.popitem(last=False)  # LRU eviction
            if _obs.enabled():
                _obs.get().count("engine.cache_evictions")
                _obs.get().event("cache_eviction", engine=self._watch_key)
        return None, False, cold

    def _build(self, signature: tuple, names: Tuple[str, ...], make_step: Callable, states: dict, leaves: list,
               structure: tuple, watch_key: str, budget: int) -> Optional[_Graph]:
        """Build the signature's program (a CUDA graph on the card; None on
        the CPU) and cache it. One build is one JAX trace: it counts in
        ``trace_count`` and in the watchdog's ``note_trace``."""
        self.trace_count += 1
        _obs.note_trace(watch_key, budget=budget)
        program = self._capture(names, make_step(), states, leaves, structure) if self._device.type == "cuda" else None
        self._compiled[signature] = program
        return program

    # ------------------------------------------------------------------
    # the CUDA graph of one signature
    # ------------------------------------------------------------------
    def _state_buffer(self, name: str, sname: str, like: torch.Tensor) -> torch.Tensor:
        key = (name, sname, tuple(like.shape), like.dtype)
        buf = self._state_buffers.get(key)
        if buf is None:
            buf = self._state_buffers[key] = torch.empty(like.shape, dtype=like.dtype, device=self._device)
        return buf

    def _capture(self, names: Tuple[str, ...], step_fn: Callable, states: dict, leaves: list,
                 structure: tuple) -> _Graph:
        """Warm up, then capture ``step_fn(states, *call)`` over static
        copies of the inputs ``call`` (module docstring). ``states`` are the
        states the step is given (a cohort's stacked ones); the graph merges
        into engine buffers of their shapes."""
        t0 = time.perf_counter()
        dev = self._device
        inputs = [
            torch.empty(x.shape, dtype=x.dtype, device=dev) if isinstance(x, torch.Tensor) else x for x in leaves
        ]
        buffers = {n: {s: self._state_buffer(n, s, v) for s, v in d.items()} for n, d in states.items()}
        # the defaults (read by reset() inside the step) stay alive with the graph
        pins = [m._defaults[s] for n in names for m in (self._metrics[n],) for s in m._defaults]
        self._copy_in(inputs, leaves, buffers, states)
        call = _unflatten(structure, iter(inputs))
        side = self._warm_up(step_fn, buffers, call)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        # the warm-up was the build's run of the hooks: the capture is muted.
        # No cyclic collection inside the capture (``torch.cuda.graph`` runs
        # one just before it): one that frees an earlier graph calls its
        # reset, which is illegal while this thread captures, and the capture
        # is invalidated
        with torch.cuda.device(dev), tracing(), _trace.muted(), _no_cyclic_gc():
            # thread_local: other threads' CUDA calls stay legal during the capture
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                new_states, *outputs = step_fn(buffers, *call)
                merged = {n: {} for n in new_states}
                for n, d in new_states.items():
                    for s, v in d.items():
                        buf = buffers[n][s]
                        if v.dtype == buf.dtype and v.shape == buf.shape:
                            merged[n][s] = buf.copy_(v)
                        else:  # copying into the buffer would cast the state back
                            merged[n][s] = v
        pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        return _Graph(graph, inputs, buffers, merged, tuple(outputs), pins, pool_bytes,
                      (time.perf_counter() - t0) * 1e3)

    def _warm_up(self, step_fn: Callable, states: dict, call: tuple) -> torch.cuda.Stream:
        """Run ``step_fn(states, *call)`` once uncaptured on a new side
        stream, value checks off and host reads raising; returns the stream,
        which the current stream then waits on."""
        dev = self._device
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(side), tracing(), _host_reads_raise():
            step_fn(states, *call)
        torch.cuda.current_stream(dev).wait_stream(side)
        return side

    @staticmethod
    def _copy_in(inputs: list, leaves: list, buffers: dict, states: dict) -> None:
        """Copy the step's inputs into the static inputs, and every state
        into the engine's buffer."""
        for dst, src in zip(inputs, leaves):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
        for n, d in states.items():
            for s, v in d.items():
                buffers[n][s].copy_(v)

    def _run(self, program: Optional[_Graph], make_step: Callable, states: dict, leaves: list, structure: tuple,
             built: bool, watch_key: str):
        """One step: ``(new_states, values)``, and the stacked finite flags
        with a guard. On the card the states and inputs are already copied
        into the program's buffers. ``built`` says the program was built in
        this step: on the CPU that run is the build's, and every later run
        mutes the hooks inside the step."""
        with _obs.profile_span(watch_key):
            if program is None:  # the CPU: the step function itself, value checks off
                with tracing(), (nullcontext() if built else _trace.muted()):
                    return make_step()(states, *_unflatten(structure, iter(leaves)))
            program.graph.replay()
        # clones: nothing handed out is a buffer the next replay writes
        return apply_to_collection((program.merged,) + program.outputs, torch.Tensor, torch.clone)

    def _current_states(self, names: Tuple[str, ...]) -> Dict[str, Dict[str, torch.Tensor]]:
        return {n: {s: getattr(self._metrics[n], s) for s in self._metrics[n]._defaults} for n in names}

    def _write_back(self, names: Tuple[str, ...], new_states, values) -> None:
        """Install the step's states and values on the metrics (under the
        lock: generations install in step order)."""
        for name in names:
            m = self._metrics[name]
            for sname, v in new_states[name].items():
                setattr(m, sname, v)
            m._forward_cache = values.get(name)
            m._computed = None
        self.dispatch_generation += 1

    # ------------------------------------------------------------------
    # the public step
    # ------------------------------------------------------------------
    def step(self, *args: Any, **kwargs: Any):
        """One forward over the batch: returns what the eager forward would
        (the per-metric dict for a collection, the bare value for a single
        metric), having installed every metric's new states. On the card the
        work is queued: reading a value is the synchronization point."""
        # a distributed backend appearing after construction makes the
        # no-sync step wrong: run everything eager then
        if is_distributed_initialized():
            return self._finish(self._run_eager(tuple(self._metrics), args, kwargs))

        names = self._compiled_names()
        out: Dict[str, Any] = {}
        if names:
            leaves: List[Any] = []
            structure = _flatten((args, kwargs), leaves)
            with self._lock:
                # one engine dispatch = one step of the span and flight records
                if _trace.tracing_enabled() or _flight.flight_enabled():
                    _trace.advance_step()
                guard = _rguard.active()
                guard_token = self._guard_token(guard)
                with _trace.span("engine.cache_lookup", phase="dispatch", engine=self._watch_key):
                    signature = self._signature(names, self._current_states(names), leaves, structure, guard_token)
                    program, cache_hit, cold = self._lookup(signature)
                # the states handed to the step; on the card every one is
                # copied into the graph's buffers (the JAX package donates,
                # copying every state first when a guard is on): the live
                # attributes are the last-good snapshot on every step
                with _trace.span("engine.donate", phase="dispatch", copy_all=self._device.type == "cuda"):
                    states = self._current_states(names)
                    if program is not None:
                        self._copy_in(program.inputs, leaves, program.states, states)
                telemetry_on = _obs.enabled()
                if _flight.flight_enabled():
                    _flight.record("engine_dispatch", engine=self._watch_key, cache_hit=cache_hit)
                if telemetry_on:
                    _obs.get().count("engine.dispatches")
                t0 = time.perf_counter()
                # the cost ledger's shapes of the build's inputs, taken
                # before the step replaces the states
                ledger_inputs = None
                if not cache_hit and _costledger.cost_ledger_enabled():
                    ledger_inputs = _costledger.shape_tree((states, args, kwargs))
                make_step = lambda: self._make_step_fn(names, guard_token)  # noqa: E731
                try:
                    with _trace.span("engine.dispatch", phase="dispatch", engine=self._watch_key, cache_hit=cache_hit):
                        if not cache_hit:
                            program = self._build(signature, names, make_step, states, leaves, structure,
                                                  self._watch_key, max(8, self._cache_size))
                        new_states, values, *finites = self._run(program, make_step, states, leaves, structure,
                                                                 not cache_hit, self._watch_key)
                except Exception as err:  # noqa: BLE001 - any build failure
                    self._compiled.pop(signature, None)
                    self._check_states_alive(names, err)
                    # the metric attributes were never touched: rerun eagerly.
                    # If that raises too the batch was bad: it propagates and
                    # the engine stays compiled for the next batch. Only when
                    # eager succeeds where the build failed is a forward not a
                    # pure step: demote the members that fail alone (all of
                    # them when none does)
                    out_eager = self._run_eager(tuple(self._metrics), args, kwargs)
                    if guard is not None and telemetry_on:
                        # the eager rerun succeeded where the step died: that
                        # is the recovery (a bad input re-raises above)
                        _obs.get().count("reliability.engine_dispatch_recoveries")
                    failed = self._failing_members(names, leaves, structure) or {n: err for n in names}
                    reason = f"trace failed: {type(err).__name__}: {err}"
                    # one dump per demotion, with the steps leading up to it
                    _flight.dump_on_failure(
                        "engine_dispatch_failure",
                        engine=self._watch_key,
                        error=f"{type(err).__name__}: {err}",
                        demoted=list(failed),
                    )
                    for n, e in failed.items():
                        self._eager_names.setdefault(n, f"trace failed: {type(e).__name__}: {e}")
                    if telemetry_on:
                        _obs.get().count("engine.trace_failures")
                        _obs.get().event("eager_fallback", engine=self._watch_key, metrics=list(failed), reason=reason)
                    # once per engine, not once per training-loop step
                    warn_once(
                        f"CompiledStepEngine: falling back to eager forward ({type(err).__name__}: {err})",
                        key=f"engine-demoted:{id(self)}",
                    )
                    # a durable EvalSession wrapping these metrics checkpoints
                    # the surviving state now; never allowed to turn the
                    # recovery into a crash
                    try:
                        from metrics_tpu_torch.reliability import session as _rsession

                        _rsession.notify_dispatch_failure(self._metrics.values())
                    except Exception:  # noqa: BLE001 - best-effort hook
                        pass
                    return self._finish(out_eager)
                if not cache_hit:
                    # a miss carries the build: warm-up and capture on the
                    # card, and the first replay's enqueue
                    dt = time.perf_counter() - t0
                    if telemetry_on:
                        _obs.get().observe("engine.trace_s", dt)
                    _costledger.note_compile(self._watch_key, "step", signature, dt, cold,
                                             lambda: self._program_definition(names, guard_token), ledger_inputs)
                self._write_back(names, new_states, values)
                if finites:
                    self._apply_guard_verdicts(guard, names, finites[0])
                if _env.san_enabled():
                    # MetricSan use-after-donate canary: after a successful
                    # dispatch no freed buffer and no graph buffer may remain
                    # reachable from the metrics; lazy, cold off-path
                    from metrics_tpu_torch.analysis import sanitizer as _san

                    _san.on_engine_dispatch(self._metrics, names, self._graph_storages())
                for name in names:
                    out[name] = values.get(name)

        if self._eager_names:
            if _obs.enabled():
                _obs.get().count("engine.eager_steps", len(self._eager_names))
            out.update(self._run_eager(tuple(self._eager_names), args, kwargs))
        # the registration order of the metrics
        return self._finish({name: out[name] for name in self._metrics})

    __call__ = step

    def _apply_guard_verdicts(self, guard, names: Tuple[str, ...], finites: torch.Tensor) -> None:
        """Host-side epilogue of the in-step finite check: every member's
        flag in one device-to-host copy, then the guard's policy. Under
        raise / quarantine the step already selected the last-good states;
        warn keeps the poisoned ones."""
        rolled_back = guard.policy in ("raise", "quarantine")
        host_flags = _flags_to_host(finites).tolist()
        for name, flag in zip(names, host_flags):
            guard.stats["checks"] += 1
            # the opt-in integer-saturation warning runs on the written-back
            # states; no-op unless guard.overflow_margin is set
            guard.maybe_warn_overflow(self._metrics[name], context=f"compiled step ({name})")
            if not flag:
                guard.handle_violation(
                    self._metrics[name], None, context=f"compiled step ({name})", already_rolled_back=rolled_back
                )

    def _graph_storages(self) -> set:
        """Storage pointers of every cached graph's static inputs, state
        buffers and outputs: what a replay writes (the sanitizer's canary
        reads them; empty on the CPU, which builds no graph)."""
        ptrs = set()
        for program in self._compiled.values():
            if program is not None:
                ptrs |= program.storage_ptrs()
        return ptrs

    def _buffer_ptrs(self) -> set:
        """Data pointers of the engine's state buffers."""
        return {b.data_ptr() for b in self._state_buffers.values() if b.numel()}

    def _check_states_alive(self, names: Tuple[str, ...], err: Exception) -> None:
        """After a failed step, no live state may be one of the engine's
        buffers (the JAX package's check that no live state was donated):
        every state handed out is a clone, so this holds by construction;
        refuse to continue if it ever does not."""
        owned = self._buffer_ptrs()
        for name in names:
            m = self._metrics[name]
            for sname in m._defaults:
                v = getattr(m, sname)
                if isinstance(v, torch.Tensor) and v.numel() and v.data_ptr() in owned:
                    raise RuntimeError(
                        f"compiled step failed while state {name}.{sname} aliases an engine buffer;"
                        " accumulated state lost: reset() the metric"
                    ) from err

    def _failing_members(self, names: Tuple[str, ...], leaves: list, structure: tuple) -> Dict[str, Exception]:
        """The members of a failed group whose step fails alone, with their
        errors. A trial runs the member's step function once, as a warm-up
        (on the card) or as the CPU step, captures nothing and leaves every
        metric attribute as it was."""
        if len(names) == 1:
            return {}
        call = _unflatten(structure, iter([x.to(self._device) if isinstance(x, torch.Tensor) else x
                                           for x in leaves]))
        failed = {}
        # the trials are no step of the JAX package's: their hooks are muted
        with _trace.muted():
            for n in names:
                try:
                    if self._device.type == "cuda":
                        self._warm_up(self._make_step_fn((n,)), self._current_states((n,)), call)
                    else:
                        with tracing():
                            self._make_step_fn((n,))(self._current_states((n,)), *call)
                except Exception as err:  # noqa: BLE001 - the member's own failure
                    failed[n] = err
        return failed

    def cohort_step(
        self,
        states: Dict[str, Dict[str, torch.Tensor]],
        args: tuple,
        kwargs: Optional[dict] = None,
        *,
        capacity: int,
        n_tenants: Optional[int] = None,
        health_state: Optional[Dict[str, torch.Tensor]] = None,
    ):
        """One step of every tenant of a stacked-state cohort (see
        :class:`~metrics_tpu_torch.cohort.MetricCohort`, which owns the
        stacked states, the padding and the write-back): on the card one
        CUDA graph replay per (signature, capacity bucket).

        ``states`` is the stacked ``{member: {state: tensor}}`` (leading dim
        ``capacity``); the tensor leaves of ``args`` / ``kwargs`` carry the
        same leading dim. Returns ``(new_states, values, finites, guard,
        new_health)``: ``finites`` is None without a guard, else the
        ``(capacity, members)`` bool flags, the rollback of the poisoned
        tenants already selected under raise / quarantine; ``guard`` is the
        guard the step ran under; ``new_health`` is None unless
        ``health_state`` (the four accumulators plus the ``valid`` mask and
        the ``step`` index) was given, in which case the health variant, a
        separate program, runs.

        There is no eager fallback: the cohort exists to remove per-tenant
        eager reruns. A failed build or replay drops the program from the
        cache and raises; nothing is demoted. The step never syncs: a
        distributed cohort syncs at ``compute()``. ``n_tenants`` (the live
        tenant count) feeds the ``cohort.dispatch_tenants`` counter."""
        kwargs = dict(kwargs or {})
        names = self._compiled_names()
        if self._eager_names or not names:
            raise ValueError(
                "cohort dispatch requires every metric in the engine to be"
                f" engine-eligible; eager fallbacks: {self._eager_names}"
            )
        health = health_state is not None
        states, call = _cohort_call(states, args, kwargs, health_state)
        leaves: List[Any] = []
        structure = _flatten(call, leaves)
        watch_key = self._cohort_watch_key
        with self._lock:
            if _trace.tracing_enabled() or _flight.flight_enabled():
                _trace.advance_step()
            guard = _rguard.active()
            guard_token = self._guard_token(guard)
            with _trace.span("engine.cache_lookup", phase="dispatch", engine=watch_key):
                signature = self._signature(names, states, leaves, structure, guard_token,
                                            ("cohort", int(capacity), health))
                program, cache_hit, cold = self._lookup(signature)
            telemetry_on = _obs.enabled()
            if telemetry_on:
                tel = _obs.get()
                tel.count("engine.dispatches")
                tel.count("cohort.dispatches")
                if n_tenants is not None:
                    tel.count("cohort.dispatch_tenants", n_tenants)
            t0 = time.perf_counter()
            ledger_inputs = None
            if not cache_hit and _costledger.cost_ledger_enabled():
                ledger_inputs = _costledger.shape_tree((states,) + call)
            if _flight.flight_enabled():
                _flight.record("cohort_dispatch", engine=watch_key, cache_hit=cache_hit, capacity=int(capacity))
            make_step = lambda: self._make_cohort_step_fn(names, health, guard_token)  # noqa: E731
            try:
                with _trace.span("engine.dispatch", phase="dispatch", engine=watch_key, cache_hit=cache_hit):
                    if not cache_hit:
                        program = self._build(signature, names, make_step, states, leaves, structure, watch_key,
                                               max(_COHORT_TRACE_BUDGET, self._cache_size))
                    elif program is not None:
                        self._copy_in(program.inputs, leaves, program.states, states)
                    new_states, values, *finites = self._run(program, make_step, states, leaves, structure,
                                                             not cache_hit, watch_key)
            except Exception:
                # never reuse a program whose build or replay died
                self._compiled.pop(signature, None)
                if telemetry_on:
                    _obs.get().count("engine.trace_failures")
                raise
            if not cache_hit:
                dt = time.perf_counter() - t0
                if telemetry_on:
                    _obs.get().observe("engine.trace_s", dt)
                _costledger.note_compile(watch_key, "cohort_step", signature, dt, cold,
                                         lambda: self._program_definition(names, guard_token, health), ledger_inputs)
            self.dispatch_generation += 1
        new_health = None
        if health:
            new_states = dict(new_states)
            new_health = new_states.pop(_COHORT_HEALTH_KEY)
        return new_states, values, (finites[0] if finites else None), guard, new_health

    # ------------------------------------------------------------------
    # abstract steps: the programs a step would build, traced for the
    # program audit (``metrics_tpu_torch.analysis``)
    # ------------------------------------------------------------------
    def abstract_step(self, *args: Any, **kwargs: Any):
        """Trace the step function :meth:`step` would build for these inputs
        (the unguarded program; a guard token only adds the finite-flag
        epilogue) over fake tensors of the compiled members' current states
        and of the call's tensors, on their devices: returns
        ``(graph_module, out_shapes, n_donated)``. ``out_shapes`` is the
        ``(new_states, values)`` tree with :class:`LeafSpec` leaves;
        ``n_donated`` counts the state leaves the step writes back (the
        buffers a step copies in and clones out, where the JAX package
        donates), which lead the graph's placeholders.

        The static-analysis hook (:mod:`metrics_tpu_torch.analysis.program`).
        It touches no signature cache, metric state, ``trace_count``,
        watchdog, cost ledger or telemetry, captures no CUDA graph, launches
        no kernel and allocates no device memory. A host read in the step
        raises out of the trace."""
        names = self._compiled_names()
        if not names:
            raise ValueError(
                "every metric in this engine runs eager"
                f" ({self._eager_names}); there is no compiled step program"
                " to trace"
            )
        states = self._current_states(names)
        return self._abstract(self._make_step_fn(names, None), states, args, kwargs)

    def abstract_cohort_step(self, *args: Any, capacity: int = 4, **kwargs: Any):
        """:meth:`abstract_step` of the cohort step :meth:`cohort_step` would
        build at ``capacity``: the same step function under
        ``torch.func.vmap``. The inputs are one tenant's; the states and
        every tensor input get a leading tenant axis of ``capacity`` here
        (fake tensors of the stacked shapes)."""
        names = self._compiled_names()
        if not names:
            raise ValueError(
                "every metric in this engine runs eager"
                f" ({self._eager_names}); there is no cohort step program to trace"
            )
        states, args, kwargs = self._stacked_abstract_inputs(names, args, kwargs, capacity)
        return self._abstract(self._make_cohort_step_fn(names), states, args, kwargs)

    def abstract_double_buffer_step(self, *args: Any, capacity: Optional[int] = None, **kwargs: Any):
        """Trace the two-generation composition of the step function over
        fake tensors (nothing built, nothing launched): generation N steps
        from the compiled members' current states, generation N+1 from
        generation N's state outputs, both on the same batch, and both
        generations' values are returned. Returns ``(graph_module,
        out_shapes, n_donated, n_state_outputs)``: ``out_shapes`` is the
        ``(new_states_N, values_N, new_states_N+1, values_N+1)`` tree of
        :class:`LeafSpec` leaves, and generation N's state outputs lead the
        graph's outputs (what ``_write_back`` installs and generation N+1
        steps from). The hook behind the MTA009 prover's cross-check
        (:func:`metrics_tpu_torch.analysis.concurrency.composed_generation_hazards`).
        ``capacity`` traces the vmapped cohort step over stacked states
        instead, as :meth:`abstract_cohort_step` does. Like
        :meth:`abstract_step` it traces the unguarded program and touches
        no signature cache, metric state, counter, watchdog, cost ledger or
        telemetry."""
        names = self._compiled_names()
        if not names:
            raise ValueError(
                "every metric in this engine runs eager"
                f" ({self._eager_names}); there is no step program to trace"
            )
        if capacity is None:
            step = self._make_step_fn(names, None)
            states = self._current_states(names)
        else:
            step = self._make_cohort_step_fn(names)
            states, args, kwargs = self._stacked_abstract_inputs(names, args, kwargs, capacity)

        def two_generations(states0, batch0, batch1):
            new0, vals0 = step(states0, *batch0)
            new1, vals1 = step(new0, *batch1)
            return new0, vals0, new1, vals1

        graph, out_shapes, n_donated = self._abstract(two_generations, states, (args, kwargs), (args, kwargs))
        return graph, out_shapes, n_donated, _count_specs(out_shapes[0])

    def _stacked_abstract_inputs(self, names: Tuple[str, ...], args: tuple, kwargs: dict, capacity: int):
        """The current states and the call with a leading tenant axis of
        ``capacity`` on every tensor (as :class:`LeafSpec`): what a cohort
        of that capacity feeds its step."""

        def stack(x):
            if isinstance(x, torch.Tensor):
                return LeafSpec((int(capacity),) + tuple(x.shape), x.dtype, x.device)
            return x

        states = {n: {s: stack(v) for s, v in d.items()} for n, d in self._current_states(names).items()}
        return states, tuple(stack(a) for a in args), {k: stack(v) for k, v in kwargs.items()}

    @staticmethod
    def _abstract(step_fn: Callable, states: dict, *call: Any):
        """``(graph_module, out_shapes, n_donated)`` of ``step_fn(states,
        *call)`` over fake tensors of ``states`` and the call (tensors or
        :class:`LeafSpec`), value checks off and the hooks inside the step
        muted."""
        leaves: List[Any] = []
        _flatten(states, leaves)
        with tracing(), _trace.muted():
            graph, out_shapes = fake_trace(step_fn, (states,) + call)
        return graph, out_shapes, len(leaves)

    # ------------------------------------------------------------------
    # lookups that build nothing
    # ------------------------------------------------------------------
    def is_built(self, *args: Any, **kwargs: Any) -> bool:
        """Whether :meth:`step` on these inputs would build nothing: its
        signature is cached, or the step runs no build at all (every member
        eager, or a distributed world). Counts nothing, builds nothing and
        leaves the LRU order as it is. An asynchronous server sends only
        such steps to its worker thread: a build's warm-up turns on the
        process-global sync debug mode, under which another thread's
        synchronizing call raises.

        Takes no lock, so the serve loop never waits for a step in flight on
        the worker: a step installs states of the shapes and dtypes it read,
        and a membership test of the cache is one atomic dict read."""
        if is_distributed_initialized():
            return True
        names = self._compiled_names()
        if not names:
            return True
        leaves: List[Any] = []
        structure = _flatten((args, kwargs), leaves)
        signature = self._signature(names, self._current_states(names), leaves, structure,
                                    self._guard_token(_rguard.active()))
        return signature in self._compiled

    def cohort_is_built(self, states: Dict[str, Dict[str, torch.Tensor]], args: tuple, kwargs: Optional[dict] = None,
                        *, capacity: int, health_state: Optional[Dict[str, Any]] = None) -> bool:
        """:meth:`is_built` for :meth:`cohort_step` (same arguments; input
        leaves may be :class:`LeafSpec` stand-ins of the routed tensors;
        lock-free like it)."""
        names = self._compiled_names()
        if self._eager_names or not names:
            return True  # cohort_step raises without building
        states, call = _cohort_call(states, args, dict(kwargs or {}), health_state)
        leaves: List[Any] = []
        structure = _flatten(call, leaves)
        signature = self._signature(names, states, leaves, structure, self._guard_token(_rguard.active()),
                                    ("cohort", int(capacity), health_state is not None))
        return signature in self._compiled

    @property
    def _cohort_watch_key(self) -> str:
        return self._watch_key + "@cohort"

    def _run_eager(self, names: Tuple[str, ...], args: tuple, kwargs: dict) -> Dict[str, Any]:
        with shared_canonicalization(), regression_family_sharing():
            return {name: self._metrics[name](*args, **self._metrics[name]._filter_kwargs(**kwargs)) for name in names}

    def _finish(self, out: Dict[str, Any]):
        return out["metric"] if self._single else out

    @property
    def cache_size(self) -> int:
        return self._cache_size

    def cache_info(self) -> Dict[str, Any]:
        """Diagnostics: kept signatures, builds, fallbacks and, on the card,
        the graphs' private pools and build times (warm-up plus capture)."""
        graphs = [p for p in self._compiled.values() if p is not None]
        return {
            "compiled_signatures": len(self._compiled),
            "trace_count": self.trace_count,
            "seen_signatures": len(self._seen_signatures),
            "eager_fallbacks": dict(self._eager_names),
            "graph_pool_bytes": sum(p.pool_bytes for p in graphs),
            "graph_build_ms": [p.build_ms for p in graphs],
        }
