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

On the CPU (``device="cpu"``) each step runs the same step function
directly with value checks off: the engine's plain version.

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
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import torch
import torch.utils._pytree as pytree

from metrics_tpu_torch.functional.regression.sufficient_stats import regression_family_sharing
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.parallel.backend import is_distributed_initialized
from metrics_tpu_torch.utilities.checks import shared_canonicalization
from metrics_tpu_torch.utilities.data import apply_to_collection, tracing
from metrics_tpu_torch.utilities.prints import warn_once

__all__ = ["CompiledStepEngine"]

_DEFAULT_CACHE_SIZE = 16

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


def _abstract_leaf(x: Any) -> tuple:
    """Cache-key atom of one input leaf: tensors key on (shape, dtype,
    device); anything else on its type and value (a capture bakes it in)."""
    if isinstance(x, torch.Tensor):
        return ("arr", tuple(x.shape), x.dtype, x.device)
    return ("val", type(x), x)


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


class _Graph:
    """One captured signature: the graph, its static inputs, the state
    buffers it merges into, its captured values, and the tensors it reads
    that live outside its pool (pinned, so they outlive every replay)."""

    __slots__ = ("graph", "inputs", "states", "values", "pins", "pool_bytes", "build_ms")

    def __init__(self, graph, inputs, states, values, pins, pool_bytes, build_ms):
        self.graph = graph
        self.inputs = inputs
        self.states = states
        self.values = values
        self.pins = pins
        self.pool_bytes = pool_bytes
        self.build_ms = build_ms


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

    def __init__(self, metrics: Union[Metric, Mapping[str, Metric]], cache_size: int = _DEFAULT_CACHE_SIZE):
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
    def _make_step_fn(self, names: Tuple[str, ...]) -> Callable:
        metrics = self._metrics

        def step_fn(states, args, kwargs):
            new_states = {}
            values = {}
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
                        new_states[name] = {
                            s: Metric._merge_state_value(m._reductions[s], states[name][s], batch[s])
                            for s in m._defaults
                        }
                    finally:
                        m._restore_state(saved)
                        m._computed = None
            return new_states, values

        return step_fn

    # ------------------------------------------------------------------
    # the cohort step function: the same step, vmapped over a leading
    # tenant axis
    # ------------------------------------------------------------------
    def _make_cohort_step_fn(self, names: Tuple[str, ...], health: bool = False) -> Callable:
        """The step function of ``names`` under ``torch.func.vmap`` over the
        leading tenant axis of the states and of every tensor input. Each
        tenant's new state depends only on its own rows, so padding slots
        stay inert. ``health=True`` also advances the per-tenant health
        accumulators (``states[_COHORT_HEALTH_KEY]``) outside the vmap, in
        the same step, from ``aux`` (the ``valid`` slot mask and the
        cohort's ``step`` index)."""
        base = self._make_step_fn(names)

        def cohort_step_fn(states, args, kwargs):
            in_dims = (0, _cohort_in_dims(args), _cohort_in_dims(kwargs))
            return torch.func.vmap(base, in_dims=in_dims)(states, args, kwargs)

        if not health:
            return cohort_step_fn

        def cohort_health_step_fn(states, args, kwargs, aux):
            new_states, values = cohort_step_fn({n: states[n] for n in names}, args, kwargs)
            new_states = dict(new_states)
            new_states[_COHORT_HEALTH_KEY] = self._advance_health(
                states[_COHORT_HEALTH_KEY], new_states, names, aux, args, kwargs
            )
            return new_states, values

        return cohort_health_step_fn

    @staticmethod
    def _advance_health(
        h: Dict[str, torch.Tensor],
        new_states: Dict[str, Dict[str, torch.Tensor]],
        names: Tuple[str, ...],
        aux: Dict[str, torch.Tensor],
        args: tuple,
        kwargs: dict,
    ) -> Dict[str, torch.Tensor]:
        """One elementwise advance of the int32 ``(capacity,)`` health
        accumulators: rows seen, updates and the last active step of every
        live slot, and the slots whose merged float states are not all
        finite. ``aux["valid"]`` masks the padding slots."""
        valid = aux["valid"].to(torch.bool)
        count = h["updates"].dtype
        nonfinite = torch.zeros(valid.shape, dtype=count, device=valid.device)
        for name in names:
            flag = _tenant_finite_flags(new_states[name])
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
    @staticmethod
    def _signature(names: Tuple[str, ...], states: dict, leaves: list, structure: tuple, extra: tuple = ()) -> tuple:
        state_sig = tuple((n, s, tuple(v.shape), v.dtype) for n, d in states.items() for s, v in d.items())
        return (names, state_sig, structure, tuple(_abstract_leaf(x) for x in leaves)) + extra

    def _get_compiled(self, signature: tuple, names: Tuple[str, ...], make_step: Callable, states: dict,
                      leaves: list, structure: tuple):
        """The signature's program (None on the CPU, where the step function
        runs directly); builds it on a miss."""
        if signature in self._compiled:
            self._compiled.move_to_end(signature)
            return self._compiled[signature]
        self.trace_count += 1
        program = self._capture(names, make_step(), states, leaves, structure) if self._device.type == "cuda" else None
        if len(self._compiled) >= self._cache_size:
            self._compiled.popitem(last=False)  # LRU eviction
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
        with torch.cuda.device(dev), tracing():
            # thread_local: other threads' CUDA calls stay legal during the capture
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                new_states, values = step_fn(buffers, *call)
                for n, d in new_states.items():
                    for s, v in d.items():
                        buffers[n][s].copy_(v)
        pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        return _Graph(graph, inputs, buffers, values, pins, pool_bytes, (time.perf_counter() - t0) * 1e3)

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

    def _run(self, program: Optional[_Graph], make_step: Callable, states: dict, leaves: list, structure: tuple):
        """One step: ``(new_states, values)``."""
        if program is None:  # the CPU: the step function itself, value checks off
            with tracing():
                return make_step()(states, *_unflatten(structure, iter(leaves)))
        self._copy_in(program.inputs, leaves, program.states, states)
        program.graph.replay()
        # clones: nothing handed out is a buffer the next replay writes
        return apply_to_collection((program.states, program.values), torch.Tensor, torch.clone)

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
                states = self._current_states(names)
                signature = self._signature(names, states, leaves, structure)
                make_step = lambda: self._make_step_fn(names)  # noqa: E731
                try:
                    program = self._get_compiled(signature, names, make_step, states, leaves, structure)
                    new_states, values = self._run(program, make_step, states, leaves, structure)
                except Exception as err:  # noqa: BLE001 - any build failure
                    self._compiled.pop(signature, None)
                    # the metric attributes were never touched: rerun eagerly.
                    # If that raises too the batch was bad: it propagates and
                    # the engine stays compiled for the next batch. Only when
                    # eager succeeds where the build failed is a forward not a
                    # pure step: demote the members that fail alone (all of
                    # them when none does)
                    out_eager = self._run_eager(tuple(self._metrics), args, kwargs)
                    failed = self._failing_members(names, leaves, structure) or {n: err for n in names}
                    for n, e in failed.items():
                        self._eager_names.setdefault(n, f"trace failed: {type(e).__name__}: {e}")
                    # once per engine, not once per training-loop step
                    warn_once(
                        f"CompiledStepEngine: falling back to eager forward ({type(err).__name__}: {err})",
                        key=f"engine-demoted:{id(self)}",
                    )
                    return self._finish(out_eager)
                self._write_back(names, new_states, values)
                for name in names:
                    out[name] = values.get(name)

        if self._eager_names:
            out.update(self._run_eager(tuple(self._eager_names), args, kwargs))
        # the registration order of the metrics
        return self._finish({name: out[name] for name in self._metrics})

    __call__ = step

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
        for n in names:
            try:
                if self._device.type == "cuda":
                    self._warm_up(self._make_step_fn((n,)), self._current_states((n,)), call)
                else:
                    self._run(None, lambda: self._make_step_fn((n,)), self._current_states((n,)), leaves, structure)
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
        health_state: Optional[Dict[str, torch.Tensor]] = None,
    ):
        """One step of every tenant of a stacked-state cohort (see
        :class:`~metrics_tpu_torch.cohort.MetricCohort`, which owns the
        stacked states, the padding and the write-back): on the card one
        CUDA graph replay per (signature, capacity bucket).

        ``states`` is the stacked ``{member: {state: tensor}}`` (leading dim
        ``capacity``); the tensor leaves of ``args`` / ``kwargs`` carry the
        same leading dim. Returns ``(new_states, values, new_health)``:
        ``new_health`` is None unless ``health_state`` (the four
        accumulators plus the ``valid`` mask and the ``step`` index) was
        given, in which case the health variant, a separate program, runs.

        There is no eager fallback: the cohort exists to remove per-tenant
        eager reruns. A failed build or replay drops the program from the
        cache and raises; nothing is demoted. The step never syncs: a
        distributed cohort syncs at ``compute()``."""
        kwargs = dict(kwargs or {})
        names = self._compiled_names()
        if self._eager_names or not names:
            raise ValueError(
                "cohort dispatch requires every metric in the engine to be"
                f" engine-eligible; eager fallbacks: {self._eager_names}"
            )
        health = health_state is not None
        call: tuple = (args, kwargs)
        if health:
            health_state = dict(health_state)
            aux = {"valid": health_state.pop("valid"), "step": health_state.pop("step")}
            states = {**states, _COHORT_HEALTH_KEY: health_state}
            call = (args, kwargs, aux)
        leaves: List[Any] = []
        structure = _flatten(call, leaves)
        with self._lock:
            signature = self._signature(names, states, leaves, structure, ("cohort", int(capacity), health))
            make_step = lambda: self._make_cohort_step_fn(names, health)  # noqa: E731
            try:
                program = self._get_compiled(signature, names, make_step, states, leaves, structure)
                new_states, values = self._run(program, make_step, states, leaves, structure)
            except Exception:
                # never reuse a program whose build or replay died
                self._compiled.pop(signature, None)
                raise
            self.dispatch_generation += 1
        new_health = None
        if health:
            new_states = dict(new_states)
            new_health = new_states.pop(_COHORT_HEALTH_KEY)
        return new_states, values, new_health

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
            "eager_fallbacks": dict(self._eager_names),
            "graph_pool_bytes": sum(p.pool_bytes for p in graphs),
            "graph_build_ms": [p.build_ms for p in graphs],
        }
