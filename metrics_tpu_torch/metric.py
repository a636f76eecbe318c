"""Core metric runtime: the stateful ``Metric`` base class.

Port of the core of ``metrics_tpu/metric.py``: the state registry
(``add_state``), forward/update/compute semantics including the batch-local
forward value, the one-update fused forward for mergeable states, result
caching, gather-then-reduce sync at compute (the exact tier, the quantized
``sync_precision=`` tier with its error-feedback residuals, a
``SyncPolicy``'s retry / timeout / degradation, and the two-level sync under
a ``HierarchicalSyncBackend``), reset, persistence and pickling, and metric
arithmetic: the operators on ``Metric`` build a ``CompositionalMetric``.

Metric state is a set of ``torch.Tensor``s (or Python lists of tensors for
"cat" states) on one explicit ``torch.device``. A metric built without a
``device`` lives on the GPU: construction raises when no CUDA device is
present rather than drifting to the CPU. Inputs passed to ``update`` (and so
to ``forward``) are moved to the metric's device. States are replaced, never
updated in place, by the metrics of this package.
"""
import functools
import inspect
import operator
import time as _time
from abc import ABC, abstractmethod
from contextlib import nullcontext
from copy import deepcopy
from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch

from metrics_tpu_torch.observability import identity as _obs_identity
from metrics_tpu_torch.observability import telemetry as _obs
from metrics_tpu_torch.observability import trace as _obs_trace
from metrics_tpu_torch.parallel import hierarchy as _hier
from metrics_tpu_torch.parallel import quantize as _quant
from metrics_tpu_torch.parallel.backend import get_sync_backend, is_distributed_initialized
from metrics_tpu_torch.reliability import guard as _rguard
from metrics_tpu_torch.reliability import sync as _rsync
from metrics_tpu_torch.utilities import env as _env
from metrics_tpu_torch.utilities.checks import shared_canonicalization
from metrics_tpu_torch.utilities.data import (
    _flatten,
    apply_to_collection,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
)
from metrics_tpu_torch.utilities.distributed import gather_all_tensors
from metrics_tpu_torch.utilities.prints import warn_once

# suffix of the per-quantized-state error-feedback residual companion (see
# ``Metric.add_state(sync_precision=...)``): ``<state>__qres`` is a REAL
# registered state — it snapshots, resets, checkpoints and resumes with the
# state it compensates — but it never crosses the wire (``_sync_dist``
# excludes it) and always stays f32 (``astype`` skips it)
_SYNC_RESIDUAL_SUFFIX = "__qres"


def _encode_session_cursor(cursor: int) -> torch.Tensor:
    """The durable-session step cursor as a checkpointable 0-d int32 tensor
    on the host (JAX's x64-off default, so the spec a save writes and the
    spec a load validates against agree with the JAX package's). The one
    encoding, shared by Metric, CompositionalMetric and MetricCollection."""
    return torch.tensor(int(cursor), dtype=torch.int32)


def _decode_session_cursor(value: Any) -> int:
    return int(value.item()) if isinstance(value, torch.Tensor) else int(value)


def _device_owned(v: Any, device: torch.device) -> torch.Tensor:
    """A checkpoint value as state on ``device`` that aliases nothing the
    caller holds: a copy, even when it already lies there."""
    return torch.as_tensor(v).detach().to(device, copy=True)


_NULL_CTX = nullcontext()


def _san_allow_ctx():
    """Sanctioned state-write scope for MetricSan's write interceptor.

    The update wrapper and forward's residual-seeding writes are
    legitimate lifecycle writes that are not reachable through the
    class-level methods the sanitizer wraps at arm time, so they declare
    themselves here. Zero-overhead when MetricSan is off: one flag read
    and a shared (reentrant) null context."""
    if _env.san_enabled():
        from metrics_tpu_torch.analysis import sanitizer as _san

        return _san.allow_state_writes()
    return _NULL_CTX


def _resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` means the GPU. There is no silent CPU fallback: without a
    CUDA device the caller must ask for the CPU by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "metrics_tpu_torch metrics run on a CUDA device by default and none is"
                " available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


class Metric(ABC):
    """Base class for all metrics.

    Implements ``add_state()``, ``forward()``, ``reset()`` and distributed
    synchronization. Override ``update()`` and ``compute()``; register state
    with ``add_state()``.

    Args:
        compute_on_step:
            Forward only calls ``update()`` and returns None if this is False.
        dist_sync_on_step:
            Synchronize metric state across processes at each ``forward()``
            before returning the value at the step.
        process_group:
            Scope of synchronization (passed to the sync backend as ``group``).
            Default: the entire world.
        dist_sync_fn:
            Callback performing the all-gather of metric state. When None, the
            active sync backend is used if distributed is initialized.
        device:
            Where the states live and the inputs are moved. Default (None):
            ``"cuda"``, which raises if no CUDA device is available.
    """

    # True only while forward() computes its batch-local step value; lets
    # computes relax epoch-end invariants a mini-batch can't satisfy.
    _batch_local_compute = False

    # provenance of the `_computed` cache (see `_wrap_compute`)
    _computed_batch_local = False

    # True only during the classic forward's batch-local re-update, which
    # runs on throwaway post-reset state: the state guard skips it
    _batch_local_pass = False

    # Durable-session step cursor (reliability/session.py): the index of the
    # last batch folded into the accumulated state, or None when the metric
    # is not enrolled in an EvalSession. When set, it travels with the
    # state: state_dict() and _named_states() emit it under
    # _SESSION_CURSOR_KEY, so a checkpoint of the state and the cursor that
    # describes it are one artifact. reset() keeps it: the session, not the
    # state, owns batch accounting.
    _session_cursor: Optional[int] = None
    _SESSION_CURSOR_KEY = "__session_cursor__"

    # Serving enrollment (serving/async_engine.py): a weakref to the
    # AsyncServingEngine whose worker steps this metric, or None. While
    # set, compute() drains the pipeline's staged batches first, so an
    # epoch value never misses a batch the serve loop already submitted.
    _serving_pipeline: Optional[Any] = None

    # Opt-in fused forward: when every state merge commutes with its
    # registered reduction — sum/min/max counters, list appends — forward
    # runs ONE update on fresh state, computes the batch value from it, and
    # folds the batch stats into the accumulated state, instead of two full
    # updates per forward.
    _fused_forward = False

    def __init__(
        self,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.device = _resolve_device(device)
        self.dist_sync_on_step = dist_sync_on_step
        self.compute_on_step = compute_on_step
        self.process_group = process_group
        self.dist_sync_fn = dist_sync_fn
        self._to_sync = True

        self._update_signature = inspect.signature(self.update)
        self.update = self._wrap_update(self.update)
        self.compute = self._wrap_compute(self.compute)
        self._computed = None
        self._forward_cache = None

        self._defaults: Dict[str, Any] = {}
        self._persistent: Dict[str, bool] = {}
        self._reductions: Dict[str, Optional[Callable]] = {}
        # state name -> "bf16" | "int8" for states synced through the
        # quantized tier (absent = exact); read with getattr defaults
        # everywhere so pickles made before the knob keep working
        self._sync_precisions: Dict[str, str] = {}

    def add_state(
        self,
        name: str,
        default: Union[torch.Tensor, list],
        dist_reduce_fx: Optional[Union[str, Callable]] = None,
        persistent: bool = False,
        sync_precision: str = "exact",
    ) -> None:
        """Register a metric state variable.

        Args:
            name: attribute name the state will live at (``self.<name>``).
            default: a ``torch.Tensor`` or an **empty list**; the reset value.
            dist_reduce_fx: ``"sum"``, ``"mean"``, ``"cat"``, ``"min"``,
                ``"max"``, a custom callable, or None. Applied to the
                cross-process gathered state (stacked ``(world, ...)`` for
                tensor states, flattened for list states).
            persistent: include this state in ``state_dict()``.
            sync_precision: ``"exact"`` (default, bit-identical sync) or a
                quantized wire tier — ``"bf16"`` (2× fewer bytes) or
                ``"int8"`` (block-scaled, ~3.9×). Only ``"sum"``-reduced
                tensor states qualify (list states are always exact); a
                quantized state gets a f32 error-feedback residual
                companion (``<name>__qres``) so repeated syncs do not drift.
        """
        if not isinstance(default, (torch.Tensor, list)) or (isinstance(default, list) and default):
            raise ValueError("state variable must be a tensor or any empty list (where you can append tensors)")
        if sync_precision not in _quant.PRECISIONS:
            raise ValueError(f"`sync_precision` must be one of {_quant.PRECISIONS}, got {sync_precision!r}")
        if sync_precision != "exact" and (isinstance(default, list) or dist_reduce_fx != "sum"):
            raise ValueError(
                f"sync_precision={sync_precision!r} requires a 'sum'-reduced"
                " array state: cat/list states and non-additive reductions"
                " always sync exact (quantizing a rank-order concat or an"
                " order-sensitive merge would corrupt it, not compress it)"
            )

        if dist_reduce_fx == "sum":
            dist_reduce_fx = dim_zero_sum
        elif dist_reduce_fx == "mean":
            dist_reduce_fx = dim_zero_mean
        elif dist_reduce_fx == "cat":
            dist_reduce_fx = dim_zero_cat
        elif dist_reduce_fx == "min":
            dist_reduce_fx = dim_zero_min
        elif dist_reduce_fx == "max":
            dist_reduce_fx = dim_zero_max
        elif dist_reduce_fx is not None and not callable(dist_reduce_fx):
            raise ValueError("`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', None]")

        if isinstance(default, list):
            # a distinct empty list: appends to the live state never alias the default
            setattr(self, name, [])
        else:
            default = default.detach().to(self.device)
            setattr(self, name, default.clone())

        self._defaults[name] = default
        self._persistent[name] = persistent
        self._reductions[name] = dist_reduce_fx
        if sync_precision != "exact":
            self._register_sync_residual(name, sync_precision, persistent)

    # ------------------------------------------------------------------
    # quantized sync tier (sync_precision=)
    # ------------------------------------------------------------------
    def _register_sync_residual(self, name: str, precision: str, persistent: bool) -> None:
        """Attach the f32 error-feedback residual companion to a quantized
        state. Registered like any state (snapshot, reset and checkpoint
        carry it) with a zero default and a 'sum' reduction: under the step
        engine's (accumulated, batch) fold the batch residual is always the
        zero default, so the merge is an identity and the residual only
        changes at sync time."""
        res_name = name + _SYNC_RESIDUAL_SUFFIX
        res_default = torch.zeros(tuple(self._defaults[name].shape), dtype=torch.float32, device=self.device)
        setattr(self, res_name, res_default.clone())
        self._defaults[res_name] = res_default
        self._persistent[res_name] = persistent
        self._reductions[res_name] = dim_zero_sum
        if not hasattr(self, "_sync_precisions"):
            self._sync_precisions = {}  # a pickle made before the knob
        self._sync_precisions[name] = precision

    def sync_precisions(self) -> Dict[str, str]:
        """Per-state wire precision of the quantized sync tier (states not
        listed sync exact). A copy; change it with :meth:`set_sync_precision`."""
        return dict(getattr(self, "_sync_precisions", {}))

    def _sync_residual_names(self) -> tuple:
        """Names of the error-feedback residual companion states."""
        return tuple(n + _SYNC_RESIDUAL_SUFFIX for n in getattr(self, "_sync_precisions", {}))

    def set_sync_precision(self, precision: str, states: Optional[Sequence[str]] = None) -> Dict[str, str]:
        """Switch registered states onto a sync tier after construction.

        Args:
            precision: ``"exact"`` | ``"bf16"`` | ``"int8"``.
            states: state names to switch. Default (None): every *eligible*
                state — ``"sum"``-reduced tensor states — with ineligible
                ones left exact (list states are exact by contract). Naming
                an ineligible state explicitly raises.

        Returns the resulting ``{state: precision}`` map (exact states
        omitted). Dropping back to ``"exact"`` deregisters the residual
        companions; switching between quantized tiers keeps the residual (it
        is f32 either way and still describes the last sync's error).
        """
        if precision not in _quant.PRECISIONS:
            raise ValueError(f"`sync_precision` must be one of {_quant.PRECISIONS}, got {precision!r}")
        if not hasattr(self, "_sync_precisions"):
            self._sync_precisions = {}
        residual_names = set(self._sync_residual_names())
        if states is None:
            candidates = [
                n
                for n in self._defaults
                if n not in residual_names
                and not isinstance(self._defaults[n], list)
                and self._reductions.get(n) is dim_zero_sum
            ]
        else:
            candidates = list(states)
            for n in candidates:
                if n not in self._defaults or n in residual_names:
                    raise KeyError(f"{type(self).__name__} has no registered state {n!r}")
                if isinstance(self._defaults[n], list) or self._reductions.get(n) is not dim_zero_sum:
                    raise ValueError(
                        f"state {n!r} cannot use sync_precision={precision!r}:"
                        " only 'sum'-reduced array states qualify (cat/list"
                        " states are always exact)"
                    )
        for n in candidates:
            if precision == "exact":
                if n in self._sync_precisions:
                    del self._sync_precisions[n]
                    res = n + _SYNC_RESIDUAL_SUFFIX
                    self._defaults.pop(res, None)
                    self._persistent.pop(res, None)
                    self._reductions.pop(res, None)
                    if hasattr(self, res):
                        delattr(self, res)
            elif n in self._sync_precisions:
                self._sync_precisions[n] = precision
            else:
                self._register_sync_residual(n, precision, self._persistent[n])
        # a cached result no longer describes what sync would now produce
        self._computed = None
        return self.sync_precisions()

    def forward(self, *args: Any, **kwargs: Any):
        """Update state with the batch; return the batch-local value if
        ``compute_on_step``.

        Metrics flagged ``_fused_forward`` run one update and a state merge
        (see :meth:`_forward_fused`); the others run the reference's double
        update: accumulate, then recompute the batch alone on reset state.
        Returns once the work is queued on the device: reading a value is
        the synchronization point."""
        if self._fused_forward and self.compute_on_step:
            return self._forward_fused(*args, **kwargs)
        with _obs.metric_scope(self, "forward"):
            self.update(*args, **kwargs)
            self._forward_cache = None

            if self.compute_on_step:
                self._to_sync = self.dist_sync_on_step

                # save accumulated state, compute on this batch alone
                cache = self._snapshot_state()
                self.reset()
                # error-feedback residuals belong to the SYNC stream, not
                # the accumulation: seed the batch-local pass with the
                # persistent values, so a dist_sync_on_step sync compensates
                # the previous step sync's error instead of starting from
                # the reset zeros every step
                with _san_allow_ctx():
                    for res_name in self._sync_residual_names():
                        setattr(self, res_name, cache[res_name])
                try:
                    self._batch_local_pass = True
                    try:
                        self.update(*args, **kwargs)
                    finally:
                        self._batch_local_pass = False
                    # a mini-batch may be partial (e.g. miss classes) in ways the
                    # epoch-end compute treats as errors; computes can key on this
                    self._batch_local_compute = True
                    try:
                        self._forward_cache = self.compute()
                    finally:
                        self._batch_local_compute = False
                finally:
                    # restore accumulated state even when the batch-local pass
                    # raises: a rejected step value must not cost the epoch state
                    # or leave _to_sync stuck False. Residuals a step sync just
                    # committed survive the restore (without a sync they still
                    # hold the values seeded above)
                    post_sync_residuals = {r: getattr(self, r) for r in self._sync_residual_names()}
                    self._restore_state(cache)
                    with _san_allow_ctx():
                        for r, v in post_sync_residuals.items():
                            setattr(self, r, v)
                    self._to_sync = True
                    self._computed = None

                return self._forward_cache

    __call__ = forward

    def _forward_fused(self, *args: Any, **kwargs: Any):
        """One-update forward for ``_fused_forward`` metrics: batch stats are
        computed once (on fresh default state), the batch-local value comes
        from them, and they are folded into the accumulated state with
        :meth:`_merge_states`."""
        with _obs.metric_scope(self, "forward"):
            accumulated = self._snapshot_state()
            self.reset()
            # sync-stream seeding, as on the classic path: a step sync must
            # compensate the previous sync's error, not restart from zero
            with _san_allow_ctx():
                for res_name in self._sync_residual_names():
                    setattr(self, res_name, accumulated[res_name])
            try:
                self.update(*args, **kwargs)  # the ONLY update: batch stats
            except BaseException:
                # update rejected the batch: the accumulated state is untouched,
                # as on the classic path
                self._restore_state(accumulated)
                self._to_sync = True
                raise
            try:
                self._to_sync = self.dist_sync_on_step
                self._batch_local_compute = True
                self._forward_cache = self.compute()
            finally:
                # once update() accepted the batch it stays in the epoch state
                # even if the batch-local compute() raises
                self._batch_local_compute = False
                self._merge_states(accumulated)
                self._to_sync = True
                self._computed = None
            # reliability hook: the merge can go non-finite even when the
            # batch stats were healthy (accumulator overflow); the guard rolls
            # back to the pre-batch snapshot per its policy
            guard = _rguard.active()
            if guard is not None:
                guard.check_states(self, accumulated, context="merge")
            return self._forward_cache

    @staticmethod
    def _merge_reduction_supported(reduction: Optional[Callable]) -> bool:
        """True iff a registered reduction folds (accumulated, batch) pairs purely."""
        return reduction in (dim_zero_sum, dim_zero_min, dim_zero_max)

    @staticmethod
    def _merge_state_value(reduction: Optional[Callable], prior: Any, batch: Any) -> Any:
        """(accumulated, batch) → merged state by its registered reduction:
        sum → add, min/max → elementwise min/max, list states → concat."""
        if isinstance(batch, list):
            return prior + batch
        if reduction is dim_zero_sum:
            return prior + batch
        if reduction is dim_zero_min:
            return torch.minimum(prior, batch)
        if reduction is dim_zero_max:
            return torch.maximum(prior, batch)
        raise TypeError("state reduction does not support a pure (accumulated, batch) merge")

    def _merge_states(self, accumulated: Dict[str, Any]) -> None:
        """Fold the current (batch-only) states into ``accumulated``. The
        residual companions are not folded: their current value (the residual
        a step sync just committed, or the seeded value) already is the
        truth, and adding the prior would re-apply error the compensation
        has consumed."""
        residual_names = set(self._sync_residual_names())
        for name, reduction in self._reductions.items():
            if name in residual_names:
                continue
            batch = getattr(self, name)
            if not isinstance(batch, list) and not self._merge_reduction_supported(reduction):
                raise TypeError(
                    f"state {name!r} of {type(self).__name__} has a reduction that"
                    " does not support fused forward; unset `_fused_forward`"
                )
            setattr(self, name, self._merge_state_value(reduction, accumulated[name], batch))

    def _sync_dist(self, dist_sync_fn: Callable = gather_all_tensors) -> None:
        """All-gather every registered state and apply its reduction. With
        telemetry on, the whole sync feeds the ``sync.latency_ms`` histogram
        (host clock) and the ``sync.*`` byte counters (from tensor
        metadata); with span tracing on it records one ``phase="sync"`` span
        carrying this process's rank."""
        telemetry_on = _obs.enabled()
        t0 = _time.perf_counter() if telemetry_on else 0.0
        # the rank is resolved only when tracing is on: the disabled path
        # stays two global reads
        span_attrs = {"rank": _obs_identity.current_rank()} if _obs_trace.tracing_enabled() else {}
        with _obs_trace.span(f"metrics_tpu.{type(self).__name__}.sync", phase="sync", **span_attrs):
            self._sync_dist_impl(dist_sync_fn)
        if telemetry_on:
            _obs.get().observe_hist("sync.latency_ms", (_time.perf_counter() - t0) * 1e3, _obs.LATENCY_BUCKETS_MS)

    def _sync_dist_impl(self, dist_sync_fn: Callable = gather_all_tensors) -> None:
        if dist_sync_fn is gather_all_tensors:
            # the default gather resolves through the installed backend: a
            # HierarchicalSyncBackend routes the whole sync through the
            # two-level engine; a caller-supplied dist_sync_fn keeps flat
            # semantics (it owns its transport)
            backend = get_sync_backend()
            if isinstance(backend, _hier.HierarchicalSyncBackend):
                return self._sync_dist_hierarchical(backend)
        precisions = getattr(self, "_sync_precisions", {})
        residual_names = set(self._sync_residual_names())
        # residual companions never cross the wire: they are each rank's own
        # quantization error
        input_dict = {attr: getattr(self, attr) for attr in self._reductions if attr not in residual_names}
        # quantize ONCE, before any gather attempt: a retried gather re-sends
        # the identical payload, so error feedback cannot double-apply;
        # residuals commit only after the collective succeeds (never on the
        # degraded local-only path, where nothing crossed the wire)
        wire_dict: Dict[str, Any] = dict(input_dict)
        new_residuals: Dict[str, torch.Tensor] = {}
        for name, precision in precisions.items():
            payload, new_res = _quant.compensate_and_quantize(
                input_dict[name], getattr(self, name + _SYNC_RESIDUAL_SUFFIX), precision
            )
            wire_dict[name] = payload
            new_residuals[name] = new_res
        if _obs.enabled():
            tel = _obs.get()
            payload = sum(
                _obs.array_nbytes(v)
                for state in input_dict.values()
                for v in (state if isinstance(state, list) else [state])
            )
            # what crosses the wire per rank: the quantized payloads for
            # tiered states, the tensors else; the gap is the compression
            wire = sum(_quant.payload_wire_nbytes(state) for state in wire_dict.values())
            tel.count("sync.calls")
            tel.count("sync.payload_bytes", payload)
            tel.count("sync.wire_bytes", wire)
            tel.observe_hist("sync.payload_bytes", payload, _obs.PAYLOAD_BUCKETS_BYTES)
            tel.observe_hist("sync.wire_bytes", wire, _obs.PAYLOAD_BUCKETS_BYTES)
            tel.event(
                "sync",
                metric=type(self).__name__,
                payload_bytes=payload,
                wire_bytes=wire,
                quantized_states=len(precisions),
            )
        # an installed SyncPolicy adds timeout and bounded retry around every
        # gather (a passthrough without one). Degradation is decided here,
        # for the whole state dict at once: a metric with some states
        # world-aggregated and others local would be silently wrong
        guarded_sync_fn = _rsync.apply_sync_policy(dist_sync_fn)
        degraded = False
        try:
            output_dict = apply_to_collection(wire_dict, torch.Tensor, guarded_sync_fn, group=self.process_group)
        except _rsync.SyncFailedError as err:
            local_only = _rsync.degraded_local_fallback(err)
            if local_only is None:
                raise
            # the local-only sync keeps the EXACT local states for quantized
            # tiers too (no bytes crossed the wire), and the residuals stay
            # untouched
            output_dict = apply_to_collection(input_dict, torch.Tensor, local_only, group=self.process_group)
            degraded = True

        for attr, reduction_fn in self._reductions.items():
            if attr in residual_names:
                continue
            if not degraded and attr in precisions:
                # gathered payload dicts {"q": [rank0, ...], "scales": [...]}:
                # each rank's contribution dequantized and summed in f32
                gathered = output_dict[attr]
                local = input_dict[attr]
                setattr(
                    self,
                    attr,
                    _quant.merge_dequantized(
                        [{k: v[r] for k, v in gathered.items()} for r in range(len(gathered["q"]))],
                        local.shape,
                        local.dtype,
                    ),
                )
                continue
            # tensor states stack to (world, ...); list states flatten
            if len(output_dict[attr]) and isinstance(output_dict[attr][0], torch.Tensor):
                output_dict[attr] = torch.stack(list(output_dict[attr]))
            elif len(output_dict[attr]) and isinstance(output_dict[attr][0], list):
                output_dict[attr] = _flatten(output_dict[attr])
            reduced = reduction_fn(output_dict[attr]) if reduction_fn is not None else output_dict[attr]
            setattr(self, attr, reduced)
        if not degraded:
            for name, res in new_residuals.items():
                setattr(self, name + _SYNC_RESIDUAL_SUFFIX, res)

    def _sync_dist_hierarchical(self, backend: "_hier.HierarchicalSyncBackend") -> None:
        """Two-level sync through an installed hierarchical backend: level-0
        reduction inside the slice, a sparse level-1 exchange of one
        pre-reduced contribution per slice, ``SyncPolicy`` and
        ``sync_precision`` resolved per level, degradation per level and
        atomic across the whole state dict (see
        :mod:`metrics_tpu_torch.parallel.hierarchy`)."""
        precisions = getattr(self, "_sync_precisions", {})
        residual_names = set(self._sync_residual_names())
        input_dict = {attr: getattr(self, attr) for attr in self._reductions if attr not in residual_names}
        residuals = {name: getattr(self, name + _SYNC_RESIDUAL_SUFFIX) for name in precisions}
        if _obs.enabled():
            tel = _obs.get()
            payload = sum(
                _obs.array_nbytes(v)
                for state in input_dict.values()
                for v in (state if isinstance(state, list) else [state])
            )
            tel.count("sync.calls")
            tel.count("sync.payload_bytes", payload)
            tel.observe_hist("sync.payload_bytes", payload, _obs.PAYLOAD_BUCKETS_BYTES)
            tel.event(
                "sync",
                metric=type(self).__name__,
                payload_bytes=payload,
                hierarchical=True,
                num_slices=backend.topology.num_slices,
                quantized_states=len(precisions),
            )
        outcome = _hier.sync_states(
            backend, input_dict, self._reductions, precisions, residuals, group=self.process_group
        )
        for attr, value in outcome.states.items():
            setattr(self, attr, value)
        # residuals commit only when the level that consumed them succeeded:
        # sync_states returns none on degradation
        for name, res in outcome.residuals.items():
            setattr(self, name + _SYNC_RESIDUAL_SUFFIX, res)

    def _to_own_device(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device)

    def _wrap_update(self, update: Callable) -> Callable:
        @functools.wraps(update)
        def wrapped_func(*args: Any, **kwargs: Any):
            self._computed = None
            # telemetry: wall time, call count and a profiler range
            # (`metrics_tpu.<Name>.update`); a shared null context when off
            with _obs.metric_scope(self, "update"), _san_allow_ctx():
                args = apply_to_collection(args, torch.Tensor, self._to_own_device)
                kwargs = apply_to_collection(kwargs, torch.Tensor, self._to_own_device)
                # reliability hook: with a StateGuard installed the update
                # runs snapshot -> update -> fused isfinite check -> policy;
                # without one the cost is this one global read
                guard = _rguard.active()
                if guard is None:
                    return update(*args, **kwargs)
                return guard.run_update(self, update, args, kwargs)

        return wrapped_func

    def _wrap_compute(self, compute: Callable) -> Callable:
        @functools.wraps(compute)
        def wrapped_func(*args: Any, **kwargs: Any):
            with _obs.metric_scope(self, "compute"):
                return _inner(*args, **kwargs)

        def _inner(*args: Any, **kwargs: Any):
            # serving drain barrier: an enrolled metric folds every staged
            # batch into state first (a no-op on the pipeline's own worker)
            if self._serving_pipeline is not None:
                pipe = self._serving_pipeline()
                if pipe is not None:
                    pipe.drain()
            # the cache carries its provenance: a value computed under
            # batch-local (forward) semantics must never serve an epoch-end
            # compute, or vice versa
            if self._computed is not None and self._computed_batch_local == self._batch_local_compute:
                return self._computed

            dist_sync_fn = self.dist_sync_fn
            if dist_sync_fn is None and is_distributed_initialized():
                dist_sync_fn = gather_all_tensors

            synced = False
            cache = {}
            if self._to_sync and dist_sync_fn is not None:
                # cache prior to syncing so accumulation continues un-synced
                cache = self._snapshot_state()
                self._sync_dist(dist_sync_fn)
                synced = True

            self._computed = compute(*args, **kwargs)
            self._computed_batch_local = self._batch_local_compute
            if synced:
                # restore un-synced accumulation, but KEEP the error-feedback
                # residuals the sync just committed: they describe the error
                # of the quantization that crossed the wire, which the next
                # sync must compensate
                post_sync_residuals = {r: getattr(self, r) for r in self._sync_residual_names()}
                self._restore_state(cache)
                with _san_allow_ctx():
                    for r, v in post_sync_residuals.items():
                        setattr(self, r, v)
            return self._computed

        return wrapped_func

    def _snapshot_state(self) -> Dict[str, Any]:
        """Snapshot everything ``reset()`` touches, so forward's
        snapshot/reset/restore cycle is lossless."""
        return {attr: getattr(self, attr) for attr in self._defaults}

    def _restore_state(self, cache: Dict[str, Any]) -> None:
        for attr, val in cache.items():
            setattr(self, attr, val)

    @abstractmethod
    def update(self) -> None:
        """Override to update the metric state from a batch of inputs."""

    @abstractmethod
    def compute(self):
        """Override to compute the final value from (synced) state."""

    def reset(self) -> None:
        """Reset all state variables to their registered defaults."""
        self._computed = None
        for attr, default in self._defaults.items():
            setattr(self, attr, [] if isinstance(default, list) else default.clone())

    def clone(self) -> "Metric":
        """Make a copy of the metric."""
        return deepcopy(self)

    def __getstate__(self) -> dict:
        # drop the wrapped bound methods for pickling
        return {k: v for k, v in self.__dict__.items() if k not in ["update", "compute", "_serving_pipeline"]}

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self.update = self._wrap_update(self.update)
        self.compute = self._wrap_compute(self.compute)

    def to(self, device: Union[str, torch.device]) -> "Metric":
        """Move every state and default to ``device``; later inputs follow."""
        self.device = torch.device(device)
        for key, default in self._defaults.items():
            current_val = getattr(self, key)
            if isinstance(current_val, torch.Tensor):
                setattr(self, key, current_val.to(self.device))
            elif isinstance(current_val, list):
                setattr(self, key, [v.to(self.device) for v in current_val])
            else:
                raise TypeError(
                    "Expected metric state to be either a torch.Tensor"
                    f" or a list of torch.Tensor, but encountered {current_val}"
                )
            if isinstance(default, torch.Tensor):
                self._defaults[key] = default.to(self.device)
        self._computed = None
        return self

    def astype(self, dtype: torch.dtype) -> "Metric":
        """Cast floating-point tensor states (and their defaults) to ``dtype``.

        Integer counter states keep their dtype, as ``nn.Module.half`` does.
        List states are cast elementwise. The error-feedback residuals stay
        f32: they hold sub-quantization-step corrections a narrower dtype
        would round away.
        """

        def _cast(v):
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                return v.to(dtype)
            return v

        residual_names = set(self._sync_residual_names())
        for key in self._defaults:
            if key in residual_names:
                continue
            val = getattr(self, key)
            setattr(self, key, [_cast(v) for v in val] if isinstance(val, list) else _cast(val))
            default = self._defaults[key]
            self._defaults[key] = [_cast(v) for v in default] if isinstance(default, list) else _cast(default)
        self._computed = None
        return self

    def bfloat16(self) -> "Metric":
        """Shorthand for ``astype(torch.bfloat16)``."""
        return self.astype(torch.bfloat16)

    def float16(self) -> "Metric":
        """Shorthand for ``astype(torch.float16)``: IEEE half, when it is
        what is wanted."""
        return self.astype(torch.float16)

    def half(self) -> "Metric":
        """Shorthand for :meth:`bfloat16`, as in the JAX package: ``half()``
        here means bfloat16, not ``nn.Module.half()``'s float16 (use
        :meth:`float16` for that)."""
        return self.bfloat16()

    def float(self) -> "Metric":
        """Shorthand for ``astype(torch.float32)``."""
        return self.astype(torch.float32)

    def persistent(self, mode: bool = False) -> None:
        """Post-init toggle: should states be saved in ``state_dict``?"""
        for key in self._persistent:
            self._persistent[key] = mode

    def _cursor_state(self) -> torch.Tensor:
        """The session cursor as a checkpointable scalar (see
        :func:`_encode_session_cursor`)."""
        return _encode_session_cursor(self._session_cursor)

    def _route_cursor(self, state_dict: dict, prefix: str) -> bool:
        """Restore a session cursor riding in ``state_dict`` (if any);
        returns True when one was found. Shared by the metric, composition
        and collection loaders so the cursor follows the state everywhere."""
        key = prefix + self._SESSION_CURSOR_KEY
        if key in state_dict:
            self._session_cursor = _decode_session_cursor(state_dict[key])
            return True
        return False

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "") -> dict:
        """Collect persistent states into a checkpointable dict. A metric
        enrolled in an :class:`~metrics_tpu_torch.reliability.EvalSession`
        also emits its step cursor (see ``_session_cursor``)."""
        destination = {} if destination is None else destination
        for key in self._defaults:
            if self._persistent[key]:
                destination[prefix + key] = getattr(self, key)
        if self._session_cursor is not None:
            destination[prefix + self._SESSION_CURSOR_KEY] = self._cursor_state()
        return destination

    def load_state_dict(
        self,
        state_dict: dict,
        prefix: str = "",
        strict: bool = False,
        _warn_on_zero_match: bool = True,
    ) -> None:
        """Restore states saved by :meth:`state_dict`, from tensors on any
        device (or numpy arrays).

        Args:
            strict: require every registered state (at ``prefix + name``)
                to be present in ``state_dict``; raises ``KeyError`` listing
                the missing keys otherwise. For checkpoint validation beyond
                key presence (schema version, payload checksum, dtype/shape
                specs) use :func:`metrics_tpu_torch.reliability.load_envelope`.
            _warn_on_zero_match: internal — a collection passes False and runs
                the zero-match check over ALL its members instead.
        """
        if strict:
            missing = [prefix + key for key in self._defaults if prefix + key not in state_dict]
            if missing:
                raise KeyError(
                    f"strict load_state_dict: {type(self).__name__} is missing"
                    f" state keys {missing}"
                )
        loaded = self._route_cursor(state_dict, prefix)
        for key in self._defaults:
            name = prefix + key
            if name in state_dict:
                val = state_dict[name]
                if isinstance(val, list):
                    setattr(self, key, [_device_owned(v, self.device) for v in val])
                else:
                    setattr(self, key, _device_owned(val, self.device))
                loaded = True
        if loaded:
            # a cached pre-load result no longer describes the state
            self._computed = None
        elif _warn_on_zero_match and state_dict and self._defaults:
            # a mistyped prefix matches ZERO keys and would otherwise return
            # without a sound, the state silently keeping its priors
            warn_once(
                f"load_state_dict: none of {type(self).__name__}'s"
                f" {len(self._defaults)} state keys (prefix={prefix!r}) matched"
                f" the non-empty state_dict ({len(state_dict)} entries); nothing"
                " was loaded. Check the prefix used at save time, or pass"
                " strict=True to make this an error.",
                key=f"load-zero-match:{type(self).__name__}:{prefix}",
            )

    def _named_states(self, prefix: str = "") -> list:
        """Every loadable ``(key, value)`` pair, prefixed as :meth:`state_dict`
        prefixes it, whatever the ``persistent`` flags say: the key universe
        a strict envelope load checks against. A session-enrolled metric
        includes its step cursor, so an envelope carries the cursor under
        the same checksum as the state it describes."""
        pairs = [(prefix + key, getattr(self, key)) for key in self._defaults]
        if self._session_cursor is not None:
            pairs.append((prefix + self._SESSION_CURSOR_KEY, self._cursor_state()))
        return pairs

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Filter kwargs to those accepted by this metric's ``update`` signature."""
        _params = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
        _sign_params = self._update_signature.parameters
        filtered_kwargs = {
            k: v for k, v in kwargs.items() if (k in _sign_params and _sign_params[k].kind not in _params)
        }
        if not filtered_kwargs:
            filtered_kwargs = kwargs
        return filtered_kwargs

    def __hash__(self) -> int:
        # identity-based: unique per instance and stable across update()/reset()
        return hash((self.__class__.__name__, id(self)))

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}()"

    # ------------------------------------------------------------------
    # metric arithmetic: each operator builds a CompositionalMetric
    # ------------------------------------------------------------------
    def __add__(self, other: Any):
        return CompositionalMetric(_add, self, other)

    def __and__(self, other: Any):
        return CompositionalMetric(operator.and_, self, other)

    def __eq__(self, other: Any):
        return CompositionalMetric(_eq, self, other)

    def __floordiv__(self, other: Any):
        return CompositionalMetric(operator.floordiv, self, other)

    def __ge__(self, other: Any):
        return CompositionalMetric(_ge, self, other)

    def __gt__(self, other: Any):
        return CompositionalMetric(_gt, self, other)

    def __le__(self, other: Any):
        return CompositionalMetric(_le, self, other)

    def __lt__(self, other: Any):
        return CompositionalMetric(_lt, self, other)

    def __matmul__(self, other: Any):
        return CompositionalMetric(operator.matmul, self, other)

    def __mod__(self, other: Any):
        return CompositionalMetric(_fmod, self, other)

    def __mul__(self, other: Any):
        return CompositionalMetric(_mul, self, other)

    def __ne__(self, other: Any):
        return CompositionalMetric(_ne, self, other)

    def __or__(self, other: Any):
        return CompositionalMetric(operator.or_, self, other)

    def __pow__(self, other: Any):
        return CompositionalMetric(operator.pow, self, other)

    def __radd__(self, other: Any):
        return CompositionalMetric(_add, other, self)

    def __rand__(self, other: Any):
        # bitwise_and is commutative
        return CompositionalMetric(operator.and_, self, other)

    def __rfloordiv__(self, other: Any):
        return CompositionalMetric(operator.floordiv, other, self)

    def __rmatmul__(self, other: Any):
        return CompositionalMetric(operator.matmul, other, self)

    def __rmod__(self, other: Any):
        return CompositionalMetric(_fmod, other, self)

    def __rmul__(self, other: Any):
        return CompositionalMetric(_mul, other, self)

    def __ror__(self, other: Any):
        return CompositionalMetric(operator.or_, other, self)

    def __rpow__(self, other: Any):
        return CompositionalMetric(operator.pow, other, self)

    def __rsub__(self, other: Any):
        return CompositionalMetric(operator.sub, other, self)

    def __rtruediv__(self, other: Any):
        return CompositionalMetric(operator.truediv, other, self)

    def __rxor__(self, other: Any):
        return CompositionalMetric(operator.xor, other, self)

    def __sub__(self, other: Any):
        return CompositionalMetric(operator.sub, self, other)

    def __truediv__(self, other: Any):
        return CompositionalMetric(operator.truediv, self, other)

    def __xor__(self, other: Any):
        return CompositionalMetric(operator.xor, self, other)

    def __abs__(self):
        return CompositionalMetric(operator.abs, self, None)

    def __inv__(self):
        return CompositionalMetric(operator.invert, self, None)

    def __invert__(self):
        return self.__inv__()

    def __neg__(self):
        return CompositionalMetric(_neg, self, None)

    def __pos__(self):
        return CompositionalMetric(operator.abs, self, None)

    def __getitem__(self, idx):
        return CompositionalMetric(functools.partial(_getitem_op, idx=idx), self, None)


# The operators' callables are module-level (or partials of module-level
# functions), so composites pickle.


def _reject_sequence_operands(*vals: Any) -> None:
    """Arithmetic on tuple/list-valued computes (curve metrics) raises:
    Python's sequence semantics for ``+``/``*``/comparisons would silently
    concatenate, repeat or compare lexicographically instead."""
    for v in vals:
        if isinstance(v, (tuple, list)):
            raise TypeError(
                "metric arithmetic is not defined for tuple/list-valued"
                " compute() results (e.g. curve metrics)"
            )


def _add(a: Any, b: Any) -> Any:
    _reject_sequence_operands(a, b)
    return operator.add(a, b)


def _mul(a: Any, b: Any) -> Any:
    _reject_sequence_operands(a, b)
    return operator.mul(a, b)


def _eq(a: Any, b: Any) -> Any:
    _reject_sequence_operands(a, b)
    return operator.eq(a, b)


def _ne(a: Any, b: Any) -> Any:
    _reject_sequence_operands(a, b)
    return operator.ne(a, b)


def _lt(a: Any, b: Any) -> Any:
    _reject_sequence_operands(a, b)
    return operator.lt(a, b)


def _le(a: Any, b: Any) -> Any:
    _reject_sequence_operands(a, b)
    return operator.le(a, b)


def _gt(a: Any, b: Any) -> Any:
    _reject_sequence_operands(a, b)
    return operator.gt(a, b)


def _ge(a: Any, b: Any) -> Any:
    _reject_sequence_operands(a, b)
    return operator.ge(a, b)


def _fmod(a: Any, b: Any) -> torch.Tensor:
    """C-style remainder, ``torch.fmod``: the sign follows the dividend
    (``-7 % 3`` is ``-1``), not Python's ``%`` or ``torch.remainder``. A
    Python dividend becomes a 0-d tensor made in place on the divisor's
    device (no host copy)."""
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, device=b.device) if isinstance(b, torch.Tensor) else torch.as_tensor(a)
    return torch.fmod(a, b)


def _getitem_op(x: Any, idx: Any) -> Any:
    return x[idx]


def _neg(x: Any) -> Any:
    # the reference's unary minus is -abs(x), kept as it is
    return -abs(x)


class CompositionalMetric(Metric):
    """Lazy composition of two metrics (or a metric and a constant) by an operator.

    ``update`` fans out to the operand metrics (kwargs filtered by each
    one's signature) inside one shared-canonicalization scope, ``compute``
    applies the operator to the operands' results, and ``_sync_dist`` is a
    no-op because the operands sync themselves. The composite registers no
    state: checkpointing, ``reset``, ``persistent``, ``to`` and ``astype``
    recurse into the operands (state keys under ``metric_a.`` /
    ``metric_b.``). It lives on its first metric operand's device; a tensor
    constant is moved there.

    ``forward`` preserves accumulation: its snapshot/reset/restore cycle
    recurses into the operands and clears their cached values on restore, so
    the step value is the batch's and the epoch ``compute()`` stays the
    aggregate of every batch.

    Example:
        >>> from metrics_tpu_torch import MeanAbsoluteError, MeanSquaredError
        >>> rmse = MeanSquaredError(device="cpu") ** 0.5
        >>> rmse.update(torch.tensor([0.0, 1.0, 2.0, 3.0]), torch.tensor([0.0, 1.0, 2.0, 5.0]))
        >>> rmse.compute()
        tensor(1.)
        >>> both = (MeanSquaredError(device="cpu") + MeanAbsoluteError(device="cpu")) / 2
        >>> both(torch.tensor([1.0, 2.0]), torch.tensor([1.5, 3.0]))
        tensor(0.6875)
    """

    def __init__(
        self,
        operator: Callable,
        metric_a: Union[Metric, int, float, torch.Tensor],
        metric_b: Union[Metric, int, float, torch.Tensor, None],
    ):
        device = next(m.device for m in (metric_a, metric_b) if isinstance(m, Metric))
        super().__init__(device=device)
        self.op = operator
        self.metric_a = metric_a.to(self.device) if isinstance(metric_a, torch.Tensor) else metric_a
        self.metric_b = metric_b.to(self.device) if isinstance(metric_b, torch.Tensor) else metric_b

    def _operands(self):
        return [m for m in (self.metric_a, self.metric_b) if isinstance(m, Metric)]

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None) -> None:
        # no syncing here: metric_a and metric_b sync themselves
        pass

    def update(self, *args: Any, **kwargs: Any) -> None:
        # both operands see the same batch: share input canonicalization
        with shared_canonicalization():
            for metric in self._operands():
                metric.update(*args, **metric._filter_kwargs(**kwargs))

    def _snapshot_state(self) -> Dict[str, Any]:
        # the composition owns no registered state; forward()'s
        # snapshot/reset/restore cycle recurses into the operand metrics,
        # or the mid-forward reset would destroy their accumulation
        cache = super()._snapshot_state()
        if isinstance(self.metric_a, Metric):
            cache["__operand_a"] = self.metric_a._snapshot_state()
        if isinstance(self.metric_b, Metric):
            cache["__operand_b"] = self.metric_b._snapshot_state()
        return cache

    def _restore_state(self, cache: Dict[str, Any]) -> None:
        cache = dict(cache)
        operand_a = cache.pop("__operand_a", None)
        operand_b = cache.pop("__operand_b", None)
        super()._restore_state(cache)
        if operand_a is not None:
            self.metric_a._restore_state(operand_a)
            self.metric_a._computed = None
        if operand_b is not None:
            self.metric_b._restore_state(operand_b)
            self.metric_b._computed = None

    def _operand_compute(self, metric: Any) -> Any:
        if not isinstance(metric, Metric):
            return metric
        # forward() sets the batch-local flag on the composition only;
        # operand computes must see the same step semantics
        prev = metric._batch_local_compute
        metric._batch_local_compute = self._batch_local_compute
        try:
            return metric.compute()
        finally:
            metric._batch_local_compute = prev

    def compute(self) -> Any:
        val_a = self._operand_compute(self.metric_a)
        val_b = self._operand_compute(self.metric_b)

        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def reset(self) -> None:
        self._computed = None
        for metric in self._operands():
            metric.reset()

    def persistent(self, mode: bool = False) -> None:
        for metric in self._operands():
            metric.persistent(mode=mode)

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "") -> dict:
        destination = {} if destination is None else destination
        if isinstance(self.metric_a, Metric):
            self.metric_a.state_dict(destination, prefix + "metric_a.")
        if isinstance(self.metric_b, Metric):
            self.metric_b.state_dict(destination, prefix + "metric_b.")
        if self._session_cursor is not None:
            destination[prefix + self._SESSION_CURSOR_KEY] = self._cursor_state()
        return destination

    def load_state_dict(
        self,
        state_dict: dict,
        prefix: str = "",
        strict: bool = False,
        _warn_on_zero_match: bool = True,
    ) -> None:
        self._route_cursor(state_dict, prefix)
        if isinstance(self.metric_a, Metric):
            self.metric_a.load_state_dict(state_dict, prefix + "metric_a.", strict=strict, _warn_on_zero_match=False)
        if isinstance(self.metric_b, Metric):
            self.metric_b.load_state_dict(state_dict, prefix + "metric_b.", strict=strict, _warn_on_zero_match=False)
        # the zero-match check runs over the WHOLE composition: one operand
        # matching nothing is legitimate partial persistence, nothing
        # matching anywhere is a mistyped prefix (an enclosing container
        # runs its own check and passes False)
        named = self._named_states(prefix)
        if _warn_on_zero_match and state_dict and named and not any(key in state_dict for key, _ in named):
            warn_once(
                f"load_state_dict: no operand state of this"
                f" {type(self).__name__} (prefix={prefix!r}) matched the"
                f" non-empty state_dict ({len(state_dict)} entries);"
                " nothing was loaded. Check the prefix used at save time"
                " or pass strict=True to make this an error.",
                key=f"load-zero-match:{type(self).__name__}:{prefix}",
            )
        self._computed = None

    def _named_states(self, prefix: str = "") -> list:
        pairs = super()._named_states(prefix)
        if isinstance(self.metric_a, Metric):
            pairs += self.metric_a._named_states(prefix + "metric_a.")
        if isinstance(self.metric_b, Metric):
            pairs += self.metric_b._named_states(prefix + "metric_b.")
        return pairs

    def to(self, device: Union[str, torch.device]) -> "CompositionalMetric":
        """Move the operands (and a tensor constant) to ``device``."""
        self.device = torch.device(device)
        for name in ("metric_a", "metric_b"):
            value = getattr(self, name)
            if isinstance(value, (Metric, torch.Tensor)):
                setattr(self, name, value.to(self.device))
        self._computed = None
        return self

    def astype(self, dtype: torch.dtype) -> "CompositionalMetric":
        for metric in self._operands():
            metric.astype(dtype)
        self._computed = None
        return self

    def __repr__(self) -> str:
        _op_name = getattr(self.op, "__name__", repr(self.op))
        _op_metrics = f"(\n  {_op_name}(\n    {repr(self.metric_a)},\n    {repr(self.metric_b)}\n  )\n)"
        return self.__class__.__name__ + _op_metrics
