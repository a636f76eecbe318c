"""MetricCohort: thousands of structurally identical eval streams in one step.

Port of ``metrics_tpu/cohort.py``. Serving loops evaluate one stream per
user, per model variant or per A/B arm: N structurally identical
:class:`~metrics_tpu_torch.MetricCollection`\\ s. Run one by one they cost N
steps of small kernels. The cohort stacks the N collections' states along a
leading *tenant* axis and runs the step engine's step function under
``torch.func.vmap`` over that axis
(:meth:`~metrics_tpu_torch.engine.CompiledStepEngine.cohort_step`): on a
CUDA device one CUDA graph replay then updates every tenant, with one
kernel per operation, not one per tenant (the label counts and score
histograms batch as one count over the flat ``(tenant, bucket)`` index,
``ops/histogram.py``).

* **Power-of-two capacity buckets.** The stacked state is padded from the
  live tenant count N up to ``bucket_capacity(N)``, so a 1 → 10,000 tenant
  ramp builds one graph per bucket (at most 14), never one per N.
* **Padding slots are inert, not masked per operation.** Under ``vmap``
  each tenant's new state depends only on its own rows, so padding slots
  may accumulate garbage; validity is applied where values are read
  (``forward`` values, ``compute``), which keeps the batched step the
  per-tenant step: a tenant's states equal the same collection run alone.
* **One collective per state.** ``compute()`` in a ``torch.distributed``
  world gathers each *stacked* state once (states × world payloads, not
  tenants × states × world), then restores the local states. The quantized
  ``sync_precision=`` tier quantizes each stacked state once across the
  tenants (blocks span tenants; the per-element bound is unchanged) with
  per-tenant error-feedback residuals; a ``SyncPolicy`` degrades the whole
  cohort at once; a ``HierarchicalSyncBackend`` routes the sync through the
  two-level engine, still one collective per state per level.
* **Checkpoints.** ``state_dict`` / ``load_state_dict`` / ``_named_states``
  speak ``MetricCollection``'s protocol, with the active-slot table under
  ``__cohort_slots__``, so membership round-trips with the state it
  indexes; a JAX cohort's ``state_dict()`` loads through
  :func:`~metrics_tpu_torch.interop.state_from_jax`.

* **The state guard.** With a ``StateGuard`` installed the step computes
  one all-finite flag per tenant and member inside the graph, and under
  raise / quarantine rolls back only the poisoned tenants; the flags come
  back in one device-to-host copy, tally per slot in ``health()``'s
  ``guard_verdicts`` column and feed the guard's policy. ``save_envelope``
  / ``load_envelope`` of a cohort carry the slot table with the states.

Unlike the JAX package, which donates the stacked buffers to each dispatch
(copying them all first when a guard is on, its ``copy_all``), the engine
copies every stacked state into its graph's buffers before a replay and
clones the new states out after it: no state, value or ``compute()`` result
is a graph buffer, so the live stacked states are the last-good snapshot on
every step, and ``_check_states_alive`` asserts as much after a failed one.
"""
from collections import OrderedDict
from contextlib import nullcontext
from copy import deepcopy
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.utils._pytree as pytree

from metrics_tpu_torch.engine import CompiledStepEngine, LeafSpec, _flags_to_host, _HostMirror
from metrics_tpu_torch.metric import Metric, _san_allow_ctx
from metrics_tpu_torch.observability import exporter as _exporter
from metrics_tpu_torch.observability import flight as _flight
from metrics_tpu_torch.observability import telemetry as _obs
from metrics_tpu_torch.observability import trace as _trace
from metrics_tpu_torch.parallel import hierarchy as _hier
from metrics_tpu_torch.parallel import quantize as _quant
from metrics_tpu_torch.parallel.backend import get_sync_backend, is_distributed_initialized
from metrics_tpu_torch.reliability import sync as _rsync
from metrics_tpu_torch.utilities import env as _env
from metrics_tpu_torch.utilities.data import _is_concrete, tracing
from metrics_tpu_torch.utilities.distributed import gather_all_tensors
from metrics_tpu_torch.utilities.prints import warn_once

__all__ = ["MetricCohort", "bucket_capacity", "route_rows"]

#: the per-tenant health accumulators, in the order a health read stacks them
_HEALTH_KEYS = ("rows_seen", "updates", "last_step", "nonfinite")

#: checkpoint key of the active-slot table: a fixed-shape ``(capacity,)``
#: int8 validity mask, carried like a member state
_SLOTS_KEY = "__cohort_slots__"

#: smallest stacked capacity: 2 (not 1) keeps the 1 → 10,000 tenant ramp
#: within ⌈log2(10,000)⌉ = 14 buckets, {2, 4, ..., 16384}
_MIN_CAPACITY = 2


def bucket_capacity(n: int) -> int:
    """The power-of-two capacity bucket holding ``n`` tenants (min 2).

    >>> [bucket_capacity(n) for n in (1, 2, 3, 9, 10_000)]
    [2, 2, 4, 16, 16384]
    """
    if n < 0:
        raise ValueError(f"tenant count must be >= 0, got {n}")
    return max(_MIN_CAPACITY, 1 << max(0, int(n) - 1).bit_length())


def route_rows(tenant_ids: torch.Tensor, *arrays: torch.Tensor, num_tenants: int):
    """Route a flat row stream to the cohort's stacked per-tenant layout.

    Serving pipelines deliver interleaved rows tagged with a tenant index;
    the cohort step wants dense ``(num_tenants, rows_per_tenant, ...)``
    stacks. One stable sort of ``tenant_ids`` (ties keep arrival order) and
    a gather per array route them, on the ids' device.

    Every tenant must contribute the same number of rows. With concrete
    ``tenant_ids`` unequal counts raise (one read of the ids to the host);
    while the engine builds a step the check is skipped, as the package's
    other value checks are.

    Example:
        >>> ids = torch.tensor([1, 0, 1, 0])
        >>> route_rows(ids, torch.tensor([10.0, 20.0, 30.0, 40.0]), num_tenants=2)
        tensor([[20., 40.],
                [10., 30.]])
    """
    tenant_ids = torch.as_tensor(tenant_ids)
    if tenant_ids.ndim != 1:
        raise ValueError(f"tenant_ids must be rank-1, got shape {tuple(tenant_ids.shape)}")
    n_rows = tenant_ids.shape[0]
    if num_tenants < 1 or n_rows % num_tenants:
        raise ValueError(
            f"{n_rows} rows do not split evenly over {num_tenants} tenants;"
            " every tenant must contribute the same number of rows per step"
        )
    rows_per_tenant = n_rows // num_tenants
    if _is_concrete(tenant_ids):
        counts = np.bincount(tenant_ids.cpu().numpy(), minlength=num_tenants)
        if len(counts) > num_tenants or not (counts == rows_per_tenant).all():
            raise ValueError(
                f"tenant_ids rows per tenant {counts.tolist()} != uniform"
                f" {rows_per_tenant} over {num_tenants} tenants"
            )
    order = torch.argsort(tenant_ids, stable=True)
    routed = tuple(
        a[order.to(a.device)].reshape((num_tenants, rows_per_tenant) + tuple(a.shape[1:]))
        for a in map(torch.as_tensor, arrays)
    )
    return routed[0] if len(routed) == 1 else routed


def _stacked_default(default: torch.Tensor, capacity: int) -> torch.Tensor:
    """``capacity`` copies of ``default`` in a tensor of the cohort's own."""
    return default.expand((capacity,) + tuple(default.shape)).clone()


def _set_rows(stacked: torch.Tensor, slots: Union[int, Sequence[int]], value: torch.Tensor) -> torch.Tensor:
    """``stacked`` with ``value`` at ``slots``, as a new tensor: states are
    replaced, never written in place (a ``state_dict()`` handed out keeps
    its values)."""
    out = stacked.clone()
    out[slots if isinstance(slots, int) else torch.as_tensor(slots, device=out.device)] = value
    return out


class MetricCohort:
    """N structurally identical metric stacks updated by one step.

    Args:
        metrics: the per-tenant template: a single :class:`Metric`, an
            ordered ``name -> Metric`` mapping, a list of metrics, or a
            :class:`~metrics_tpu_torch.MetricCollection`. Every member must
            be engine-eligible (the cohort has no per-tenant eager fallback:
            N eager reruns are exactly the cost it exists to remove);
            ineligible members raise at construction with the engine's
            reasons.
        tenants: initial tenant count (slots ``0..tenants-1``).
        cache_size: LRU capacity of the engine's signature cache (distinct
            ``(input signature, capacity bucket, health)`` programs kept).
        track_health: arm per-tenant health accounting (:meth:`health`).
            ``True`` / ``False`` pin it; ``None`` follows the telemetry
            switch (``metrics_tpu_torch.observability.enabled()``).

    Inputs carry the tenant axis first: each tensor leaf is either
    ``(len(cohort), ...)`` (one row block per live tenant, in
    :meth:`tenant_ids` order) or already ``(capacity, ...)``. Python scalars
    broadcast to every tenant. Flat tagged streams route via
    :func:`route_rows`. Every tenant starts from the registered defaults; to
    adopt accumulated state use :meth:`from_collections`,
    ``MetricCollection.as_cohort()`` (tenant 0 adopts) or
    ``add_tenant(state=...)``.

    Example:
        >>> from metrics_tpu_torch import MeanSquaredError
        >>> cohort = MetricCohort(MeanSquaredError(device="cpu"), tenants=3)
        >>> preds = torch.tensor([[0.0, 1.0], [1.0, 1.0], [2.0, 0.0]])
        >>> cohort(preds, torch.zeros(3, 2))
        tensor([0.5000, 1.0000, 2.0000])
        >>> cohort.capacity, cohort.compute(tenant=2)
        (4, tensor(2.))
    """

    # Serving enrollment (serving/async_engine.py): a weakref to the
    # pipeline whose worker steps this cohort; compute() drains it first
    _serving_pipeline: Optional[Any] = None

    def __init__(
        self,
        metrics: Union[Metric, Mapping[str, Metric], Sequence[Metric], Any],
        tenants: int = 1,
        cache_size: int = 16,
        track_health: Optional[bool] = None,
    ):
        self._single = isinstance(metrics, Metric)
        self._template: "OrderedDict[str, Metric]" = OrderedDict(self._template_items(metrics))
        if not self._template:
            raise ValueError("MetricCohort needs at least one metric")
        # nothing to demote at construction (an ineligible member raises
        # below): no construction-time telemetry events
        self._engine = CompiledStepEngine(self._template, cache_size=cache_size, observe=False)
        self._engine._compiled_names()  # names members on another device
        if self._engine.eager_fallbacks:
            raise ValueError(
                "every cohort member must be engine-eligible (the vmapped"
                " cohort step has no per-tenant eager fallback); ineligible:"
                f" {self._engine.eager_fallbacks}"
            )
        if int(tenants) < 1:
            raise ValueError(f"tenants must be >= 1, got {tenants}")
        self._device = self._engine._device
        self._cache_size = int(cache_size)
        self._capacity = bucket_capacity(int(tenants))
        self._active = np.zeros(self._capacity, dtype=bool)
        self._active[: int(tenants)] = True
        self._states: Dict[str, Dict[str, torch.Tensor]] = self._default_states(self._capacity)
        self._compute_cache: Tuple[Optional[tuple], Optional[Any]] = (None, None)
        # per-tenant health: device accumulators created at the first
        # health-armed step (None until then) and the cohort's step count
        self._track_health = track_health
        self._health: Optional[Dict[str, torch.Tensor]] = None
        # what a reader on another thread (the exporter's scrape) reads,
        # published together: the accumulators and, on the card, the event
        # recorded after their last write and their pinned host mirror
        self._health_view: Optional[Tuple[Dict[str, torch.Tensor], Any, Optional[_HostMirror]]] = None
        self._health_mirror: Optional[_HostMirror] = None
        # host-side tally of guard verdicts per slot (the guard's epilogue
        # reads its flags anyway): health()'s guard_verdicts column
        self._guard_verdicts = np.zeros(self._capacity, dtype=np.int64)
        self._steps = 0
        # slot index and validity mask on the device, per membership: a
        # step reads them without a host-to-device copy
        self._membership_tensors: Dict[str, torch.Tensor] = {}
        # scrape source enrollment: one weak reference (the exporter never
        # keeps a dropped cohort alive)
        self._exporter_id = _exporter.register_cohort(self)
        self._note_membership()

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------
    @staticmethod
    def _template_items(metrics: Any) -> List[Tuple[str, Metric]]:
        if isinstance(metrics, Metric):
            return [("metric", metrics)]
        if isinstance(metrics, Mapping):
            items = list(metrics.items())
        elif hasattr(metrics, "items") and hasattr(metrics, "keys"):  # MetricCollection
            items = list(metrics.items())
        elif isinstance(metrics, (list, tuple)):
            items = []
            for m in metrics:
                if not isinstance(m, Metric):
                    raise ValueError(f"{m!r} is not a metrics_tpu_torch.Metric")
                name = type(m).__name__
                if any(n == name for n, _ in items):
                    raise ValueError(f"two template metrics both named {name}")
                items.append((name, m))
        else:
            raise ValueError(f"unknown template input to MetricCohort: {type(metrics)}")
        for name, m in items:
            if not isinstance(m, Metric):
                raise ValueError(f"template member {name!r} is not a metrics_tpu_torch.Metric")
            if name.startswith("__") and name.endswith("__"):
                # dunder names belong to the cohort's own entries (the
                # health accumulators, the slot table)
                raise ValueError(
                    f"template member name {name!r} is reserved (dunder"
                    " names belong to cohort-internal state)"
                )
        return items

    def _default_states(self, capacity: int) -> Dict[str, Dict[str, torch.Tensor]]:
        return {
            name: {sname: _stacked_default(default, capacity) for sname, default in m._defaults.items()}
            for name, m in self._template.items()
        }

    @classmethod
    def from_collections(cls, collections: Sequence[Any], cache_size: int = 16) -> "MetricCohort":
        """Stack N independent, structurally identical collections (or
        metrics) into one cohort: tenant ``i`` adopts ``collections[i]``'s
        current state. The first entry becomes the template (deep-copied;
        the originals are left untouched)."""
        if not collections:
            raise ValueError("from_collections needs at least one collection")
        cohort = cls(deepcopy(collections[0]), tenants=len(collections), cache_size=cache_size)
        for i, col in enumerate(collections):
            cohort._adopt_state(i, cohort._extract_states(col))
        return cohort

    def _extract_states(self, source: Any) -> Dict[str, Dict[str, torch.Tensor]]:
        """Per-member state rows from a template-shaped collection or metric,
        or from a raw nested ``{member: {state: tensor or array}}`` mapping,
        validated against the template's structure."""
        if isinstance(source, Metric):
            raw: Dict[str, Dict[str, Any]] = {"metric": {s: getattr(source, s) for s in source._defaults}}
        elif isinstance(source, Mapping) and all(isinstance(v, Mapping) for v in source.values()):
            raw = {k: dict(d) for k, d in source.items()}
        else:
            raw = {name: {s: getattr(m, s) for s in m._defaults} for name, m in dict(source.items()).items()}
        if set(raw) != set(self._template):
            raise ValueError(
                f"structure mismatch: cohort members {sorted(self._template)} != source members {sorted(raw)}"
            )
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, tm in self._template.items():
            d = raw[name]
            if set(d) != set(tm._defaults):
                raise ValueError(f"member {name!r} state mismatch: {sorted(d)} != {sorted(tm._defaults)}")
            out[name] = {}
            for sname, default in tm._defaults.items():
                v = torch.as_tensor(d[sname]).detach().to(self._device, copy=True)
                if v.shape != default.shape or v.dtype != default.dtype:
                    raise ValueError(
                        f"member {name}.{sname}: shape/dtype {tuple(v.shape)}/{v.dtype} does not match template"
                        f" {tuple(default.shape)}/{default.dtype}"
                    )
                out[name][sname] = v
        return out

    def _adopt_state(self, slot: int, rows: Dict[str, Dict[str, torch.Tensor]]) -> None:
        for name, d in rows.items():
            for sname, v in d.items():
                self._states[name][sname] = _set_rows(self._states[name][sname], slot, v)

    # ------------------------------------------------------------------
    # membership
    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return int(self._active.sum())

    @property
    def capacity(self) -> int:
        """Current padded capacity (a power of two >= the tenant count)."""
        return self._capacity

    def tenant_ids(self) -> Tuple[int, ...]:
        """Live tenant slots, in the order forward inputs and computed
        values are laid out."""
        return tuple(int(i) for i in np.flatnonzero(self._active))

    def _slot_index(self) -> np.ndarray:
        return np.flatnonzero(self._active)

    def _dense_prefix(self) -> bool:
        """True when the live slots are ``0..len-1``: padding is a tail."""
        slots = self._slot_index()
        return bool(slots.size) and int(slots[-1]) == slots.size - 1

    def _membership_tensor(self, key: str) -> torch.Tensor:
        """The live slots' index (``"slots"``) or the int8 validity mask
        (``"valid"``) on the cohort's device, made once per membership."""
        if key not in self._membership_tensors:
            host = self._slot_index() if key == "slots" else self._active.astype(np.int8)
            self._membership_tensors[key] = torch.from_numpy(host).to(self._device)
        return self._membership_tensors[key]

    def _note_membership(self) -> None:
        self._compute_cache = (None, None)
        self._membership_tensors = {}
        if _obs.enabled():
            tel = _obs.get()
            tel.gauge("cohort.size", len(self))
            tel.gauge("cohort.capacity", self._capacity)

    def add_tenant(self, state: Optional[Any] = None) -> int:
        """Admit one tenant; returns its slot id (stable until removed).

        Reuses a freed slot when one exists, else grows the stacked state to
        the next capacity bucket (padding with registered defaults; the next
        forward builds the new bucket's program once and the old one stays
        cached). ``state`` seeds the new tenant: a template-shaped
        collection or metric (its current state is adopted) or nothing
        (registered defaults)."""
        self._drain_serving()
        free = np.flatnonzero(~self._active)
        if free.size:
            slot = int(free[0])
        else:
            slot = self._capacity
            self._grow(bucket_capacity(self._capacity + 1))
        # a reused slot may hold a removed tenant's garbage: re-default it
        self._default_slots(slot)
        self._reset_slot_health([slot])
        self._guard_verdicts[slot] = 0
        self._active[slot] = True
        if state is not None:
            self._adopt_state(slot, self._extract_states(state))
        self._note_membership()
        return slot

    def add_tenants(self, n: int) -> List[int]:
        """Admit ``n`` default-state tenants at once; returns their slot ids.
        One capacity grow for all of them; freed slots are already
        re-defaulted at removal and grown slots are born at defaults."""
        if n <= 0:
            return []
        self._drain_serving()
        need = len(self) + int(n)
        if need > self._capacity:
            self._grow(bucket_capacity(need))
        slots = [int(s) for s in np.flatnonzero(~self._active)[: int(n)]]
        self._reset_slot_health(slots)
        self._guard_verdicts[slots] = 0
        self._active[slots] = True
        self._note_membership()
        return slots

    def remove_tenant(self, tenant: int, return_state: bool = False):
        """Evict tenant ``tenant``. With ``return_state=True`` the tenant's
        accumulated state is first unstacked into an independent template
        clone (see :meth:`tenant_collection`) and returned; the slot is
        re-defaulted and reusable either way. Capacity never shrinks: the
        bucket's program stays warm for the next admission wave."""
        self._check_tenant(tenant)
        self._drain_serving()
        out = self.tenant_collection(tenant) if return_state else None
        self._active[int(tenant)] = False
        self._default_slots(int(tenant))
        self._reset_slot_health([int(tenant)])
        self._guard_verdicts[int(tenant)] = 0
        self._note_membership()
        return out

    def _default_slots(self, slot: int) -> None:
        for name, m in self._template.items():
            for sname, default in m._defaults.items():
                self._states[name][sname] = _set_rows(self._states[name][sname], slot, default)

    def _grow(self, new_capacity: int) -> None:
        grown = new_capacity - self._capacity
        pad = self._default_states(grown)
        for name, d in self._states.items():
            for sname, cur in d.items():
                d[sname] = torch.cat([cur, pad[name][sname]])
        self._active = np.concatenate([self._active, np.zeros(grown, dtype=bool)])
        self._guard_verdicts = np.concatenate([self._guard_verdicts, np.zeros(grown, dtype=np.int64)])
        if self._health is not None:
            pad_health = self._default_health(grown)
            self._publish_health({k: torch.cat([v, pad_health[k]]) for k, v in self._health.items()})
        self._capacity = new_capacity

    # ------------------------------------------------------------------
    # per-tenant health
    # ------------------------------------------------------------------
    def _default_health(self, capacity: int) -> Dict[str, torch.Tensor]:
        """Fresh int32 health accumulators for ``capacity`` slots (rows seen
        saturate after ~2.1e9 rows per tenant, as in the JAX package)."""
        zeros = torch.zeros((capacity,), dtype=torch.int32, device=self._device)
        return {"rows_seen": zeros, "updates": zeros.clone(), "last_step": torch.full_like(zeros, -1),
                "nonfinite": zeros.clone()}

    def _reset_slot_health(self, slots: List[int]) -> None:
        """Re-default some slots' health (slot reuse must not inherit the
        evicted tenant's history)."""
        if self._health is None:
            return
        fresh = self._default_health(1)
        self._publish_health({k: _set_rows(v, slots, fresh[k][0]) for k, v in self._health.items()})

    def _publish_health(self, health: Optional[Dict[str, torch.Tensor]]) -> None:
        """Install new health accumulators (never written in place: a step
        clones them out of its graph), or None. On the card they are
        published with an event recorded on the writer's stream after their
        producers, which a reader waits on; the pinned mirror a reader
        copies into is made here, by the writer, when the capacity changes."""
        written = None
        if health is not None and self._device.type == "cuda":
            like = health["rows_seen"]
            if self._health_mirror is None or self._health_mirror.shape != (len(_HEALTH_KEYS),) + tuple(like.shape):
                self._health_mirror = _HostMirror(len(_HEALTH_KEYS), like)
            written = torch.cuda.Event()
            written.record(torch.cuda.current_stream(self._device))
        self._health = health
        self._health_view = None if health is None else (health, written, self._health_mirror)

    def _health_enabled(self) -> bool:
        return self._track_health if self._track_health is not None else _obs.enabled()

    def health(self, stale_after: int = 16) -> Optional[Dict[str, Any]]:
        """Per-tenant health snapshot from the in-step accumulators: one
        small device read, never a per-tenant sync. None before any
        health-armed step; otherwise a dict of aligned per-tenant numpy
        arrays over the live slots (in :meth:`tenant_ids` order): ``step``
        (the cohort's step count), ``tenants`` (slot ids), ``rows_seen``,
        ``updates``, ``last_step`` (-1 = never active), ``staleness`` (steps
        since last activity; never-active tenants read the full step count),
        ``nonfinite`` (steps that left a nonfinite float state, or with a
        guard the steps the guard flagged) and ``guard_verdicts`` (host-side
        :class:`~metrics_tpu_torch.reliability.StateGuard` violations
        attributed to the slot).

        With telemetry on, each snapshot refreshes the ``cohort.tenant.*``
        gauges (``stale`` counts tenants with ``staleness >= stale_after``);
        with the flight recorder armed, a ``cohort_health`` breadcrumb
        naming the stale and poisoned slots rides the event window into any
        later dump. Health is process-local diagnostics: it does not
        checkpoint, and a restored cohort starts a fresh window."""
        view = self._health_view
        if view is None:
            return None
        health, written, mirror = view
        rows = [health[k] for k in _HEALTH_KEYS]
        stacked = torch.stack(rows) if written is None else mirror.read(rows, written)
        host = dict(zip(_HEALTH_KEYS, stacked.numpy()))
        slots = self._slot_index()
        step = self._steps
        last = host["last_step"][slots]
        staleness = np.where(last < 0, step, step - last).astype(np.int64)
        snapshot = {
            "step": step,
            "tenants": [int(s) for s in slots],
            "rows_seen": host["rows_seen"][slots],
            "updates": host["updates"][slots],
            "last_step": last,
            "staleness": staleness,
            "nonfinite": host["nonfinite"][slots],
            "guard_verdicts": self._guard_verdicts[slots].copy(),
        }
        stale = np.flatnonzero(staleness >= int(stale_after))
        poisoned = np.flatnonzero((snapshot["nonfinite"] > 0) | (snapshot["guard_verdicts"] > 0))
        if _obs.enabled():
            tel = _obs.get()
            tel.count("cohort.health_snapshots")
            tel.gauge("cohort.tenant.stale", int(stale.size))
            tel.gauge("cohort.tenant.poisoned", int(poisoned.size))
            tel.gauge("cohort.tenant.max_staleness", int(staleness.max()) if staleness.size else 0)
        if _flight.flight_enabled():
            _flight.record(
                "cohort_health",
                step=step,
                tenants=int(slots.size),
                stale=[int(slots[i]) for i in stale],
                poisoned=[int(slots[i]) for i in poisoned],
            )
        return snapshot

    def _drain_serving(self) -> None:
        """The serving drain barrier, taken before every read or write of
        the stacked states from outside a step: on a cohort enrolled in an
        :class:`~metrics_tpu_torch.serving.AsyncServingEngine`, every staged
        step folds in first and the caller's stream is ordered after the
        worker's, so what is read is final (reading a JAX array waits for
        the work that produces it; a CUDA tensor read on another stream
        does not). A no-op unenrolled and on the pipeline's own worker."""
        if self._serving_pipeline is not None:
            pipe = self._serving_pipeline()
            if pipe is not None:
                pipe.drain()

    def _check_tenant(self, tenant: int) -> None:
        if not (0 <= int(tenant) < self._capacity) or not self._active[int(tenant)]:
            raise KeyError(f"no live tenant at slot {tenant} (live: {self.tenant_ids()})")

    def tenant_collection(self, tenant: int):
        """Unstack one tenant into an independent object (the inverse of
        :meth:`from_collections`): a deep copy of the template (a
        :class:`MetricCollection` for multi-metric cohorts, a bare metric
        otherwise) holding that tenant's current state. A drain barrier
        on an enrolled cohort, as :meth:`compute` is."""
        self._check_tenant(tenant)
        self._drain_serving()
        clones = OrderedDict((n, deepcopy(m)) for n, m in self._template.items())
        for name, clone in clones.items():
            with _san_allow_ctx():
                for sname in clone._defaults:
                    setattr(clone, sname, self._states[name][sname][int(tenant)].clone())
            clone._computed = None
        if self._single:
            return clones["metric"]
        from metrics_tpu_torch.collections import MetricCollection

        return MetricCollection(clones)

    # ------------------------------------------------------------------
    # the hot path
    # ------------------------------------------------------------------
    def _route(self, x: Any) -> Any:
        """One input leaf onto the capacity-padded cohort layout."""
        if not isinstance(x, torch.Tensor):
            return x
        n = len(self)
        if x.ndim == 0 or x.shape[0] not in (n, self._capacity):
            raise ValueError(
                f"cohort input leaf has leading dim {tuple(x.shape[:1])}, expected"
                f" {n} (one row-block per live tenant) or capacity"
                f" {self._capacity} (pre-padded); shape {tuple(x.shape)}"
            )
        if x.shape[0] == self._capacity:
            return x
        if self._dense_prefix():  # padding is a tail: no scatter
            return torch.cat([x, x.new_zeros((self._capacity - n,) + tuple(x.shape[1:]))])
        base = x.new_zeros((self._capacity,) + tuple(x.shape[1:]))
        base[self._membership_tensor("slots").to(x.device)] = x
        return base

    def _step_is_built(self, args: tuple, kwargs: dict) -> bool:
        """Whether :meth:`forward` on these inputs would replay a program
        already built (``CompiledStepEngine.cohort_is_built`` over stand-ins
        of the routed inputs); routes nothing and builds nothing."""
        n = len(self)

        def spec(x: Any) -> Any:
            if not isinstance(x, torch.Tensor):
                return x
            if x.ndim == 0 or x.shape[0] not in (n, self._capacity):
                raise ValueError  # forward raises on this leaf
            return LeafSpec((self._capacity,) + tuple(x.shape[1:]), x.dtype, x.device)

        try:
            stacked_args = pytree.tree_map(spec, tuple(args))
            stacked_kwargs = pytree.tree_map(spec, dict(kwargs))
        except ValueError:
            return False
        health_state = None
        if self._health_enabled():
            if self._health is None:
                return False
            health_state = dict(self._health)
            # the device of a tensor, as the step's own leaves key on: a
            # cohort built on "cuda" holds tensors on "cuda:0", and the two
            # devices compare unequal
            device = self._health["rows_seen"].device
            health_state["valid"] = LeafSpec((self._capacity,), torch.int8, device)
            health_state["step"] = LeafSpec((), torch.int32, device)
        return n > 0 and self._engine.cohort_is_built(
            self._states, stacked_args, stacked_kwargs, capacity=self._capacity, health_state=health_state
        )

    def forward(self, *args: Any, **kwargs: Any):
        """One step folding every tenant's batch into its stacked state;
        returns the per-tenant batch-local values (leading dim = live tenant
        count, in :meth:`tenant_ids` order). Tensor inputs carry the tenant
        axis first (see the class docs); Python scalars broadcast to every
        tenant. On the card the work is queued: reading a value is the
        synchronization point."""
        n = len(self)
        if n == 0:
            raise ValueError("cohort has no live tenants; add_tenant() first")
        names = tuple(self._template)
        stacked_args = pytree.tree_map(self._route, tuple(args))
        stacked_kwargs = pytree.tree_map(self._route, dict(kwargs))
        health_state = None
        if self._health_enabled():
            if self._health is None:
                self._publish_health(self._default_health(self._capacity))
            health_state = dict(self._health)
            health_state["valid"] = self._membership_tensor("valid")
            health_state["step"] = torch.full((), self._steps + 1, dtype=torch.int32, device=self._device)
        # batch-local values are local: no distributed backend may be
        # reached from inside the step; the cohort syncs at compute()
        prev_sync = [(m, m._to_sync) for m in self._template.values()]
        for m in self._template.values():
            m._to_sync = False
        try:
            # the host-side span around the whole vmapped step
            with _trace.span("cohort.forward", phase="dispatch", tenants=n, capacity=self._capacity):
                new_states, values, finites, guard, new_health = self._engine.cohort_step(
                    self._states, stacked_args, stacked_kwargs, capacity=self._capacity, n_tenants=n,
                    health_state=health_state,
                )
        except Exception:
            self._check_states_alive()
            raise
        finally:
            for m, p in prev_sync:
                m._to_sync = p
        self._states = {name: dict(new_states[name]) for name in names}
        self._steps += 1
        if new_health is not None:
            self._publish_health(new_health)
        if finites is not None:
            self._apply_guard_verdicts(guard, names, finites)
        if _env.san_enabled():
            # MetricSan use-after-donate canary: the cohort's graphs own only
            # its stacked buffers; the template metrics' registered defaults
            # and attributes must be neither freed nor one of them
            from metrics_tpu_torch.analysis import sanitizer as _san

            _san.on_engine_dispatch(self._template, names, self._engine._graph_storages())
        out = {name: (self._valid_rows(values[name]) if name in values else None) for name in names}
        return out["metric"] if self._single else out

    __call__ = forward

    def forward_slots(self, slots: Sequence[int], *args: Any, **kwargs: Any):
        """:meth:`forward` for the live tenants at ``slots`` alone, the others
        left as they were. Inputs carry one row-block per listed slot, in
        slot order (or the capacity-padded layout). The step is the full
        step's own program at this capacity (on the card the same CUDA
        graph), run with the validity mask set to ``slots``; ``torch.where``
        over that mask then keeps the other slots' states. So each listed
        tenant's fold is bit for bit the full step's. Returns the listed
        tenants' batch-local values, in slot order."""
        slots = np.unique(np.asarray(slots, dtype=np.int64))
        for slot in slots:
            self._check_tenant(int(slot))
        self._drain_serving()
        mask = np.zeros(self._capacity, dtype=bool)
        mask[slots] = True
        held_states = self._states
        held = (self._active, self._membership_tensors)
        self._active, self._membership_tensors = mask, {}
        valid = self._membership_tensor("valid").to(torch.bool)
        try:
            return self.forward(*args, **kwargs)
        finally:
            if self._states is not held_states:
                self._states = {
                    name: {sname: torch.where(valid.view((-1,) + (1,) * (v.ndim - 1)), v, held_states[name][sname])
                           for sname, v in d.items()}
                    for name, d in self._states.items()
                }
            self._active, self._membership_tensors = held

    def _check_states_alive(self) -> None:
        """After a failed step, no stacked state may be one of the engine's
        buffers (the JAX package's check that no live state was donated):
        the states are copied in and cloned out, so this holds by
        construction; refuse to continue if it ever does not."""
        owned = self._engine._buffer_ptrs()
        for name, d in self._states.items():
            for sname, v in d.items():
                if v.numel() and v.data_ptr() in owned:
                    raise RuntimeError(
                        f"cohort step failed while stacked state {name}.{sname} aliases an engine buffer;"
                        " accumulated state lost: reset() the cohort or reload a checkpoint"
                    )

    def _apply_guard_verdicts(self, guard, names: Tuple[str, ...], finites: torch.Tensor) -> None:
        """Host epilogue of the in-step finite check: every tenant's flags in
        one device-to-host copy, masked to the live slots (padding slots may
        hold garbage by design), one violation per poisoned member naming
        the offending tenants. Under raise / quarantine the step already
        rolled the poisoned tenants back, per tenant."""
        rolled_back = guard.policy in ("raise", "quarantine")
        host_flags = _flags_to_host(finites).numpy()
        for i, name in enumerate(names):
            guard.stats["checks"] += 1
            bad = np.flatnonzero(self._active & ~host_flags[:, i])
            if bad.size == 0:
                continue
            # per-tenant attribution: tally the verdict per slot and leave a
            # breadcrumb naming the slots before the guard's own dump fires
            self._guard_verdicts[bad] += 1
            if _flight.flight_enabled():
                _flight.record("cohort_tenant_poison", metric=name, tenants=bad.tolist(), policy=guard.policy)
            guard.handle_violation(
                self._template[name],
                None,
                context=f"cohort step ({name}, tenants {bad.tolist()})",
                already_rolled_back=rolled_back,
            )

    def _valid_rows(self, value: Any) -> Any:
        """Cut a capacity-stacked value down to the live tenants."""
        n = len(self)
        if n == self._capacity:
            return value
        if self._dense_prefix():
            return pytree.tree_map(lambda v: v[:n], value)
        idx = self._membership_tensor("slots")
        return pytree.tree_map(lambda v: v[idx.to(v.device)], value)

    # ------------------------------------------------------------------
    # compute: every tenant's epoch value from the vmapped member computes
    # ------------------------------------------------------------------
    def _member_compute(self, m: Metric, rows: Dict[str, torch.Tensor]):
        """Run one template member's ``compute`` on given state rows (under
        ``vmap``), restoring its own states after."""
        saved = m._snapshot_state()
        prev_sync = m._to_sync
        try:
            with _san_allow_ctx():
                for sname in m._defaults:
                    setattr(m, sname, rows[sname])
            # the cohort syncs once for all tenants, before this runs
            m._to_sync = False
            m._computed = None
            return m.compute()
        finally:
            m._restore_state(saved)
            m._to_sync = prev_sync
            m._computed = None

    def _compute_program(self):
        """``(fn, new)``: the vmapped member computes, made once per
        capacity and membership (the JAX package jits them once per key);
        ``new`` is True when made by this call."""
        key = (self._capacity, tuple((name, tuple(sorted(m._defaults))) for name, m in self._template.items()))
        cached_key, fn = self._compute_cache
        if cached_key == key:
            return fn, False

        def compute_fn(states):
            return {name: self._member_compute(self._template[name], states[name]) for name in self._template}

        fn = torch.func.vmap(compute_fn)
        self._compute_cache = (key, fn)
        return fn, True

    def compute(self, tenant: Optional[int] = None):
        """Every tenant's epoch value (or one tenant's with ``tenant=``),
        from the member computes vmapped over the stacked states. In a
        ``torch.distributed`` world the stacked states are synced first,
        one collective per state for the whole cohort, and restored after,
        as ``Metric.compute`` does, keeping the error-feedback residuals the
        sync committed. On a cohort enrolled in an
        :class:`~metrics_tpu_torch.serving.AsyncServingEngine` this is a
        drain barrier, as ``MetricCollection.compute`` is."""
        self._drain_serving()
        synced_cache = None
        if is_distributed_initialized():
            synced_cache = {name: dict(d) for name, d in self._states.items()}
            self._sync_stacked()
        try:
            fn, new = self._compute_program()
            # the member computes' hooks fire once per program, as at the
            # JAX package's trace of its jitted compute
            with tracing(), (nullcontext() if new else _trace.muted()):
                values = fn(self._states)
        finally:
            if synced_cache is not None:
                # keep the residual companions the sync just committed (they
                # describe the error that crossed the wire); everything else
                # resumes un-synced accumulation
                for name, m in self._template.items():
                    for res_name in m._sync_residual_names():
                        synced_cache[name][res_name] = self._states[name][res_name]
                self._states = synced_cache
        if tenant is not None:
            self._check_tenant(tenant)
            values = pytree.tree_map(lambda v: v[int(tenant)], values)
        else:
            values = {n: self._valid_rows(v) for n, v in values.items()}
        return values["metric"] if self._single else values

    def _sync_stacked(self) -> None:
        """Gather-then-reduce every stacked state across ranks in one
        collective each, with the quantized ``sync_precision=`` tier applied
        to the stacked tensor (blocks span tenants; the per-element error
        bound is unchanged) and the per-tenant error-feedback residuals
        committed only when the collectives succeed. Degradation is atomic
        across the whole cohort: tenants mixing world and local states would
        be silently wrong, not degraded."""
        backend = get_sync_backend()
        if isinstance(backend, _hier.HierarchicalSyncBackend):
            # two levels: one level-0 and one level-1 collective per STATE for
            # the whole cohort, policy and precision per level
            self._sync_stacked_hierarchical(backend)
            return
        input_dict: Dict[Tuple[str, str], torch.Tensor] = {}
        wire_dict: Dict[Tuple[str, str], Any] = {}
        new_residuals: Dict[Tuple[str, str], torch.Tensor] = {}
        reductions: Dict[Tuple[str, str], Any] = {}
        precisions: Dict[Tuple[str, str], str] = {}
        for name, m in self._template.items():
            res_names = set(m._sync_residual_names())
            member_prec = m.sync_precisions()
            for sname, red in m._reductions.items():
                if sname in res_names:
                    continue  # residuals never cross the wire
                key = (name, sname)
                x = self._states[name][sname]
                input_dict[key] = x
                reductions[key] = red
                if sname in member_prec:
                    precisions[key] = member_prec[sname]
                    wire_dict[key], new_residuals[key] = _quant.compensate_and_quantize(
                        x, self._states[name][sname + "__qres"], member_prec[sname]
                    )
                else:
                    # no copy: the engine's graphs never alias a stacked state
                    # (the JAX package copies here against buffer donation)
                    wire_dict[key] = x
        if _obs.enabled():
            tel = _obs.get()
            payload = sum(_obs.array_nbytes(v) for v in input_dict.values())
            wire = sum(_quant.payload_wire_nbytes(w) for w in wire_dict.values())
            tel.count("sync.calls")
            tel.count("cohort.sync_collectives", len(wire_dict))
            tel.count("sync.payload_bytes", payload)
            tel.count("sync.wire_bytes", wire)
            tel.observe_hist("sync.payload_bytes", payload, _obs.PAYLOAD_BUCKETS_BYTES)
            tel.observe_hist("sync.wire_bytes", wire, _obs.PAYLOAD_BUCKETS_BYTES)
            tel.event(
                "cohort_sync",
                tenants=len(self),
                capacity=self._capacity,
                states=len(wire_dict),
                payload_bytes=payload,
                wire_bytes=wire,
            )
        guarded = _rsync.apply_sync_policy(gather_all_tensors)
        degraded = False
        gathered: Dict[Tuple[str, str], Any] = {}
        try:
            for key, w in wire_dict.items():
                gathered[key] = {k: guarded(v) for k, v in w.items()} if isinstance(w, dict) else guarded(w)
        except _rsync.SyncFailedError as err:
            local_only = _rsync.degraded_local_fallback(err)
            if local_only is None:
                raise
            # local-only: the exact local states for every tier (no bytes
            # crossed the wire), residuals untouched
            gathered = {k: local_only(v) for k, v in input_dict.items()}
            degraded = True
        for key, red in reductions.items():
            if not degraded and key in precisions:
                g = gathered[key]  # payload dict of per-rank lists
                local = input_dict[key]
                self._states[key[0]][key[1]] = _quant.merge_dequantized(
                    [{k: v[r] for k, v in g.items()} for r in range(len(g["q"]))], local.shape, local.dtype
                )
                continue
            stacked = torch.stack(list(gathered[key]))
            self._states[key[0]][key[1]] = red(stacked) if red is not None else stacked
        if not degraded:
            for (name, sname), res in new_residuals.items():
                self._states[name][sname + "__qres"] = res

    def _sync_stacked_hierarchical(self, backend: "_hier.HierarchicalSyncBackend") -> None:
        """The cohort sync through the two-level engine: one collective per
        STATE per level, the stacked tensor quantized at the level its tier
        resolves to, and the stacked residuals committed only when the lossy
        level succeeds. Degradation stays atomic across the whole cohort
        and per level: a failed leader exchange serves every tenant the
        slice-local merge."""
        states: Dict[Tuple[str, str], Any] = {}
        reductions: Dict[Tuple[str, str], Any] = {}
        precisions: Dict[Tuple[str, str], str] = {}
        residuals: Dict[Tuple[str, str], torch.Tensor] = {}
        for name, m in self._template.items():
            res_names = set(m._sync_residual_names())
            member_prec = m.sync_precisions()
            for sname, red in m._reductions.items():
                if sname in res_names:
                    continue
                key = (name, sname)
                states[key] = self._states[name][sname]
                reductions[key] = red
                if sname in member_prec:
                    precisions[key] = member_prec[sname]
                    residuals[key] = self._states[name][sname + "__qres"]
        if _obs.enabled():
            tel = _obs.get()
            payload = sum(_obs.array_nbytes(v) for v in states.values())
            tel.count("sync.calls")
            tel.count("cohort.sync_collectives", len(states))
            tel.count("sync.payload_bytes", payload)
            tel.observe_hist("sync.payload_bytes", payload, _obs.PAYLOAD_BUCKETS_BYTES)
            tel.event(
                "cohort_sync",
                tenants=len(self),
                capacity=self._capacity,
                states=len(states),
                payload_bytes=payload,
                hierarchical=True,
                num_slices=backend.topology.num_slices,
            )
        outcome = _hier.sync_states(backend, states, reductions, precisions, residuals)
        for (name, sname), value in outcome.states.items():
            self._states[name][sname] = value
        for (name, sname), res in outcome.residuals.items():
            self._states[name][sname + "__qres"] = res

    # ------------------------------------------------------------------
    # lifecycle / checkpointing
    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Reset every tenant to the registered defaults (membership and
        capacity are kept). Health accounting resets with the state it
        described."""
        self._drain_serving()
        self._states = self._default_states(self._capacity)
        if self._health is not None:
            self._publish_health(self._default_health(self._capacity))
        self._guard_verdicts = np.zeros(self._capacity, dtype=np.int64)
        self._steps = 0

    def _slots_state(self) -> torch.Tensor:
        return torch.from_numpy(self._active.astype(np.int8)).to(self._device)

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "") -> dict:
        """Persistent stacked states plus the active-slot table, member-
        prefixed like ``MetricCollection.state_dict``."""
        self._drain_serving()
        destination = {} if destination is None else destination
        for name, m in self._template.items():
            for sname in m._defaults:
                if m._persistent[sname]:
                    destination[f"{prefix}{name}.{sname}"] = self._states[name][sname]
        destination[prefix + _SLOTS_KEY] = self._slots_state()
        return destination

    def _named_states(self, prefix: str = "") -> list:
        """Every loadable ``(key, value)`` pair: the full stacked state plus
        the slot table."""
        self._drain_serving()
        pairs = [
            (f"{prefix}{name}.{sname}", self._states[name][sname])
            for name, m in self._template.items()
            for sname in m._defaults
        ]
        pairs.append((prefix + _SLOTS_KEY, self._slots_state()))
        return pairs

    def load_state_dict(self, state_dict: dict, prefix: str = "", strict: bool = False) -> None:
        """Restore stacked states saved by :meth:`state_dict`, from tensors
        on any device or numpy arrays. A checkpoint of another capacity
        bucket resizes this cohort to match: every loaded stack must agree
        on its leading dim."""
        self._drain_serving()
        incoming: Dict[str, Dict[str, torch.Tensor]] = {}
        caps = set()
        missing = []
        for name, m in self._template.items():
            for sname in m._defaults:
                key = f"{prefix}{name}.{sname}"
                if key in state_dict:
                    v = torch.as_tensor(state_dict[key]).detach().to(self._device, copy=True)
                    incoming.setdefault(name, {})[sname] = v
                    caps.add(int(v.shape[0]) if v.ndim else -1)
                else:
                    missing.append(key)
        if strict and missing:
            raise KeyError(f"strict load_state_dict: MetricCohort is missing state keys {missing}")
        slots_key = prefix + _SLOTS_KEY
        # the slot table loads even when no member state matched: a
        # persistent-only state_dict() of a default template carries only
        # the slot mask, and membership must still round-trip
        slots_mask = None
        if slots_key in state_dict:
            slots_mask = np.asarray(torch.as_tensor(state_dict[slots_key]).cpu()).ravel() != 0
            if incoming:
                caps.add(int(slots_mask.size))
        if not incoming and slots_mask is None:
            if state_dict:
                warn_once(
                    f"load_state_dict: no cohort state key (prefix={prefix!r})"
                    f" matched the non-empty state_dict ({len(state_dict)}"
                    " entries); nothing was loaded. Check the prefix used at"
                    " save time or pass strict=True.",
                    key=f"load-zero-match:MetricCohort:{prefix}",
                )
            return
        if incoming and (len(caps) != 1 or -1 in caps):
            raise ValueError(
                f"loaded cohort stacks disagree on capacity: {sorted(caps)}; a partial load cannot resize the cohort"
            )
        new_capacity = caps.pop() if incoming else int(slots_mask.size)
        if new_capacity != self._capacity:
            if missing:
                raise ValueError(
                    f"capacity change ({self._capacity} -> {new_capacity}) requires a complete load; missing: {missing}"
                )
            self._capacity = int(new_capacity)
            self._active = np.zeros(self._capacity, dtype=bool)
            self._publish_health(None)
            self.reset()
        for name, d in incoming.items():
            for sname, v in d.items():
                self._states[name][sname] = v
        if slots_mask is not None:
            if slots_mask.size != self._capacity:
                raise ValueError(
                    f"loaded slot mask has {slots_mask.size} entries, capacity is {self._capacity}"
                )
            self._active = slots_mask.astype(bool)
        else:
            warn_once(
                f"load_state_dict: cohort checkpoint carries no {_SLOTS_KEY!r} slot table;"
                " assuming every slot is a live tenant",
                key=f"cohort-no-slots:{prefix}",
            )
            self._active = np.ones(self._capacity, dtype=bool)
        # any restore starts a fresh health window: the loaded state has
        # another history
        self._publish_health(None)
        self._guard_verdicts = np.zeros(self._capacity, dtype=np.int64)
        self._steps = 0
        self._note_membership()

    def persistent(self, mode: bool = True) -> None:
        """Toggle whether stacked states land in ``state_dict`` (delegates
        to the template's per-state flags)."""
        for m in self._template.values():
            m.persistent(mode)

    # the engine's graphs close over the template instances: copies and
    # pickles drop them and build anew against their own template objects
    def __getstate__(self) -> dict:
        return {k: v for k, v in self.__dict__.items()
                if k not in ("_engine", "_compute_cache", "_serving_pipeline", "_health_view", "_health_mirror")}

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        # the copy's accumulators were made on this thread's stream
        self._health_mirror = None
        self._publish_health(self._health)
        self._engine = CompiledStepEngine(self._template, cache_size=self._cache_size, observe=False)
        self._compute_cache = (None, None)
        # a copied or unpickled cohort is a new scrape source (the weak
        # registry entry belongs to the original)
        self._exporter_id = _exporter.register_cohort(self)

    # ------------------------------------------------------------------
    # diagnostics
    # ------------------------------------------------------------------
    def cache_info(self) -> Dict[str, Any]:
        """The engine's cache diagnostics (one entry per live (signature,
        capacity bucket, health) program)."""
        return self._engine.cache_info()

    def abstract_double_buffer(self, *args: Any, **kwargs: Any):
        """The two-generation composition of this cohort's vmapped step at
        its current capacity, traced over fake tensors from one tenant's
        sample inputs (nothing built, launched or written): the cohort
        spelling of
        :meth:`~metrics_tpu_torch.engine.CompiledStepEngine.abstract_double_buffer_step`.
        Returns ``(graph_module, out_shapes, n_donated, n_state_outputs)``."""
        return self._engine.abstract_double_buffer_step(*args, capacity=self._capacity, **kwargs)

    def keys(self):
        return self._template.keys()

    def items(self):
        return self._template.items()

    def __repr__(self) -> str:
        body = "\n".join(f"  ({k}): {m!r}" for k, m in self._template.items())
        return f"MetricCohort(tenants={len(self)}, capacity={self._capacity},\n{body}\n)"
