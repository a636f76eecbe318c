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
  tenants × states × world), then restores the local states.
* **Checkpoints.** ``state_dict`` / ``load_state_dict`` / ``_named_states``
  speak ``MetricCollection``'s protocol, with the active-slot table under
  ``__cohort_slots__``, so membership round-trips with the state it
  indexes; a JAX cohort's ``state_dict()`` loads through
  :func:`~metrics_tpu_torch.interop.state_from_jax`.

Unlike the JAX package, which donates the stacked buffers to each dispatch,
the engine copies every stacked state into its graph's buffers before a
replay and clones the new states out after it: no state, value or
``compute()`` result is a graph buffer.
"""
from collections import OrderedDict
from copy import deepcopy
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.utils._pytree as pytree

from metrics_tpu_torch.engine import CompiledStepEngine
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.parallel.backend import is_distributed_initialized
from metrics_tpu_torch.utilities.data import _is_concrete, tracing
from metrics_tpu_torch.utilities.distributed import gather_all_tensors
from metrics_tpu_torch.utilities.prints import warn_once

__all__ = ["MetricCohort", "bucket_capacity", "route_rows"]

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
            switch in the JAX package, and the port has no telemetry yet,
            so ``None`` is off.

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
        self._engine = CompiledStepEngine(self._template, cache_size=cache_size)
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
        self._steps = 0
        # slot index and validity mask on the device, per membership: a
        # step reads them without a host-to-device copy
        self._membership_tensors: Dict[str, torch.Tensor] = {}

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

    def add_tenant(self, state: Optional[Any] = None) -> int:
        """Admit one tenant; returns its slot id (stable until removed).

        Reuses a freed slot when one exists, else grows the stacked state to
        the next capacity bucket (padding with registered defaults; the next
        forward builds the new bucket's program once and the old one stays
        cached). ``state`` seeds the new tenant: a template-shaped
        collection or metric (its current state is adopted) or nothing
        (registered defaults)."""
        free = np.flatnonzero(~self._active)
        if free.size:
            slot = int(free[0])
        else:
            slot = self._capacity
            self._grow(bucket_capacity(self._capacity + 1))
        # a reused slot may hold a removed tenant's garbage: re-default it
        self._default_slots(slot)
        self._reset_slot_health([slot])
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
        need = len(self) + int(n)
        if need > self._capacity:
            self._grow(bucket_capacity(need))
        slots = [int(s) for s in np.flatnonzero(~self._active)[: int(n)]]
        self._reset_slot_health(slots)
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
        out = self.tenant_collection(tenant) if return_state else None
        self._active[int(tenant)] = False
        self._default_slots(int(tenant))
        self._reset_slot_health([int(tenant)])
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
        if self._health is not None:
            pad_health = self._default_health(grown)
            self._health = {k: torch.cat([v, pad_health[k]]) for k, v in self._health.items()}
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
        self._health = {k: _set_rows(v, slots, fresh[k][0]) for k, v in self._health.items()}

    def _health_enabled(self) -> bool:
        # None follows the JAX package's telemetry switch, which the port
        # does not have yet: off
        return bool(self._track_health)

    def health(self, stale_after: int = 16) -> Optional[Dict[str, Any]]:
        """Per-tenant health snapshot from the in-step accumulators: one
        small device read, never a per-tenant sync. None before any
        health-armed step; otherwise a dict of aligned per-tenant numpy
        arrays over the live slots (in :meth:`tenant_ids` order): ``step``
        (the cohort's step count), ``tenants`` (slot ids), ``rows_seen``,
        ``updates``, ``last_step`` (-1 = never active), ``staleness`` (steps
        since last activity; never-active tenants read the full step count)
        and ``nonfinite`` (steps that left a nonfinite float state).
        ``stale_after`` is the threshold of the JAX package's staleness
        gauges, which wait for the port's telemetry. Health is process-local diagnostics: it does not checkpoint, and a
        restored cohort starts a fresh window."""
        if self._health is None:
            return None
        keys = ("rows_seen", "updates", "last_step", "nonfinite")
        host = dict(zip(keys, torch.stack([self._health[k] for k in keys]).cpu().numpy()))
        slots = self._slot_index()
        step = self._steps
        last = host["last_step"][slots]
        staleness = np.where(last < 0, step, step - last).astype(np.int64)
        return {
            "step": step,
            "tenants": [int(s) for s in slots],
            "rows_seen": host["rows_seen"][slots],
            "updates": host["updates"][slots],
            "last_step": last,
            "staleness": staleness,
            "nonfinite": host["nonfinite"][slots],
        }

    def _check_tenant(self, tenant: int) -> None:
        if not (0 <= int(tenant) < self._capacity) or not self._active[int(tenant)]:
            raise KeyError(f"no live tenant at slot {tenant} (live: {self.tenant_ids()})")

    def tenant_collection(self, tenant: int):
        """Unstack one tenant into an independent object (the inverse of
        :meth:`from_collections`): a deep copy of the template (a
        :class:`MetricCollection` for multi-metric cohorts, a bare metric
        otherwise) holding that tenant's current state."""
        self._check_tenant(tenant)
        clones = OrderedDict((n, deepcopy(m)) for n, m in self._template.items())
        for name, clone in clones.items():
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
                self._health = self._default_health(self._capacity)
            health_state = dict(self._health)
            health_state["valid"] = self._membership_tensor("valid")
            health_state["step"] = torch.full((), self._steps + 1, dtype=torch.int32, device=self._device)
        # batch-local values are local: no distributed backend may be
        # reached from inside the step; the cohort syncs at compute()
        prev_sync = [(m, m._to_sync) for m in self._template.values()]
        for m in self._template.values():
            m._to_sync = False
        try:
            new_states, values, new_health = self._engine.cohort_step(
                self._states, stacked_args, stacked_kwargs, capacity=self._capacity, health_state=health_state
            )
        finally:
            for m, p in prev_sync:
                m._to_sync = p
        self._states = {name: dict(new_states[name]) for name in names}
        self._steps += 1
        if new_health is not None:
            self._health = new_health
        out = {name: (self._valid_rows(values[name]) if name in values else None) for name in names}
        return out["metric"] if self._single else out

    __call__ = forward

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
        key = (self._capacity, tuple((name, tuple(sorted(m._defaults))) for name, m in self._template.items()))
        cached_key, fn = self._compute_cache
        if cached_key == key:
            return fn

        def compute_fn(states):
            return {name: self._member_compute(self._template[name], states[name]) for name in self._template}

        fn = torch.func.vmap(compute_fn)
        self._compute_cache = (key, fn)
        return fn

    def compute(self, tenant: Optional[int] = None):
        """Every tenant's epoch value (or one tenant's with ``tenant=``),
        from the member computes vmapped over the stacked states. In a
        ``torch.distributed`` world the stacked states are synced first,
        one collective per state for the whole cohort, and restored after,
        as ``Metric.compute`` does."""
        synced_cache = None
        if is_distributed_initialized():
            synced_cache = {name: dict(d) for name, d in self._states.items()}
            self._sync_stacked()
        try:
            with tracing():
                values = self._compute_program()(self._states)
        finally:
            if synced_cache is not None:
                self._states = synced_cache
        if tenant is not None:
            self._check_tenant(tenant)
            values = pytree.tree_map(lambda v: v[int(tenant)], values)
        else:
            values = {n: self._valid_rows(v) for n, v in values.items()}
        return values["metric"] if self._single else values

    def _sync_stacked(self) -> None:
        """Gather-then-reduce every stacked state across ranks, one
        collective per state for the whole cohort (the exact tier)."""
        for name, m in self._template.items():
            for sname, red in m._reductions.items():
                stacked = torch.stack(list(gather_all_tensors(self._states[name][sname])))
                self._states[name][sname] = red(stacked) if red is not None else stacked

    # ------------------------------------------------------------------
    # lifecycle / checkpointing
    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Reset every tenant to the registered defaults (membership and
        capacity are kept). Health accounting resets with the state it
        described."""
        self._states = self._default_states(self._capacity)
        if self._health is not None:
            self._health = self._default_health(self._capacity)
        self._steps = 0

    def _slots_state(self) -> torch.Tensor:
        return torch.from_numpy(self._active.astype(np.int8)).to(self._device)

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "") -> dict:
        """Persistent stacked states plus the active-slot table, member-
        prefixed like ``MetricCollection.state_dict``."""
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
            self._health = None
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
        self._health = None
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
        return {k: v for k, v in self.__dict__.items() if k not in ("_engine", "_compute_cache")}

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._engine = CompiledStepEngine(self._template, cache_size=self._cache_size)
        self._compute_cache = (None, None)

    # ------------------------------------------------------------------
    # diagnostics
    # ------------------------------------------------------------------
    def cache_info(self) -> Dict[str, Any]:
        """The engine's cache diagnostics (one entry per live (signature,
        capacity bucket, health) program)."""
        return self._engine.cache_info()

    def keys(self):
        return self._template.keys()

    def items(self):
        return self._template.items()

    def __repr__(self) -> str:
        body = "\n".join(f"  ({k}): {m!r}" for k, m in self._template.items())
        return f"MetricCohort(tenants={len(self)}, capacity={self._capacity},\n{body}\n)"
