"""MetricSan — the opt-in runtime sanitizer behind the static analyzer.

Port of ``metrics_tpu/analysis/sanitizer.py``. Pass 3
(:mod:`metrics_tpu_torch.analysis.distributed`) proves what it can see:
equivalence on probe batches, identity of reset values, purity of traced
computes, passthrough in traced programs. What it structurally *cannot*
see — arbitrary host code holding a reference to a buffer the step engine
owns, a state written from outside the metric lifecycle at run time, a
live sync that drifts where the probe didn't — MetricSan enforces
dynamically, and every violation is reported under the **static rule it
refutes**, so the flight dump reads the same whether the defect was caught
before dispatch or in production:

* **use-after-donate canaries (MTA007)** — after every successful engine
  dispatch, the sanitizer sweeps each metric's registered defaults and
  live state attributes for the two forms the hazard takes here. The JAX
  package donates the states to its dispatch and asks each buffer
  ``is_deleted()``; the port copies every state into its CUDA graph's
  buffers and clones the results out, so a tensor has nothing to delete.
  (a) *Dead storage*: a tensor whose storage holds no bytes while the
  tensor has elements — a buffer freed under a live reference, which is
  what a dispatch that bypasses the defensive copies leaves on any device.
  (b) *Graph aliasing*, on the card: a default or live state that shares
  storage with a captured graph's static inputs, state buffers or outputs,
  which the next replay overwrites. Both compare storages and pointers
  only; neither reads the device.
* **state-write interceptor (MTA006)** — while armed, a ``__setattr__``
  interceptor on :class:`~metrics_tpu_torch.metric.Metric` flags writes to
  *registered state* from outside the sanctioned lifecycle contexts
  (update, reset, restore, sync, checkpoint load, dtype/device moves,
  engine write-back). A ``compute`` that mutates state — or external
  code poking accumulators directly — is caught at the exact write.
* **single-replica sync identity (MTA005)** — a sync at world size 1
  must be an identity (exact tier: bit-identical; quantized tiers:
  within the documented bound). Any drift means the reduction composite
  is unsound in a way that R>1 will amplify, caught on the cheapest
  possible mesh. The pre-sync snapshot copies each state to the host
  (only while armed, only around an eager ``_sync_dist``).
* **reset-identity probe (MTA006)** — the first concrete ``reset()`` of
  each metric class probes every state's reset value against its
  ``dist_reduce_fx`` identity, the dynamic twin of the static check (for
  metrics constructed at run time that no audit ever saw). A reset inside
  an engine build's warm-up, a CUDA-graph capture or an FX trace is not
  probed (the probe reads values to the host) and leaves the class
  unprobed for the next one.
* **ThreadSan: cross-thread write instrumentation (MTL106)** — arm-time
  ``__setattr__`` instrumentation of the thread-shared attributes the
  pass-4 lint flags (:func:`metrics_tpu_torch.analysis.concurrency.
  thread_shared_model`, plus anything registered via
  :func:`~metrics_tpu_torch.analysis.concurrency.register_threadsan_target`).
  Every write to a watched attribute records the writer thread and
  whether the owning lock was held; a write from a second thread with
  neither write synchronized is a data race, flight-dumped ONCE per
  (class, attr) as ``metricsan_thread_race`` and counted on
  ``san.thread.races``. Lock-held detection is conservative toward
  silence: an ``RLock`` answers ownership exactly; a plain ``Lock``
  held by ANYONE reads as synchronized, so properly locked code can
  never false-positive.

Arming: ``METRICS_TPU_SAN=1`` in the environment, :func:`enable_san`,
or the scoped :func:`san_scope`. Like every observability feature the
default is OFF and zero-overhead — each hook reads one module-global
flag (``metrics_tpu_torch.utilities.env.san_enabled``) and branches; the
``__setattr__`` interceptor is *installed on arm and removed on disarm*,
so the unarmed hot path pays nothing at all.

Every violation is recorded once per (rule, check, subject), dumped
through the :class:`~metrics_tpu_torch.observability.flight.FlightRecorder`
when one is armed (reason ``metricsan_<check>``, hint naming the MTA
rule), and surfaced as a rate-limited warning — or raised as
:class:`MetricSanError` under ``san_scope(raise_on_violation=True)``.
"""
import functools
import threading
import weakref
from contextlib import contextmanager
from typing import Any, Collection, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.analysis.program import _np
from metrics_tpu_torch.analysis.rules import RULES
from metrics_tpu_torch.observability import flight as _flight
from metrics_tpu_torch.utilities import env as _env
from metrics_tpu_torch.utilities.data import _is_concrete
from metrics_tpu_torch.utilities.prints import warn_once

__all__ = [
    "MetricSan",
    "MetricSanError",
    "active",
    "allow_state_writes",
    "disable_san",
    "enable_san",
    "san_enabled",
    "san_scope",
]


class MetricSanError(RuntimeError):
    """A sanitizer violation under ``raise_on_violation=True``."""


_tls = threading.local()


def _allow_depth() -> int:
    return getattr(_tls, "allow_depth", 0)


@contextmanager
def allow_state_writes() -> Iterator[None]:
    """Mark the dynamic extent as a sanctioned state-write context (the
    lifecycle methods run under this; everything else is a violation)."""
    _tls.allow_depth = _allow_depth() + 1
    try:
        yield
    finally:
        _tls.allow_depth -= 1


def _prune_on_collect(san: "MetricSan", obj: Any) -> Optional[Any]:
    """A weakref whose callback drops the collected object's ThreadSan
    rows — ``id()`` reuse must never pair a fresh object with a dead
    object's writer history, and the write map must not grow with every
    short-lived watched instance. Returns None for non-weakref-able
    objects (``__slots__`` without ``__weakref__``): their lifetime
    cannot be tracked soundly, so the caller records NO history for them
    at all — conservative silence, never a stale-id false pair."""
    oid = id(obj)
    san_ref = weakref.ref(san)

    def _prune(_collected: Any) -> None:
        s = san_ref()
        if s is None:
            return
        with s._lock:
            s._thread_live.pop(oid, None)
            for key in [k for k in s._thread_writes if k[0] == oid]:
                del s._thread_writes[key]

    try:
        return weakref.ref(obj, _prune)
    except TypeError:
        return None


class MetricSan:
    """The armed sanitizer: violation log + dedup + reporting policy."""

    def __init__(self, raise_on_violation: bool = False):
        self.raise_on_violation = raise_on_violation
        self.violations: List[Dict[str, Any]] = []
        self._seen: set = set()
        self._identity_probed: set = set()
        # ThreadSan: (id(obj), attr) -> (writer thread id, lock held?,
        # cross-thread ownership transitions seen so far)
        self._thread_writes: Dict[Tuple[int, str], Tuple[int, bool, int]] = {}
        # keeps id(obj) honest: a finalizer per watched instance prunes
        # its rows, so dead-object ids cannot leak memory or be recycled
        # into a fresh object's history (a false cross-thread pair)
        self._thread_live: Dict[int, Any] = {}
        # RLock: the _thread_live weakref finalizers may fire from GC in
        # the middle of a locked section on the same thread
        self._lock = threading.RLock()

    def violation(self, rule: str, check: str, subject: str, message: str, **context: Any) -> bool:
        """Record one violation (first occurrence per (rule, check,
        subject)): append to the log, dump the flight window naming the
        rule, warn once — or raise under ``raise_on_violation``. Returns
        True when this call newly recorded (and dumped) the violation,
        False when it deduplicated — callers keeping per-dump counters
        key off the return value."""
        key = (rule, check, subject)
        with self._lock:
            if key in self._seen:
                return False
            self._seen.add(key)
            self.violations.append(
                {"rule": rule, "check": check, "subject": subject,
                 "message": message, **context}
            )
        slug = RULES[rule].slug if rule in RULES else ""
        hint = f"MetricSan: {rule} ({slug}) on {subject} — {message}"
        _flight.dump_on_failure(
            f"metricsan_{check}", hint=hint, rule=rule, subject=subject, **context
        )
        if self.raise_on_violation:
            raise MetricSanError(hint)
        warn_once(hint, key=f"metricsan:{check}:{subject}")
        return True

    # ------------------------------------------------------------------
    # the checks (each invoked from one hook; all no-ops when unreachable)
    # ------------------------------------------------------------------
    def check_post_dispatch(
        self,
        metrics: Mapping[str, Any],
        names: Tuple[str, ...],
        graph_storages: Collection[int] = (),
    ) -> None:
        """Use-after-donate canary: any dead buffer, or any buffer a captured
        graph owns (``graph_storages``: the storage pointers of the engine's
        static inputs, state buffers and outputs), still reachable from a
        metric after a successful dispatch is a host reference that escaped
        the engine's defensive copies."""
        for name in names:
            m = metrics[name]
            dead: List[str] = []
            aliased: List[str] = []
            for sname in m._defaults:
                for label, buf in (
                    ("registered default", m._defaults.get(sname)),
                    ("live state", getattr(m, sname, None)),
                ):
                    if not isinstance(buf, torch.Tensor) or not buf.numel():
                        continue
                    storage = buf.untyped_storage()
                    if not storage.nbytes():  # freed under the reference
                        dead.append(f"{sname} ({label})")
                    elif graph_storages and storage.data_ptr() in graph_storages:
                        aliased.append(f"{sname} ({label})")
            # one fault, one dump: a dispatch that killed (or handed out)
            # N reachable buffers of one metric is one event, not N
            if dead:
                self.violation(
                    "MTA007", "use_after_donate",
                    type(m).__name__,
                    f"buffers backing {dead} were donated to the compiled"
                    " step and are now freed — host references escaped"
                    " into the donation set (donation-safe copies were"
                    " bypassed)",
                    states=dead,
                )
            elif aliased:
                self.violation(
                    "MTA007", "use_after_donate",
                    type(m).__name__,
                    f"buffers backing {aliased} are a captured graph's static"
                    " buffers, donated to every replay — the next replay"
                    " overwrites them under the metric (the clone out of the"
                    " graph was bypassed)",
                    states=aliased,
                )

    def check_reset_identity(self, metric: Any) -> None:
        """Once per (class, state): the reset default must be the identity
        of its reduction — the dynamic twin of the static MTA006 probe,
        for metrics no audit ever saw. Honors the same suppressions the
        static pass does (class-level allows and state-scoped
        ``_analysis_allow`` entries): a documented, audited exception must
        not re-fire at run time."""
        from metrics_tpu_torch.analysis.distributed import _reduction_identity_violation
        from metrics_tpu_torch.analysis.rules import class_allowed_rules, state_allowed_rules

        reductions = getattr(metric, "_reductions", {})
        if all((type(metric), sname) in self._identity_probed for sname in reductions):
            return  # every later reset: no source read for the allow comments
        cls = type(metric).__name__
        residual_names = set(metric._sync_residual_names())
        if "MTA006" in class_allowed_rules(type(metric)):
            self._identity_probed.update((type(metric), sname) for sname in reductions)
            return
        scoped = state_allowed_rules(metric).get("MTA006", set())
        for sname, red in reductions.items():
            key = (type(metric), sname)
            if key in self._identity_probed:
                continue
            self._identity_probed.add(key)
            default = metric._defaults.get(sname)
            if sname in residual_names or sname in scoped or isinstance(default, list):
                continue
            note = _reduction_identity_violation(red, default, default)
            if note is not None:
                self.violation("MTA006", "non_identity_reset", f"{cls}.{sname}", note)

    def check_thread_write(
        self, obj: Any, owner: type, attr: str, lock_attr: Optional[str]
    ) -> None:
        """ThreadSan: one watched-attribute write. Records
        (writer thread, owning-lock-held) per (instance, attr); writes
        ping-ponging between threads with no write synchronized are a
        cross-thread data race. Conservative toward silence twice over:
        an RLock answers ownership exactly while a plain Lock that is
        merely *locked* (possibly by another thread) still reads as
        synchronized — properly locked code can never false-positive —
        and the FIRST cross-thread transition per (instance, attr) is
        tolerated as an ownership handoff (construct on the main thread,
        then a single worker owns the attr: the exact single-owner fix
        the MTL106 message recommends; there is no happens-before graph
        here, so a one-way handoff must not read as a race). A genuine
        race interleaves, so it produces a SECOND transition and flags;
        the deliberate limitation: a write→join→write-back handoff also
        shows two transitions and still flags."""
        held = False
        lock = getattr(obj, lock_attr, None) if lock_attr else None
        if lock is not None:
            owned = getattr(lock, "_is_owned", None)
            if callable(owned):
                try:
                    held = bool(owned())
                except Exception:  # noqa: BLE001 — exotic lock: assume unheld
                    held = False
            elif hasattr(lock, "locked"):
                held = bool(lock.locked())
        tid = threading.get_ident()
        key = (id(obj), attr)
        with self._lock:
            if id(obj) not in self._thread_live:
                ref = _prune_on_collect(self, obj)
                if ref is None:
                    # lifetime untrackable: recording history under a
                    # recyclable id could pair a dead object's writer with
                    # a fresh object — keep no state, report no races
                    return
                self._thread_live[id(obj)] = ref
            prev = self._thread_writes.get(key)
            transitions = 0 if prev is None else (
                prev[2] + (1 if prev[0] != tid else 0)
            )
            self._thread_writes[key] = (tid, held, transitions)
        if prev is None or prev[0] == tid or held or prev[1]:
            return
        if transitions < 2:
            return  # first cross-thread transition: ownership handoff
        recorded = self.violation(
            "MTL106", "thread_race", f"{owner.__name__}.{attr}",
            f"cross-thread unsynchronized write: thread {tid} wrote"
            f" `{attr}` after thread {prev[0]} did, and neither write held"
            f" the owning lock ({lock_attr!r}) — a data race (torn update /"
            " lost increment) the static MTL106 lint predicted",
            attr=attr, lock=lock_attr,
        )
        if recorded:
            # one count per deduped dump — the documented 1:1 contract
            # with the metricsan_thread_race flight record
            from metrics_tpu_torch.observability import telemetry as _obs

            if _obs.enabled():
                _obs.get().count("san.thread.races")

    def check_sync_identity(
        self,
        metric: Any,
        pre_states: Dict[str, Any],
        world: int,
    ) -> None:
        """A world-size-1 sync must be an identity: exact states bitwise,
        quantized states within their documented single-replica bound."""
        if world != 1:
            return
        from metrics_tpu_torch.analysis.distributed import (
            _exact_state_close,
            quantized_state_tolerance,
        )
        from metrics_tpu_torch.analysis.rules import class_allowed_rules, state_allowed_rules

        cls = type(metric).__name__
        if "MTA005" in class_allowed_rules(type(metric)):
            return
        scoped = state_allowed_rules(metric).get("MTA005", set())
        precisions = metric.sync_precisions()
        residual_names = set(metric._sync_residual_names())
        for sname, before in pre_states.items():
            if sname in residual_names or sname in scoped or isinstance(before, list):
                continue
            if metric._reductions.get(sname) is None:
                # no declared reduction: sync stacks to (world, ...) by
                # design; contract questions there belong to MTL104/MTA004
                # (and the in-program mesh states suppress those), not to
                # an identity check
                continue
            after = getattr(metric, sname, None)
            if after is None or isinstance(after, list):
                continue
            a = np.asarray(before)
            b = _np(after)
            tier = precisions.get(sname, "exact")
            if tier == "exact":
                ok = _exact_state_close(a, b)[0] if a.shape == b.shape else False
            elif a.shape != b.shape:
                ok = False
            else:
                tol = quantized_state_tolerance(a[None], tier, 1)
                if np.issubdtype(a.dtype, np.integer):
                    tol = max(tol, 1.0)
                ok = bool(np.all(np.abs(a.astype(np.float64) - b.astype(np.float64)) <= tol))
            if not ok:
                self.violation(
                    "MTA005", "single_replica_sync_drift", f"{cls}.{sname}",
                    "a world-size-1 sync changed this state"
                    + ("" if tier == "exact" else f" beyond the {tier} tier bound")
                    + " — the gather→reduce composite is not an identity on"
                    " one replica, so it cannot be a sound merge on many",
                    tier=tier,
                )


# ----------------------------------------------------------------------
# module-level arm/disarm (telemetry's singleton shape)
# ----------------------------------------------------------------------
_active: Optional[MetricSan] = None


def active() -> Optional[MetricSan]:
    """The armed sanitizer (None when disarmed)."""
    return _active if _env.san_enabled() else None


def san_enabled() -> bool:
    return _env.san_enabled()


# (owner, method_name, original) triples wrapped with allow_state_writes
# while armed: the sanctioned lifecycle contexts. Wrapping happens on the
# class object at arm time and is fully undone at disarm, so the unarmed
# library is bit-for-bit the code that shipped.
_WRAPPED: List[Tuple[type, str, Any]] = []


def _wrap_lifecycle_method(owner: type, name: str, before: Optional[Any] = None) -> None:
    orig = owner.__dict__.get(name)
    if orig is None:
        return

    @functools.wraps(orig)
    def wrapper(self, *args: Any, **kwargs: Any):
        if before is not None:
            before(self)
        with allow_state_writes():
            return orig(self, *args, **kwargs)

    _WRAPPED.append((owner, name, orig))
    setattr(owner, name, wrapper)


def _probe_may_read() -> bool:
    """Whether a reset runs concretely: not inside an engine
    build's warm-up or a capture (``_is_concrete``), and under no tensor
    dispatch mode (an FX trace's fake and proxy modes). The probe reads
    values to the host; anywhere else it would break the capture or the
    trace, or be lost."""
    return _is_concrete() and torch._C._len_torch_dispatch_stack() == 0


def _on_reset(metric: Any) -> None:
    san = _active
    if san is not None and hasattr(metric, "_defaults") and _probe_may_read():
        try:
            san.check_reset_identity(metric)
        except MetricSanError:
            raise
        except Exception:  # noqa: BLE001 — a probe bug must not break reset
            pass


def _san_setattr(self: Any, name: str, value: Any) -> None:
    san = _active
    if (
        san is not None
        and name in self.__dict__.get("_defaults", ())
        and _allow_depth() == 0
    ):
        san.violation(
            "MTA006", "state_write_outside_update",
            f"{type(self).__name__}.{name}",
            "registered state written outside a sanctioned lifecycle"
            " context (update/reset/restore/sync/load/engine write-back) —"
            " a compute mutating state, or external code poking an"
            " accumulator",
        )
    object.__setattr__(self, name, value)


def _install_hooks() -> None:
    from metrics_tpu_torch.cohort import MetricCohort
    from metrics_tpu_torch.collections import MetricCollection
    from metrics_tpu_torch.engine import CompiledStepEngine
    from metrics_tpu_torch.metric import CompositionalMetric, Metric

    # ThreadSan targets can grow between arms (fixtures/user classes
    # register at any time): the thread-hook installer is idempotent per
    # class and runs on EVERY arm, unlike the one-shot metric hooks below
    _install_thread_hooks()
    if _WRAPPED:  # already installed
        return
    Metric.__setattr__ = _san_setattr
    # cohort write-back contexts: the vmapped compute installs stacked
    # state rows onto the template members inside its trace, and unstack
    # (tenant_collection) seeds clones — both are sanctioned lifecycle
    # writes, exactly like the engine's _write_back
    _wrap_lifecycle_method(MetricCohort, "_member_compute")
    _wrap_lifecycle_method(MetricCohort, "tenant_collection")
    _wrap_lifecycle_method(Metric, "reset", before=_on_reset)
    _wrap_lifecycle_method(CompositionalMetric, "reset")
    _wrap_lifecycle_method(Metric, "_restore_state")
    _wrap_lifecycle_method(CompositionalMetric, "_restore_state")
    _wrap_lifecycle_method(Metric, "_merge_states")
    _wrap_lifecycle_method(Metric, "load_state_dict")
    _wrap_lifecycle_method(CompositionalMetric, "load_state_dict")
    _wrap_lifecycle_method(MetricCollection, "load_state_dict")
    _wrap_lifecycle_method(Metric, "astype")
    _wrap_lifecycle_method(CompositionalMetric, "astype")
    # the port's device move is `to` (the JAX package's `to_device`)
    _wrap_lifecycle_method(Metric, "to")
    _wrap_lifecycle_method(CompositionalMetric, "to")
    _wrap_lifecycle_method(Metric, "add_state")
    _wrap_lifecycle_method(Metric, "set_sync_precision")
    _wrap_lifecycle_method(CompiledStepEngine, "_write_back")
    _wrap_sync(Metric)


def _wrap_sync(owner: type) -> None:
    """``_sync_dist`` gets a richer wrapper than the plain allow scope:
    pre-sync state snapshot → sync (sanctioned writes) → the world-size-1
    identity check. The snapshot reads every state to the host, so it is
    taken only around a concrete sync."""
    orig = owner.__dict__.get("_sync_dist")
    if orig is None:
        return

    @functools.wraps(orig)
    def wrapper(self, *args: Any, **kwargs: Any):
        san = _active
        pre = snapshot_states(self) if san is not None and _is_concrete() else None
        with allow_state_writes():
            result = orig(self, *args, **kwargs)
        if san is not None and pre is not None:
            try:
                from metrics_tpu_torch.parallel.backend import get_sync_backend

                world = int(get_sync_backend().world_size)
            except Exception:  # noqa: BLE001 — unknown world: don't guess
                world = 0
            san.check_sync_identity(self, pre, world)
        return result

    _WRAPPED.append((owner, "_sync_dist", orig))
    setattr(owner, "_sync_dist", wrapper)


def _uninstall_hooks() -> None:
    from metrics_tpu_torch.metric import Metric

    while _WRAPPED:
        owner, name, orig = _WRAPPED.pop()
        setattr(owner, name, orig)
    if Metric.__dict__.get("__setattr__") is _san_setattr:
        del Metric.__setattr__
    _uninstall_thread_hooks()


# ----------------------------------------------------------------------
# ThreadSan: arm-time instrumentation of thread-shared attributes
# ----------------------------------------------------------------------
# classes instrumented this arm: (cls, original own __setattr__ or None,
# the frozenset of attrs the installed wrapper watches)
_THREAD_WRAPPED: List[Tuple[type, Optional[Any], frozenset]] = []


def _install_thread_hooks() -> None:
    """Instrument every ThreadSan target class (the statically inferred
    thread-shared model plus explicit registrations) with a watched-attr
    ``__setattr__``. Idempotent per class; fully undone at disarm.
    Metric subclasses are skipped — they already carry the state-write
    interceptor, and their thread story is the engine lock's."""
    try:
        from metrics_tpu_torch.analysis import concurrency as _conc
        from metrics_tpu_torch.metric import Metric

        targets = _conc.threadsan_targets()
    except Exception:  # noqa: BLE001 — import-time arming mid-package-init
        return
    watched_total = 0
    for cls, attrs, lock_attr in targets:
        if not attrs or issubclass(cls, Metric):
            continue
        already = next(
            (entry for entry in _THREAD_WRAPPED if entry[0] is cls), None
        )
        if already is not None:
            if already[2] == frozenset(attrs):
                watched_total += len(attrs)
                continue
            # the watched set grew since the wrapper was installed
            # (register_threadsan_target between arms): re-wrap fresh
            _THREAD_WRAPPED.remove(already)
            if already[1] is not None:
                cls.__setattr__ = already[1]  # type: ignore[method-assign]
            elif "__setattr__" in cls.__dict__:
                del cls.__setattr__  # type: ignore[misc]
        orig = cls.__dict__.get("__setattr__")
        # the write must continue through what the class RESOLVED before
        # instrumentation — its own __setattr__ if it defines one, else
        # the INHERITED one (a base class's custom setattr must keep
        # running while armed, or arming changes program behavior)
        forward = orig if orig is not None else cls.__setattr__
        watched = frozenset(attrs)

        def _make(cls=cls, forward=forward, watched=watched, lock_attr=lock_attr):
            def _threadsan_setattr(self: Any, name: str, value: Any) -> None:
                san = _active
                if san is not None and name in watched and _allow_depth() == 0:
                    san.check_thread_write(self, cls, name, lock_attr)
                forward(self, name, value)

            return _threadsan_setattr

        cls.__setattr__ = _make()  # type: ignore[method-assign]
        _THREAD_WRAPPED.append((cls, orig, watched))
        watched_total += len(attrs)
    from metrics_tpu_torch.observability import telemetry as _obs

    if _obs.enabled():
        _obs.get().gauge("san.thread.watched_attrs", watched_total)


def _uninstall_thread_hooks() -> None:
    uninstalled = bool(_THREAD_WRAPPED)
    while _THREAD_WRAPPED:
        cls, orig, _watched = _THREAD_WRAPPED.pop()
        if orig is not None:
            cls.__setattr__ = orig  # type: ignore[method-assign]
        elif "__setattr__" in cls.__dict__:
            del cls.__setattr__  # type: ignore[misc]
    if uninstalled:
        # the gauge documents "attrs under instrumentation WHILE ARMED":
        # zero it on disarm or a post-disarm scrape reports phantom watches
        from metrics_tpu_torch.observability import telemetry as _obs

        if _obs.enabled():
            _obs.get().gauge("san.thread.watched_attrs", 0)


def enable_san(raise_on_violation: bool = False) -> MetricSan:
    """Arm MetricSan process-wide. Returns the sanitizer (its
    ``violations`` list is the machine-readable record)."""
    global _active
    _active = MetricSan(raise_on_violation=raise_on_violation)
    _install_hooks()
    _env.set_san_enabled(True)
    return _active


def disable_san() -> Optional[MetricSan]:
    """Disarm and fully undo the hook installation; returns the last
    sanitizer so callers can inspect its violation log."""
    global _active
    _env.set_san_enabled(False)
    _uninstall_hooks()
    san, _active = _active, None
    return san


@contextmanager
def san_scope(raise_on_violation: bool = False) -> Iterator[MetricSan]:
    """Arm MetricSan for a ``with`` block, restoring the prior state on
    exit::

        with san_scope() as san:
            run_eval()
        assert san.violations == []
    """
    prev_active, prev_enabled = _active, _env.san_enabled()
    san = enable_san(raise_on_violation=raise_on_violation)
    try:
        yield san
    finally:
        globals()["_active"] = prev_active
        if prev_active is None or not prev_enabled:
            _env.set_san_enabled(False)
            _uninstall_hooks()
        else:
            _env.set_san_enabled(True)


# --------------------------------------------------------------------
# engine/metric hook entry points (lazy-imported from the hot paths;
# every caller guards on env.san_enabled() first)
# --------------------------------------------------------------------
def on_engine_dispatch(
    metrics: Mapping[str, Any], names: Tuple[str, ...], graph_storages: Collection[int] = ()
) -> None:
    san = _active
    if san is not None:
        san.check_post_dispatch(metrics, names, graph_storages)


def snapshot_states(metric: Any) -> Dict[str, Any]:
    """Host copies of the non-list states, for the sync identity check."""
    out: Dict[str, Any] = {}
    for sname in metric._defaults:
        v = getattr(metric, sname, None)
        if not isinstance(v, list) and v is not None:
            out[sname] = _np(v).copy()
    return out


if _env.san_requested():  # METRICS_TPU_SAN=1: arm at import
    enable_san()
