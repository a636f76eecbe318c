"""Fault injection: make the failure paths testable on demand.

Port of ``metrics_tpu/reliability/faultinject.py``. Recovery code that only
runs during real outages is recovery code that has never run. Each helper
here injects one production failure mode — NaN/Inf in update inputs, a sync
backend that fails or hangs (one level of a hierarchical backend, an
unreachable slice, a simulated multi-slice fleet in one process), a step
engine build that fails, a corrupted checkpoint envelope, a preempted or
skewed eval session, a torn checkpoint file, a cut transport, a step engine
that bypasses its defensive copies — as a scoped context manager (or a
function) that restores the previous world on exit. ``slow_consumer``
and ``preempt_at_step(during="background_write")`` drill ``serving/``;
``expire_lease`` and ``kill_at_migration_phase`` drill ``fleet/``.

Nothing here is imported by the runtime hot paths.
"""
import os
import time
from contextlib import contextmanager
from copy import deepcopy
from typing import Any, Dict, Iterator, List, Optional, Type

import numpy as np
import torch

from metrics_tpu_torch.parallel.backend import SyncBackend, get_sync_backend, set_sync_backend

__all__ = [
    "FaultInjected",
    "Preempted",
    "TransportPartitioned",
    "partition_transport",
    "poison",
    "nonfinite_updates",
    "flaky_sync_backend",
    "flaky_level",
    "hung_level",
    "pod_dropout",
    "simulated_pods",
    "failing_engine_compile",
    "corrupt_envelope",
    "expire_lease",
    "kill_at_migration_phase",
    "preempt_at_step",
    "slow_consumer",
    "torn_write",
    "donation_unsafe_engine",
    "cursor_skew",
]


class FaultInjected(RuntimeError):
    """Marker exception raised by injected faults (distinguishable from
    organic failures in assertions and logs)."""


class Preempted(FaultInjected):
    """Raised by :func:`preempt_at_step`: the process "died" here. A test
    catches it, abandons the session object, and drives recovery purely from
    what reached disk, the same evidence a real SIGKILL leaves."""


class TransportPartitioned(FaultInjected):
    """Raised by :func:`partition_transport`: the network between this
    process and its peers is unreachable, but the process survives, its
    in-memory and durable state intact, and every transport call fails until
    the partition heals."""


# ----------------------------------------------------------------------
# non-finite inputs
# ----------------------------------------------------------------------
def poison(x: torch.Tensor, mode: str = "nan", index: Any = 0) -> torch.Tensor:
    """``x`` with ``x[index]`` replaced by NaN (``mode="nan"``) or +Inf
    (``mode="inf"``), as a new tensor. For crafting poisoned batches fed to
    *compiled* paths, where wrapping ``update`` would poison the step
    function instead of one batch's data."""
    if mode not in ("nan", "inf"):
        raise ValueError(f"mode must be 'nan' or 'inf', got {mode!r}")
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        raise ValueError("poison() needs a floating-point tensor")
    out = x.clone()
    out[index] = float("nan") if mode == "nan" else float("inf")
    return out


def _target_metrics(obj: Any) -> List[Any]:
    values = getattr(obj, "values", None)
    if values is not None and not hasattr(obj, "_defaults"):
        return list(obj.values())  # MetricCollection
    return [obj]


@contextmanager
def nonfinite_updates(obj: Any, mode: str = "nan", times: int = 1, arg_index: int = 0) -> Iterator[Dict[str, int]]:
    """Poison the first ``times`` ``update()`` calls of a metric (or of every
    member of a collection): positional argument ``arg_index`` gets one
    element overwritten with NaN/Inf before the real update runs.

    Eager-path injection only: under the step engine ``update`` runs inside
    the step function, and a wrapper would poison the captured program;
    feed :func:`poison`-ed batch data instead."""
    metrics = _target_metrics(obj)
    injected = {"count": 0}
    originals = [(m, m.update) for m in metrics]

    def _wrap(orig):
        def poisoned_update(*args, **kwargs):
            if injected["count"] < times and len(args) > arg_index:
                injected["count"] += 1
                args = (*args[:arg_index], poison(args[arg_index], mode), *args[arg_index + 1:])
            return orig(*args, **kwargs)

        return poisoned_update

    try:
        for m, orig in originals:
            m.update = _wrap(orig)
        yield injected
    finally:
        for m, orig in originals:
            m.update = orig


# ----------------------------------------------------------------------
# flaky / hung sync backend
# ----------------------------------------------------------------------
class _FlakyBackend(SyncBackend):
    """Delegates to ``inner`` after misbehaving: the first ``fails`` gather
    calls raise ``exc_type`` (after an optional delay — set ``fails=0`` and
    ``delay_s>0`` for a slow-but-successful backend, the timeout drill).
    ``rank`` and ``size`` are the inner backend's."""

    def __init__(
        self,
        inner: SyncBackend,
        fails: int,
        delay_s: float = 0.0,
        exc_type: Type[BaseException] = FaultInjected,
        slow_calls: int = 0,
    ):
        self.inner = inner
        self.remaining_failures = fails
        self.delay_s = delay_s
        self.exc_type = exc_type
        self.remaining_slow = slow_calls
        self.calls = 0

    @property
    def world_size(self) -> int:
        return self.inner.world_size

    def size(self, group: Optional[Any] = None) -> int:
        return self.inner.size(group)

    def rank(self, group: Optional[Any] = None) -> int:
        return self.inner.rank(group)

    def gather(self, x: torch.Tensor, group: Optional[Any] = None) -> List[torch.Tensor]:
        self.calls += 1
        if self.remaining_failures > 0:
            self.remaining_failures -= 1
            if self.delay_s:
                time.sleep(self.delay_s)
            raise self.exc_type(f"injected sync failure ({self.remaining_failures} more to come)")
        if self.remaining_slow > 0:
            self.remaining_slow -= 1
            time.sleep(self.delay_s)
        return self.inner.gather(x, group=group)


@contextmanager
def flaky_sync_backend(
    fails: int = 1,
    delay_s: float = 0.0,
    exc_type: Type[BaseException] = FaultInjected,
    slow_calls: int = 0,
) -> Iterator[_FlakyBackend]:
    """Install a sync backend that fails the first ``fails`` gathers (then
    delegates to the previously active backend). With ``fails=0`` and
    ``slow_calls > 0``, the first ``slow_calls`` gathers instead *succeed
    slowly* (sleep ``delay_s``) — the drill for ``SyncPolicy.timeout_s``."""
    backend = _FlakyBackend(get_sync_backend(), fails, delay_s, exc_type, slow_calls)
    prev = set_sync_backend(backend)
    try:
        yield backend
    finally:
        set_sync_backend(prev)


# ----------------------------------------------------------------------
# level-scoped faults for hierarchical backends
# ----------------------------------------------------------------------
def _active_hierarchy():
    from metrics_tpu_torch.parallel.hierarchy import HierarchicalSyncBackend  # lazy: cycle-free

    backend = get_sync_backend()
    if not isinstance(backend, HierarchicalSyncBackend):
        raise RuntimeError(
            "level-scoped fault injection needs an installed"
            " HierarchicalSyncBackend (set_sync_backend(...) or"
            " simulated_pods()); the active backend is"
            f" {type(backend).__name__}"
        )
    return backend


@contextmanager
def _wrap_level(backend: Any, level: int, make_wrapper) -> Iterator[Any]:
    attr = "level1" if level == 1 else "level0"
    inner = getattr(backend, attr)
    wrapper = make_wrapper(inner)
    setattr(backend, attr, wrapper)
    try:
        yield wrapper
    finally:
        setattr(backend, attr, inner)


@contextmanager
def flaky_level(
    level: int = 1,
    fails: int = 1,
    delay_s: float = 0.0,
    exc_type: Type[BaseException] = FaultInjected,
) -> Iterator[Any]:
    """Fail the first ``fails`` gathers of exactly ONE level of the installed
    :class:`~metrics_tpu_torch.parallel.hierarchy.HierarchicalSyncBackend`
    (then delegate), leaving the other level healthy: level-1 retries must
    not re-run or corrupt the level-0 exchange that already succeeded."""
    if level not in (0, 1):
        raise ValueError(f"level must be 0 or 1, got {level}")
    backend = _active_hierarchy()
    with _wrap_level(backend, level, lambda inner: _FlakyBackend(inner, fails, delay_s, exc_type)) as wrapper:
        yield wrapper


@contextmanager
def hung_level(level: int = 1, delay_s: float = 30.0, calls: int = 1_000_000) -> Iterator[Any]:
    """Make one level's gathers hang (succeed only after ``delay_s``): the
    drill for a per-level ``SyncPolicy.timeout_s``, which must time the
    level out and degrade it while the other level's result stays exact.
    Run it only over virtual or gloo transports: an abandoned NCCL
    collective leaves the communicator unusable."""
    if level not in (0, 1):
        raise ValueError(f"level must be 0 or 1, got {level}")
    backend = _active_hierarchy()
    with _wrap_level(
        backend, level, lambda inner: _FlakyBackend(inner, fails=0, delay_s=delay_s, slow_calls=calls)
    ) as wrapper:
        yield wrapper


class _DroppedPodBackend(SyncBackend):
    """Level-1 transport of a world whose slice ``slice_id`` is gone: every
    exchange raises :class:`PodUnreachableError` naming it."""

    def __init__(self, inner: SyncBackend, slice_id: int):
        self.inner = inner
        self.slice_id = int(slice_id)
        self.calls = 0

    @property
    def world_size(self) -> int:
        return self.inner.world_size

    def rank(self, group: Optional[Any] = None) -> int:
        return self.inner.rank(group)

    def gather(self, x: Any, group: Optional[Any] = None) -> List[Any]:
        from metrics_tpu_torch.parallel.hierarchy import PodUnreachableError  # lazy

        self.calls += 1
        raise PodUnreachableError(self.slice_id)


@contextmanager
def pod_dropout(slice_id: int) -> Iterator[Any]:
    """Make slice ``slice_id`` unreachable at level 1 while level 0 stays
    healthy. Every level-1 exchange raises
    :class:`~metrics_tpu_torch.parallel.hierarchy.PodUnreachableError`
    naming the lost slice, so per-level degradation records WHICH slice was
    dropped in the quorum snapshot."""
    backend = _active_hierarchy()
    if not 0 <= int(slice_id) < backend.topology.num_slices:
        raise ValueError(f"slice_id {slice_id} outside topology with {backend.topology.num_slices} slices")
    with _wrap_level(backend, 1, lambda inner: _DroppedPodBackend(inner, slice_id)) as wrapper:
        yield wrapper


class _MirrorBackend(SyncBackend):
    """A simulated fleet segment for single-process drills: ``gather``
    returns the local contribution plus ``world_size - 1`` copies — remote
    peers whose contributions are bit-identical to this process's own (so a
    healthy 2-slice sum is exactly 2x local, and a degraded one exactly
    1x). This process is rank 0."""

    def __init__(self, world: int):
        self._world = int(world)

    @property
    def world_size(self) -> int:
        return self._world

    def rank(self, group: Optional[Any] = None) -> int:
        return 0

    def gather(self, x: Any, group: Optional[Any] = None) -> List[Any]:
        return [x] + [x.clone() for _ in range(self._world - 1)]


@contextmanager
def simulated_pods(
    num_slices: int = 2,
    slice_size: int = 1,
    level_precisions: Any = ("exact", None),
) -> Iterator[Any]:
    """Install a :class:`~metrics_tpu_torch.parallel.hierarchy.HierarchicalSyncBackend`
    over a simulated multi-slice fleet in ONE process: this rank is rank 0
    of slice 0 and every remote peer mirrors its contributions
    (:class:`_MirrorBackend`). The drills compose on top —
    ``flaky_level`` / ``hung_level`` / ``pod_dropout`` fail one level while
    the other keeps answering — with exact expectations (healthy sum =
    ``num_slices * slice_size`` × local; level-1-degraded = ``slice_size``
    × local; level-0-degraded = local)."""
    from metrics_tpu_torch.parallel.hierarchy import HierarchicalSyncBackend, SyncTopology  # lazy: cycle-free

    topology = SyncTopology.regular(num_slices, slice_size)
    backend = HierarchicalSyncBackend(
        topology,
        _MirrorBackend(slice_size),
        _MirrorBackend(num_slices),
        rank=0,
        level_precisions=tuple(level_precisions),
    )
    prev = set_sync_backend(backend)
    try:
        yield backend
    finally:
        set_sync_backend(prev)


# ----------------------------------------------------------------------
# step engine build failure
# ----------------------------------------------------------------------
@contextmanager
def failing_engine_compile(times: int = 1, exc_type: Type[BaseException] = FaultInjected) -> Iterator[Dict[str, int]]:
    """Make the next ``times`` step-engine builds raise ``exc_type`` when
    their step function runs (its warm-up on the card, its first run on the
    CPU): the failure shape of a step that cannot be captured, which drives
    the rerun-eagerly-then-demote recovery. ``exc_type=KeyboardInterrupt``
    drills an operator ^C inside a step: a BaseException the engine lets
    escape while the accumulated states stay at the last-good snapshot."""
    from metrics_tpu_torch.engine import CompiledStepEngine  # lazy: cycle-free

    orig = CompiledStepEngine._make_step_fn
    injected = {"count": 0}

    def patched(self, names, *fn_args, **fn_kwargs):
        real = orig(self, names, *fn_args, **fn_kwargs)

        def step_fn(states, args, kwargs):
            if injected["count"] < times:
                injected["count"] += 1
                raise exc_type("injected engine compile failure")
            return real(states, args, kwargs)

        return step_fn

    CompiledStepEngine._make_step_fn = patched
    try:
        yield injected
    finally:
        CompiledStepEngine._make_step_fn = orig


# ----------------------------------------------------------------------
# checkpoint corruption
# ----------------------------------------------------------------------
def _flip_first_byte(value: Any) -> Any:
    """A copy of one payload value with the bits of its first byte flipped."""
    if isinstance(value, torch.Tensor):  # a bfloat16 payload entry
        out = value.clone()
        out.reshape(-1)[:1].view(torch.int16).bitwise_xor_(0xFF)
        return out
    arr = np.array(np.asarray(value), copy=True)
    raw = np.atleast_1d(arr).view(np.uint8)  # a view: mutates arr in place
    raw.reshape(-1)[0] ^= 0xFF
    return arr


def corrupt_envelope(envelope: Dict[str, Any], mode: str = "payload") -> Dict[str, Any]:
    """A corrupted copy of a state envelope (the original is left intact).
    The modes mirror real checkpoint damage:

    * ``"payload"``  — flip bits in one payload array, checksum untouched
      (bit rot in storage; caught by the checksum).
    * ``"checksum"`` — clobber the stored checksum (a partial write of the
      header).
    * ``"schema"``   — bump ``schema_version`` past what this build knows
      (a checkpoint from a future library version).
    * ``"truncate"`` — drop one payload entry and its spec, recomputing the
      checksum (a consistent but incomplete envelope; caught by strict key
      matching, not by the checksum).
    """
    from metrics_tpu_torch.reliability.checkpoint import _checksum  # lazy: cycle-free

    env = deepcopy({k: v for k, v in envelope.items() if k != "payload"})
    env["payload"] = dict(envelope["payload"])
    if mode == "payload":
        key = sorted(env["payload"])[0]
        val = env["payload"][key]
        first = val[0] if isinstance(val, list) else val
        flipped = _flip_first_byte(first)
        env["payload"][key] = [flipped, *val[1:]] if isinstance(val, list) else flipped
    elif mode == "checksum":
        env["checksum"] = "crc32:00000000"
    elif mode == "schema":
        env["schema_version"] = envelope["schema_version"] + 999
    elif mode == "truncate":
        key = sorted(env["payload"])[-1]
        del env["payload"][key]
        env["spec"] = {k: v for k, v in env["spec"].items() if k != key}
        env["checksum"] = _checksum(env["payload"])
    else:
        raise ValueError(f"mode must be one of 'payload'|'checksum'|'schema'|'truncate', got {mode!r}")
    return env


# ----------------------------------------------------------------------
# durable-session faults (preemption, torn files, cursor skew, partitions)
# ----------------------------------------------------------------------
class _PartitionedBackend(SyncBackend):
    """A transport with the cable cut: every collective raises
    :class:`TransportPartitioned` until :meth:`heal`, after which calls pass
    through to the wrapped backend unchanged."""

    def __init__(self, inner: Optional[SyncBackend]):
        self.inner = inner
        self.healed = False
        self.calls = 0

    @property
    def world_size(self) -> int:
        return self.inner.world_size if self.inner is not None else 1

    def rank(self, group: Optional[Any] = None) -> int:
        return self.inner.rank(group) if self.inner is not None else 0

    def heal(self) -> None:
        self.healed = True

    def _check(self, what: str) -> None:
        if not self.healed:
            self.calls += 1
            raise TransportPartitioned(f"injected network partition: {what} unreachable")

    def gather(self, x: Any, group: Optional[Any] = None) -> List[Any]:
        self._check("gather")
        return self.inner.gather(x, group=group)

    def heartbeat(self):
        self._check("heartbeat")
        return self.inner.heartbeat()


@contextmanager
def partition_transport(owner: Any, attr: str = "backend") -> Iterator[Dict[str, Any]]:
    """Cut the network under ``owner.<attr>`` (an object's
    :class:`SyncBackend`): every collective on it raises
    :class:`TransportPartitioned` until ``info["heal"]()`` runs, so a test can
    drive the blocked, healed and recovered sequence inside one block. Exit
    restores the original backend object. ``info`` reports ``calls``
    (transport attempts refused) and ``heal``."""
    inner = getattr(owner, attr)
    wrapper = _PartitionedBackend(inner)
    setattr(owner, attr, wrapper)
    info: Dict[str, Any] = {"heal": wrapper.heal, "wrapper": wrapper, "calls": 0}
    try:
        yield info
    finally:
        info["calls"] = wrapper.calls
        setattr(owner, attr, inner)


def expire_lease(authority: Any, shard: str) -> None:
    """Force ``shard``'s lease past its TTL on ``authority``: the lease-loss
    drill. The next ``FleetRebalancer.check_failover()`` treats the shard as
    dead and promotes its followers, and any write the old owner attempts
    before re-acquiring is refused typed (``LeaseExpiredError``, one
    ``fleet_fenced_write`` dump)."""
    authority.expire(str(shard))


@contextmanager
def kill_at_migration_phase(
    coordinator: Any, phase: str, after: int = 0, mode: str = "kill"
) -> Iterator[Dict[str, Any]]:
    """Simulate a process death at the START of one tenant-migration yield
    point (``"prepare"``, ``"in_flight"``, ``"pre_commit"``, ``"pre_gc"``,
    or the per-txn ``"recover"`` entry; see the state-machine table in
    :mod:`metrics_tpu_torch.fleet.migration`): the coordinator raises
    :class:`Preempted` the moment a handoff enters ``phase``, after skipping
    the first ``after`` entries (so a kill can land mid-rebalance, N
    successful moves in). Everything durably written before that instant
    (the staged envelope, the ``prepared`` record, the target's committed
    generation) is exactly what a real kill leaves; drive recovery by
    rebuilding the shards from their journals (``FleetShard.restore``) and
    calling ``MigrationCoordinator.recover()``, which must land every tenant
    on exactly one side. ``info`` reports ``seen`` (phase entries observed)
    and ``kills``.

    ``mode="partition"`` injects a network partition instead of a death:
    entering ``phase`` raises :class:`TransportPartitioned`, and the
    coordinator's sync backend (when it has one) keeps refusing every
    collective until ``info["heal"]()`` runs or the context exits. The
    coordinator object survives with its in-memory state intact: the
    recovery to prove is ``recover()`` on the live objects after the heal,
    not a rebuild from disk. Exit restores the class's no-op seam and the
    original backend."""
    from metrics_tpu_torch.fleet.migration import MigrationCoordinator

    if phase not in MigrationCoordinator.YIELD_POINTS:
        raise ValueError(f"phase must be one of {MigrationCoordinator.YIELD_POINTS}, got {phase!r}")
    if mode not in ("kill", "partition"):
        raise ValueError(f"mode must be 'kill' or 'partition', got {mode!r}")
    inner_backend = coordinator.backend
    info: Dict[str, Any] = {"seen": 0, "kills": 0}

    def heal() -> None:
        if isinstance(coordinator.backend, _PartitionedBackend):
            coordinator.backend.heal()
        coordinator.backend = inner_backend

    info["heal"] = heal

    def dying(ph: str, txn: str) -> None:
        if ph == phase and coordinator.backend is inner_backend:
            info["seen"] += 1
            if info["seen"] > int(after):
                info["kills"] += 1
                if mode == "partition":
                    if inner_backend is not None:
                        coordinator.backend = _PartitionedBackend(inner_backend)
                    raise TransportPartitioned(f"injected partition at migration phase {ph!r} (txn {txn})")
                raise Preempted(f"injected kill at migration phase {ph!r} (txn {txn})")

    coordinator._phase = dying
    try:
        yield info
    finally:
        del coordinator._phase  # uncover the class-level no-op hook
        coordinator.backend = inner_backend


@contextmanager
def preempt_at_step(session: Any, step: int, during: str = "step") -> Iterator[Dict[str, int]]:
    """Simulate a preemption: while active, the session "dies" (raises
    :class:`Preempted`) the moment it is fed ``step_index >= step``, before
    that batch touches any state. Everything the session checkpointed before
    that instant is exactly what a real preemption leaves; drive recovery by
    building a fresh metric and session over the same journal directory and
    calling ``resume()``.

    ``during="background_write"`` (a session with
    ``background_checkpoints=True``) also kills the background writer
    mid-write: every commit attempted while active tears as a kill inside
    ``atomic_file`` would, leaving a truncated ``.tmp`` carcass at the next
    generation's path, nothing renamed into place and the manifest
    untouched (``info["torn_writes"]`` counts them)."""
    if during not in ("step", "background_write"):
        raise ValueError(f"during must be 'step' or 'background_write', got {during!r}")
    orig = session.step
    info = {"preempted_at": -1, "torn_writes": 0}

    def dying(step_index, *args: Any, **kwargs: Any):
        if int(step_index) >= step:
            info["preempted_at"] = int(step_index)
            raise Preempted(f"injected preemption at step {step_index}")
        return orig(step_index, *args, **kwargs)

    bg = getattr(session, "_bg", None)
    if during == "background_write" and bg is None:
        raise RuntimeError(
            "preempt_at_step(during='background_write') needs a session"
            " constructed with background_checkpoints=True"
        )
    session.step = dying
    if during == "background_write":

        def torn_commit(job):
            # the carcass a kill mid-write leaves: partial bytes at
            # <generation>.npz.tmp, target path and manifest untouched
            records = bg._journal.records()
            nxt = (int(records[-1]["generation"]) + 1) if records else 1
            # metrics-tpu: allow(MTL107) — the torn write is the POINT:
            # this injector manufactures the exact carcass a non-atomic
            # writer leaves, so recovery tests can prove it is ignored
            with open(bg._journal._gen_path(nxt) + ".tmp", "wb") as f:
                f.write(b"PK\x03\x04torn-mid-write")
            info["torn_writes"] += 1
            raise Preempted(f"injected preemption mid background write (cursor {job['cursor']})")

        bg._commit_job = torn_commit
    try:
        yield info
    finally:
        del session.step  # uncover the bound method
        if during == "background_write":
            del bg._commit_job


@contextmanager
def slow_consumer(target: Any, delay_s: float = 0.05, calls: int = 1_000_000) -> Iterator[Dict[str, int]]:
    """Make a serving consumer slow: the first ``calls`` dispatches sleep
    ``delay_s`` before running (a wedged card or an oversubscribed host),
    filling the admission queue and driving the backpressure policies.

    ``target`` is an :class:`~metrics_tpu_torch.serving.AsyncServingEngine`
    (its dispatch is wrapped) or an
    :class:`~metrics_tpu_torch.serving.IngestQueue` (its downstream target is
    wrapped, a cohort or a pipeline)."""
    info = {"delayed": 0}

    def slowed(call):
        def slow(*args: Any, **kwargs: Any):
            if info["delayed"] < calls:
                info["delayed"] += 1
                time.sleep(delay_s)
            return call(*args, **kwargs)

        return slow

    if hasattr(target, "_dispatch") and hasattr(target, "drain"):
        target._dispatch = slowed(target._dispatch)
        try:
            yield info
        finally:
            del target._dispatch
        return
    if hasattr(target, "_target") and hasattr(target, "submit"):
        orig_target = target._target
        target._target = slowed(orig_target)
        try:
            yield info
        finally:
            target._target = orig_target
        return
    raise TypeError(f"slow_consumer wraps an AsyncServingEngine or an IngestQueue; got {type(target).__name__}")


def torn_write(path: Any, keep_fraction: float = 0.5) -> int:
    """Truncate a checkpoint file in place to ``keep_fraction`` of its bytes:
    the carcass of a process killed mid-write (possible only for files
    written without the atomic tmp-and-rename path, which is why the journal
    uses it; injected against a finished generation it drills the
    resume-time fallback). Returns the new size."""
    if not 0.0 <= keep_fraction < 1.0:
        raise ValueError(f"keep_fraction must be in [0, 1), got {keep_fraction}")
    size = os.path.getsize(path)
    new_size = int(size * keep_fraction)
    os.truncate(path, new_size)
    return new_size


@contextmanager
def donation_unsafe_engine(form: str = "free") -> Iterator[None]:
    """While active, :class:`~metrics_tpu_torch.engine.CompiledStepEngine`
    bypasses one of its defensive copies after each successful step, so a
    buffer the dispatch consumed stays reachable from the metrics. The JAX
    package's injector deletes the live states that alias a registered
    default, as XLA donation would; the port donates nothing (every state is
    copied into the graph's buffers and cloned out) and its ``reset()``
    clones the defaults, so the hazard takes the two forms the
    use-after-donate canary of :mod:`metrics_tpu_torch.analysis.sanitizer`
    looks for (MTA007):

    * ``form="free"`` (any device): every step reads the registered
      defaults in place (``reset()`` inside the step; on the card the graph
      reads them on every replay). After the step the injector frees their
      storage, as a dispatch that consumed them without the clone would:
      the step itself succeeds and the dead buffers stay reachable through
      ``_defaults``.
    * ``form="graph"`` (the card): the step's states and values are handed
      out as the captured graph's own buffers, without the clone, so the
      metric's live states are buffers the next replay overwrites. On the
      CPU there is no graph and this form changes nothing.

    A metric stepped under either form is spoiled; build a new one."""
    from metrics_tpu_torch.engine import CompiledStepEngine  # lazy: cycle-free

    if form not in ("free", "graph"):
        raise ValueError(f"form must be 'free' or 'graph', got {form!r}")
    orig = CompiledStepEngine._run

    def unsafe(self, program, make_step, states, *rest, **kwargs):
        out = orig(self, program, make_step, states, *rest, **kwargs)
        if form == "graph":
            return out if program is None else (program.merged,) + program.outputs
        for name in states:
            m = self._metrics.get(name)
            for default in (m._defaults.values() if m is not None else ()):
                if isinstance(default, torch.Tensor) and default.numel():
                    default.untyped_storage().resize_(0)  # what donation would have done
        return out

    CompiledStepEngine._run = unsafe
    try:
        yield
    finally:
        CompiledStepEngine._run = orig


@contextmanager
def cursor_skew(session: Any, delta: int) -> Iterator[None]:
    """While active, every checkpoint the session commits records a step
    cursor offset by ``delta`` (state untouched): the accounting drift of a
    rank that counted batches its peers did not. Drives the multi-process
    resume agreement: skewed ranks must roll back to a common generation or
    raise ``SessionResumeError``."""
    orig = session.checkpoint

    def skewed(*args: Any, **kwargs: Any):
        real_cursor = session.cursor
        session.cursor = real_cursor + delta
        session.metric._session_cursor = session.cursor
        try:
            return orig(*args, **kwargs)
        finally:
            session.cursor = real_cursor
            session.metric._session_cursor = real_cursor

    session.checkpoint = skewed
    try:
        yield
    finally:
        del session.checkpoint
