"""Fault injection for the sync paths: make the failure paths testable on demand.

Port of the sync-facing part of ``metrics_tpu/reliability/faultinject.py``.
Recovery code that only runs during real outages is recovery code that has
never run. Each helper here injects one sync failure mode — a backend that
fails or hangs, one level of a hierarchical backend that fails or hangs, an
unreachable slice, a simulated multi-slice fleet in one process — as a
scoped context manager that restores the previous backend on exit. The
injectors for inputs, checkpoint envelopes, the engine and the fleet come
with the rest of ``reliability/``.

Nothing here is imported by the runtime hot paths.
"""
import time
from contextlib import contextmanager
from typing import Any, Iterator, List, Optional, Type

import torch

from metrics_tpu_torch.parallel.backend import SyncBackend, get_sync_backend, set_sync_backend

__all__ = [
    "FaultInjected",
    "flaky_sync_backend",
    "flaky_level",
    "hung_level",
    "pod_dropout",
    "simulated_pods",
]


class FaultInjected(RuntimeError):
    """Marker exception raised by injected faults (distinguishable from
    organic failures in assertions and logs)."""


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
