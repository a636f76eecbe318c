"""Threaded virtual worlds for the port's sync tests.

The JAX package's test bed simulates DDP ranks with threads that run in
lockstep (``tests/helpers/testers.py``: ``VirtualDDPGroup``,
``VirtualTwoLevelGroup``, ``run_virtual_ddp``, ``run_virtual_hierarchy``),
and that module imports JAX. This is its torch-only twin: each thread is one
rank with its own metric replica, and the gathers rendezvous at barriers
inside one process, so a world of 4 or 8 costs milliseconds. Every backend
here answers ``rank()`` in the port's method form, resolved per thread.
Real process worlds (gloo, NCCL) are ``tests/torch_workers.py::run_world``.
"""
import threading
from typing import Any, Callable, List, Optional

import torch

from metrics_tpu_torch.parallel.backend import SyncBackend, set_sync_backend
from metrics_tpu_torch.parallel.hierarchy import HierarchicalSyncBackend, SyncTopology

_RANK = threading.local()


def current_rank() -> int:
    """The simulated rank of the calling thread (0 outside a world)."""
    return getattr(_RANK, "rank", 0)


class VirtualDDPGroup(SyncBackend):
    """Barrier-synchronized all-gather across simulated ranks (threads):
    each rank's k-th ``gather`` writes slot k and waits until every rank has
    written it, then every rank receives the rank-ordered list."""

    def __init__(self, world_size: int):
        self._world = world_size
        self._barrier = threading.Barrier(world_size)
        self._slots = {}
        self._counters = {}
        self._lock = threading.Lock()

    @property
    def world_size(self) -> int:
        return self._world

    def rank(self, group: Optional[Any] = None) -> int:
        return current_rank()

    def gather(self, x: torch.Tensor, group: Optional[Any] = None) -> List[torch.Tensor]:
        rank = _RANK.rank
        with self._lock:
            call_id = self._counters.get(rank, 0)
            self._counters[rank] = call_id + 1
            slot = self._slots.setdefault(call_id, [None] * self._world)
        slot[rank] = x
        self._barrier.wait()
        return list(slot)

    def abort(self) -> None:
        self._barrier.abort()


class _SliceBarrierTransport(SyncBackend):
    """Level-0 transport of :class:`VirtualTwoLevelGroup`: a barrier-gather
    among the rank threads of ONE slice (each slice has its own barrier)."""

    def __init__(self, topology: SyncTopology):
        self.topology = topology
        self._barriers = [threading.Barrier(topology.slice_size) for _ in topology.slices]
        self._slots = {}
        self._counters = {}
        self._lock = threading.Lock()
        self.calls = 0

    @property
    def world_size(self) -> int:
        return self.topology.slice_size

    def rank(self, group: Optional[Any] = None) -> int:
        return self.topology.local_index(current_rank())

    def gather(self, x: torch.Tensor, group: Optional[Any] = None) -> List[torch.Tensor]:
        rank = _RANK.rank
        sid = self.topology.slice_of(rank)
        j = self.topology.local_index(rank)
        with self._lock:
            self.calls += 1
            call_id = self._counters.get(rank, 0)
            self._counters[rank] = call_id + 1
            slot = self._slots.setdefault((sid, call_id), [None] * self.topology.slice_size)
        slot[j] = x
        self._barriers[sid].wait()
        return list(slot)


class _LeaderBarrierTransport(SyncBackend):
    """Level-1 transport of :class:`VirtualTwoLevelGroup`: each slice's
    leader thread publishes the slice's contribution; every rank receives the
    slice-ordered list after one world rendezvous. ``widths`` records the
    length of every list handed out."""

    def __init__(self, topology: SyncTopology):
        self.topology = topology
        self._barrier = threading.Barrier(topology.world_size)
        self._slots = {}
        self._counters = {}
        self._lock = threading.Lock()
        self.widths: List[int] = []

    @property
    def world_size(self) -> int:
        return self.topology.num_slices

    def rank(self, group: Optional[Any] = None) -> int:
        return self.topology.slice_of(current_rank())

    def gather(self, x: torch.Tensor, group: Optional[Any] = None) -> List[torch.Tensor]:
        rank = _RANK.rank
        sid = self.topology.slice_of(rank)
        with self._lock:
            call_id = self._counters.get(rank, 0)
            self._counters[rank] = call_id + 1
            slot = self._slots.setdefault(call_id, [None] * self.topology.num_slices)
        if self.topology.is_leader(rank):
            slot[sid] = x
        self._barrier.wait()
        with self._lock:
            self.widths.append(len(slot))
        return list(slot)


class VirtualTwoLevelGroup(HierarchicalSyncBackend):
    """:class:`VirtualDDPGroup`'s two-level sibling: level-0 gathers
    rendezvous per slice, level-1 exchanges rendezvous the slice leaders."""

    def __init__(self, topology: SyncTopology, level_precisions=("exact", None)):
        super().__init__(
            topology,
            _SliceBarrierTransport(topology),
            _LeaderBarrierTransport(topology),
            rank=current_rank,
            level_precisions=level_precisions,
        )

    def abort(self) -> None:
        for b in self.level0._barriers:
            b.abort()
        self.level1._barrier.abort()


def _run_threads(world: int, group: Any, target: Callable[[int], None]) -> None:
    errors: List[Optional[BaseException]] = [None] * world

    def worker(rank: int) -> None:
        _RANK.rank = rank
        try:
            target(rank)
        except BaseException as err:  # noqa: BLE001 - re-raised below
            errors[rank] = err
            group.abort()

    prev = set_sync_backend(group)
    try:
        threads = [threading.Thread(target=worker, args=(r,)) for r in range(world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        set_sync_backend(prev)
    real = [e for e in errors if e is not None and not isinstance(e, threading.BrokenBarrierError)]
    if real:
        raise real[0]
    broken = [e for e in errors if e is not None]
    if broken:
        raise broken[0]


def run_virtual_ddp(world_size: int, fn: Callable, *args: Any, group: Optional[VirtualDDPGroup] = None, **kwargs: Any):
    """Run ``fn(rank, world_size, *args, **kwargs)`` on every simulated rank
    of a flat world with a :class:`VirtualDDPGroup` (or ``group``) installed
    as the sync backend; returns the group."""
    group = group or VirtualDDPGroup(world_size)
    _run_threads(world_size, group, lambda rank: fn(rank, world_size, *args, **kwargs))
    return group


def run_virtual_hierarchy(topology: SyncTopology, fn: Callable, *args: Any, level_precisions=("exact", None), **kwargs: Any):
    """Run ``fn(rank, topology, *args, **kwargs)`` on every simulated rank of
    a two-level world with a :class:`VirtualTwoLevelGroup` installed as the
    sync backend; returns the group."""
    group = VirtualTwoLevelGroup(topology, level_precisions=level_precisions)
    _run_threads(topology.world_size, group, lambda rank: fn(rank, topology, *args, **kwargs))
    return group
