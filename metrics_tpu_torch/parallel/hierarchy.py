"""Hierarchical fault-domain sync: two-level topology-aware collectives.

Port of ``metrics_tpu/parallel/hierarchy.py``. A fleet of GPU nodes is not
one flat world: ranks inside a node talk over NVLink while nodes reach each
other over a slower, failure-prone network. The flat host sync path
(``Metric._sync_dist`` → one ``SyncBackend.gather`` per state) conflates the
two fault domains: one flaky remote node forces an all-or-nothing choice
between retrying the *whole world* and degrading to *local-only* state.
This module makes the reduction, the wire precision and the failure policy
all **per level**:

* :class:`SyncTopology` partitions the world's ranks into equal-size
  slices (level 0 = intra-slice, level 1 = inter-slice).
* :class:`HierarchicalSyncBackend` composes two pluggable
  :class:`~metrics_tpu_torch.parallel.backend.SyncBackend` transports — one
  scoped to the caller's slice, one connecting the slice leaders — and
  still honours the flat ``gather`` contract (rank-ordered world list) so
  hierarchy-unaware callers keep working unchanged.
  :meth:`HierarchicalSyncBackend.over_flat` builds both from one flat
  transport (over gloo or NCCL: ``over_flat(topology,
  TorchDistributedBackend())``).
* :func:`sync_states` is the two-level reduction engine shared by
  ``Metric._sync_dist`` and ``MetricCohort._sync_stacked``: level-0
  reduction inside the slice, then a **sparse** level-1 exchange of one
  pre-reduced contribution per slice, with ``SyncPolicy`` (retry /
  timeout / backoff, via ``SyncPolicy.for_level``) and ``sync_precision``
  resolved per level, residuals committed only after the level that
  consumed them succeeds.

Degradation is **per level and atomic** across the whole state dict:

* level-1 terminal failure with ``degraded_ok`` drops the unreachable
  slice(s) and serves the LEVEL-0 RESULT — the local slice's exact merge
  IS the fallback; no state ever mixes world- and slice-scope
  contributions, and quantization residuals are not committed (the lossy
  level they compensate never completed).
* level-0 terminal failure with ``degraded_ok`` degrades the whole sync
  to local-only state, exactly like the flat path.

Every hierarchical sync records a :class:`QuorumSnapshot` (surviving
membership) readable via :func:`last_quorum`. Nothing here runs until a
:class:`HierarchicalSyncBackend` is installed via ``set_sync_backend``.
"""
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from metrics_tpu_torch.observability import flight as _flight
from metrics_tpu_torch.observability import telemetry as _obs
from metrics_tpu_torch.observability import trace as _trace
from metrics_tpu_torch.parallel import quantize as _q
from metrics_tpu_torch.parallel.backend import SyncBackend
from metrics_tpu_torch.utilities.data import dim_zero_max, dim_zero_min, dim_zero_sum
from metrics_tpu_torch.utilities.prints import warn_once

__all__ = [
    "HierarchicalSyncBackend",
    "HierarchicalSyncOutcome",
    "PodUnreachableError",
    "QuorumSnapshot",
    "SyncTopology",
    "last_quorum",
    "record_quorum",
    "reset_quorum",
    "sync_states",
    "two_level_fold",
]


class PodUnreachableError(RuntimeError):
    """A level-1 exchange could not reach one specific pod (slice).

    Raised by transports (and the ``pod_dropout`` fault injector) that can
    attribute a level-1 failure to a named slice; the degradation path
    records the lost slice in the quorum snapshot instead of blaming every
    remote pod.
    """

    def __init__(self, slice_id: int, message: Optional[str] = None):
        super().__init__(message or f"pod (slice) {slice_id} unreachable at sync level 1")
        self.slice_id = int(slice_id)


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------
class SyncTopology:
    """A partition of world ranks ``0..W-1`` into equal-size fault domains.

    ``slices[sid]`` lists the member ranks of slice ``sid`` in slice-local
    order; the first member is the slice's **leader** (the rank that
    speaks for the slice in the level-1 exchange). Slices must be
    disjoint, equal-sized, and cover ``0..W-1`` exactly — equal sizes keep
    the composed flat ``gather`` well-defined (member ``j`` of every slice
    pairs up in one level-1 round).
    """

    def __init__(self, slices: Sequence[Sequence[int]]):
        self.slices: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(int(r) for r in s) for s in slices
        )
        if not self.slices or any(not s for s in self.slices):
            raise ValueError("SyncTopology needs at least one non-empty slice")
        sizes = {len(s) for s in self.slices}
        if len(sizes) != 1:
            raise ValueError(
                f"slices must be equal-sized, got sizes {sorted(len(s) for s in self.slices)}"
                " — unequal fault domains would leave level-1 exchange rounds unpaired"
            )
        flat = [r for s in self.slices for r in s]
        if sorted(flat) != list(range(len(flat))):
            raise ValueError(
                f"slices must partition ranks 0..{len(flat) - 1} exactly once, got {flat}"
            )
        self._slice_of = {r: sid for sid, s in enumerate(self.slices) for r in s}
        self._local_index = {r: j for s in self.slices for j, r in enumerate(s)}

    @classmethod
    def regular(cls, num_slices: int, slice_size: int) -> "SyncTopology":
        """Contiguous rank blocks: slice ``s`` owns ranks
        ``[s*slice_size, (s+1)*slice_size)`` — the layout of a multi-node
        job whose ranks are numbered host-major."""
        if num_slices < 1 or slice_size < 1:
            raise ValueError("num_slices and slice_size must be >= 1")
        return cls(
            [
                list(range(s * slice_size, (s + 1) * slice_size))
                for s in range(num_slices)
            ]
        )

    @property
    def world_size(self) -> int:
        return len(self.slices) * len(self.slices[0])

    @property
    def num_slices(self) -> int:
        return len(self.slices)

    @property
    def slice_size(self) -> int:
        return len(self.slices[0])

    def slice_of(self, rank: int) -> int:
        return self._slice_of[int(rank)]

    def local_index(self, rank: int) -> int:
        """Position of ``rank`` within its slice (0 = leader)."""
        return self._local_index[int(rank)]

    def leader(self, slice_id: int) -> int:
        return self.slices[int(slice_id)][0]

    def leaders(self) -> Tuple[int, ...]:
        return tuple(s[0] for s in self.slices)

    def is_leader(self, rank: int) -> bool:
        return self.local_index(rank) == 0

    def __repr__(self) -> str:
        return (
            f"SyncTopology(num_slices={self.num_slices},"
            f" slice_size={self.slice_size}, slices={self.slices})"
        )


# ---------------------------------------------------------------------------
# quorum
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class QuorumSnapshot:
    """Surviving membership of the most recent hierarchical exchange.

    ``slices_present`` are the slice ids whose contributions are inside
    the state actually being served; ``degraded_level`` is ``None`` on a
    fully-healthy exchange, else the level that failed terminally.
    ``lost_slices`` names specific pods known unreachable (when the
    failure could be attributed, e.g. ``PodUnreachableError``)."""

    world_size: int
    num_slices: int
    slices_present: Tuple[int, ...]
    ranks_present: Tuple[int, ...]
    degraded_level: Optional[int] = None
    lost_slices: Tuple[int, ...] = ()
    source: str = "sync"
    wall_time: float = field(default_factory=time.time)

    @property
    def full(self) -> bool:
        return self.degraded_level is None and len(self.slices_present) == self.num_slices

    @property
    def dropped_pods(self) -> int:
        """Slices whose contribution is NOT in the served state."""
        return self.num_slices - len(self.slices_present)

    @property
    def lost_ranks(self) -> Tuple[int, ...]:
        """Ranks absent from the served state — the complement of
        ``ranks_present`` over ``range(world_size)``. The fleet's
        evacuation trigger maps these to shards hosted on the dead
        processes."""
        return tuple(sorted(set(range(self.world_size)) - set(self.ranks_present)))

    def as_dict(self) -> Dict[str, Any]:
        return {
            "world_size": self.world_size,
            "num_slices": self.num_slices,
            "slices_present": list(self.slices_present),
            "ranks_present": list(self.ranks_present),
            "quorum_size": len(self.slices_present),
            "dropped_pods": self.dropped_pods,
            "degraded_level": self.degraded_level,
            "lost_slices": list(self.lost_slices),
            "source": self.source,
            "full": self.full,
        }


_QUORUM_LOCK = threading.Lock()
_LAST_QUORUM: Optional[QuorumSnapshot] = None


def record_quorum(q: QuorumSnapshot) -> None:
    """Publish the membership snapshot of the exchange that just ran (the
    exporter reads it for ``metrics_tpu_sync_degraded_pods``/``/healthz``)."""
    global _LAST_QUORUM
    with _QUORUM_LOCK:
        _LAST_QUORUM = q


def last_quorum() -> Optional[QuorumSnapshot]:
    """The most recent quorum snapshot, or None if no hierarchical
    exchange has run in this process."""
    with _QUORUM_LOCK:
        return _LAST_QUORUM


def reset_quorum() -> None:
    global _LAST_QUORUM
    with _QUORUM_LOCK:
        _LAST_QUORUM = None


# ---------------------------------------------------------------------------
# the backend
# ---------------------------------------------------------------------------
class _SliceView(SyncBackend):
    """Level-0 adapter over a FLAT backend: gather the whole world, keep
    only the caller's slice (slice-local order). Correct over any flat
    transport; real deployments plug in a genuinely slice-scoped backend
    instead (a ``torch.distributed.new_group`` per slice, riding NVLink
    inside a node)."""

    def __init__(self, inner: SyncBackend, topology: SyncTopology, rank_fn: Callable[[], int]):
        self.inner = inner
        self.topology = topology
        self._rank_fn = rank_fn

    @property
    def world_size(self) -> int:
        return self.topology.slice_size

    def rank(self, group: Optional[Any] = None) -> int:
        return self.topology.local_index(self._rank_fn())

    def gather(self, x: torch.Tensor, group: Optional[Any] = None) -> List[torch.Tensor]:
        full = self.inner.gather(x, group=group)
        members = self.topology.slices[self.topology.slice_of(self._rank_fn())]
        return [full[r] for r in members]


class _LeaderView(SyncBackend):
    """Level-1 adapter over a FLAT backend: gather the whole world, keep
    one entry per slice (its leader's), slice-id order."""

    def __init__(self, inner: SyncBackend, topology: SyncTopology, rank_fn: Callable[[], int]):
        self.inner = inner
        self.topology = topology
        self._rank_fn = rank_fn

    @property
    def world_size(self) -> int:
        return self.topology.num_slices

    def rank(self, group: Optional[Any] = None) -> int:
        return self.topology.slice_of(self._rank_fn())

    def gather(self, x: torch.Tensor, group: Optional[Any] = None) -> List[torch.Tensor]:
        full = self.inner.gather(x, group=group)
        return [full[self.topology.leader(s)] for s in range(self.topology.num_slices)]


class HierarchicalSyncBackend(SyncBackend):
    """Two fault domains composed from two pluggable transports.

    Args:
        topology: the slice partition of the world's ranks.
        level0: a :class:`SyncBackend` scoped to the caller's slice —
            ``gather`` returns one entry per slice member, slice-local
            order (``world_size == topology.slice_size``).
        level1: a :class:`SyncBackend` connecting the slice leaders —
            ``gather`` returns one entry per slice, slice-id order
            (``world_size == topology.num_slices``). Non-leader ranks
            still call it (the transport broadcasts the leaders' exchange
            intra-slice; virtual transports simply rendezvous).
        rank: this process's world rank — an int, a callable (virtual
            backends resolve it per thread), or None for the
            ``torch.distributed`` rank (0 without a process group).
        level_precisions: per-level wire-tier override ``(level0,
            level1)``; each entry is a tier name or None = the state's
            registered ``sync_precision``. The default ``("exact", None)``
            keeps the fast intra-slice hop exact and pays quantization
            only on the slow inter-pod link — only ``"sum"``-reduced
            states ever quantize, and only level-1 quantization consumes
            the error-feedback residual (level-0 overrides quantize
            feedback-free).
    """

    def __init__(
        self,
        topology: SyncTopology,
        level0: SyncBackend,
        level1: SyncBackend,
        rank: Union[int, Callable[[], int], None] = None,
        level_precisions: Tuple[Optional[str], Optional[str]] = ("exact", None),
    ):
        if len(level_precisions) != 2:
            raise ValueError("level_precisions must have exactly two entries (level0, level1)")
        for p in level_precisions:
            if p is not None and p not in _q.PRECISIONS:
                raise ValueError(
                    f"level precision must be None or one of {_q.PRECISIONS}, got {p!r}"
                )
        self.topology = topology
        self.level0 = level0
        self.level1 = level1
        self._rank = rank
        self.level_precisions = tuple(level_precisions)

    @classmethod
    def over_flat(
        cls,
        topology: SyncTopology,
        inner: SyncBackend,
        level_precisions: Tuple[Optional[str], Optional[str]] = ("exact", None),
    ) -> "HierarchicalSyncBackend":
        """Build the hierarchy over one FLAT transport (e.g.
        ``TorchDistributedBackend``): per-level gathers select the slice /
        leader entries out of a world gather. Semantically identical to
        sparse per-level transports, without their wire savings — the
        compatibility construction for worlds that only have one
        collective."""
        if inner.world_size != topology.world_size:
            raise ValueError(
                f"topology world ({topology.world_size}) != backend world"
                f" ({inner.world_size})"
            )
        rank_fn = lambda: inner.rank()  # noqa: E731 — resolved per call (virtual ranks)
        return cls(
            topology,
            _SliceView(inner, topology, rank_fn),
            _LeaderView(inner, topology, rank_fn),
            rank=rank_fn,
            level_precisions=level_precisions,
        )

    # -- identity ------------------------------------------------------
    @property
    def world_size(self) -> int:
        return self.topology.world_size

    def rank(self, group: Optional[Any] = None) -> int:
        if callable(self._rank):
            return int(self._rank())
        if self._rank is not None:
            return int(self._rank)
        return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0

    @property
    def slice_id(self) -> int:
        return self.topology.slice_of(self.rank())

    # -- per-level collectives -----------------------------------------
    def gather_level0(self, x: torch.Tensor, group: Optional[Any] = None) -> List[torch.Tensor]:
        """Gather among my slice's members (slice-local order)."""
        return self.level0.gather(x, group=group)

    def gather_level1(self, x: torch.Tensor, group: Optional[Any] = None) -> List[torch.Tensor]:
        """Exchange one contribution per slice (slice-id order)."""
        return self.level1.gather(x, group=group)

    def gather(self, x: torch.Tensor, group: Optional[Any] = None) -> List[torch.Tensor]:
        """The flat contract (rank-ordered world list), composed from the
        two levels — hierarchy-unaware callers (legacy ``dist_sync_fn``
        users, session cursor gathers on old paths) stay correct when a
        hierarchical backend is installed."""
        return _compose_world(
            self, self.gather_level0(x, group=group), self.gather_level1, group
        )

    def heartbeat(self) -> Tuple[int, ...]:
        """Rank liveness from the last quorum this process observed: a
        hierarchical exchange that degraded (dropped pods, lost ranks)
        leaves its :class:`QuorumSnapshot` behind, and THAT membership —
        not the static topology — is what a lease authority should renew
        against. Before any exchange has run there is no evidence of
        trouble, so the full world reports present (the base-class
        default)."""
        q = last_quorum()
        if q is not None:
            return tuple(q.ranks_present)
        return tuple(range(self.world_size))


# ---------------------------------------------------------------------------
# the two-level reduction engine
# ---------------------------------------------------------------------------
def two_level_fold(reduction: Optional[Callable]) -> Optional[str]:
    """Classify a registered ``dist_reduce_fx`` as a two-level-safe fold.

    Only reductions that SHRINK at level 1 (one slice partial instead of
    ``slice_size`` contributions) decompose: ``sum``, ``max``, ``min``.
    ``cat``/list states, ``mean``, custom callables and ``None`` take the
    composed flat path instead (rank-ordered, bit-identical to a flat
    backend — there is no bandwidth win to buy with a semantic risk)."""
    if reduction is dim_zero_sum:
        return "sum"
    if reduction is dim_zero_max:
        return "max"
    if reduction is dim_zero_min:
        return "min"
    return None


@dataclass
class HierarchicalSyncOutcome:
    """What a two-level sync produced: the merged states, the residuals
    to commit (empty unless the level that consumed them succeeded), the
    membership snapshot, and which level (if any) degraded."""

    states: Dict[Any, Any]
    residuals: Dict[Any, torch.Tensor]
    quorum: QuorumSnapshot
    degraded_level: Optional[int] = None


def _effective_precision(spec: Optional[str], registered: str, fold: Optional[str]) -> str:
    """Per-level tier resolution: an explicit level override wins, else
    the state's registered tier; never quantize a non-``sum`` fold."""
    if fold != "sum":
        return "exact"
    return registered if spec is None else spec


def _wire_nbytes(values: Any) -> int:
    return sum(_obs.array_nbytes(v) for v in pytree.tree_leaves(values))


def _lost_slice_from(err: BaseException) -> Optional[int]:
    """Walk the cause chain for a PodUnreachableError's slice id."""
    seen = 0
    while err is not None and seen < 8:
        if isinstance(err, PodUnreachableError):
            return err.slice_id
        err = err.__cause__ or err.__context__
        seen += 1
    return None


def _degrade_telemetry(level: int, err: BaseException, quorum: QuorumSnapshot) -> None:
    """One degradation: counter + event + warning. The terminal gather
    already wrote this fault's flight dump inside ``apply_sync_policy``;
    dumping again here would double-count one failure."""
    if _obs.enabled():
        tel = _obs.get()
        tel.count("reliability.sync_level_degraded")
        tel.event(
            "sync_level_degraded",
            level=level,
            error=f"{type(err).__name__}: {err}",
            quorum=list(quorum.slices_present),
            lost=list(quorum.lost_slices),
        )
    _flight.record(
        "sync_level_degraded",
        level=level,
        error=f"{type(err).__name__}: {err}",
        quorum=list(quorum.slices_present),
    )
    scope = "LOCAL-ONLY" if level == 0 else "the level-0 (slice-local) result"
    warn_once(
        f"hierarchical sync: level-{level} exchange failed terminally"
        f" ({type(err).__name__}: {err}); serving {scope} for the whole"
        " sync (degraded_ok=True). Telemetry counter:"
        " reliability.sync_level_degraded; membership: see last_quorum().",
        key=f"reliability-sync-level{level}-degraded",
    )


def _compose_world(
    backend: HierarchicalSyncBackend,
    l0_entries: List[Any],
    g1: Callable,
    group: Optional[Any],
) -> List[Any]:
    """Rank-ordered world list from one slice's level-0 entries plus one
    level-1 round per slice member — the staged version of
    ``HierarchicalSyncBackend.gather`` (staged so ALL level-0 rounds
    complete before ANY level-1 round: per-level atomicity)."""
    topo = backend.topology
    world: List[Any] = [None] * topo.world_size
    for j, member_val in enumerate(l0_entries):
        per_slice = g1(member_val, group=group)
        for sid, v in enumerate(per_slice):
            world[topo.slices[sid][j]] = v
    return world


def sync_states(
    backend: HierarchicalSyncBackend,
    states: Dict[Any, Any],
    reductions: Dict[Any, Optional[Callable]],
    precisions: Optional[Dict[Any, str]] = None,
    residuals: Optional[Dict[Any, torch.Tensor]] = None,
    group: Optional[Any] = None,
) -> HierarchicalSyncOutcome:
    """Run one two-level sync of a whole state dict.

    Stage 1 gathers EVERY state inside the slice (level 0); stage 2 runs
    EVERY level-1 exchange; only then is anything committed — so a level-1
    failure can degrade every state to its level-0 result atomically, and
    a level-0 failure can degrade every state to local-only. No state ever
    mixes scopes.

    Args:
        backend: the installed hierarchical backend.
        states: ``{key: array | list-of-arrays}`` — residual companions
            must already be excluded.
        reductions: the registered ``dist_reduce_fx`` per key.
        precisions: registered ``sync_precision`` tier per key (subset).
        residuals: current error-feedback residual per key (subset of
            ``precisions``); consumed by level-1 quantization and
            returned committed only when level 1 succeeds.
    """
    from metrics_tpu_torch.reliability import sync as _rsync  # lazy: no import cycle

    precisions = precisions or {}
    residuals = residuals or {}
    topo = backend.topology
    spec0, spec1 = backend.level_precisions
    policy = _rsync.active_policy()
    p0 = policy.for_level(0) if policy is not None else None
    p1 = policy.for_level(1) if policy is not None else None
    g0 = _rsync.apply_sync_policy(backend.gather_level0, policy=p0)
    g1 = _rsync.apply_sync_policy(backend.gather_level1, policy=p1)

    my_slice = backend.slice_id
    my_rank = backend.rank()
    telemetry_on = _obs.enabled()
    wire_bytes = [0, 0]  # per level, this rank's contribution

    if telemetry_on:
        def _tally(level: int, values: Any) -> None:
            wire_bytes[level] += _wire_nbytes(values)

        def _emit_total_wire() -> None:
            # the flat sync.wire_bytes contract holds on this path too:
            # the total of what actually shipped, summed over levels, so
            # the documented payload/wire compression gap stays readable
            # whichever backend is installed
            total = wire_bytes[0] + wire_bytes[1]
            tel = _obs.get()
            tel.count("sync.wire_bytes", total)
            tel.observe_hist("sync.wire_bytes", total, _obs.PAYLOAD_BUCKETS_BYTES)
    else:
        # byte accounting is telemetry work: zero-overhead-when-off means
        # not walking tree leaves for tallies nobody will read
        def _tally(level: int, values: Any) -> None:
            return None

        def _emit_total_wire() -> None:
            return None

    folds = {key: two_level_fold(reductions.get(key)) for key in states}
    folds = {
        key: (None if isinstance(states[key], list) else f) for key, f in folds.items()
    }

    def _local_outcome(err: BaseException) -> HierarchicalSyncOutcome:
        quorum = QuorumSnapshot(
            world_size=topo.world_size,
            num_slices=topo.num_slices,
            # local-only state: a slice's contribution is "present" only
            # when this rank IS the whole slice — with peers in the slice,
            # their contributions are NOT in the served state and the
            # quorum must not claim them
            slices_present=(my_slice,) if topo.slice_size == 1 else (),
            ranks_present=(my_rank,),
            degraded_level=0,
            source="sync",
        )
        _degrade_telemetry(0, err, quorum)
        if p0 is not None:
            p0.stats["degraded"] += 1
        record_quorum(quorum)
        # EXACTLY the flat degraded path: every state gathers as [x] and
        # runs the normal post-gather machinery — arrays stack to a
        # (1, ...) world axis before their reduction, list states keep
        # the flattened-list contract — so downstream compute() sees the
        # same shapes/types whichever backend degraded
        out: Dict[Any, Any] = {}
        for key, v in states.items():
            red = reductions.get(key)
            if isinstance(v, list):
                flat = list(v)
                out[key] = red(flat) if red is not None else flat
            else:
                stacked = torch.stack([v])
                out[key] = red(stacked) if red is not None else stacked
        return HierarchicalSyncOutcome(out, {}, quorum, degraded_level=0)

    # ------------------------------------------------------------------
    # stage 1 — level 0: every state crosses the intra-slice fabric
    # ------------------------------------------------------------------
    t0 = time.perf_counter()
    l0_data: Dict[Any, Any] = {}  # fold keys -> slice partial; others -> raw l0 lists
    try:
        with _trace.span("sync.level0", phase="sync", level=0):
            for key, x in states.items():
                fold = folds[key]
                red = reductions.get(key)
                if fold is None:
                    if isinstance(x, list):
                        l0_data[key] = [g0(e, group=group) for e in x]
                        _tally(0, x)
                    else:
                        l0_data[key] = g0(x, group=group)
                        _tally(0, x)
                    continue
                eff0 = _effective_precision(spec0, precisions.get(key, "exact"), fold)
                arr = x
                if eff0 != "exact":
                    # level-0 quantization is FEEDBACK-FREE: the residual
                    # companion belongs to the level-1 hop (the lossy link
                    # the tier exists for); compensating two hops with one
                    # residual would double-apply the correction
                    payload = _q.quantize_payload(arr, eff0)
                    _tally(0, payload)
                    gathered = {k: g0(v, group=group) for k, v in payload.items()}
                    n = len(gathered["q"])
                    l0_data[key] = _q.merge_dequantized(
                        [{k: v[r] for k, v in gathered.items()} for r in range(n)],
                        arr.shape,
                        arr.dtype,
                    )
                else:
                    _tally(0, arr)
                    l0_data[key] = red(torch.stack(list(g0(arr, group=group))))
    except _rsync.SyncFailedError as err:
        if p0 is not None and p0.degraded_ok:
            return _local_outcome(err)
        raise

    if telemetry_on:
        tel = _obs.get()
        tel.count("sync.level0.calls")
        tel.count("sync.level0.wire_bytes", wire_bytes[0])
        tel.observe_hist(
            "sync.level0.ms", (time.perf_counter() - t0) * 1e3, _obs.LATENCY_BUCKETS_MS
        )

    def _slice_scope_value(key: Any) -> Any:
        """The level-0 (slice-local) result for one state — the atomic
        fallback when level 1 fails."""
        fold = folds[key]
        red = reductions.get(key)
        if fold is not None:
            return l0_data[key]
        if isinstance(states[key], list):
            flat = [v for elem_list in l0_data[key] for v in elem_list]
            return red(flat) if red is not None else flat
        # reduction None on an array state leaves the STACKED gathered
        # array, exactly like the flat path (metric.py stacks then applies
        # no reduction) — a hierarchical backend must not change the type
        stacked = torch.stack(list(l0_data[key]))
        return red(stacked) if red is not None else stacked

    # ------------------------------------------------------------------
    # stage 2 — level 1: one contribution per slice crosses the inter-slice link
    # ------------------------------------------------------------------
    # quantize ONCE before any exchange attempt: retries re-send the
    # identical payload, so error feedback cannot double-apply; residuals
    # commit only after the level that consumed them succeeds
    l1_wire: Dict[Any, Any] = {}
    new_residuals: Dict[Any, torch.Tensor] = {}
    eff1_tiers: Dict[Any, str] = {}
    for key in states:
        fold = folds[key]
        if fold is None:
            continue
        eff1 = _effective_precision(spec1, precisions.get(key, "exact"), fold)
        eff1_tiers[key] = eff1
        partial = l0_data[key]
        if eff1 != "exact":
            payload, new_res = _q.compensate_and_quantize(
                partial, residuals.get(key), eff1
            )
            l1_wire[key] = payload
            if key in residuals:
                new_residuals[key] = new_res
        else:
            l1_wire[key] = partial

    t1 = time.perf_counter()
    merged: Dict[Any, Any] = {}
    try:
        with _trace.span("sync.level1", phase="sync", level=1):
            for key in states:
                fold = folds[key]
                red = reductions.get(key)
                if fold is None:
                    # non-fold states ship slice_size level-1 rounds (one
                    # value per round): the wire tally counts EVERY entry,
                    # or the advertised level-0/level-1 byte ratio inflates
                    if isinstance(states[key], list):
                        world_lists = [
                            _compose_world(backend, elem_l0, g1, group)
                            for elem_l0 in l0_data[key]
                        ]
                        for elem_l0 in l0_data[key]:
                            _tally(1, elem_l0)
                        flat = [v for wl in world_lists for v in wl]
                        merged[key] = red(flat) if red is not None else flat
                    else:
                        world = _compose_world(backend, l0_data[key], g1, group)
                        _tally(1, l0_data[key])
                        stacked = torch.stack(list(world))
                        merged[key] = (
                            red(stacked) if red is not None else stacked
                        )
                    continue
                wire = l1_wire[key]
                _tally(1, wire)
                if eff1_tiers[key] != "exact":
                    gathered = {k: g1(v, group=group) for k, v in wire.items()}
                    n = len(gathered["q"])
                    partial = l0_data[key]
                    merged[key] = _q.merge_dequantized(
                        [{k: v[s] for k, v in gathered.items()} for s in range(n)],
                        partial.shape,
                        partial.dtype,
                    )
                else:
                    merged[key] = red(torch.stack(list(g1(wire, group=group))))
    except _rsync.SyncFailedError as err:
        if p1 is None or not p1.degraded_ok:
            raise
        # per-level atomic degradation: EVERY state falls back to its
        # level-0 result (any level-1 rounds that did complete are
        # discarded — a half-merged mix of world- and slice-scope states
        # would be silently wrong, not degraded), and residuals are NOT
        # committed: the lossy exchange they compensate never finished
        lost = _lost_slice_from(err)
        quorum = QuorumSnapshot(
            world_size=topo.world_size,
            num_slices=topo.num_slices,
            slices_present=(my_slice,),
            ranks_present=tuple(topo.slices[my_slice]),
            degraded_level=1,
            lost_slices=(lost,) if lost is not None else tuple(
                s for s in range(topo.num_slices) if s != my_slice
            ),
            source="sync",
        )
        _degrade_telemetry(1, err, quorum)
        p1.stats["degraded"] += 1
        record_quorum(quorum)
        _emit_total_wire()  # level-0 bytes DID ship; level-1 counts what left before failing
        out = {key: _slice_scope_value(key) for key in states}
        return HierarchicalSyncOutcome(out, {}, quorum, degraded_level=1)

    if telemetry_on:
        tel = _obs.get()
        tel.count("sync.level1.calls")
        tel.count("sync.level1.wire_bytes", wire_bytes[1])
        tel.observe_hist(
            "sync.level1.ms", (time.perf_counter() - t1) * 1e3, _obs.LATENCY_BUCKETS_MS
        )
    _emit_total_wire()

    quorum = QuorumSnapshot(
        world_size=topo.world_size,
        num_slices=topo.num_slices,
        slices_present=tuple(range(topo.num_slices)),
        ranks_present=tuple(range(topo.world_size)),
        degraded_level=None,
        source="sync",
    )
    record_quorum(quorum)
    return HierarchicalSyncOutcome(merged, new_residuals, quorum, degraded_level=None)
