"""Consistent tenant→shard placement: rendezvous (HRW) hashing plus a
live-move override table.

Port of ``metrics_tpu/fleet/placement.py`` (host code; the weights are the
JAX package's, so both packages place every key on the same shard).

The fleet's routing problem is the classic elastic-membership one: N
shards (processes hosting one :class:`~metrics_tpu_torch.cohort.MetricCohort`
each) serve millions of tenant keys, shards join and leave, and a
membership change must move as few tenants as possible — a mod-N table
reshuffles nearly everything on every change. Rendezvous hashing gives
the minimal-churn property for free: every ``(shard, key)`` pair gets a
deterministic 64-bit weight and the key lives on the argmax shard, so
adding a shard moves only the keys whose new shard now wins (~1/N of
them) and removing one moves only its own keys.

Two lookups exist on purpose:

* :meth:`FleetPlacement.assign` — the pure hash answer, "where should
  this tenant live";
* :meth:`FleetPlacement.locate` — where it lives RIGHT NOW, consulting
  the override table the migration coordinator maintains while a move is
  in progress or a tenant is pinned off its hash-home. ``route_rows`` /
  :class:`~metrics_tpu_torch.serving.IngestQueue` feeders must use ``locate``
  so a tenant's stream follows it across a move instead of splitting.

``generation`` increments on every observable routing change (shard
membership or override) and is exported as the
``fleet.map_generation`` gauge — two processes comparing
generations can tell whether they are routing off the same map.
"""
import hashlib
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from metrics_tpu_torch.observability import telemetry as _obs

__all__ = ["FleetPlacement"]


def _weight(shard: str, key: int) -> int:
    """Deterministic 64-bit rendezvous weight for ``(shard, key)``.
    blake2b, not ``hash()``: Python's string hashing is salted per
    process and a placement map must agree across every process in the
    fleet."""
    h = hashlib.blake2b(f"{shard}\x00{int(key)}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


class FleetPlacement:
    """The fleet's tenant→shard map (pure data; no I/O, no shard refs)."""

    def __init__(self, shards: Iterable[str] = ()):
        self._shards: List[str] = []
        self._overrides: Dict[int, str] = {}
        self.generation = 0
        for name in shards:
            self.add_shard(name)

    # ------------------------------------------------------------------
    # membership
    # ------------------------------------------------------------------
    @property
    def shards(self) -> Tuple[str, ...]:
        return tuple(self._shards)

    def add_shard(self, name: str) -> None:
        name = str(name)
        if name in self._shards:
            raise ValueError(f"shard {name!r} is already in the placement")
        self._shards.append(name)
        self._bump()

    def remove_shard(self, name: str) -> None:
        name = str(name)
        if name not in self._shards:
            raise KeyError(f"shard {name!r} is not in the placement")
        self._shards.remove(name)
        # overrides pointing at a dead shard are stale routes, not pins:
        # the tenant reverts to its hash-home until the rebalancer moves
        # its state there
        for key, shard in list(self._overrides.items()):
            if shard == name:
                del self._overrides[key]
        self._bump()

    # ------------------------------------------------------------------
    # lookup
    # ------------------------------------------------------------------
    def assign(self, key: int) -> str:
        """The rendezvous answer: where ``key`` SHOULD live under the
        current shard membership."""
        if not self._shards:
            raise RuntimeError("placement has no shards")
        return max(self._shards, key=lambda s: _weight(s, key))

    def assign_ranked(self, key: int, n: Optional[int] = None) -> Tuple[str, ...]:
        """Every shard in descending rendezvous-weight order for ``key``
        (truncated to the first ``n``). Rank 1 is :meth:`assign`; rank 2
        is the key's natural **follower** — the shard replication streams
        its deltas to, and the shard that already holds a near-minimal
        share of promoted keys when rank 1 dies (HRW's minimal-churn
        property applies rank by rank)."""
        if not self._shards:
            raise RuntimeError("placement has no shards")
        order = sorted(self._shards, key=lambda s: _weight(s, key), reverse=True)
        return tuple(order if n is None else order[: int(n)])

    def follower(self, key: int, primary: Optional[str] = None) -> Optional[str]:
        """The rank-2 rendezvous choice for ``key`` — the first shard in
        the weight order that is not ``primary`` (default: the rank-1
        assignment). None when the placement has fewer than two shards
        (a fleet with no one to replicate to)."""
        primary = str(primary) if primary is not None else self.assign(key)
        for name in self.assign_ranked(key):
            if name != primary:
                return name
        return None

    def locate(self, key: int) -> str:
        """Where ``key`` lives right now: the migration override when a
        move pinned one, else :meth:`assign`. Streams route off THIS."""
        return self._overrides.get(int(key)) or self.assign(key)

    def record_location(self, key: int, shard: str) -> None:
        """Pin ``key``'s live location (the migration coordinator calls
        this when a handoff commits). A pin matching the hash-home is
        dropped rather than stored — the override table holds only the
        exceptions, so it stays small after a converged rebalance."""
        key = int(key)
        shard = str(shard)
        if shard == self.assign(key):
            if self._overrides.pop(key, None) is not None:
                self._bump()
        elif self._overrides.get(key) != shard:
            self._overrides[key] = shard
            self._bump()

    def clear_location(self, key: int) -> None:
        if self._overrides.pop(int(key), None) is not None:
            self._bump()

    @property
    def overrides(self) -> Dict[int, str]:
        return dict(self._overrides)

    # ------------------------------------------------------------------
    # rebalancing
    # ------------------------------------------------------------------
    def rebalance_plan(
        self, keys_by_shard: Mapping[str, Iterable[int]]
    ) -> Tuple[List[Tuple[int, str, str]], float]:
        """``(moves, churn_ratio)`` to converge the fleet onto the hash
        assignment: one ``(key, src, dst)`` per tenant living off its
        hash-home. ``churn_ratio`` (moves / total tenants) is the bench's
        bounded figure of merit — rendezvous hashing keeps it near 1/N
        for an N+1th shard, and a regression here means the hash lost its
        minimal-churn property."""
        moves: List[Tuple[int, str, str]] = []
        total = 0
        for src, keys in keys_by_shard.items():
            for key in keys:
                total += 1
                dst = self.assign(key)
                if dst != src:
                    moves.append((int(key), str(src), dst))
        return moves, (len(moves) / total if total else 0.0)

    def _bump(self) -> None:
        self.generation += 1
        if _obs.enabled():
            _obs.get().gauge("fleet.map_generation", self.generation)

    def __repr__(self) -> str:
        return (
            f"FleetPlacement(shards={self._shards},"
            f" overrides={len(self._overrides)}, generation={self.generation})"
        )
