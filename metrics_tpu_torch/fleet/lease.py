"""Leased shard ownership with epoch fencing: the split-brain guard.

Port of ``metrics_tpu/fleet/lease.py`` (host code; the clock is injectable,
as in the JAX package).

A shard that loses its process does not lose its *identity* — a
partitioned owner can come back minutes later with live in-memory state
and every intention of committing it. Without fencing, that commit
silently merges a dead timeline into the live one: the follower promoted
in the meantime owns the tenants, the returning owner re-commits stale
generations over them, and "exactly once" becomes "at least twice".

The classic fix (Chubby/ZooKeeper-style) is a **lease + epoch**: every
grant of shard ownership carries a monotonically increasing epoch
integer, every durable write is stamped with the writer's epoch, and a
write under any epoch older than the current grant is refused with a
typed error — never merged, never retried into acceptance. The
:class:`LeaseAuthority` here is the fleet-local source of truth for
those epochs; in a deployed fleet its liveness signal rides the sync
backend's quorum machinery (:meth:`LeaseAuthority.heartbeat` consumes
``SyncBackend.heartbeat()`` / the last
:class:`~metrics_tpu_torch.parallel.hierarchy.QuorumSnapshot`).

Lease state machine (see docs/reliability.md "Shard failure & failover"):

========= ============================== ===============================
state     how it is entered              what the holder may do
========= ============================== ===============================
HELD      :meth:`acquire` (epoch = N)    commit generations, ack waves,
                                         replicate — every write renews
EXPIRED   TTL elapsed with no renewal,   nothing: writes raise
          :meth:`expire` (injection), or :class:`LeaseExpiredError`
          a heartbeat reporting the      until re-acquired (epoch N+1)
          holder's rank lost
FENCED    :meth:`fence` (failover took   nothing, ever: the epoch is
          ownership; epoch bumped to     gone — writes raise
          N+1 without a grant)           :class:`StaleEpochError`
========= ============================== ===============================

The authority is deliberately *local and synchronous* — a dict with a
clock — because the property under test is the fencing discipline of
the writers, not a consensus protocol: the chaos bed drives a real
partitioned-owner-returns scenario through it and proves both the
commit path and the wave-ack path refuse the stale epoch.
"""
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional

from metrics_tpu_torch.observability import flight as _flight
from metrics_tpu_torch.observability import telemetry as _obs

__all__ = [
    "LeaseAuthority",
    "LeaseError",
    "LeaseExpiredError",
    "ShardLease",
    "StaleEpochError",
]


class LeaseError(RuntimeError):
    """Base of the typed lease refusals (never raised itself)."""


class StaleEpochError(LeaseError):
    """A write arrived under an epoch older than the current grant — the
    writer lost ownership (failover fenced it) and must not merge."""

    def __init__(self, shard: str, held_epoch: int, current_epoch: int):
        self.shard = str(shard)
        self.held_epoch = int(held_epoch)
        self.current_epoch = int(current_epoch)
        super().__init__(
            f"shard {shard!r}: write fenced — held epoch {held_epoch} is"
            f" stale (current epoch {current_epoch}); ownership moved while"
            " this writer was partitioned"
        )


class LeaseExpiredError(LeaseError):
    """The holder's lease TTL elapsed without renewal. Ownership has not
    (yet) moved — the epoch is still the holder's — but writing on an
    expired lease races the failover that expiry is about to trigger, so
    it is refused until the holder re-acquires."""

    def __init__(self, shard: str, epoch: int):
        self.shard = str(shard)
        self.epoch = int(epoch)
        super().__init__(
            f"shard {shard!r}: lease (epoch {epoch}) expired without"
            " renewal; re-acquire before writing"
        )


@dataclass(frozen=True)
class ShardLease:
    """One grant of shard ownership: the token a :class:`FleetShard`
    holds and stamps into its journal commits and migration records."""

    shard: str
    holder: str
    epoch: int
    ttl_s: float


class LeaseAuthority:
    """Fleet-wide epoch/lease table — the fencing source of truth.

    Args:
        ttl_s: grant lifetime; a lease not renewed (every fenced write
            renews implicitly, as does :meth:`heartbeat`) within this
            window reports as expired and triggers failover.
        clock: injectable monotonic clock (tests freeze time with it).
        backend: optional :class:`~metrics_tpu_torch.parallel.SyncBackend`
            whose :meth:`~metrics_tpu_torch.parallel.SyncBackend.heartbeat`
            supplies rank liveness when :meth:`heartbeat` is called
            without an explicit quorum.
    """

    def __init__(
        self,
        ttl_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        backend: Optional[Any] = None,
    ):
        if float(ttl_s) <= 0:
            raise ValueError(f"ttl_s must be positive, got {ttl_s}")
        self.ttl_s = float(ttl_s)
        self._clock = clock
        self.backend = backend
        self._epochs: Dict[str, int] = {}
        self._leases: Dict[str, ShardLease] = {}
        self._expiry: Dict[str, float] = {}

    # ------------------------------------------------------------------
    # grants
    # ------------------------------------------------------------------
    def acquire(self, shard: str, holder: Optional[str] = None) -> ShardLease:
        """Grant ownership of ``shard`` under the next epoch. Acquiring
        over a live grant supersedes it (the old holder's epoch turns
        stale) — takeover IS the operation, there is no separate steal."""
        shard = str(shard)
        epoch = self._epochs.get(shard, 0) + 1
        self._epochs[shard] = epoch
        lease = ShardLease(shard, str(holder or shard), epoch, self.ttl_s)
        self._leases[shard] = lease
        self._expiry[shard] = self._clock() + self.ttl_s
        if _obs.enabled():
            _obs.get().gauge("fleet.lease.epoch", epoch)
        _flight.record(
            "fleet_lease_acquired", shard=shard, holder=lease.holder, epoch=epoch
        )
        return lease

    def current_epoch(self, shard: str) -> int:
        """The epoch a write must hold to be accepted (0 = never granted)."""
        return self._epochs.get(str(shard), 0)

    def check(self, lease: ShardLease) -> None:
        """Validate ``lease`` for a write: raises :class:`StaleEpochError`
        when the epoch was superseded, :class:`LeaseExpiredError` when the
        TTL elapsed; otherwise renews the TTL (a live owner's writes are
        its heartbeat) and returns."""
        current = self.current_epoch(lease.shard)
        if lease.epoch != current:
            raise StaleEpochError(lease.shard, lease.epoch, current)
        now = self._clock()
        if now > self._expiry.get(lease.shard, float("-inf")):
            raise LeaseExpiredError(lease.shard, lease.epoch)
        self._expiry[lease.shard] = now + lease.ttl_s

    def renew(self, lease: ShardLease) -> None:
        """Explicit heartbeat renewal — :meth:`check` without a write."""
        self.check(lease)

    def is_current(self, lease: ShardLease) -> bool:
        try:
            self.check(lease)
        except LeaseError:
            return False
        return True

    # ------------------------------------------------------------------
    # revocation
    # ------------------------------------------------------------------
    def fence(self, shard: str) -> int:
        """Revoke the current grant WITHOUT granting a new one: bump the
        epoch so every outstanding lease on ``shard`` is stale. Failover
        calls this before promoting the follower — from this instant the
        old owner cannot commit, even if it is still running."""
        shard = str(shard)
        epoch = self._epochs.get(shard, 0) + 1
        self._epochs[shard] = epoch
        self._leases.pop(shard, None)
        self._expiry.pop(shard, None)
        if _obs.enabled():
            _obs.get().gauge("fleet.lease.epoch", epoch)
        _flight.record("fleet_lease_fenced", shard=shard, epoch=epoch)
        return epoch

    def expire(self, shard: str) -> None:
        """Force ``shard``'s lease past its TTL (fault injection / ops:
        'treat this owner as dead now'). The epoch is untouched — failover
        fences when it actually takes ownership."""
        shard = str(shard)
        if shard in self._leases:
            self._expiry[shard] = self._clock() - 1.0
            if _obs.enabled():
                _obs.get().count("fleet.lease.expirations")
            _flight.record(
                "fleet_lease_expired", shard=shard, epoch=self._epochs.get(shard, 0)
            )

    def expired_shards(self) -> List[str]:
        """Shards whose lease is past TTL and not yet fenced — the
        automatic-failover work list."""
        now = self._clock()
        return sorted(
            s for s, exp in self._expiry.items() if s in self._leases and exp < now
        )

    # ------------------------------------------------------------------
    # liveness from the sync layer
    # ------------------------------------------------------------------
    def heartbeat(
        self,
        shard_ranks: Optional[Mapping[str, int]] = None,
        quorum: Optional[Any] = None,
    ) -> List[str]:
        """One liveness sweep from the sync backend's quorum machinery:
        leases whose hosting rank is present renew; leases on lost ranks
        expire (counted ``fleet.lease.expirations``). ``shard_ranks``
        maps shard name → hosting world rank; rank liveness comes from
        ``quorum.ranks_present`` (default: the last
        :class:`QuorumSnapshot`), falling back to
        ``backend.heartbeat()``. Returns the shards newly expired — feed
        them to :meth:`FleetRebalancer.failover`."""
        if not shard_ranks:
            return []
        present = None
        if quorum is None:
            try:
                from metrics_tpu_torch.parallel.hierarchy import last_quorum

                quorum = last_quorum()
            except Exception:  # noqa: BLE001 — liveness probe must not raise
                quorum = None
        if quorum is not None:
            present = set(quorum.ranks_present)
        elif self.backend is not None:
            present = set(self.backend.heartbeat())
        if present is None:
            return []
        now = self._clock()
        newly: List[str] = []
        for shard, rank in shard_ranks.items():
            shard = str(shard)
            lease = self._leases.get(shard)
            if lease is None:
                continue
            if int(rank) in present:
                self._expiry[shard] = now + lease.ttl_s
            elif self._expiry.get(shard, now) >= now:
                self._expiry[shard] = now - 1.0
                newly.append(shard)
                if _obs.enabled():
                    _obs.get().count("fleet.lease.expirations")
                _flight.record(
                    "fleet_lease_expired",
                    shard=shard,
                    epoch=self._epochs.get(shard, 0),
                    rank=int(rank),
                )
        return newly

    def __repr__(self) -> str:
        return (
            f"LeaseAuthority(leases={sorted(self._leases)},"
            f" epochs={dict(sorted(self._epochs.items()))}, ttl_s={self.ttl_s})"
        )
