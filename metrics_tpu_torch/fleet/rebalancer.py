"""Capacity-driven resharding and quorum-driven evacuation.

Port of ``metrics_tpu/fleet/rebalancer.py`` (host code over the
coordinator, the replicator and the lease authority).

The rebalancer closes the loop between what the fleet OBSERVES — per-
tenant load from :meth:`MetricCohort.health`, admission pressure from
the ingest queue, slice liveness from the hierarchical sync's
:class:`~metrics_tpu_torch.parallel.hierarchy.QuorumSnapshot` — and what the
placement SAYS: it computes the moves that converge the fleet onto the
rendezvous assignment and drives each one through the coordinator's
exactly-once handoff. There is deliberately no second protocol here: a
rebalance, a split, a merge and an evacuation are all just batches of
ordinary migrations, so every crash-safety property the chaos bed proves
for one handoff holds mid-rebalance for free.

Playbook (see docs/reliability.md "Elastic fleet"):

* **split** a hot shard — add a spare shard to the placement; rendezvous
  hashing re-homes ~1/N of every shard's tenants onto it; ``converge()``
  moves them.
* **merge** a cold shard — remove it from the placement; only ITS
  tenants re-home (scattered across the survivors); ``converge()``
  drains it empty.
* **evacuate** a dying slice — same as merge, but triggered from the
  last :class:`QuorumSnapshot`'s ``lost_slices``/``lost_ranks`` instead
  of a load signal, for every shard hosted on the dead slice.
* **failover** a DEAD shard — the one verb that is not a batch of
  migrations, because the source is gone: promote each tenant's
  replicated envelope from its follower's
  :class:`~metrics_tpu_torch.fleet.replication.ReplicaStore`, fence the dead
  owner's epoch so a partitioned comeback cannot commit, and let the
  replay guard + ingest redelivery close the post-watermark gap. A dead
  shard with NO replica falls back to its newest durable generation —
  loudly (``fleet_evacuation_data_loss`` dump +
  ``fleet.evacuation_rows_lost``), never a silent stale serve.
"""
from typing import Any, Dict, Iterable, List, Optional, Tuple

from metrics_tpu_torch.observability import flight as _flight
from metrics_tpu_torch.observability import telemetry as _obs

__all__ = ["FleetRebalancer"]


class FleetRebalancer:
    """Load/liveness-driven convergence of shards onto the placement.

    Args:
        coordinator: the fleet's
            :class:`~metrics_tpu_torch.fleet.MigrationCoordinator`.
        shard_slices: optional ``{shard_name: slice_id}`` map tying each
            shard to the hierarchy slice hosting it — required only for
            :meth:`evacuate`.
        shard_ranks: optional ``{shard_name: world_rank}`` map tying each
            shard to the process rank hosting it — what
            :meth:`check_failover` intersects with
            ``last_quorum().lost_ranks`` to spot dead shards.
        replicator: optional
            :class:`~metrics_tpu_torch.fleet.replication.ShardReplicator`; arms
            :meth:`failover` (promote from replicas) and lets
            :meth:`evacuate` prefer promotion over the lossy durable
            fallback.
        authority: optional :class:`~metrics_tpu_torch.fleet.LeaseAuthority`;
            :meth:`failover` fences the dead owner's epoch through it and
            :meth:`check_failover` reads its expirations.
        hot_rows: mean rows-seen-per-tenant above which
            :meth:`should_split` flags a shard (load observed by the
            cohort's in-dispatch health accumulators).
        hot_buffered_rows: ingest-queue backlog above which a shard is
            flagged regardless of rows-seen (admission pressure).
    """

    def __init__(
        self,
        coordinator: Any,
        shard_slices: Optional[Dict[str, int]] = None,
        shard_ranks: Optional[Dict[str, int]] = None,
        replicator: Optional[Any] = None,
        authority: Optional[Any] = None,
        hot_rows: float = 1e6,
        hot_buffered_rows: int = 1 << 16,
    ):
        self.coordinator = coordinator
        self.shard_slices = dict(shard_slices or {})
        self.shard_ranks = dict(shard_ranks or {})
        self.replicator = replicator
        self.authority = authority
        self.hot_rows = float(hot_rows)
        self.hot_buffered_rows = int(hot_buffered_rows)

    # ------------------------------------------------------------------
    # planning + convergence
    # ------------------------------------------------------------------
    def plan(self) -> Tuple[List[Tuple[int, str, str]], float]:
        """``(moves, churn_ratio)`` to converge the live fleet onto the
        placement's rendezvous assignment."""
        keys_by_shard = {
            name: shard.tenants()
            for name, shard in self.coordinator.shards.items()
        }
        return self.coordinator.placement.rebalance_plan(keys_by_shard)

    def converge(self, max_moves: Optional[int] = None) -> int:
        """Migrate every off-home tenant to its assigned shard (up to
        ``max_moves``); returns moves performed. Each move is one full
        exactly-once handoff — a kill mid-converge strands at most the
        single in-flight txn, which :meth:`MigrationCoordinator.recover`
        finishes or aborts."""
        moves, _churn = self.plan()
        done = 0
        for key, src, dst in moves:
            if max_moves is not None and done >= int(max_moves):
                break
            self.coordinator.migrate(key, dst, src_name=src)
            done += 1
        if done:
            if _obs.enabled():
                _obs.get().count("fleet.rebalances")
        return done

    # ------------------------------------------------------------------
    # load triggers
    # ------------------------------------------------------------------
    def pressure(self, shard_name: str) -> Dict[str, float]:
        """The shard's load signals: tenant count, mean rows-seen per
        tenant (0 before any health-armed dispatch), and queue backlog."""
        shard = self.coordinator.shards[shard_name]
        rows_mean = 0.0
        health = shard.cohort.health()
        if health is not None and len(health.get("rows_seen", ())):
            rows = health["rows_seen"]
            rows_mean = float(sum(int(r) for r in rows)) / max(1, len(rows))
        buffered = int(shard.queue.buffered_rows) if shard.queue is not None else 0
        return {
            "tenants": float(len(shard)),
            "rows_seen_mean": rows_mean,
            "buffered_rows": float(buffered),
        }

    def should_split(self, shard_name: str) -> bool:
        p = self.pressure(shard_name)
        return (
            p["rows_seen_mean"] >= self.hot_rows
            or p["buffered_rows"] >= self.hot_buffered_rows
        )

    def should_merge(self, shard_name: str) -> bool:
        """A shard with no tenants and no backlog is pure overhead."""
        p = self.pressure(shard_name)
        return p["tenants"] == 0 and p["buffered_rows"] == 0

    # ------------------------------------------------------------------
    # the playbook verbs
    # ------------------------------------------------------------------
    def split(self, spare: Any, max_moves: Optional[int] = None) -> int:
        """Bring ``spare`` (a constructed, empty :class:`FleetShard`)
        into the fleet and converge — rendezvous hashing spreads ~1/N of
        the existing tenants onto it, relieving every hot shard at once."""
        self.coordinator.shards[spare.name] = spare
        self.coordinator.placement.add_shard(spare.name)
        return self.converge(max_moves=max_moves)

    def merge(self, cold_name: str, max_moves: Optional[int] = None) -> int:
        """Retire ``cold_name``: drop it from the placement, converge (its
        tenants scatter to their new homes), then detach the empty shard
        from the coordinator."""
        cold_name = str(cold_name)
        self.coordinator.placement.remove_shard(cold_name)
        moved = self.converge(max_moves=max_moves)
        shard = self.coordinator.shards.get(cold_name)
        if shard is not None and len(shard) == 0:
            self.coordinator.shards.pop(cold_name)
        return moved

    def evacuate(
        self,
        quorum: Optional[Any] = None,
        max_moves: Optional[int] = None,
        dead: Iterable[str] = (),
        expected_cursor: Optional[int] = None,
    ) -> int:
        """Clear out every shard hosted on a slice the last (or given)
        :class:`QuorumSnapshot` reports lost, plus any shard named in
        ``dead``; returns moves performed (migrations + promotions).
        No-op when the quorum is full and ``dead`` is empty.

        Per doomed shard, in preference order:

        1. **replicas exist** (an armed replicator durably holds its
           tenants) → :meth:`failover` promotes them — no data loss;
        2. **named dead, no replica** → fall back to the shard's newest
           durable generation (:meth:`FleetShard.restore` — the only
           truth a dead process leaves) and merge that. The fallback is
           stale by whatever folded since the last commit, and it is
           NEVER silent: the lost range is quantified (tenants behind ×
           cursor gap, against ``expected_cursor`` — default: the
           freshest cursor any surviving shard holds) in one
           ``fleet_evacuation_data_loss`` flight dump and the
           ``fleet.evacuation_rows_lost`` counter. A replayable source
           stream converges anyway (the regressed cursors re-admit the
           lost steps); a non-replayable one knows exactly what it lost;
        3. **still alive** (lost slice, process up) →
           plain merge of the live state.
        """
        if quorum is None:
            from metrics_tpu_torch.parallel.hierarchy import last_quorum

            quorum = last_quorum()
        lost = set(quorum.lost_slices) if quorum is not None else set()
        dead = {str(d) for d in dead}
        doomed = [
            name
            for name in self.coordinator.shards
            if name in dead or self.shard_slices.get(name) in lost
        ]
        moved = 0
        for name in doomed:
            if self.replicator is not None and self.replicator.has_replicas(name):
                moved += self.failover(name)
                continue
            shard = self.coordinator.shards[name]
            if name in dead:
                shard.restore()
                exp = expected_cursor
                if exp is None:
                    exp = max(
                        (
                            s.cursor_of(k)
                            for nm, s in self.coordinator.shards.items()
                            if nm != name
                            for k in s.tenants()
                        ),
                        default=-1,
                    )
                gaps = {
                    k: exp - shard.cursor_of(k)
                    for k in shard.tenants()
                    if shard.cursor_of(k) < exp
                }
                if gaps:
                    rows_lost = int(sum(gaps.values()))
                    if _obs.enabled():
                        _obs.get().count("fleet.evacuation_rows_lost", rows_lost)
                    _flight.dump_on_failure(
                        "fleet_evacuation_data_loss",
                        shard=name,
                        tenants_behind=len(gaps),
                        rows_lost=rows_lost,
                        max_cursor_gap=int(max(gaps.values())),
                        expected_cursor=int(exp),
                        durable_generation=shard.journal.newest_generation(),
                    )
            moved += self.merge(name, max_moves=max_moves)
        if doomed:
            if _obs.enabled():
                _obs.get().count("fleet.evacuations")
        return moved

    # ------------------------------------------------------------------
    # failover (the dead-shard verb — see metrics_tpu_torch.fleet.replication)
    # ------------------------------------------------------------------
    def failover(self, dead_name: str) -> int:
        """Promote the followers of dead shard ``dead_name``: fence its
        epoch (a partitioned comeback is refused from this instant),
        adopt every replicated tenant envelope into the follower durably
        holding it, fast-forward cursors to the replication watermarks,
        re-pin the placement, and drop the carcass from the fleet.
        Returns tenants promoted. The promoted shards converge
        bit-identically with a never-failed twin once the
        post-watermark rows arrive (ingest redelivery or a full-stream
        resubmit — the replay guard folds each step exactly once)."""
        dead_name = str(dead_name)
        if self.replicator is None:
            raise RuntimeError(
                "failover needs a ShardReplicator (no replicas, nothing to"
                " promote — use evacuate(dead=[...]) for the durable-"
                "generation fallback)"
            )
        if self.authority is not None:
            self.authority.fence(dead_name)
        promoted = self.replicator.promote(dead_name)
        self.coordinator.shards.pop(dead_name, None)
        if dead_name in self.coordinator.placement.shards:
            self.coordinator.placement.remove_shard(dead_name)
        # re-pin after the membership change: remove_shard dropped the
        # overrides that pointed AT the dead shard, but the promoted
        # tenants' pins must survive it, keyed to where their state IS
        for key, fname, _cursor in promoted:
            self.coordinator.placement.record_location(key, fname)
        self.replicator.stats["failovers"] += 1
        if _obs.enabled():
            _obs.get().count("fleet.failovers")
        _flight.record(
            "fleet_failover", shard=dead_name, tenants_promoted=len(promoted)
        )
        return len(promoted)

    def check_failover(self, quorum: Optional[Any] = None) -> List[str]:
        """The automatic trigger: one sweep of the two death signals —
        lease expiry (after a :meth:`LeaseAuthority.heartbeat` fed by
        ``quorum``/``shard_ranks``) and ``last_quorum().lost_ranks`` —
        failing over every shard either one marks dead. Returns the
        shards failed over (empty on a healthy fleet — this is safe to
        call every serving tick)."""
        doomed: set = set()
        if self.authority is not None:
            self.authority.heartbeat(self.shard_ranks or None, quorum=quorum)
            doomed.update(
                s
                for s in self.authority.expired_shards()
                if s in self.coordinator.shards
            )
        if quorum is None:
            from metrics_tpu_torch.parallel.hierarchy import last_quorum

            quorum = last_quorum()
        if quorum is not None and self.shard_ranks:
            lost = set(quorum.lost_ranks)
            doomed.update(
                name
                for name, rank in self.shard_ranks.items()
                if rank in lost and name in self.coordinator.shards
            )
        for name in sorted(doomed):
            self.failover(name)
        return sorted(doomed)
