"""Elastic fleet: tenant→shard placement, live migration, resharding,
replication + fenced failover.

Port of ``metrics_tpu/fleet/``. Each shard's stacked tenant state is a
:class:`~metrics_tpu_torch.cohort.MetricCohort` on the template metric's
device (the card unless the caller asks for the CPU); placement, leases,
protocol records and journals are host code, and every durable artifact
(journals, ``MIGRATIONS.json``, replica manifests, tenant envelopes) is
the JAX package's, so a fleet directory written by either package is
restored and recovered by the other.

A single :class:`~metrics_tpu_torch.cohort.MetricCohort` makes N tenants one
process's property; this package makes them a *fleet's*. Five layers,
each usable alone:

* :mod:`~metrics_tpu_torch.fleet.placement` — :class:`FleetPlacement`,
  minimal-churn rendezvous hashing with a live-move override table so
  streams follow their tenant mid-migration (rank-2 of the same weight
  order names each tenant's replication follower);
* :mod:`~metrics_tpu_torch.fleet.migration` — :class:`FleetShard` (cohort +
  journal + tenant bookkeeping) and :class:`MigrationCoordinator`, the
  two-phase, chaos-proven exactly-once handoff built on checksummed
  :func:`tenant_envelope` transfers;
* :mod:`~metrics_tpu_torch.fleet.lease` — :class:`LeaseAuthority`, leased
  ownership with epoch fencing: a partitioned old owner cannot commit
  generations or acknowledge waves under a stale epoch
  (:class:`StaleEpochError` — typed refusal, never a silent merge);
* :mod:`~metrics_tpu_torch.fleet.replication` — :class:`ShardReplicator` +
  :class:`ReplicaStore`, continuous post-commit delta replication of
  tenant envelopes to each tenant's rendezvous follower, with
  follower-durable watermarks;
* :mod:`~metrics_tpu_torch.fleet.rebalancer` — :class:`FleetRebalancer`,
  capacity-driven split/merge, quorum-driven evacuation, and
  replica-promoting failover of dead shards.

See docs/reliability.md ("Elastic fleet", "Shard failure & failover")
for the handoff and lease state machines,
``tests/reliability/test_fleet_chaos.py`` for the kill-at-every-phase
proof, and ``tests/reliability/test_fleet_failover.py`` for the
kill-anywhere → failover → bit-identical-twin proof.
"""
from metrics_tpu_torch.fleet.lease import (
    LeaseAuthority,
    LeaseError,
    LeaseExpiredError,
    ShardLease,
    StaleEpochError,
)
from metrics_tpu_torch.fleet.migration import (
    TENANT_ENVELOPE_FORMAT,
    FleetShard,
    MigrationCoordinator,
    adopt_into,
    open_tenant_envelope,
    tenant_envelope,
)
from metrics_tpu_torch.fleet.placement import FleetPlacement
from metrics_tpu_torch.fleet.rebalancer import FleetRebalancer
from metrics_tpu_torch.fleet.replication import ReplicaStore, ShardReplicator

__all__ = [
    "TENANT_ENVELOPE_FORMAT",
    "FleetPlacement",
    "FleetRebalancer",
    "FleetShard",
    "LeaseAuthority",
    "LeaseError",
    "LeaseExpiredError",
    "MigrationCoordinator",
    "ReplicaStore",
    "ShardLease",
    "ShardReplicator",
    "StaleEpochError",
    "adopt_into",
    "open_tenant_envelope",
    "tenant_envelope",
]
