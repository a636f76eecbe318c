"""Reliability subsystem of the port: survive a failure, don't just observe it.

Port of part of ``metrics_tpu/reliability/``. Ported so far:

* **Guarded sync** (:mod:`.sync`) — timeout and bounded jittered-backoff
  retry for host-level state gathers, with a ``degraded_ok`` local-only
  fallback instead of a crashed eval, and per-level policies for the
  hierarchical sync (``SyncPolicy(levels=...)``).
* **Fault injection for the sync paths** (:mod:`.faultinject`) — scoped
  context managers that create each sync failure on demand
  (``flaky_sync_backend``, ``flaky_level``, ``hung_level``, ``pod_dropout``,
  ``simulated_pods``).
* The atomic writers the observability core needs
  (``checkpoint.atomic_file``, ``journal.atomic_write_json``).

Still missing (ROADMAP Queue 1 item 4): the checksummed checkpoint envelope
(``save_envelope`` / ``load_envelope`` and their errors), the non-finite
state guard (``StateGuard``), the checkpoint journal, ``EvalSession``, and
the injectors for inputs, envelopes, the engine, sessions and the fleet.

Telemetry counters (under ``reliability.*``): ``sync_retries``,
``degraded_syncs`` and ``sync_level_degraded``; a healthy run keeps every
one at zero.
"""
from metrics_tpu_torch.reliability.checkpoint import atomic_file  # noqa: F401
from metrics_tpu_torch.reliability.journal import atomic_write_json  # noqa: F401
from metrics_tpu_torch.reliability.sync import (  # noqa: F401
    SyncFailedError,
    SyncPolicy,
    SyncTimeoutError,
    set_sync_policy,
    sync_policy_scope,
)
from metrics_tpu_torch.reliability import faultinject  # noqa: F401

__all__ = [
    "SyncFailedError",
    "SyncPolicy",
    "SyncTimeoutError",
    "atomic_file",
    "atomic_write_json",
    "faultinject",
    "set_sync_policy",
    "sync_policy_scope",
]
