"""Reliability subsystem of the port: survive a failure, don't just observe it.

Port of ``metrics_tpu/reliability/``. Each piece is off by default and adds
no work until enabled:

* **Validated checkpointing** (:mod:`.checkpoint`) — a versioned,
  checksummed state envelope around ``state_dict`` / ``load_state_dict``;
  ``strict`` loads reject schema drift, corruption and partial matches with
  typed errors. The envelope is the JAX package's: either package loads the
  other's files strictly.
* **Non-finite state guard** (:mod:`.guard`) — ``raise`` / ``warn`` /
  ``quarantine`` policies applied after every update and merge; quarantine
  rolls a poisoned batch back to the last-good state (inside the CUDA graph
  under the step engine and the cohort, per tenant in the cohort).
* **Guarded sync** (:mod:`.sync`) — timeout and bounded jittered-backoff
  retry for host-level state gathers, with a ``degraded_ok`` local-only
  fallback, and per-level policies for the hierarchical sync.
* **Fault injection** (:mod:`.faultinject`) — scoped context managers that
  create each failure on demand.
* **Durable eval sessions** (:mod:`.session` and :mod:`.journal`) — an
  :class:`EvalSession` wraps a metric stream with crash-consistent
  checkpoint rotation (:class:`CheckpointJournal`), exactly-once batch
  accounting (a step cursor checksummed into the same envelope as the
  state, with a replay guard on resume), multi-process resume agreement and
  an optional hung-step deadline.

Not ported yet (ROADMAP Queue 1): the session's background checkpoints
(item 5, ``serving/``) and the fault injectors whose targets live in
``serving/``, ``fleet/`` and ``analysis/`` (items 5, 7, 8).

Telemetry counters (under ``reliability.*``): ``quarantined``,
``guard_overflow_warns``, ``sync_retries``, ``degraded_syncs``,
``sync_level_degraded``, ``checkpoint_rejects``,
``engine_dispatch_recoveries`` and the ``session_*`` family; a healthy run
keeps every failure counter at zero.
"""
from metrics_tpu_torch.reliability.checkpoint import (  # noqa: F401
    CheckpointCorruptionError,
    CheckpointError,
    CheckpointMismatchError,
    CheckpointSchemaError,
    atomic_file,
    load_envelope,
    read_envelope,
    save_envelope,
    write_envelope,
)
from metrics_tpu_torch.reliability.journal import (  # noqa: F401
    CheckpointJournal,
    atomic_write_json,
)
from metrics_tpu_torch.reliability.session import (  # noqa: F401
    EvalSession,
    SessionError,
    SessionResumeError,
    SessionStepTimeoutError,
)
from metrics_tpu_torch.reliability.guard import (  # noqa: F401
    NonFiniteStateError,
    StateGuard,
    guard_scope,
    install_guard,
    uninstall_guard,
)
from metrics_tpu_torch.reliability.sync import (  # noqa: F401
    SyncFailedError,
    SyncPolicy,
    SyncTimeoutError,
    set_sync_policy,
    sync_policy_scope,
)
from metrics_tpu_torch.reliability import faultinject  # noqa: F401

__all__ = [
    "CheckpointCorruptionError",
    "CheckpointError",
    "CheckpointJournal",
    "CheckpointMismatchError",
    "CheckpointSchemaError",
    "EvalSession",
    "NonFiniteStateError",
    "SessionError",
    "SessionResumeError",
    "SessionStepTimeoutError",
    "StateGuard",
    "SyncFailedError",
    "SyncPolicy",
    "SyncTimeoutError",
    "atomic_file",
    "atomic_write_json",
    "faultinject",
    "guard_scope",
    "install_guard",
    "load_envelope",
    "read_envelope",
    "save_envelope",
    "set_sync_policy",
    "sync_policy_scope",
    "uninstall_guard",
    "write_envelope",
]
