"""Durable eval sessions: preemption-tolerant, exactly-once metric streams.

Port of ``metrics_tpu/reliability/session.py``. A long eval dies two ways.
Losing the accumulated state restarts it from zero; restarting it *naively*
— re-feeding a stream whose head was already counted — silently counts
every replayed batch twice. :class:`EvalSession` closes both holes:

* **Crash-consistent checkpoint rotation** — every ``checkpoint_every``
  accepted steps the whole state is committed to a
  :class:`~metrics_tpu_torch.reliability.CheckpointJournal` generation; a
  torn newest generation falls back to the previous good one.
* **Exactly-once batch accounting** — the step cursor (index of the last
  batch folded into state) is embedded in the same envelope as the state
  (``Metric._SESSION_CURSOR_KEY``, under the payload checksum). After
  :meth:`~EvalSession.resume`, re-fed batches at or below the cursor are
  no-ops (the replay guard), counted as
  ``reliability.session_replays_skipped``::

      session = EvalSession(collection, "ckpts/", checkpoint_every=50)
      start = session.resume() + 1          # -1 on a fresh start
      for i, (preds, target) in enumerate(loader):
          session.step(i, preds, target)    # i <= cursor: skipped
      final = session.compute()

* **Multi-process resume agreement** — on resume every rank gathers its
  cursor through the active sync backend (``torch.distributed`` over gloo
  or NCCL, or a two-level ``HierarchicalSyncBackend``); disagreeing ranks
  roll back to the newest generation every rank still holds on disk
  (``reliability.session_resume_rollbacks``), or raise a typed
  :class:`SessionResumeError` (``degraded_ok=True`` demotes that to one
  warning and continues on local accounting).
* **Hung-step deadline** — ``step_deadline_s`` runs each forward on the
  abandonable worker of :class:`~metrics_tpu_torch.reliability.SyncPolicy`;
  a wedged step restores the pre-step snapshot, writes a protective
  checkpoint and raises :class:`SessionStepTimeoutError`.
* **Engine failure hook** — when the step engine demotes members to eager
  after a failed step, any session wrapping those metrics writes a
  protective checkpoint of the surviving state
  (``reliability.session_protective_checkpoints``).

* **Background checkpoints** — ``background_checkpoints=True`` moves the
  checkpoint write off the step path: :meth:`~EvalSession.checkpoint`
  snapshots the state on the card at the barrier and returns; the writer of
  ``serving/bgcheckpoint.py`` fetches, checksums and commits it behind the
  journal's atomic rename (:meth:`~EvalSession.flush_checkpoints` is the
  barrier). Protective checkpoints stay synchronous.

Nothing here runs for code that never constructs a session: the runtime
hooks live in the engine's failure path and in ``state_dict``'s
``cursor is not None`` branch.
"""
import weakref
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from metrics_tpu_torch.observability import flight as _flight
from metrics_tpu_torch.observability import telemetry as _obs
from metrics_tpu_torch.observability import trace as _trace
from metrics_tpu_torch.parallel.backend import get_sync_backend
from metrics_tpu_torch.parallel.hierarchy import (
    HierarchicalSyncBackend,
    QuorumSnapshot,
    _lost_slice_from,
    record_quorum,
)
from metrics_tpu_torch.reliability import sync as _rsync
from metrics_tpu_torch.reliability.checkpoint import load_envelope, save_envelope
from metrics_tpu_torch.reliability.journal import CheckpointJournal, _cursor_from_envelope, current_git_sha
from metrics_tpu_torch.utilities.prints import warn_once

__all__ = [
    "EvalSession",
    "SessionError",
    "SessionResumeError",
    "SessionStepTimeoutError",
    "notify_dispatch_failure",
]


class SessionError(RuntimeError):
    """Base of every durable-session failure."""


class SessionResumeError(SessionError):
    """Ranks could not agree on a common resume point (cursor skew with no
    shared generation), or a rollback target failed to load."""


class SessionStepTimeoutError(SessionError):
    """A step exceeded ``step_deadline_s``; the pre-step state was
    checkpointed before this was raised."""


# sessions alive in this process, so the engine's failure path can find the
# one wrapping its metrics; weak: a dropped session is not kept alive here
_SESSIONS: "weakref.WeakSet[EvalSession]" = weakref.WeakSet()


def notify_dispatch_failure(metrics: Iterable[Any]) -> None:
    """Called by ``CompiledStepEngine`` after a failed step was survived
    (state intact, members demoted to eager): every live session wrapping
    any of ``metrics`` writes a protective checkpoint. Never raises: a failed
    protective checkpoint must not break the recovery it protects."""
    if not _SESSIONS:
        return
    ids = {id(m) for m in metrics}
    for session in list(_SESSIONS):
        if session._member_ids & ids:
            try:
                session._protective_checkpoint("engine dispatch failure")
            except Exception as err:  # noqa: BLE001 - best-effort by contract
                warn_once(
                    "EvalSession: protective checkpoint after an engine"
                    f" dispatch failure itself failed ({type(err).__name__}:"
                    f" {err}); continuing without it",
                    key=f"session-protective-failed:{id(session)}",
                )


def _cursor_vector(cursors: List[int], length: int) -> np.ndarray:
    """Fixed-length (gather-shape-stable) vector of the newest ``length``
    cursors, -1-padded: ranks may hold different generation counts."""
    vec = np.full((length,), -1, dtype=np.int32)
    tail = cursors[-length:]
    vec[: len(tail)] = tail
    return vec


def _ints(gathered: List[torch.Tensor]) -> List[int]:
    """Every rank's cursor, in one device-to-host copy."""
    return [int(c) for c in torch.stack(list(gathered)).reshape(-1).tolist()]


def _common(gathered: List[torch.Tensor]) -> set:
    """The cursors every rank's availability vector holds (-1 pads)."""
    rows = torch.stack(list(gathered)).tolist()
    out = {int(x) for x in rows[0] if x >= 0}
    for row in rows[1:]:
        out &= {int(x) for x in row if x >= 0}
    return out


class EvalSession:
    """Wrap a metric or collection stream with durable, exactly-once steps.

    Args:
        metric: the :class:`~metrics_tpu_torch.Metric`,
            :class:`~metrics_tpu_torch.CompositionalMetric` or
            :class:`~metrics_tpu_torch.MetricCollection` whose state the
            session owns. Enrolling sets its session cursor (so checkpoints
            carry it); feed batches only through :meth:`step`.
        directory: the checkpoint journal directory (one per rank).
        checkpoint_every: commit a generation every N accepted steps
            (``None``: only on explicit :meth:`checkpoint` calls and
            protective checkpoints).
        keep_last: journal generations retained (torn-write and rollback
            depth).
        step_deadline_s: optional per-step wall-clock bound. None: no
            watchdog.
        degraded_ok: demote an unresolvable multi-process cursor skew from
            :class:`SessionResumeError` to one rate-limited warning.
        background_checkpoints: write checkpoints off the step path (module
            docstring): a snapshot on the card at the barrier, the fetch and
            commit on a daemon writer
            (:class:`~metrics_tpu_torch.serving.BackgroundCheckpointer`).

    Attributes:
        cursor: index of the last batch folded into the accumulated state
            (-1 before any). The replay guard skips ``step_index <= cursor``.
        stats: host-side tally mirroring the telemetry counters.
    """

    def __init__(
        self,
        metric: Any,
        directory: Any,
        checkpoint_every: Optional[int] = 1,
        keep_last: int = 3,
        step_deadline_s: Optional[float] = None,
        degraded_ok: bool = False,
        background_checkpoints: bool = False,
    ):
        from metrics_tpu_torch.collections import MetricCollection
        from metrics_tpu_torch.metric import Metric

        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(
                "EvalSession wraps a Metric, CompositionalMetric or"
                f" MetricCollection, got {type(metric).__name__}"
            )
        if checkpoint_every is not None and checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1 (or None)")
        self.metric = metric
        self._is_collection = isinstance(metric, MetricCollection)
        self.journal = CheckpointJournal(directory, keep_last=keep_last)
        self.checkpoint_every = checkpoint_every
        self.step_deadline_s = step_deadline_s
        self.degraded_ok = bool(degraded_ok)
        self.cursor = -1
        self._steps_since_checkpoint = 0
        self._inflight: Optional[int] = None
        self.stats: Dict[str, int] = {
            "steps": 0,
            "replays_skipped": 0,
            "checkpoints": 0,
            "protective_checkpoints": 0,
            "resumes": 0,
            "resume_rollbacks": 0,
            "partial_quorum_resumes": 0,
            "deadline_exceeded": 0,
        }
        self._bg = None
        if background_checkpoints:
            # lazy: the synchronous path never imports serving/
            from metrics_tpu_torch.serving.bgcheckpoint import BackgroundCheckpointer

            self._bg = BackgroundCheckpointer(self.journal)
            # the writer does not outlive the session: a dropped session
            # finishes its queued commit and stops the writer (the finalizer
            # holds the writer, not the session)
            weakref.finalize(self, self._bg.close)
        # enroll: the cursor now rides state_dict / _named_states / envelopes
        metric._session_cursor = self.cursor
        self._member_ids = self._collect_member_ids(metric)
        _SESSIONS.add(self)

    @staticmethod
    def _collect_member_ids(metric: Any) -> set:
        from metrics_tpu_torch.collections import MetricCollection
        from metrics_tpu_torch.metric import CompositionalMetric, Metric

        ids = {id(metric)}
        if isinstance(metric, MetricCollection):
            ids |= {id(m) for m in metric.values()}
        elif isinstance(metric, CompositionalMetric):
            for operand in (metric.metric_a, metric.metric_b):
                if isinstance(operand, Metric):
                    ids.add(id(operand))
        return ids

    def _device(self) -> torch.device:
        """Where the cursor exchanges live: the metric's device (NCCL
        gathers need CUDA tensors)."""
        if self._is_collection:
            return next(iter(self.metric.values())).device if len(self.metric) else torch.device("cpu")
        return self.metric.device

    # ------------------------------------------------------------------
    # the step (replay guard + optional deadline)
    # ------------------------------------------------------------------
    def step(self, step_index: int, *args: Any, **kwargs: Any):
        """Feed batch ``step_index`` (0-based, increasing across the
        stream). Replayed batches (``step_index <= cursor``, already folded
        into the possibly resumed state) are no-ops returning None, counted
        as ``reliability.session_replays_skipped``. Returns the forward
        value otherwise."""
        step_index = int(step_index)
        if step_index < 0:
            raise ValueError(f"step_index must be >= 0, got {step_index}")
        if step_index <= self.cursor:
            self.stats["replays_skipped"] += 1
            if _obs.enabled():
                _obs.get().count("reliability.session_replays_skipped")
            return None
        self._inflight = step_index
        try:
            # the durable cursor is the trace and flight step index of
            # everything this forward does
            with _trace.step_scope(step_index):
                _flight.record("session_step", step=step_index)
                if self.step_deadline_s is None:
                    value = self.metric(*args, **kwargs)
                else:
                    value = self._step_with_deadline(args, kwargs)
        finally:
            self._inflight = None
        self.cursor = step_index
        self.metric._session_cursor = step_index
        self.stats["steps"] += 1
        self._steps_since_checkpoint += 1
        if self.checkpoint_every is not None and self._steps_since_checkpoint >= self.checkpoint_every:
            self.checkpoint()
        return value

    def adopt_cursor(self, cursor: int) -> int:
        """Fast-forward the replay guard to ``cursor`` without feeding
        batches (state that already covers steps ``<= cursor`` arrived from
        elsewhere). Only moves forward. Returns the resulting cursor."""
        cursor = int(cursor)
        if cursor > self.cursor:
            self.cursor = cursor
            self.metric._session_cursor = cursor
        return self.cursor

    def _step_with_deadline(self, args: tuple, kwargs: dict):
        """Run one forward on an abandonable daemon worker (the machinery
        that bounds wedged sync gathers). On expiry: restore the pre-step
        snapshot, write a protective checkpoint of it, raise
        :class:`SessionStepTimeoutError`. Best effort by nature: the
        abandoned worker cannot be killed and may briefly keep mutating the
        metric; the raise makes the session unusable for further steps."""
        snapshot = self._snapshot()

        def call():
            # inner exceptions travel as values: a SyncTimeoutError raised
            # inside the forward is not the watchdog's own expiry
            try:
                return ("ok", self.metric(*args, **kwargs))
            except BaseException as err:  # noqa: BLE001 - re-raised below
                return ("raised", err)

        try:
            outcome, payload = _rsync._attempt(call, (), {}, self.step_deadline_s)
        except _rsync.SyncTimeoutError as err:
            timed_out_step = self._inflight
            self._restore(snapshot)
            # the wedged batch was rolled back: the protective checkpoint
            # records the pre-step cursor
            self._inflight = None
            self.stats["deadline_exceeded"] += 1
            if _obs.enabled():
                _obs.get().count("reliability.session_deadline_exceeded")
                _obs.get().event("session_deadline_exceeded", step=timed_out_step, deadline_s=self.step_deadline_s)
            self._protective_checkpoint("step deadline exceeded")
            raise SessionStepTimeoutError(
                f"step {timed_out_step} exceeded step_deadline_s="
                f"{self.step_deadline_s}; state restored to the last-good"
                " snapshot and checkpointed (the abandoned worker may still"
                " be running: do not reuse this process's devices for the"
                " retry)"
            ) from err
        if outcome == "raised":
            raise payload
        return payload

    def _members(self) -> List[Any]:
        return list(self.metric.values()) if self._is_collection else [self.metric]

    def _snapshot(self) -> List[Dict[str, Any]]:
        # list ("cat") states are appended to in place: copy them, so the
        # snapshot cannot alias a state the abandoned step appends into
        return [
            {k: list(v) if isinstance(v, list) else v for k, v in m._snapshot_state().items()}
            for m in self._members()
        ]

    def _restore(self, snapshot: List[Dict[str, Any]]) -> None:
        for m, cache in zip(self._members(), snapshot):
            m._restore_state(cache)
            m._computed = None

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------
    def checkpoint(self, note: Optional[str] = None) -> Dict[str, Any]:
        """Commit the current state (cursor embedded) as a new journal
        generation; returns the manifest record, or with
        ``background_checkpoints=True`` a pending descriptor: the snapshot is
        taken here and the writer commits it (:meth:`flush_checkpoints` is
        the barrier)."""
        self.metric._session_cursor = self.cursor
        with _trace.span("session.checkpoint", phase="checkpoint", cursor=self.cursor):
            if self._bg is not None:
                from metrics_tpu_torch.serving.bgcheckpoint import snapshot_pairs

                record = self._bg.submit(snapshot_pairs(self.metric), type(self.metric).__name__, self.cursor,
                                         note=note)
            else:
                record = self.journal.commit(save_envelope(self.metric), self.cursor, note=note)
        self._steps_since_checkpoint = 0
        self.stats["checkpoints"] += 1
        if _obs.enabled():
            _obs.get().count("reliability.session_checkpoints")
        return record

    def flush_checkpoints(self) -> None:
        """Barrier for ``background_checkpoints=True``: block until every
        queued snapshot is committed, re-raising the first writer error. A
        no-op for a synchronous session."""
        if self._bg is not None:
            self._bg.drain()

    def close(self) -> None:
        """Flush background checkpoints (re-raising a writer error) and stop
        the writer; later checkpoints are synchronous. A no-op for a
        synchronous session."""
        if self._bg is not None:
            try:
                self._bg.drain()
            finally:
                self._bg.close()
                self._bg = None

    def _protective_checkpoint(self, reason: str) -> None:
        """An out-of-cadence checkpoint after a survived failure: persist the
        last-good state now. Cursor: the in-flight step when its batch
        already landed in state (the engine hook fires after a successful
        eager rerun), else the last accepted step."""
        cursor = self._inflight if self._inflight is not None else self.cursor
        self.metric._session_cursor = cursor
        try:
            if self._bg is not None:
                # durable now: through the writer's synchronous seam, which
                # drains the queued snapshot and commits under its lock
                from metrics_tpu_torch.serving.bgcheckpoint import snapshot_pairs

                self._bg.commit_sync(snapshot_pairs(self.metric), type(self.metric).__name__, cursor,
                                     note=f"protective: {reason}")
            else:
                self.journal.commit(save_envelope(self.metric), cursor, note=f"protective: {reason}")
        finally:
            self.metric._session_cursor = self.cursor if self._inflight is None else cursor
        self.stats["protective_checkpoints"] += 1
        if _obs.enabled():
            _obs.get().count("reliability.session_protective_checkpoints")
            _obs.get().event("session_protective_checkpoint", reason=reason, cursor=cursor)

    # ------------------------------------------------------------------
    # resume
    # ------------------------------------------------------------------
    def resume(self) -> int:
        """Restore the newest good generation (torn writes fall back, see
        :meth:`CheckpointJournal.load_latest_good`), agree with the other
        ranks on the cursor, and return it (-1 when the journal is empty: a
        fresh start). Then re-feed the stream from the top: the replay
        guard makes it exactly-once."""
        if self._bg is not None:
            # a resume mid-life must not race the writer over the journal
            self._bg.drain(raise_errors=False)
        with _trace.span("session.resume", phase="checkpoint"):
            envelope, record, _skipped = self.journal.load_latest_good()
            if envelope is None:
                self._agree_on_cursor()  # ranks must agree even about "fresh"
                return self.cursor
            self._load(envelope, record)
        _flight.record("session_resume", step=self.cursor)
        self.stats["resumes"] += 1
        if _obs.enabled():
            _obs.get().count("reliability.session_resumes")
            _obs.get().event("session_resume", cursor=self.cursor, generation=record["generation"])
        sha = record.get("git_sha") or ""
        head = current_git_sha()
        if sha and head and sha != head:
            # state from other code is not evidence about this code, but it
            # may be what the operator wants (a fix mid-eval): warn
            warn_once(
                f"EvalSession.resume: checkpoint generation"
                f" {record['generation']} was written at git SHA"
                f" {sha[:12]} but the current HEAD is {head[:12]}; the"
                " resumed metric state predates the code now computing on"
                " it",
                key=f"session-sha-drift:{self.journal.directory}",
            )
        self._agree_on_cursor()
        return self.cursor

    def _load(self, envelope: Dict[str, Any], record: Dict[str, Any]) -> None:
        from metrics_tpu_torch.metric import Metric

        # an envelope without an embedded cursor (a journal seeded with plain
        # save_envelope) must still strict-load: clear the enrollment for
        # the load, then fall back to the manifest's cursor
        has_cursor = any(key.endswith(Metric._SESSION_CURSOR_KEY) for key in envelope["payload"])
        if not has_cursor:
            self.metric._session_cursor = None
        try:
            load_envelope(self.metric, envelope, strict=True)
        finally:
            if self.metric._session_cursor is None:
                self.metric._session_cursor = self.cursor  # re-enroll
        if has_cursor:
            cursor = self.metric._session_cursor
        else:
            rec_cursor = record.get("cursor")
            cursor = int(rec_cursor) if rec_cursor is not None else -1
        self.cursor = int(cursor)
        self.metric._session_cursor = self.cursor
        self._steps_since_checkpoint = 0

    def _cursor_tensor(self) -> torch.Tensor:
        return torch.tensor(self.cursor, dtype=torch.int32, device=self._device())

    def _avail_tensor(self, cursors: List[int]) -> torch.Tensor:
        return torch.from_numpy(_cursor_vector(cursors, self.journal.keep_last)).to(self._device())

    def _agree_on_cursor(self) -> None:
        """Compare step cursors across ranks through the sync backend:
        agree, roll back to the newest generation every rank still holds, or
        fail typed (``degraded_ok`` demotes to a warning)."""
        backend = get_sync_backend()
        if backend.world_size <= 1:
            return
        if isinstance(backend, HierarchicalSyncBackend):
            # two-level agreement: the slice first, then the leaders, so a
            # dead remote slice cannot deadlock the intra-slice leg
            self._agree_on_cursor_hierarchical(backend)
            return
        cursors = _ints(backend.gather(self._cursor_tensor()))
        if len(set(cursors)) == 1:
            return
        # every rank computes the same verdict from the same gathered list,
        # so this second gather runs on all ranks or none
        common = _common(backend.gather(self._avail_tensor(self.journal.cursors_on_disk())))
        self._resolve_cursor_skew(cursors, common, scope="world")

    def _agree_on_cursor_hierarchical(self, backend: HierarchicalSyncBackend) -> None:
        """Two-level resume agreement. Level 0 (inside the slice) runs first
        and touches only slice-local links; level 1 compares the
        slice-agreed cursors between the slice leaders under the level-1
        policy. When the leader exchange fails terminally and degradation is
        allowed (the session's ``degraded_ok`` or the level-1 policy's), the
        session resumes on slice-local agreement with a partial quorum
        recorded."""
        topo = backend.topology
        policy = _rsync.active_policy()
        p0 = policy.for_level(0) if policy is not None else None
        p1 = policy.for_level(1) if policy is not None else None
        g0 = _rsync.apply_sync_policy(backend.gather_level0, policy=p0)
        g1 = _rsync.apply_sync_policy(backend.gather_level1, policy=p1)

        # level 0: the slice agrees first. The availability exchange runs
        # unconditionally: a slice whose cursors disagree must not make
        # extra level-0 rounds other slices skip (over_flat level-0 views
        # are world-wide collectives)
        if topo.slice_size > 1:
            cursors0 = _ints(g0(self._cursor_tensor()))
            slice_avail = _common(g0(self._avail_tensor(self.journal.cursors_on_disk())))
            if len(set(cursors0)) != 1:
                self._resolve_cursor_skew(cursors0, slice_avail, scope="slice")
        else:
            slice_avail = {c for c in self.journal.cursors_on_disk()[-self.journal.keep_last:] if c >= 0}
        # level 1: the leaders compare the slice-agreed cursors. Only the
        # gathers sit under the broad except: a skew verdict or a failed
        # local rollback is no transport failure and propagates as itself
        try:
            cursors1 = _ints(g1(self._cursor_tensor()))
        except Exception as err:  # noqa: BLE001 - leader exchange down
            self._partial_quorum_resume(backend, p1, err)
            return
        if len(set(cursors1)) != 1:
            try:
                common = _common(g1(self._avail_tensor(sorted(slice_avail))))
            except Exception as err:  # noqa: BLE001 - leader exchange down
                self._partial_quorum_resume(backend, p1, err)
                return
            self._resolve_cursor_skew(cursors1, common, scope="world")
        record_quorum(
            QuorumSnapshot(
                world_size=topo.world_size,
                num_slices=topo.num_slices,
                slices_present=tuple(range(topo.num_slices)),
                ranks_present=tuple(range(topo.world_size)),
                degraded_level=None,
                source="session",
            )
        )

    def _resolve_cursor_skew(self, cursors: List[int], common: set, scope: str) -> None:
        """Roll back to the newest generation the agreement scope still
        holds, degrade, or fail typed."""
        target = max(common) if common else None
        if target is None:
            msg = (
                f"replicas resumed with skewed step cursors {cursors} and"
                f" share no common checkpoint generation to roll back to"
                f" (agreement scope: {scope})"
            )
            if self.degraded_ok:
                warn_once(
                    "EvalSession.resume: " + msg + "; continuing on LOCAL"
                    " accounting (degraded_ok=True): replicas may disagree"
                    " on which batches are replays",
                    key=f"session-skew-degraded:{self.journal.directory}",
                )
                return
            raise SessionResumeError(msg + " (set degraded_ok=True to continue anyway)")
        if target != self.cursor:
            self._rollback_to_cursor(target, cursors)
        else:
            # this rank already sits at the agreement point; others roll back
            self.metric._session_cursor = self.cursor

    def _partial_quorum_resume(self, backend: HierarchicalSyncBackend, p1: Any, err: BaseException) -> None:
        topo = backend.topology
        sid = backend.slice_id
        lost = _lost_slice_from(err)
        quorum = QuorumSnapshot(
            world_size=topo.world_size,
            num_slices=topo.num_slices,
            slices_present=(sid,),
            ranks_present=tuple(topo.slices[sid]),
            degraded_level=1,
            lost_slices=(lost,) if lost is not None else tuple(s for s in range(topo.num_slices) if s != sid),
            source="session",
        )
        record_quorum(quorum)
        allowed = self.degraded_ok or (p1 is not None and p1.degraded_ok)
        if not allowed:
            raise SessionResumeError(
                "resume agreement could not reach the other slices"
                f" ({type(err).__name__}: {err}); set degraded_ok=True on the"
                " session or the level-1 SyncPolicy to resume on slice-local"
                " agreement with a partial quorum"
            ) from err
        self.stats["partial_quorum_resumes"] += 1
        # an event only: the terminal leader exchange already wrote this
        # fault's flight dump inside apply_sync_policy
        _flight.record(
            "session_partial_quorum", slice=sid, lost=list(quorum.lost_slices), error=f"{type(err).__name__}: {err}"
        )
        if _obs.enabled():
            _obs.get().count("reliability.session_partial_quorum_resumes")
            _obs.get().event("session_partial_quorum_resume", slice=sid, lost=list(quorum.lost_slices))
        warn_once(
            "EvalSession.resume: the level-1 leader exchange failed"
            f" terminally ({type(err).__name__}: {err}); resuming on"
            " SLICE-LOCAL agreement with a partial quorum"
            f" (slices_present={list(quorum.slices_present)}). The dropped"
            " slice's accounting will re-agree when it returns; counter:"
            " reliability.session_partial_quorum_resumes.",
            key=f"session-partial-quorum:{self.journal.directory}",
        )

    def _rollback_to_cursor(self, target: int, cursors: List[int]) -> None:
        # load the agreed generation (not the latest). Cursors resolve
        # through the same validated path cursors_on_disk() advertised them
        # by, so an advertised target is always honorable
        for record in reversed(self.journal.records()):
            envelope = self.journal._loadable_envelope(int(record["generation"]))
            if envelope is None:
                continue
            cursor = record.get("cursor")
            if cursor is None:
                cursor = _cursor_from_envelope(envelope)
            if cursor != target:
                continue
            self._load(envelope, dict(record, cursor=int(cursor)))
            self.stats["resume_rollbacks"] += 1
            if _obs.enabled():
                _obs.get().count("reliability.session_resume_rollbacks")
                _obs.get().event("session_resume_rollback", cursor=target, skewed=cursors)
            warn_once(
                f"EvalSession.resume: replicas disagreed on step cursors"
                f" {cursors}; this rank rolled back to the common generation"
                f" at cursor {target}",
                key=f"session-rollback:{self.journal.directory}",
            )
            return
        raise SessionResumeError(f"agreed rollback cursor {target} is no longer on disk in {self.journal.directory!r}")

    # ------------------------------------------------------------------
    # conveniences
    # ------------------------------------------------------------------
    def compute(self):
        """``metric.compute()`` passthrough (final, possibly synced value)."""
        return self.metric.compute()

    def __repr__(self) -> str:
        return (
            f"EvalSession(cursor={self.cursor},"
            f" dir={self.journal.directory!r},"
            f" every={self.checkpoint_every}, keep_last={self.journal.keep_last})"
        )
