"""Streaming admission: flat tagged rows in, cohort dispatches out.

Port of ``metrics_tpu/serving/ingest.py``. Serving traffic arrives as
interleaved flat streams tagged with a tenant id, not as dense
``(tenants, rows, ...)`` stacks. :class:`IngestQueue` sits between such a
stream and a :class:`~metrics_tpu_torch.MetricCohort` (directly, or behind an
:class:`~metrics_tpu_torch.serving.AsyncServingEngine`):

* **Bounded buffering**: per-tenant row buffers capped at
  ``max_buffered_rows`` in all; the bound is what makes backpressure real.
* **Micro-batching**: a wave dispatches when every live tenant holds at
  least ``rows_per_step`` rows. Waves coalesce: when every tenant holds
  ``k × rows_per_step`` rows one dispatch folds ``k`` steps, ``k`` a power
  of two up to ``coalesce_max`` (at most ``log2`` extra step signatures).
* **Routing**: the wave is rebuilt on the host (numpy) in arrival order and
  routed by :func:`~metrics_tpu_torch.cohort.route_rows` on host tensors (the
  ids are read there, so no device synchronization), then each array is
  copied to the cohort's device once, pinned and non-blocking.
* **Backpressure** (``policy=``): ``block`` waits (``block_timeout_s``, then
  :class:`IngestOverflowError`), correctness over availability;
  ``shed_oldest`` drops the oldest buffered rows (``serving.ingest.shed_rows``);
  ``shed_by_health`` sheds tenants the cohort's health marks poisoned or
  stale first, and shedding a healthy tenant's rows is never silent
  (``serving.ingest.shed_healthy_rows`` and one ``ingest_shed_healthy``
  flight dump).

Row tails smaller than ``rows_per_step`` stay buffered until more rows
arrive; :meth:`IngestQueue.flush` dispatches every full wave and reports
what stayed pending. ``redelivery_window`` keeps dispatched waves for
at-least-once redelivery (:meth:`IngestQueue.ack_watermark`,
:meth:`IngestQueue.redeliver`).
"""
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.cohort import MetricCohort, route_rows
from metrics_tpu_torch.observability import flight as _flight
from metrics_tpu_torch.observability import telemetry as _obs
from metrics_tpu_torch.observability import trace as _trace

__all__ = ["IngestQueue", "IngestOverflowError"]

_POLICIES = ("block", "shed_oldest", "shed_by_health")


class IngestOverflowError(RuntimeError):
    """``policy="block"`` waited ``block_timeout_s`` and the buffer was
    still over its bound (a wedged consumer, or a tenant that stopped
    contributing and stalled the wave)."""


class IngestQueue:
    """Bounded streaming admission in front of a cohort.

    Args:
        target: the :class:`~metrics_tpu_torch.MetricCohort` to feed, or an
            :class:`~metrics_tpu_torch.serving.AsyncServingEngine` wrapping one
            (waves then dispatch without blocking the submitter).
        rows_per_step: rows each tenant contributes per cohort step (the
            micro-batch grain).
        max_buffered_rows: total buffered-row bound across tenants.
        policy: backpressure policy (see module docs).
        coalesce_max: largest power-of-two wave multiple one dispatch may
            fold (1 disables coalescing).
        stale_after: ``shed_by_health`` staleness threshold, in cohort
            dispatches (forwarded to :meth:`MetricCohort.health`).
        block_timeout_s: ``block`` policy wait bound before
            :class:`IngestOverflowError`.
        redelivery_window: waves retained AFTER dispatch for at-least-once
            redelivery (0 disables). This is the fleet-failover seam: a
            promoted replica holds tenant state only up to the last
            replicated watermark; :meth:`redeliver` replays the retained
            waves and the shard's replay guard drops whatever the replica
            already covered, so the promoted shard converges without the
            stream's source rewinding. :meth:`ack_watermark` releases
            waves once replication has made them durable at the follower.

    Usage::

        q = IngestQueue(cohort, rows_per_step=64, max_buffered_rows=65536)
        q.submit(tenant_ids, preds, target)     # flat tagged rows
        ...
        q.flush(); values = cohort.compute()
    """

    def __init__(
        self,
        target: Any,
        rows_per_step: int,
        max_buffered_rows: int = 1 << 20,
        policy: str = "block",
        coalesce_max: int = 4,
        stale_after: int = 16,
        block_timeout_s: float = 30.0,
        redelivery_window: int = 0,
    ):
        if policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}, got {policy!r}")
        if int(rows_per_step) < 1:
            raise ValueError(f"rows_per_step must be >= 1, got {rows_per_step}")
        if int(max_buffered_rows) < int(rows_per_step):
            raise ValueError(
                "max_buffered_rows must hold at least one tenant's step"
                f" ({rows_per_step} rows), got {max_buffered_rows}"
            )
        cohort = target.target if hasattr(target, "target") else target
        if not isinstance(cohort, MetricCohort):
            raise TypeError(
                "IngestQueue feeds a MetricCohort (directly or behind an"
                f" AsyncServingEngine); got {type(cohort).__name__}"
            )
        self._target = target
        self._cohort = cohort
        self.rows_per_step = int(rows_per_step)
        self.max_buffered_rows = int(max_buffered_rows)
        self.policy = policy
        self.coalesce_max = max(1, int(coalesce_max))
        self.stale_after = int(stale_after)
        self.block_timeout_s = float(block_timeout_s)
        self._lock = threading.Lock()
        self._lock_cond = threading.Condition(self._lock)
        # one dispatcher at a time: wave pop + downstream dispatch happen
        # under THIS lock (not the buffer lock — submitters keep buffering
        # while a dispatch runs) so two concurrent submitters can never
        # drive the cohort's forward concurrently or reorder waves
        self._wave_lock = threading.Lock()
        # per-tenant FIFO of (arrival_seq, [row-chunk per input position],
        # flow): chunks keep arrival order so shedding drops the OLDEST
        # rows; `flow` is the submission's causal batch id (None when
        # tracing was off at admission) — it rides every chunk so the
        # wave that eventually dispatches those rows can link itself to
        # the submissions it folded (Perfetto flow arrows)
        self._buffers: Dict[int, deque] = {}
        self._seq = 0
        self._buffered_rows = 0
        self._n_arrays: Optional[int] = None
        self._unhealthy: set = set()
        self.redelivery_window = max(0, int(redelivery_window))
        # (wave_seq, flat_tenant_ids, flat_arrays) per retained wave,
        # oldest first; mutated only under the wave lock (retention rides
        # the dispatch) or the buffer lock (ack/redeliver bookkeeping)
        self._retained: deque = deque()
        self._wave_seq = 0
        self.stats: Dict[str, int] = {
            "admitted_rows": 0,
            "shed_rows": 0,
            "shed_healthy_rows": 0,
            "drained_rows": 0,
            "dispatches": 0,
            "redelivered_rows": 0,
        }

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def submit(self, tenant_ids: Any, *arrays: Any) -> int:
        """Admit flat tagged rows: ``tenant_ids[i]`` names the cohort slot
        row ``i`` of every array belongs to. Applies backpressure when the
        buffer bound is hit, then buffers and dispatches every wave that
        became ready. Returns the number of rows admitted (== submitted,
        except under a shed policy that had to drop the submission's own
        overflow)."""
        if not arrays:
            raise ValueError("submit needs at least one row array")
        tenant_ids = np.asarray(tenant_ids)
        if tenant_ids.ndim != 1:
            raise ValueError(
                f"tenant_ids must be rank-1, got shape {tenant_ids.shape}"
            )
        rows = [np.asarray(a) for a in arrays]
        for a in rows:
            if a.shape[:1] != tenant_ids.shape:
                raise ValueError(
                    f"row array leading dim {a.shape[:1]} != tenant_ids"
                    f" {tenant_ids.shape}"
                )
        with self._lock:
            if self._n_arrays is None:
                self._n_arrays = len(rows)
            elif len(rows) != self._n_arrays:
                raise ValueError(
                    f"submit carries {len(rows)} arrays; earlier submissions"
                    f" carried {self._n_arrays}"
                )
        n = int(tenant_ids.shape[0])
        if n > self.max_buffered_rows:
            raise ValueError(
                f"one submission of {n} rows exceeds max_buffered_rows"
                f" ({self.max_buffered_rows}): no amount of backpressure or"
                " shedding could ever admit it — split the stream or raise"
                " the bound"
            )
        # validation BEFORE backpressure: a rejected submission must never
        # shed (or block on) other tenants' good rows first
        unique_ids = np.unique(tenant_ids)
        live = set(self._cohort.tenant_ids())
        unknown = sorted(set(unique_ids.tolist()) - live)
        if unknown:
            raise KeyError(
                f"submission names tenants {unknown} not live in the cohort"
                f" (live: {sorted(live)})"
            )
        # one causal batch id per admitted submission: the ingest chunk
        # is where the admission→...→checkpoint chain starts, so the id
        # is issued HERE and rides the buffered chunks into the wave
        flow = _trace.next_batch_id() if _trace.tracing_enabled() else None
        # the module-level span helper is the enabled gate (null context
        # when tracing is off — same idiom as every other call site)
        with _trace.span("ingest.submit", phase="ingest", flow=flow, rows=n):
            self._make_room(n)
            with self._lock:
                for tid in unique_ids:
                    mask = tenant_ids == tid
                    chunk = [a[mask] for a in rows]
                    self._buffers.setdefault(int(tid), deque()).append(
                        (self._seq, chunk, flow)
                    )
                    self._seq += 1
                self._buffered_rows += n
                self.stats["admitted_rows"] += n
        if _obs.enabled():
            _obs.get().count("serving.ingest.admitted_rows", n)
            _obs.get().gauge("serving.ingest.buffered_rows", self._buffered_rows)
        self._dispatch_ready_waves()
        return n

    # ------------------------------------------------------------------
    # backpressure
    # ------------------------------------------------------------------
    def _make_room(self, incoming: int) -> None:
        if self.policy == "block":
            deadline_waited = 0.0
            step = 0.05
            while True:
                self._dispatch_ready_waves()
                with self._lock:
                    if self._buffered_rows + incoming <= self.max_buffered_rows:
                        return
                    self._lock_cond.wait(timeout=step)
                deadline_waited += step
                if deadline_waited >= self.block_timeout_s:
                    raise IngestOverflowError(
                        f"ingest buffer held {self._buffered_rows} rows"
                        f" (bound {self.max_buffered_rows}) for"
                        f" {self.block_timeout_s}s with policy='block' —"
                        " the consumer is wedged or a tenant stalled the"
                        " wave; use a shed policy for lossy availability"
                    )
        # shed policies: drop buffered rows until the submission fits
        overflow = []
        healthy_shed = 0
        with self._lock:
            need = self._buffered_rows + incoming - self.max_buffered_rows
            if need <= 0:
                return
            order = self._shed_order()
            shed = 0
            for tid in order:
                buf = self._buffers.get(tid)
                while buf and shed < need:
                    _, chunk, _ = buf.popleft()
                    k = int(chunk[0].shape[0])
                    shed += k
                    overflow.append((tid, k))
                    if self.policy == "shed_by_health" and tid not in self._unhealthy:
                        healthy_shed += k
                if shed >= need:
                    break
            self._buffered_rows -= shed
            self.stats["shed_rows"] += shed
            self.stats["shed_healthy_rows"] += healthy_shed
        if shed and _obs.enabled():
            _obs.get().count("serving.ingest.shed_rows", shed)
            _obs.get().gauge("serving.ingest.buffered_rows", self._buffered_rows)
        if shed and _flight.flight_enabled():
            _flight.record(
                "ingest_shed",
                policy=self.policy,
                rows=shed,
                tenants=sorted({t for t, _ in overflow}),
            )
        if healthy_shed:
            # the loud path: shed_by_health exists to protect healthy
            # tenants' data — dropping it anyway (every unhealthy buffer
            # already empty) must never be silent
            if _obs.enabled():
                _obs.get().count("serving.ingest.shed_healthy_rows", healthy_shed)
            _flight.dump_on_failure(
                "ingest_shed_healthy",
                policy=self.policy,
                rows=healthy_shed,
                tenants=sorted({t for t, _ in overflow}),
            )

    def _shed_order(self) -> List[int]:
        """Tenant order shedding walks (oldest-first within each tenant).
        ``shed_oldest``: globally oldest chunk first. ``shed_by_health``:
        unhealthy tenants (poisoned, then stale) before any healthy one;
        ``self._unhealthy`` caches the verdict for the healthy-shed
        accounting above. Caller holds the lock."""
        heads = {
            tid: buf[0][0] for tid, buf in self._buffers.items() if buf
        }
        oldest_first = sorted(heads, key=heads.get)
        if self.policy == "shed_oldest":
            self._unhealthy: set = set()
            return oldest_first
        unhealthy: set = set()
        health = None
        try:
            health = self._cohort.health(stale_after=self.stale_after)
        except Exception:  # noqa: BLE001 — health is advisory for shedding
            health = None
        if health is not None:
            for i, tid in enumerate(health["tenants"]):
                poisoned = (
                    int(health["nonfinite"][i]) > 0
                    or int(health["guard_verdicts"][i]) > 0
                )
                stale = int(health["staleness"][i]) >= self.stale_after
                if poisoned or stale:
                    unhealthy.add(int(tid))
        self._unhealthy = unhealthy
        return [t for t in oldest_first if t in unhealthy] + [
            t for t in oldest_first if t not in unhealthy
        ]

    # ------------------------------------------------------------------
    # wave dispatch
    # ------------------------------------------------------------------
    def _ready_multiple(self) -> int:
        """Largest power-of-two wave multiple every live tenant can fill
        (0 = no wave ready). Caller holds the lock."""
        live = self._cohort.tenant_ids()
        if not live:
            return 0
        B = self.rows_per_step
        k = None
        for tid in live:
            have = sum(
                int(c[0].shape[0]) for _, c, _ in self._buffers.get(tid, ())
            )
            steps = have // B
            k = steps if k is None else min(k, steps)
            if k == 0:
                return 0
        m = 1
        while m * 2 <= min(k, self.coalesce_max):
            m *= 2
        return m

    def _take_rows(self, tid: int, count: int) -> List[Tuple[int, List[np.ndarray], Any]]:
        """Pop exactly ``count`` buffered rows for one tenant (splitting a
        chunk when needed); returns ``(arrival_seq, chunk_arrays, flow)``
        triples so the wave can be rebuilt in arrival order and linked to
        the submissions it folded. A split chunk keeps its flow id on
        both halves (the submission's rows ride two waves — both waves
        are causally downstream of it). Caller holds the lock."""
        out: List[Tuple[int, List[np.ndarray], Any]] = []
        buf = self._buffers[tid]
        remaining = count
        while remaining > 0:
            seq, chunk, flow = buf[0]
            k = int(chunk[0].shape[0])
            if k <= remaining:
                buf.popleft()
                out.append((seq, chunk, flow))
                remaining -= k
            else:
                out.append((seq, [a[:remaining] for a in chunk], flow))
                buf[0] = (seq, [a[remaining:] for a in chunk], flow)
                remaining = 0
        return out

    def _dispatch_ready_waves(self) -> int:
        """Dispatch every wave currently ready; returns waves dispatched.
        The dispatch runs OUTSIDE the buffer lock (an async target may
        block on its own depth bound; holding the buffer lock across that
        would stall concurrent submitters' buffering) but UNDER the wave
        lock: pop + dispatch are one atomic unit, so concurrent
        submitters can neither drive the cohort's forward concurrently
        nor install waves out of arrival order."""
        dispatched = 0
        while True:
            with self._wave_lock:
                with self._lock:
                    m = self._ready_multiple()
                    if m == 0:
                        return dispatched
                    live = self._cohort.tenant_ids()
                    take = m * self.rows_per_step
                    per_tenant = {tid: self._take_rows(tid, take) for tid in live}
                    self._buffered_rows -= take * len(live)
                    self.stats["dispatches"] += 1
                    self._lock_cond.notify_all()
                dispatched += self._dispatch_wave(live, per_tenant)

    def _dispatch_wave(self, live, per_tenant) -> int:
        """One popped wave → route_rows → downstream dispatch (runs under
        the wave lock). The wave is rebuilt in ARRIVAL order (interleaved
        across tenants, exactly as the stream delivered it) with DENSE
        tenant positions (live slots need not be contiguous); route_rows
        then does the real routing work — one stable argsort + gather per
        array — into the stacked layout. The wave pins the flow ids of
        every submission it folded (``flow_scope``), so the routing span,
        the downstream dispatch, and — through an async pipeline — the
        eventual write-back all link back to their ingest chunks."""
        pos = {tid: i for i, tid in enumerate(live)}
        pieces: List[Tuple[int, int, List[np.ndarray], Any, int]] = []
        for tid in live:
            for seq, chunk, flow in per_tenant[tid]:
                pieces.append((seq, pos[tid], chunk, flow, tid))
        pieces.sort(key=lambda p: p[0])
        flows = tuple(sorted({p[3] for p in pieces if p[3] is not None}))
        # flow_scope(None) pins nothing; the span helper is a null
        # context when tracing is off — one code path, per-wave cost
        with _trace.flow_scope(flows or None), _trace.span(
            "ingest.wave", phase="ingest", tenants=len(live), batches=len(flows)
        ):
            self._route_and_dispatch(pieces, live)
        return 1

    def _route_and_dispatch(self, pieces, live) -> None:
        flat_ids = np.concatenate(
            [np.full(c[0].shape[0], p, dtype=np.int32) for _, p, c, *_ in pieces]
        )
        flat_arrays = [
            np.concatenate([c[i] for _, _, c, *_ in pieces], axis=0)
            for i in range(self._n_arrays)
        ]
        # routed on the host (the ids are read there: no device sync), then
        # one pinned, non-blocking host-to-device copy per array
        routed = route_rows(
            torch.from_numpy(flat_ids),
            *[torch.from_numpy(a) for a in flat_arrays],
            num_tenants=len(live),
        )
        if self._n_arrays == 1:
            routed = (routed,)
        device = self._cohort._device
        if device.type == "cuda":
            routed = tuple(r.pin_memory().to(device, non_blocking=True) for r in routed)
        if _obs.enabled():
            _obs.get().count("serving.ingest.dispatches")
            _obs.get().gauge("serving.ingest.buffered_rows", self._buffered_rows)
        self._wave_seq += 1
        if self.redelivery_window:
            # retain the wave's flat rows under their ORIGINAL tenant ids
            # (positions are wave-local; redelivery re-routes from scratch)
            flat_tids = np.concatenate(
                [np.full(c[0].shape[0], t, dtype=np.int64) for _, _, c, _, t in pieces]
            )
            self._retained.append((self._wave_seq, flat_tids, flat_arrays))
            while len(self._retained) > self.redelivery_window:
                self._retained.popleft()
            if _obs.enabled():
                _obs.get().gauge(
                    "serving.ingest.redelivery_depth", len(self._retained)
                )
        self._target(*routed)

    def flush(self) -> int:
        """Dispatch every ready wave now; returns the number of rows still
        buffered (tails smaller than one wave stay pending — they ship
        when more rows arrive, or are read off :attr:`buffered_rows`)."""
        self._dispatch_ready_waves()
        return self.buffered_rows

    def drain_tenant(self, tenant: int) -> Optional[List[np.ndarray]]:
        """Pop EVERYTHING buffered for one tenant and return it as one
        concatenated array per input position (arrival order preserved),
        or None when nothing is buffered. This is the migration escape
        hatch: rows admitted for a tenant that is then removed mid-stream
        would otherwise sit stranded until a shed policy drops them —
        admitted rows must either dispatch here or travel with the
        tenant, never silently vanish. Draining frees buffer budget, so
        blocked submitters are woken."""
        tid = int(tenant)
        with self._lock:
            buf = self._buffers.pop(tid, None)
            if not buf:
                return None
            rows = sum(int(c[0].shape[0]) for _, c, _ in buf)
            self._buffered_rows -= rows
            self.stats["drained_rows"] += rows
            self._lock_cond.notify_all()
        out = [
            np.concatenate([c[i] for _, c, _ in buf], axis=0)
            for i in range(self._n_arrays)
        ]
        if _obs.enabled():
            _obs.get().count("serving.ingest.drained_rows", rows)
            _obs.get().gauge("serving.ingest.buffered_rows", self.buffered_rows)
        return out

    # ------------------------------------------------------------------
    # redelivery (failover convergence seam)
    # ------------------------------------------------------------------
    @property
    def last_wave_seq(self) -> int:
        """Monotonic sequence number of the most recently dispatched wave
        (0 before any dispatch) — what replication records as its
        watermark and later hands to :meth:`ack_watermark`."""
        with self._wave_lock:
            return self._wave_seq

    def ack_watermark(self, seq: int) -> int:
        """Release retained waves with sequence ``<= seq`` — replication
        confirmed everything up to that wave durable at the follower, so
        redelivery can never need it again. Returns waves still retained."""
        with self._wave_lock:
            while self._retained and self._retained[0][0] <= int(seq):
                self._retained.popleft()
            depth = len(self._retained)
        if _obs.enabled():
            _obs.get().gauge("serving.ingest.redelivery_depth", depth)
        return depth

    def redeliver(self, submit: Optional[Any] = None, after_seq: int = 0) -> int:
        """Re-submit every retained wave with sequence ``> after_seq``, in
        dispatch order, through ``submit(tenant_ids, *arrays)`` (default:
        this queue's own :meth:`submit` — the post-failover pattern passes
        the promoted fleet's ingest path instead). The receiving shard's
        replay guard deduplicates anything the replica already covered;
        redelivery is at-least-once by construction, exactly-once by the
        guard. Returns rows redelivered."""
        with self._wave_lock:
            waves = [
                (s, tids, arrs)
                for s, tids, arrs in self._retained
                if s > int(after_seq)
            ]
        sink = submit if submit is not None else self.submit
        rows = 0
        for _, tids, arrs in waves:
            sink(tids, *arrs)
            rows += int(tids.shape[0])
        self.stats["redelivered_rows"] += rows
        if rows and _obs.enabled():
            _obs.get().count("serving.ingest.redelivered_rows", rows)
        return rows

    @property
    def buffered_rows(self) -> int:
        with self._lock:
            return self._buffered_rows

    def __repr__(self) -> str:
        return (
            f"IngestQueue(rows_per_step={self.rows_per_step},"
            f" buffered={self.buffered_rows}/{self.max_buffered_rows},"
            f" policy={self.policy!r})"
        )
