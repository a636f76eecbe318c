"""Background checkpoints: the journal's commit is the only sync point.

Port of ``metrics_tpu/serving/bgcheckpoint.py``. A synchronous
``EvalSession.checkpoint()`` copies every state to the host, checksums,
serializes and fsyncs while the serve loop waits. Here only the snapshot
stays on that path:

1. at the barrier, on the caller's thread, every tensor state is cloned on
   the caller's current stream and an event is recorded after the clones
   (:func:`snapshot_pairs`, :meth:`BackgroundCheckpointer.submit`): kernels
   queued, nothing copied to the host; list states become shallow list
   copies (their tensors are never written in place);
2. a daemon writer makes its own stream wait on that event, copies the
   snapshot device-to-host into pinned buffers (``non_blocking=True``),
   synchronizes its own event, builds the checksummed envelope
   (``reliability.checkpoint.envelope_from_pairs``: the same spec and
   checksum as the synchronous envelope) and commits it through the
   :class:`~metrics_tpu_torch.reliability.CheckpointJournal`, whose atomic
   tmp-fsync-rename is the only synchronization with readers: a
   preemption mid-write leaves the previous generation intact.

The fetch runs on the writer's own stream because the synchronous one
(``Tensor.cpu()`` on the current stream) would, on a worker thread, run on
the legacy default stream and serialize with every kernel of the serve
loop.

Jobs coalesce: the mailbox holds one pending snapshot; a newer submission
replaces an unwritten older one (``serving.checkpoint.coalesced``). A
writer failure records one ``background_checkpoint_failure`` flight dump,
is parked, and re-raises at the next :meth:`BackgroundCheckpointer.drain`.
"""
import threading
import time
from contextlib import nullcontext
from typing import Any, Dict, List, Optional, Tuple

import torch

from metrics_tpu_torch.observability import flight as _flight
from metrics_tpu_torch.observability import telemetry as _obs
from metrics_tpu_torch.observability import trace as _trace

__all__ = ["BackgroundCheckpointer", "snapshot_pairs"]

def snapshot_pairs(obj: Any) -> List[Tuple[str, Any]]:
    """A snapshot of ``obj._named_states()``: tensor states cloned on the
    current stream (queued, no host copy), list states as shallow copies."""
    pairs = []
    for key, value in obj._named_states():
        if isinstance(value, list):
            pairs.append((key, list(value)))
        elif isinstance(value, torch.Tensor):
            pairs.append((key, value.detach().clone()))
        else:
            pairs.append((key, value))
    return pairs


def _cuda_device(pairs: List[Tuple[str, Any]]) -> Optional[torch.device]:
    for _, value in pairs:
        for v in value if isinstance(value, list) else [value]:
            if isinstance(v, torch.Tensor) and v.is_cuda:
                return v.device
    return None


def _pinned(v: Any) -> Any:
    """A CUDA tensor's copy into pinned host memory, queued on the current
    stream; anything else as it is."""
    if isinstance(v, torch.Tensor) and v.is_cuda:
        host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host.copy_(v, non_blocking=True)
        return host
    return v


class BackgroundCheckpointer:
    """One daemon writer committing snapshots through a journal.

    Args:
        journal: the :class:`~metrics_tpu_torch.reliability.CheckpointJournal`
            this writer owns. Every commit to it while the writer lives goes
            through here (:meth:`submit`, or :meth:`commit_sync` where
            durability cannot wait): the writer serializes them, so two
            writers never interleave a manifest update.

    Attributes:
        stats: ``commits``, ``coalesced`` and ``errors``.
    """

    def __init__(self, journal: Any):
        self._journal = journal
        self._lock = threading.Lock()
        self._lock_cond = threading.Condition(self._lock)
        # commits hold this lock, not the mailbox lock: a submit never
        # waits behind a fetch and fsync in flight
        self._commit_lock = threading.Lock()
        self._pending: Optional[Dict[str, Any]] = None
        self._busy = False
        self._error: Optional[BaseException] = None
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        # the fetch streams, one per device (made on first use)
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self.stats: Dict[str, int] = {"commits": 0, "coalesced": 0, "errors": 0}

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(
        self,
        pairs: List[Tuple[str, Any]],
        metric_type: str,
        cursor: int,
        note: Optional[str] = None,
        flow: Any = None,
    ) -> Dict[str, Any]:
        """Queue one snapshot for a background commit; returns a pending
        descriptor (``{"pending": True, "cursor", "note", "flow"}``: the
        generation exists only once the writer commits). An unwritten older
        snapshot in the mailbox is replaced. ``flow`` names the batch ids
        the snapshot covers (``AsyncServingEngine.last_flow``), default the
        submitting thread's pinned flow; the writer's commit span joins
        that flow."""
        if self._closed:
            raise RuntimeError("BackgroundCheckpointer is closed")
        job = self._make_job(pairs, metric_type, cursor, note, flow)
        with self._lock:
            coalesced = self._pending is not None
            if coalesced:
                self.stats["coalesced"] += 1
            self._pending = job
            self._lock_cond.notify_all()
        if coalesced and _obs.enabled():
            _obs.get().count("serving.checkpoint.coalesced")
        self._ensure_worker()
        return {"pending": True, "cursor": int(cursor), "note": note, "flow": job["flow"]}

    @staticmethod
    def _make_job(pairs, metric_type, cursor, note, flow) -> Dict[str, Any]:
        if flow is None:
            flow = _trace.current_flow()
        device = _cuda_device(pairs)
        ready = None
        if device is not None:
            # after the snapshot's clones on the caller's stream
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
        return {
            "pairs": pairs,
            "metric_type": metric_type,
            "cursor": int(cursor),
            "note": note,
            "flow": list(flow) if flow else None,
            "device": device,
            "ready": ready,
            # serving.latency.checkpoint_commit_ms: submit to durable commit
            "t_submit_ns": time.perf_counter_ns(),
        }

    def commit_sync(
        self,
        pairs: List[Tuple[str, Any]],
        metric_type: str,
        cursor: int,
        note: Optional[str] = None,
        flow: Any = None,
    ) -> Dict[str, Any]:
        """Drain the queued snapshot, then commit this one inline and return
        its manifest record (protective checkpoints: durability cannot
        wait)."""
        self.drain(raise_errors=False)
        job = self._make_job(pairs, metric_type, cursor, note, flow)
        with self._commit_lock:
            record = self._observed_commit(job)
        with self._lock:
            self.stats["commits"] += 1
        if _obs.enabled():
            _obs.get().count("serving.checkpoint.commits")
        return record

    # ------------------------------------------------------------------
    # the writer
    # ------------------------------------------------------------------
    def _ensure_worker(self) -> None:
        with self._lock:
            if self._worker is not None:
                return
            worker = threading.Thread(target=self._worker_loop, name="metrics-tpu-bgcheckpoint", daemon=True)
            self._worker = worker
        worker.start()

    def _worker_loop(self) -> None:
        while True:
            with self._lock:
                while self._pending is None and not self._closed:
                    self._lock_cond.wait()
                if self._pending is None and self._closed:
                    return
                job, self._pending = self._pending, None
                self._busy = True
            try:
                with self._commit_lock:
                    self._observed_commit(job)
                with self._lock:
                    self.stats["commits"] += 1
                if _obs.enabled():
                    _obs.get().count("serving.checkpoint.commits")
            except BaseException as err:  # noqa: BLE001 - parked for the barrier
                with self._lock:
                    self.stats["errors"] += 1
                    if self._error is None:
                        self._error = err
                _flight.dump_on_failure(
                    "background_checkpoint_failure", cursor=job["cursor"], error=f"{type(err).__name__}: {err}"
                )
            finally:
                del job
                with self._lock:
                    self._busy = False
                    self._lock_cond.notify_all()

    def _observed_commit(self, job: Dict[str, Any]) -> Dict[str, Any]:
        """One commit under the job's flow (the ``checkpoint.commit`` span
        on the writer's track), observing the submit-to-commit latency on
        success. The caller holds ``_commit_lock``."""
        flow = job.get("flow")
        with _trace.flow_scope(flow) if flow else nullcontext():
            with _trace.span("checkpoint.commit", phase="checkpoint", cursor=job["cursor"]):
                record = self._commit_job(job)
        if _obs.enabled():
            dt_ms = (time.perf_counter_ns() - job["t_submit_ns"]) / 1e6
            _obs.get().observe_hist("serving.latency.checkpoint_commit_ms", dt_ms, _obs.LATENCY_BUCKETS_MS)
        return record

    def _fetch(self, job: Dict[str, Any]) -> List[Tuple[str, Any]]:
        """The snapshot on the host: on the card, copied into pinned buffers
        on this writer's own stream after the snapshot's event, then this
        stream's event synchronized."""
        ready = job["ready"]
        if ready is None:
            return job["pairs"]
        device = job["device"]
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device=device)
        with torch.cuda.device(device), torch.cuda.stream(stream):
            stream.wait_event(ready)
            host = [(k, [_pinned(x) for x in v] if isinstance(v, list) else _pinned(v)) for k, v in job["pairs"]]
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()
        return host

    def _commit_job(self, job: Dict[str, Any]) -> Dict[str, Any]:
        """Fetch, envelope, journal commit. Runs under ``_commit_lock``, so
        commits serialize; the one seam fault injection tears
        (``faultinject.preempt_at_step(during="background_write")``)."""
        from metrics_tpu_torch.reliability.checkpoint import envelope_from_pairs

        envelope = envelope_from_pairs(self._fetch(job), metric_type=job["metric_type"])
        return self._journal.commit(envelope, job["cursor"], note=job["note"])

    # ------------------------------------------------------------------
    # barriers / lifecycle
    # ------------------------------------------------------------------
    def drain(self, timeout_s: Optional[float] = 60.0, raise_errors: bool = True) -> None:
        """Block until the mailbox is empty and the writer idle, then
        re-raise (and clear) the first parked error. ``raise_errors=False``
        (protective commits, resume) leaves a parked error parked for the
        next raising barrier."""
        if threading.current_thread() is self._worker:
            return
        with self._lock_cond:
            if not self._lock_cond.wait_for(lambda: self._pending is None and not self._busy, timeout=timeout_s):
                raise TimeoutError(f"background checkpoint drain did not clear within {timeout_s}s")
            if not raise_errors:
                return
            err, self._error = self._error, None
        if err is not None:
            raise err

    def close(self) -> None:
        """Drain and stop the writer (idempotent; never raises: it runs from
        finalizers). A parked error stays parked: an explicit ``drain()``
        before closing is where failures surface."""
        if self._closed:
            return
        try:
            self.drain(raise_errors=False)
        except Exception:  # noqa: BLE001 - a wedged drain must not break teardown
            pass
        finally:
            with self._lock:
                self._closed = True
                worker, self._worker = self._worker, None
                self._lock_cond.notify_all()
            if worker is not None:
                worker.join(timeout=30.0)

    def __repr__(self) -> str:
        return (
            f"BackgroundCheckpointer(dir={getattr(self._journal, 'directory', None)!r},"
            f" commits={self.stats['commits']}, pending={self._pending is not None})"
        )
