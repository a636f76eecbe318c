"""Asynchronous double-buffered dispatch: ``forward()`` stops blocking the
serve loop on the metric's step.

Port of ``metrics_tpu/serving/async_engine.py``. :class:`AsyncServingEngine`
stages each batch into a bounded queue (two slots by default: one batch
being stepped, one staged) and returns; a daemon worker pops the batches
and runs the target's forward, so the serve loop's next step overlaps the
metric's. ``drain()`` is the barrier: it returns once every staged batch
is folded into state and re-raises the first batch error the worker
parked. ``compute()``, ``state_dict()`` and a direct ``target.compute()``
(enrolling hooks it) run behind it.

Admission, as in the JAX package: every member must be engine-eligible, no
member class may stash a registered state in a plain attribute or reseed
one from one (the AST check), and the engine's read of the states and its
write-back must run inside one lock extent. A refused target is served on
the blocking path (``strict=True`` raises :class:`ServingAdmissionError`).
The JAX package then traces a two-generation program at the first batch;
the port, which donates nothing, runs the first batch on the caller thread
and checks the real tensors it installed
(``analysis.concurrency.first_dispatch_hazards``): on the card those are
the CUDA graph's static buffers, which only a real replay makes. The traced
prover (``CompiledStepEngine.abstract_double_buffer_step`` with
``analysis.concurrency.composed_generation_hazards``, and
``evidence["double_buffer"]`` of the program audit) is its cross-check.

What CUDA needs that JAX's asynchronous dispatch gave for free:

* **A stream of its own.** The worker enters ``torch.cuda.device`` of the
  target's device (a new thread starts on device 0) and steps on a
  ``torch.cuda.Stream`` the pipeline owns, so its kernels overlap the serve
  loop's.
* **Ordering into the worker.** ``forward()`` records an event on the
  caller's current stream; the worker's stream waits on it before the step
  copies the batch in, so the batch's producer kernels come first.
* **Lifetimes.** Every CUDA input is marked ``record_stream`` on the
  worker's stream at ``forward()``, and the queued job holds it until the
  step is enqueued; the worker marks the states it reads the same way
  before it replaces them. Without that the caching allocator could hand
  a block back to the caller's stream while the worker's copy of it is
  still queued.
* **Ordering back.** ``drain()`` makes the caller's current stream wait on
  the worker's last completion event (no host synchronization), so states
  read after the barrier are the final ones.
* **No warm-up on the worker.** Building a step signature warms it up under
  PyTorch's sync debug mode "error", which is process-global: a warm-up on
  the worker would make every synchronizing call of the serve loop raise
  meanwhile. So the first batch, and every batch whose signature the
  engine has not built (``CompiledStepEngine.is_built``), waits for the
  worker to go idle and runs on the caller thread, on the caller's stream.
  Only built signatures go to the worker. Such a batch is still a pipeline
  dispatch: its counters, latencies, spans and parked errors are the
  worker's.

Latencies keep the JAX package's meaning: ``serving.latency.dispatch_ms``
and ``e2e_ms`` end when the dispatch has returned (its kernels queued), not
when the card has finished.
"""
import queue
import threading
import time
import weakref
from collections import deque
from contextlib import nullcontext
from typing import Any, Dict, List, Optional

import torch

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.engine import CompiledStepEngine
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.observability import flight as _flight
from metrics_tpu_torch.observability import telemetry as _obs
from metrics_tpu_torch.observability import trace as _trace
from metrics_tpu_torch.utilities.prints import warn_once

__all__ = ["AsyncServingEngine", "ServingAdmissionError"]

#: two slots: one batch being stepped, one staged (the double buffer)
_DEFAULT_DEPTH = 2

_SENTINEL = object()  # worker shutdown marker


class ServingAdmissionError(ValueError):
    """The target failed async admission (``strict=True``): a member is not
    engine-eligible, or the double-buffer checks refused it."""


def _members(target: Any) -> Dict[str, Metric]:
    if isinstance(target, Metric):
        return {"metric": target}
    return dict(target.items())


def _admission_refusal(target: Any) -> Optional[str]:
    """Why ``target`` cannot serve asynchronously, or None when the checks
    made at enrollment all pass."""
    from metrics_tpu_torch.analysis import concurrency as _conc
    from metrics_tpu_torch.cohort import MetricCohort

    if not isinstance(target, (MetricCohort, MetricCollection, Metric)):
        return f"unsupported serving target {type(target).__name__}"
    members = _members(target)
    if not members:
        return "target has no member metrics"
    for name, m in members.items():
        reason = CompiledStepEngine._static_ineligibility(m)
        if reason is not None:
            return f"member {name!r} is not engine-eligible: {reason}"
        hazards = _conc._host_reference_hazards(type(m), set(m._defaults))
        if hazards:
            flavor, method, attr, lineno = hazards[0]
            return (
                f"member {name!r} carries an MTA009 host-reference hazard"
                f" ({flavor}: {type(m).__name__}.{method} line {lineno},"
                f" attr {attr!r}): two generations would share a held tensor"
            )
    if not _conc.writeback_generation_monotonic():
        return (
            "the engine's state read and write-back do not run inside one"
            " lock extent (MTA009): generations could install out of order"
        )
    return None


class AsyncServingEngine:
    """Serve a metric target without blocking the caller on its step.

    Args:
        target: a :class:`~metrics_tpu_torch.Metric`,
            :class:`~metrics_tpu_torch.MetricCollection` or
            :class:`~metrics_tpu_torch.MetricCohort`. Collections and cohorts
            step through their own engine; a bare metric gets a
            :class:`CompiledStepEngine` of its own.
        depth: staged-batch bound (default 2, the double buffer). The caller
            blocks only when ``depth`` batches are outstanding.
        strict: raise :class:`ServingAdmissionError` on refusal instead of
            serving on the blocking path.
        slo: a :class:`~metrics_tpu_torch.serving.ServingSLO` evaluated after
            every staged and served batch.

    Example::

        pipe = AsyncServingEngine(MetricCollection([...], compiled=True))
        for batch in stream:
            pipe.forward(*batch)      # returns at once
        values = pipe.compute()       # drain barrier, then epoch values
        pipe.close()

    Feed batches only through the pipeline while enrolled: a direct
    ``target(...)`` call races the worker. ``target.compute()`` stays safe:
    enrolling hooks it to drain first.
    """

    def __init__(
        self,
        target: Any,
        depth: int = _DEFAULT_DEPTH,
        strict: bool = False,
        slo: Optional[Any] = None,
    ):
        from metrics_tpu_torch.cohort import MetricCohort

        if int(depth) < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._target = target
        self._is_cohort = isinstance(target, MetricCohort)
        self._single = isinstance(target, Metric)
        self._engine: Optional[CompiledStepEngine] = None
        if self._single:
            # a bare metric has no engine of its own; the pipeline owns one
            self._engine = CompiledStepEngine(target, observe=False)
        self._depth = int(depth)
        self._lock = threading.Lock()
        self._lock_cond = threading.Condition(self._lock)
        self._queue: "queue.Queue" = queue.Queue(maxsize=self._depth)
        self._worker: Optional[threading.Thread] = None
        self._outstanding = 0
        self._error: Optional[BaseException] = None
        self._proof_done = False
        self._closed = False
        self._slo = slo
        # stage stamps (perf_counter_ns) of batches staged but not yet
        # served, oldest first: the serving.queue.age_ms gauge
        self._stage_stamps: "deque[int]" = deque()
        # set on the thread running a dispatch: a compute() inside the step
        # must not wait for the step itself
        self._local = threading.local()
        self._last_flow: Optional[tuple] = None
        self.stats: Dict[str, int] = {
            "dispatches": 0,
            "blocking_steps": 0,
            "barriers": 0,
            "errors": 0,
            "inline_steps": 0,
        }
        # CUDA: the worker's stream and its last completion event
        device = self._device_of(target)
        self._cuda = device is not None and device.type == "cuda"
        self._device = device
        self._stream: Optional[torch.cuda.Stream] = None
        self._last_done: Optional[torch.cuda.Event] = None
        self._refusal = _admission_refusal(target)
        if self._refusal is not None:
            if strict:
                raise ServingAdmissionError(f"async admission refused: {self._refusal}")
            self._note_demotion("enroll", self._refusal)
        # enroll: the target's own compute() now drains this pipeline first;
        # a weakref, so a dropped pipeline never outlives its collection
        target._serving_pipeline = weakref.ref(self)
        if _flight.flight_enabled():
            _flight.record(
                "serving_enroll", target=type(target).__name__, is_async=self.is_async, refusal=self._refusal
            )

    @staticmethod
    def _device_of(target: Any) -> Optional[torch.device]:
        from metrics_tpu_torch.cohort import MetricCohort

        if isinstance(target, MetricCohort):
            device = target._device
        else:
            members = _members(target) if isinstance(target, (Metric, MetricCollection)) else {}
            device = next(iter(members.values())).device if members else None
        if device is not None and device.type == "cuda" and device.index is None:
            # resolved here: the worker thread starts on device 0
            device = torch.device("cuda", torch.cuda.current_device())
        return device

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    @property
    def is_async(self) -> bool:
        """True when built signatures are served by the background worker;
        False after a refusal moved the target to the blocking path
        (``refusal_reason`` says why)."""
        return self._refusal is None

    @property
    def refusal_reason(self) -> Optional[str]:
        return self._refusal

    def _note_demotion(self, stage: str, reason: str) -> None:
        warn_once(
            f"AsyncServingEngine: admission refused at {stage} ({reason}); serving"
            f" {type(self._target).__name__} on the BLOCKING path",
            key=f"serving-demoted:{id(self)}",
        )
        if _obs.enabled():
            _obs.get().count("serving.demotions")
            _obs.get().event("serving_demotion", stage=stage, reason=reason)
        if _flight.flight_enabled():
            _flight.record("serving_demotion", stage=stage, reason=reason)

    def _first_dispatch_leg(self, values: Any) -> None:
        """The check on the real tensors the first batch installed (module
        docstring): a refusal moves the target to the blocking path while
        no batch is queued."""
        from metrics_tpu_torch.analysis import concurrency as _conc

        try:
            owned, defaults, states = set(), set(), []
            if self._is_cohort:
                owned = _conc.engine_owned(self._target._engine)
                for name, d in self._target._states.items():
                    states.extend((f"{name}.{s}", v) for s, v in d.items())
            else:
                engine = self._resolve_engine()
                if engine is not None:
                    owned = _conc.engine_owned(engine)
                for name, m in _members(self._target).items():
                    states.extend((f"{name}.{s}", getattr(m, s)) for s in m._defaults)
            for m in _members(self._target).values():
                defaults |= {_conc._storage(d) for d in _conc.tensor_leaves(list(m._defaults.values()))}
            defaults.discard(None)
            hazards = _conc.first_dispatch_hazards(states, owned, defaults, values)
        except Exception as err:  # noqa: BLE001 - what cannot be checked is refused
            hazards = [{"kind": "uncheckable", "error": f"{type(err).__name__}: {err}"}]
        if hazards:
            with self._lock:
                self._refusal = f"MTA009 first-dispatch check refused the step's tensors: {hazards[0]}"
                reason = self._refusal
            self._note_demotion("first dispatch", reason)

    def _resolve_engine(self) -> Optional[CompiledStepEngine]:
        if self._engine is not None:
            return self._engine
        return getattr(self._target, "_engine", None)

    def _is_built(self, args: tuple, kwargs: dict) -> bool:
        """Whether this batch's step builds nothing (module docstring: only
        such steps run on the worker)."""
        if self._is_cohort:
            return self._target._step_is_built(args, kwargs)
        if self._single:
            return self._engine.is_built(*args, **kwargs)
        if not self._target.compiled:
            return True  # the eager fan-out builds nothing
        engine = self._target._engine
        return engine is not None and engine.is_built(*args, **kwargs)

    # ------------------------------------------------------------------
    # the hot path
    # ------------------------------------------------------------------
    def forward(self, *args: Any, **kwargs: Any):
        """Stage one batch. An admitted target: queues it and returns None
        (blocking only when ``depth`` batches are outstanding; a first or
        unbuilt signature runs on the caller thread, see the module
        docstring); the batch's state lands before the next barrier, its
        failure surfaces there. A refused target: runs the blocking forward
        and returns its value. The batch-local value is not returned on the
        async path: reading it would wait for the very step the pipeline
        overlaps."""
        if self._closed:
            raise RuntimeError("AsyncServingEngine is closed")
        if self._refusal is not None:
            return self._blocking_forward(args, kwargs)
        inline = not self._proof_done or not self._is_built(args, kwargs)
        if inline:
            # no build on the worker: wait for it to go idle, then step here
            self._wait_idle()
        # step and flow identity are allocated here, at admission, and ride
        # the job: the worker pins both around the dispatch
        tracing = _trace.tracing_enabled()
        step = flow = None
        if tracing or _flight.flight_enabled():
            step = _trace.advance_step()
        if tracing:
            # an ingest wave pins its submissions' ids; a direct forward is
            # its own admitted batch
            flow = _trace.current_flow() or (_trace.next_batch_id(),)
        ready = None
        if self._cuda:
            dev = self._device
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
            if not inline:
                from metrics_tpu_torch.analysis.concurrency import tensor_leaves

                stream = self._worker_stream()
                for t in tensor_leaves((args, kwargs)):
                    if t.is_cuda:
                        t.record_stream(stream)
        t_stage_ns = time.perf_counter_ns()
        with self._lock:
            self._outstanding += 1
            self._stage_stamps.append(t_stage_ns)
            self._last_flow = flow
            age_ms = (t_stage_ns - self._stage_stamps[0]) / 1e6
        if _obs.enabled():
            tel = _obs.get()
            tel.gauge("serving.queue.depth", self._queue.qsize() + 1)
            tel.gauge("serving.queue.age_ms", age_ms)
        if self._slo is not None:
            # before the enqueue that may block: with a wedged worker the
            # queue-age target must breach on the admissions that get here
            self._slo.evaluate()
        job = (args, kwargs, step, flow, t_stage_ns, ready)
        if inline:
            with self._lock:
                self.stats["inline_steps"] += 1
            # no queue: the stage span still marks the batch's admission
            with _trace.span("serving.stage", phase="queue", step=step, flow=flow):
                pass
            first = not self._proof_done
            ok, values = self._serve(job)
            if first and ok:
                self._first_dispatch_leg(values)
                with self._lock:
                    self._proof_done = True
                if self._refusal is None:
                    self._ensure_worker()
            return None
        # the stage span covers the enqueue: a full queue blocks here
        with _trace.span("serving.stage", phase="queue", step=step, flow=flow):
            self._queue.put(job)
        return None

    __call__ = forward

    def _blocking_forward(self, args: tuple, kwargs: dict):
        """The refused path: one synchronous dispatch on the caller thread,
        latency still observed (dispatch == e2e, no queue leg)."""
        with self._lock:
            self.stats["blocking_steps"] += 1
        t0_ns = time.perf_counter_ns()
        out = self._dispatch(args, kwargs)
        if _obs.enabled():
            dt_ms = (time.perf_counter_ns() - t0_ns) / 1e6
            tel = _obs.get()
            tel.observe_hist("serving.latency.dispatch_ms", dt_ms, _obs.LATENCY_BUCKETS_MS)
            tel.observe_hist("serving.latency.e2e_ms", dt_ms, _obs.LATENCY_BUCKETS_MS)
        if self._slo is not None:
            self._slo.evaluate()
        return out

    @property
    def last_flow(self) -> Optional[tuple]:
        """Flow (batch) ids of the most recently staged batch: what a
        checkpoint taken now covers (``BackgroundCheckpointer.submit(...,
        flow=pipe.last_flow)``)."""
        with self._lock:
            return self._last_flow

    @property
    def slo(self) -> Optional[Any]:
        return self._slo

    def _dispatch(self, args: tuple, kwargs: dict):
        """One forward of the target (the worker's whole job, and the
        refused path's). The engine's recovery resolves what is recoverable
        inside the step, so an exception here means the batch failed."""
        if self._single:
            return self._engine.step(*args, **kwargs)
        return self._target(*args, **kwargs)

    def _live_tensors(self) -> List[torch.Tensor]:
        """The target's tensors a step reads and then replaces."""
        from metrics_tpu_torch.analysis import concurrency as _conc

        if self._is_cohort:
            c = self._target
            return list(_conc.tensor_leaves((c._states, c._health, c._membership_tensors)))
        members = _members(self._target).values()
        return list(_conc.tensor_leaves([[getattr(m, s) for s in m._defaults] for m in members]))

    def _serve(self, job: tuple) -> tuple:
        """Run one staged job on this thread and current stream: the
        worker's loop body, also run on the caller thread for first and
        unbuilt signatures. Returns ``(ok, values)``; a failure is parked
        for the next barrier."""
        args, kwargs, step, flow, t_stage_ns, _ready = job
        t_pop_ns = time.perf_counter_ns()
        with self._lock:
            if self._stage_stamps:
                self._stage_stamps.popleft()
            age_ms = (t_pop_ns - self._stage_stamps[0]) / 1e6 if self._stage_stamps else 0.0
        telemetry_on = _obs.enabled()
        if telemetry_on:
            tel = _obs.get()
            tel.observe_hist("serving.latency.queue_wait_ms", (t_pop_ns - t_stage_ns) / 1e6, _obs.LATENCY_BUCKETS_MS)
            tel.gauge("serving.queue.age_ms", age_ms)
        # the batch's own generation and flow for every span of the dispatch
        step_cm = _trace.step_scope(step) if step is not None else nullcontext()
        flow_cm = _trace.flow_scope(flow) if flow is not None else nullcontext()
        ok, values = False, None
        self._local.in_dispatch = True
        try:
            with step_cm, flow_cm:
                if _trace.tracing_enabled():
                    _trace.complete_span("serving.queue_wait", phase="queue", t0_ns=t_stage_ns, t1_ns=t_pop_ns)
                with _trace.span("serving.dispatch", phase="dispatch"):
                    values = self._dispatch(args, kwargs)
                # the write-back is installed when the dispatch returns
                _trace.instant("serving.writeback", phase="dispatch")
            if self._cuda:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self._device))
                with self._lock:
                    self._last_done = done
            t_done_ns = time.perf_counter_ns()
            with self._lock:
                self.stats["dispatches"] += 1
            if telemetry_on:
                tel = _obs.get()
                tel.observe_hist("serving.latency.dispatch_ms", (t_done_ns - t_pop_ns) / 1e6, _obs.LATENCY_BUCKETS_MS)
                tel.observe_hist("serving.latency.e2e_ms", (t_done_ns - t_stage_ns) / 1e6, _obs.LATENCY_BUCKETS_MS)
            if self._slo is not None:
                self._slo.evaluate()
            ok = True
        except BaseException as err:  # noqa: BLE001 - surfaced at the barrier
            with self._lock:
                self.stats["errors"] += 1
                if self._error is None:
                    self._error = err
            _flight.dump_on_failure(
                "serving_dispatch_failure",
                target=type(self._target).__name__,
                error=f"{type(err).__name__}: {err}",
            )
        finally:
            self._local.in_dispatch = False
            if _obs.enabled():
                _obs.get().count("serving.dispatches")
                _obs.get().gauge("serving.queue.depth", self._queue.qsize())
            with self._lock_cond:
                self._outstanding -= 1
                self._lock_cond.notify_all()
        return ok, values

    def _worker_stream(self) -> torch.cuda.Stream:
        with self._lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(device=self._device)
            return self._stream

    def _ensure_worker(self) -> None:
        stream = self._worker_stream() if self._cuda else None
        with self._lock:
            if self._worker is not None:
                return
            worker = threading.Thread(target=self._worker_loop, args=(stream,), name="metrics-tpu-serving",
                                      daemon=True)
            self._worker = worker
        worker.start()

    def _worker_loop(self, stream: Optional[torch.cuda.Stream]) -> None:
        # a new thread starts on device 0: enter the target's device and the
        # pipeline's own stream for every step
        device_cm = torch.cuda.device(self._device) if stream is not None else nullcontext()
        stream_cm = torch.cuda.stream(stream) if stream is not None else nullcontext()
        with device_cm, stream_cm:
            while True:
                job = self._queue.get()
                if job is _SENTINEL:
                    return
                if stream is not None:
                    # the batch's producers first; the states this step
                    # replaces stay allocated until its reads have run
                    stream.wait_event(job[5])
                    for t in self._live_tensors():
                        if t.is_cuda:
                            t.record_stream(stream)
                self._serve(job)
                del job

    # ------------------------------------------------------------------
    # barriers
    # ------------------------------------------------------------------
    def _order_after_worker(self) -> None:
        """Make the caller's current stream wait on the worker's last
        completion event (no host synchronization)."""
        with self._lock:
            done = self._last_done
        if done is not None:
            torch.cuda.current_stream(self._device).wait_event(done)

    def _wait_idle(self, timeout_s: Optional[float] = None) -> None:
        """Wait until no staged batch is outstanding and order the caller's
        stream after the worker; parked errors stay parked."""
        with self._lock_cond:
            if not self._lock_cond.wait_for(lambda: self._outstanding == 0, timeout=timeout_s):
                raise TimeoutError(
                    f"serving pipeline did not go idle ({self._outstanding} outstanding) within {timeout_s}s"
                )
        if self._cuda:
            self._order_after_worker()

    def drain(self, timeout_s: Optional[float] = None) -> None:
        """The barrier: block until every staged batch is folded into state,
        order the caller's current stream after the worker's work, then
        re-raise (and clear) the first batch error parked."""
        if threading.current_thread() is self._worker or getattr(self._local, "in_dispatch", False):
            return  # a compute() inside a dispatch must not wait for itself
        with self._lock:
            idle = self._worker is None and self._error is None
        if self._refusal is not None or idle:
            return  # blocking path / nothing ever queued: trivially clear
        with self._lock_cond:
            if not self._lock_cond.wait_for(lambda: self._outstanding == 0, timeout=timeout_s):
                raise TimeoutError(
                    f"serving drain barrier did not clear {self._outstanding}"
                    f" outstanding dispatch(es) within {timeout_s}s"
                )
            self.stats["barriers"] += 1
            err, self._error = self._error, None
        if self._cuda:
            self._order_after_worker()
        if _obs.enabled():
            _obs.get().count("serving.barriers")
        if err is not None:
            raise err

    def compute(self, *args: Any, **kwargs: Any):
        """Drain, then the target's epoch ``compute()`` (sync included)."""
        self.drain()
        return self._target.compute(*args, **kwargs)

    def state_dict(self, *args: Any, **kwargs: Any) -> dict:
        """Drain, then the target's ``state_dict``: a checkpoint taken
        through the pipeline covers every staged batch."""
        self.drain()
        return self._target.state_dict(*args, **kwargs)

    def close(self) -> None:
        """Drain and stop the worker. Idempotent; the target survives,
        un-enrolled, and keeps serving on its own blocking path."""
        if self._closed:
            return
        try:
            self.drain()
        finally:
            with self._lock:
                worker, self._worker = self._worker, None
                self._closed = True
            if worker is not None:
                self._queue.put(_SENTINEL)
                worker.join(timeout=30.0)
            if self._target._serving_pipeline is not None and self._target._serving_pipeline() is self:
                self._target._serving_pipeline = None

    @property
    def target(self) -> Any:
        return self._target

    def __repr__(self) -> str:
        mode = "async" if self.is_async else "blocking (refused)"
        return f"AsyncServingEngine({type(self._target).__name__}, depth={self._depth}, mode={mode})"
