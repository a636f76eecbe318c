"""Guarded distributed sync: timeout, bounded retry, degraded-mode fallback.

Port of ``metrics_tpu/reliability/sync.py``. The host-level sync path
(``Metric._sync_dist`` → ``gather_all_tensors`` → the active
:class:`~metrics_tpu_torch.parallel.backend.SyncBackend`) is the one place a
metric blocks on other processes. A :class:`SyncPolicy` bounds both ways it
can fail; each gather gets

* an optional **timeout** (``timeout_s``): the gather runs in a daemon
  worker thread and is abandoned if it does not return in time. A
  timed-out attempt is TERMINAL, never retried: the abandoned worker may
  still be consuming the peers' collective round, and a concurrent retry
  would pair this rank's gathers with the wrong rounds. Over NCCL an
  abandoned collective stays queued on the card's stream and the
  communicator is unsafe to use afterwards; there the process group's own
  timeout (``init_process_group(timeout=...)`` with
  ``TORCH_NCCL_ASYNC_ERROR_HANDLING``) is what ends a wedged collective;
* **bounded retries** with decorrelated-jitter backoff (``max_retries``,
  base ``backoff_s``, ceiling ``max_backoff_s``; ``jitter=False`` restores
  plain doubling) for gathers that fail cleanly, counted as
  ``reliability.sync_retries``;
* a **degraded mode** (``degraded_ok=True``): when a gather fails
  terminally, the WHOLE sync falls back to LOCAL-ONLY state (every state
  gathers as ``[x]``), with one warning and a ``reliability.degraded_syncs``
  count. Degradation is atomic per sync, applied by ``Metric._sync_dist``
  across the whole state dict: a metric with some states world-aggregated
  and others local would be silently wrong, not degraded.

The default is off: with no policy installed, :func:`apply_sync_policy`
returns its argument untouched after one module-global read.
"""
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional

from metrics_tpu_torch.observability import flight as _flight
from metrics_tpu_torch.observability import telemetry as _obs
from metrics_tpu_torch.observability import trace as _trace
from metrics_tpu_torch.utilities.prints import warn_once

__all__ = [
    "SyncPolicy",
    "SyncFailedError",
    "SyncTimeoutError",
    "set_sync_policy",
    "active_policy",
    "sync_policy_scope",
    "apply_sync_policy",
    "degraded_local_fallback",
]


class SyncFailedError(RuntimeError):
    """Every attempt of a guarded gather failed (and ``degraded_ok`` is off)."""


class SyncTimeoutError(SyncFailedError):
    """A single gather attempt exceeded ``SyncPolicy.timeout_s``."""


@dataclass
class SyncPolicy:
    """Retry/timeout/degradation contract for host-level state sync.

    Attributes:
        max_retries: additional attempts after the first failure (total
            attempts = ``max_retries + 1``).
        backoff_s: base sleep before the first retry; with ``jitter`` off it
            doubles per retry, with ``jitter`` on (the default) it is the
            floor of the decorrelated-jitter draw.
        timeout_s: per-attempt wall-clock bound; None = wait forever.
        degraded_ok: after the final failure, fall back to local-only state
            (one warning + ``reliability.degraded_syncs``) instead of raising
            :class:`SyncFailedError`.
        jitter: decorrelate retry sleeps across hosts (default on): each
            retry sleeps ``min(max_backoff_s, uniform(backoff_s, 3 * prev))``,
            drawn from a per-policy generator seeded from OS entropy, so
            ranks that failed together do not retry in lockstep.
        max_backoff_s: ceiling on any single retry sleep. Default (None):
            ``max(2.0, 8 * backoff_s)``. A ceiling below ``backoff_s`` is
            rejected.
        levels: per-level overrides for hierarchical backends
            (:mod:`metrics_tpu_torch.parallel.hierarchy`): ``{0: intra-slice
            policy, 1: inter-slice policy}``. A level without an override
            uses this policy itself (:meth:`for_level`). Overrides may not
            nest further levels. Flat syncs ignore this field.
    """

    max_retries: int = 2
    backoff_s: float = 0.05
    timeout_s: Optional[float] = None
    degraded_ok: bool = False
    jitter: bool = True
    max_backoff_s: Optional[float] = None
    levels: Optional[Dict[int, "SyncPolicy"]] = None

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_s < 0:
            raise ValueError("backoff_s must be >= 0")
        if self.max_backoff_s is None:
            self.max_backoff_s = max(2.0, 8.0 * self.backoff_s)
        if self.max_backoff_s < self.backoff_s or self.max_backoff_s <= 0:
            raise ValueError(
                f"max_backoff_s ({self.max_backoff_s}) must be > 0 and >="
                f" backoff_s ({self.backoff_s}) — a ceiling below the base"
                " degenerates every retry into the same clamped sleep"
            )
        if self.levels is not None:
            for level, override in self.levels.items():
                if not isinstance(override, SyncPolicy):
                    raise TypeError(f"levels[{level!r}] must be a SyncPolicy, got {type(override).__name__}")
                if override.levels:
                    raise ValueError(
                        "per-level policy overrides may not nest further"
                        " `levels` — the hierarchy has exactly two levels"
                    )
        # host-side tally, readable when telemetry is off
        self.stats = {"retries": 0, "degraded": 0, "timeouts": 0}
        # a fresh OS-entropy seed per policy object: two policies built from
        # the same config must not share a schedule
        self._rng = random.Random()

    def for_level(self, level: int) -> "SyncPolicy":
        """The policy governing one hierarchy level: the override when
        ``levels`` names it, else this policy itself."""
        if not self.levels:
            return self
        return self.levels.get(level, self)

    def next_backoff(self, prev: Optional[float]) -> float:
        """The sleep before the next retry, given the previous sleep (None
        before the first retry). Doubling under ``jitter=False``,
        decorrelated jitter otherwise; always within
        ``[min(backoff_s, max_backoff_s), max_backoff_s]``."""
        if not self.jitter:
            return min(self.max_backoff_s, self.backoff_s if prev is None else prev * 2.0)
        hi = 3.0 * (self.backoff_s if prev is None else prev)
        return min(self.max_backoff_s, self._rng.uniform(self.backoff_s, max(self.backoff_s, hi)))


_active: Optional[SyncPolicy] = None


def set_sync_policy(policy: Optional[SyncPolicy]) -> Optional[SyncPolicy]:
    """Install a process-global sync policy (None removes it). Returns the
    previously installed policy so callers can restore it."""
    global _active
    prev = _active
    _active = policy
    return prev


def active_policy() -> Optional[SyncPolicy]:
    return _active


@contextmanager
def sync_policy_scope(policy: Optional[SyncPolicy] = None, **kwargs: Any) -> Iterator[SyncPolicy]:
    """Install a policy for a ``with`` block (``SyncPolicy(**kwargs)`` when
    no policy object is given), restoring the prior one on exit."""
    p = policy if policy is not None else SyncPolicy(**kwargs)
    prev = set_sync_policy(p)
    try:
        yield p
    finally:
        set_sync_policy(prev)


def _attempt(fn: Callable, args: tuple, kwargs: dict, timeout_s: Optional[float]):
    if timeout_s is None:
        return fn(*args, **kwargs)
    # a fresh DAEMON thread per timed attempt, not a pool whose non-daemon
    # workers are joined at exit: a wedged gather must not keep the process
    # from terminating
    result: dict = {}
    done = threading.Event()

    def _run():
        try:
            result["value"] = fn(*args, **kwargs)
        except BaseException as err:  # noqa: BLE001 — ferried to the caller
            result["error"] = err
        finally:
            done.set()

    worker = threading.Thread(target=_run, name="metrics_tpu-sync", daemon=True)
    worker.start()
    if not done.wait(timeout_s):
        raise SyncTimeoutError(
            f"sync gather exceeded timeout_s={timeout_s}; the attempt was"
            " abandoned (its daemon worker may still be running)"
        )
    if "error" in result:
        raise result["error"]
    return result["value"]


_USE_ACTIVE = object()


def apply_sync_policy(fn: Callable, policy: Any = _USE_ACTIVE) -> Callable:
    """Wrap a gather callable (``fn(x, group=None) -> [x_rank0, ...]``) with
    the policy's retry/backoff/timeout; returns ``fn`` untouched when no
    policy is installed. An explicit ``policy=`` (possibly None) overrides
    the installed one: the hierarchical engine passes
    ``active_policy().for_level(L)``.

    On exhaustion the wrapper ALWAYS raises :class:`SyncFailedError`; it
    never degrades a single gather. Degradation is the caller's, atomic
    across a whole sync (:func:`degraded_local_fallback`). A timed-out
    attempt is terminal, not retried.
    """
    policy = _active if policy is _USE_ACTIVE else policy
    if policy is None:
        return fn

    def guarded(x, *args: Any, **kwargs: Any):
        delay: Optional[float] = None
        last_err: Optional[BaseException] = None
        for attempt in range(policy.max_retries + 1):
            t0 = time.perf_counter()
            try:
                with _trace.span("sync.gather", phase="sync", attempt=attempt):
                    result = _attempt(fn, (x, *args), kwargs, policy.timeout_s)
                if _obs.enabled():
                    _obs.get().observe_hist(
                        "reliability.sync_attempt_ms", (time.perf_counter() - t0) * 1e3, _obs.LATENCY_BUCKETS_MS
                    )
                return result
            except Exception as err:  # noqa: BLE001 — any backend failure
                last_err = err
                if isinstance(err, SyncTimeoutError):
                    # the abandoned attempt may still be consuming the
                    # peers' collective round: retrying would race it
                    policy.stats["timeouts"] += 1
                    break
                if attempt < policy.max_retries:
                    policy.stats["retries"] += 1
                    if _obs.enabled():
                        _obs.get().count("reliability.sync_retries")
                        _obs.get().event("sync_retry", attempt=attempt + 1, error=f"{type(err).__name__}: {err}")
                    delay = policy.next_backoff(delay)
                    time.sleep(delay)
        # the sync is now terminally failed for this call: one flight dump
        # here, whether the caller re-raises or degrades
        timed_out = isinstance(last_err, SyncTimeoutError)
        _flight.record("sync_failure", timeout=timed_out, error=f"{type(last_err).__name__}: {last_err}")
        _flight.dump_on_failure(
            "sync_timeout" if timed_out else "sync_failed",
            error=f"{type(last_err).__name__}: {last_err}",
            attempts=policy.max_retries + 1,
            timeout_s=policy.timeout_s,
        )
        if isinstance(last_err, SyncFailedError):
            # a terminal timeout surfaces as SyncTimeoutError, not re-wrapped
            raise last_err
        raise SyncFailedError(f"sync gather failed ({type(last_err).__name__}: {last_err})") from last_err

    return guarded


def degraded_local_fallback(err: BaseException) -> Optional[Callable]:
    """When the installed policy allows degradation, record one degraded
    sync (stats, telemetry, one warning) and return the local-only gather
    (``x -> [x]``) to apply to EVERY state of the failed sync. Returns None
    when no policy is installed or ``degraded_ok`` is off (the caller
    re-raises)."""
    policy = _active
    if policy is None or not policy.degraded_ok:
        return None
    policy.stats["degraded"] += 1
    # an event only: the terminal gather already dumped this fault
    _flight.record("degraded_sync", error=f"{type(err).__name__}: {err}")
    if _obs.enabled():
        _obs.get().count("reliability.degraded_syncs")
        _obs.get().event("degraded_sync", error=f"{type(err).__name__}: {err}")
    warn_once(
        "guarded sync: gather failed terminally"
        f" ({type(err).__name__}: {err}); continuing with LOCAL-ONLY state"
        " for the whole sync (degraded_ok=True). Synced results now reflect"
        " this process alone; telemetry counter: reliability.degraded_syncs.",
        key="reliability-degraded-sync",
    )

    def local_only(x, *args: Any, **kwargs: Any):
        return [x]

    return local_only
