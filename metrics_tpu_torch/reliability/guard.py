"""Non-finite state guard: catch a NaN/Inf before it poisons an epoch.

Port of ``metrics_tpu/reliability/guard.py``. A single poisoned batch — a
NaN loss spike, an Inf logit, a bf16 overflow — silently corrupts an
additive accumulator for the rest of the evaluation. The
:class:`StateGuard` closes that hole at the state layer: after every
``update`` (and after each fused-forward or compiled-engine state merge) the
registered floating-point states are checked with one fused ``isfinite``
reduction, and a violation is handled by policy:

* ``"raise"``      — restore the last-good state, then raise
  :class:`NonFiniteStateError` (the metric stays usable for a caller that
  catches and skips the batch).
* ``"warn"``       — keep the poisoned state, emit one rate-limited warning
  per metric class.
* ``"quarantine"`` — roll the state back to the last-good snapshot, count
  ``reliability.quarantined`` in telemetry, warn once, and keep going.

Installation is process-global and costs nothing when off (the default):
every hook in the metric runtime reads one module global and branches. With
a guard installed, each guarded eager update costs one snapshot (references
to the state tensors, list states shallow-copied) and one finite check read
to the host.

While the step engine builds or replays a step (``_is_concrete()`` False)
the host check cannot run: the engine folds the same check into its step
function, inside the CUDA graph, and rolls a poisoned merge back with a
``torch.where`` select (``metrics_tpu_torch/engine.py``); this module
supplies the policy object and the host-side accounting.

Usage::

    from metrics_tpu_torch import reliability

    reliability.install_guard("quarantine")     # process-wide
    ...
    reliability.uninstall_guard()

    with reliability.guard_scope("raise"):      # scoped
        metric(preds, target)
"""
import weakref
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional, Union

import torch

from metrics_tpu_torch.observability import flight as _flight
from metrics_tpu_torch.observability import telemetry as _obs
from metrics_tpu_torch.utilities.data import _is_concrete
from metrics_tpu_torch.utilities.prints import warn_once

__all__ = [
    "NonFiniteStateError",
    "StateGuard",
    "active",
    "install_guard",
    "uninstall_guard",
    "guard_scope",
]

POLICIES = ("raise", "warn", "quarantine")


class NonFiniteStateError(RuntimeError):
    """A metric's registered state became NaN/Inf under a ``raise`` guard."""


def _state_leaves(metric: Any):
    """Every leaf of the metric's registered states (list states flattened)."""
    for name in metric._defaults:
        val = getattr(metric, name)
        yield from val if isinstance(val, list) else [val]


def _float_leaves(metric: Any):
    """The floating-point leaves of the metric's registered states; integer
    counters cannot carry a NaN/Inf."""
    for v in _state_leaves(metric):
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            yield v


def states_finite_scalar(metric: Any):
    """One fused all-finite 0-d bool tensor over the metric's float states,
    or Python ``True`` when there is nothing to check."""
    flag = True
    for v in _float_leaves(metric):
        leaf = torch.isfinite(v).all()
        flag = leaf if flag is True else flag & leaf
    return flag


class StateGuard:
    """Policy and accounting for non-finite state handling.

    Args:
        policy: ``"raise"`` | ``"warn"`` | ``"quarantine"`` (see module docs).
        overflow_margin: opt-in integer-saturation early warning. When set,
            every guarded check also verifies that no integer accumulator has
            crossed within ``2**overflow_margin`` of its dtype limit; a
            crossing warns once per ``(metric, state)`` and counts
            ``reliability.guard_overflow_warns``. The default (None) adds no
            work.

    Attributes:
        stats: host-side tally (works with telemetry disabled):
            ``checks``, ``violations``, ``quarantined``, ``overflow_warns``.
    """

    def __init__(self, policy: str = "raise", overflow_margin: Optional[int] = None):
        if policy not in POLICIES:
            raise ValueError(f"guard policy must be one of {POLICIES}, got {policy!r}")
        if overflow_margin is not None and not (isinstance(overflow_margin, int) and 0 <= overflow_margin <= 62):
            raise ValueError(f"overflow_margin must be an int in [0, 62] or None, got {overflow_margin!r}")
        self.policy = policy
        self.overflow_margin = overflow_margin
        self.stats: Dict[str, int] = {"checks": 0, "violations": 0, "quarantined": 0, "overflow_warns": 0}
        # one telemetry EVENT per metric class: under "warn" the kept
        # poisoned state re-flags on every later batch, and per-violation
        # events would flood the bounded event log. Counters keep the tally.
        self._event_keys: set = set()
        # state names already warned near overflow, per metric instance
        # (weak keys: two live ConfusionMatrix objects each get their own
        # warning); non-weakref-able metrics fall back to an id-keyed set
        self._overflow_seen: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._overflow_seen_ids: Dict[int, set] = {}

    # ------------------------------------------------------------------
    # host-side (eager) path
    # ------------------------------------------------------------------
    def run_update(self, metric: Any, update, args: tuple, kwargs: dict):
        """Execute one guarded ``update``: snapshot, run, check, apply
        policy. The check is skipped while the engine builds or replays a
        step (its in-graph check covers that path) and during the classic
        forward's batch-local re-update, which runs on throwaway post-reset
        state: guarding it would count the poisoned batch twice, and a
        quarantine there rolls back to empty state."""
        if getattr(metric, "_batch_local_pass", False):
            return update(*args, **kwargs)
        last_good = self._rollback_snapshot(metric)
        out = update(*args, **kwargs)
        self.check_states(metric, last_good, context="update")
        return out

    @staticmethod
    def _rollback_snapshot(metric: Any) -> Dict[str, Any]:
        """A rollback-safe snapshot: list ("cat") states are appended to in
        place by ``update``, so each list leaf is shallow-copied."""
        return {k: list(v) if isinstance(v, list) else v for k, v in metric._snapshot_state().items()}

    def check_states(self, metric: Any, last_good: Dict[str, Any], context: str) -> bool:
        """Host-side finite check and policy. Returns True when the state is
        healthy (or could not be checked inside an engine step)."""
        if not _is_concrete():
            return True  # engine path: checked inside the step
        self.stats["checks"] += 1
        self.maybe_warn_overflow(metric, context)
        flag = states_finite_scalar(metric)
        if flag is True or bool(flag):
            return True
        self.handle_violation(metric, last_good, context)
        return False

    # ------------------------------------------------------------------
    # integer-saturation early warning
    # ------------------------------------------------------------------
    def maybe_warn_overflow(self, metric: Any, context: str) -> None:
        """Opt-in ``overflow_margin`` check: when an integer accumulator has
        crossed within ``2**overflow_margin`` of its dtype limit (either
        direction), warn once per ``(metric, state)`` and count
        ``reliability.guard_overflow_warns``. No-op when the margin is unset,
        inside an engine step (the engine calls this after its write-back)
        and after the one-shot warning fired."""
        margin = self.overflow_margin
        if margin is None or not _is_concrete():
            return
        name = type(metric).__name__
        slack = 1 << margin
        try:
            seen = self._overflow_seen.setdefault(metric, set())
        except TypeError:  # non-weakref-able metric: id-keyed fallback
            seen = self._overflow_seen_ids.setdefault(id(metric), set())
        for sname in metric._defaults:
            val = getattr(metric, sname)
            for v in val if isinstance(val, list) else [val]:
                if not isinstance(v, torch.Tensor) or v.is_floating_point() or v.dtype == torch.bool:
                    continue
                if sname in seen or v.numel() == 0:
                    continue
                info = torch.iinfo(v.dtype)
                near = (v.max() >= info.max - slack) | (v.min() <= info.min + slack)
                if not bool(near):
                    continue
                seen.add(sname)
                self.stats["overflow_warns"] += 1
                if _obs.enabled():
                    _obs.get().count("reliability.guard_overflow_warns")
                dtype = str(v.dtype).replace("torch.", "")
                warn_once(
                    f"StateGuard: integer accumulator {name}.{sname} ({dtype}) is"
                    f" within 2^{margin} of its dtype limit (during {context});"
                    " it will saturate and silently corrupt every later"
                    " compute. Widen the state dtype or reset/checkpoint the"
                    " metric.",
                    key=f"guard-overflow:{name}.{sname}:{id(metric)}",
                )

    # ------------------------------------------------------------------
    # policy application (shared with the engine's host-side epilogue)
    # ------------------------------------------------------------------
    def handle_violation(
        self,
        metric: Any,
        last_good: Optional[Dict[str, Any]],
        context: str,
        already_rolled_back: bool = False,
    ) -> None:
        """Apply the policy to one confirmed non-finite state.
        ``already_rolled_back`` is set by the step engine and the cohort,
        whose step functions select the last-good state inside the step."""
        name = type(metric).__name__
        self.stats["violations"] += 1
        # flight recorder: a rollback (raise/quarantine) is a survived
        # failure worth a dump; "warn" keeps the poisoned state, which
        # re-flags every later batch: record the event, dump nothing
        _flight.record("nonfinite_state", metric=name, context=context, policy=self.policy)
        if self.policy in ("raise", "quarantine"):
            _flight.dump_on_failure(f"state_guard_{self.policy}", metric=name, context=context)
        if _obs.enabled() and name not in self._event_keys and len(self._event_keys) < 1024:
            self._event_keys.add(name)
            _obs.get().event("nonfinite_state", metric=name, context=context, policy=self.policy)
        if self.policy == "warn":
            warn_once(
                f"StateGuard: non-finite values entered the state of {name}"
                f" (during {context}); accumulated results may be poisoned."
                " Use policy='quarantine' to roll back poisoned batches.",
                key=f"guard-warn:{name}",
            )
            return
        rolled = already_rolled_back
        if not rolled and last_good is not None:
            metric._restore_state(last_good)
            metric._computed = None
            rolled = True
        if self.policy == "raise":
            raise NonFiniteStateError(
                f"non-finite values entered the state of {name} during {context};"
                + (" state restored to the last-good snapshot" if rolled else "")
            )
        self.stats["quarantined"] += 1
        if _obs.enabled():
            _obs.get().count("reliability.quarantined")
        warn_once(
            f"StateGuard: quarantined a poisoned batch for {name} (during"
            f" {context}); state rolled back to the last-good snapshot."
            " Further quarantines are counted, not re-warned"
            " (telemetry counter: reliability.quarantined).",
            key=f"guard-quarantine:{name}",
        )


# ----------------------------------------------------------------------
# process-global installation (same shape as the telemetry switch)
# ----------------------------------------------------------------------
_active: Optional[StateGuard] = None


def active() -> Optional[StateGuard]:
    """The installed guard, or None (the default): the one read every
    runtime hook performs."""
    return _active


def install_guard(guard: Union[StateGuard, str]) -> StateGuard:
    """Install a process-global state guard; a policy string is shorthand
    for ``StateGuard(policy)``. Returns the installed guard."""
    global _active
    _active = StateGuard(guard) if isinstance(guard, str) else guard
    return _active


def uninstall_guard() -> None:
    """Remove the guard; the runtime reverts to unguarded (no added work)."""
    global _active
    _active = None


@contextmanager
def guard_scope(policy: Union[StateGuard, str] = "raise") -> Iterator[StateGuard]:
    """Install a guard for the duration of a ``with`` block, restoring the
    previously installed guard (or none) on exit."""
    global _active
    prior = _active
    guard = install_guard(policy)
    try:
        yield guard
    finally:
        _active = prior
