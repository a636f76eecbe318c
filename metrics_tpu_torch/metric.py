"""Core metric runtime: the stateful ``Metric`` base class.

Port of the core of ``metrics_tpu/metric.py``: the state registry
(``add_state``), forward/update/compute semantics including the batch-local
forward value, the one-update fused forward for mergeable states, result
caching, gather-then-reduce sync at compute, reset, persistence and
pickling.

Metric state is a set of ``torch.Tensor``s (or Python lists of tensors for
"cat" states) on one explicit ``torch.device``. A metric built without a
``device`` lives on the GPU: construction raises when no CUDA device is
present rather than drifting to the CPU. Inputs passed to ``update`` (and so
to ``forward``) are moved to the metric's device. States are replaced, never
updated in place, by the metrics of this package.
"""
import functools
import inspect
from abc import ABC, abstractmethod
from copy import deepcopy
from typing import Any, Callable, Dict, Optional, Union

import torch

from metrics_tpu_torch.parallel.backend import is_distributed_initialized
from metrics_tpu_torch.utilities.data import (
    _flatten,
    apply_to_collection,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
)
from metrics_tpu_torch.utilities.distributed import gather_all_tensors
from metrics_tpu_torch.utilities.prints import warn_once


def _resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` means the GPU. There is no silent CPU fallback: without a
    CUDA device the caller must ask for the CPU by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "metrics_tpu_torch metrics run on a CUDA device by default and none is"
                " available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


class Metric(ABC):
    """Base class for all metrics.

    Implements ``add_state()``, ``forward()``, ``reset()`` and distributed
    synchronization. Override ``update()`` and ``compute()``; register state
    with ``add_state()``.

    Args:
        compute_on_step:
            Forward only calls ``update()`` and returns None if this is False.
        dist_sync_on_step:
            Synchronize metric state across processes at each ``forward()``
            before returning the value at the step.
        process_group:
            Scope of synchronization (passed to the sync backend as ``group``).
            Default: the entire world.
        dist_sync_fn:
            Callback performing the all-gather of metric state. When None, the
            active sync backend is used if distributed is initialized.
        device:
            Where the states live and the inputs are moved. Default (None):
            ``"cuda"``, which raises if no CUDA device is available.
    """

    # True only while forward() computes its batch-local step value; lets
    # computes relax epoch-end invariants a mini-batch can't satisfy.
    _batch_local_compute = False

    # provenance of the `_computed` cache (see `_wrap_compute`)
    _computed_batch_local = False

    # Opt-in fused forward: when every state merge commutes with its
    # registered reduction — sum/min/max counters, list appends — forward
    # runs ONE update on fresh state, computes the batch value from it, and
    # folds the batch stats into the accumulated state, instead of two full
    # updates per forward.
    _fused_forward = False

    def __init__(
        self,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.device = _resolve_device(device)
        self.dist_sync_on_step = dist_sync_on_step
        self.compute_on_step = compute_on_step
        self.process_group = process_group
        self.dist_sync_fn = dist_sync_fn
        self._to_sync = True

        self._update_signature = inspect.signature(self.update)
        self.update = self._wrap_update(self.update)
        self.compute = self._wrap_compute(self.compute)
        self._computed = None
        self._forward_cache = None

        self._defaults: Dict[str, Any] = {}
        self._persistent: Dict[str, bool] = {}
        self._reductions: Dict[str, Optional[Callable]] = {}

    def add_state(
        self,
        name: str,
        default: Union[torch.Tensor, list],
        dist_reduce_fx: Optional[Union[str, Callable]] = None,
        persistent: bool = False,
    ) -> None:
        """Register a metric state variable.

        Args:
            name: attribute name the state will live at (``self.<name>``).
            default: a ``torch.Tensor`` or an **empty list**; the reset value.
            dist_reduce_fx: ``"sum"``, ``"mean"``, ``"cat"``, ``"min"``,
                ``"max"``, a custom callable, or None. Applied to the
                cross-process gathered state (stacked ``(world, ...)`` for
                tensor states, flattened for list states).
            persistent: include this state in ``state_dict()``.
        """
        if not isinstance(default, (torch.Tensor, list)) or (isinstance(default, list) and default):
            raise ValueError("state variable must be a tensor or any empty list (where you can append tensors)")

        if dist_reduce_fx == "sum":
            dist_reduce_fx = dim_zero_sum
        elif dist_reduce_fx == "mean":
            dist_reduce_fx = dim_zero_mean
        elif dist_reduce_fx == "cat":
            dist_reduce_fx = dim_zero_cat
        elif dist_reduce_fx == "min":
            dist_reduce_fx = dim_zero_min
        elif dist_reduce_fx == "max":
            dist_reduce_fx = dim_zero_max
        elif dist_reduce_fx is not None and not callable(dist_reduce_fx):
            raise ValueError("`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', None]")

        if isinstance(default, list):
            # a distinct empty list: appends to the live state never alias the default
            setattr(self, name, [])
        else:
            default = default.detach().to(self.device)
            setattr(self, name, default.clone())

        self._defaults[name] = default
        self._persistent[name] = persistent
        self._reductions[name] = dist_reduce_fx

    def forward(self, *args: Any, **kwargs: Any):
        """Update state with the batch; return the batch-local value if
        ``compute_on_step``.

        Metrics flagged ``_fused_forward`` run one update and a state merge
        (see :meth:`_forward_fused`); the others run the reference's double
        update: accumulate, then recompute the batch alone on reset state.
        Returns once the work is queued on the device: reading a value is
        the synchronization point."""
        if self._fused_forward and self.compute_on_step:
            return self._forward_fused(*args, **kwargs)
        self.update(*args, **kwargs)
        self._forward_cache = None

        if self.compute_on_step:
            self._to_sync = self.dist_sync_on_step

            # save accumulated state, compute on this batch alone
            cache = self._snapshot_state()
            self.reset()
            try:
                self.update(*args, **kwargs)
                # a mini-batch may be partial (e.g. miss classes) in ways the
                # epoch-end compute treats as errors; computes can key on this
                self._batch_local_compute = True
                try:
                    self._forward_cache = self.compute()
                finally:
                    self._batch_local_compute = False
            finally:
                # restore accumulated state even when the batch-local pass
                # raises: a rejected step value must not cost the epoch state
                # or leave _to_sync stuck False
                self._restore_state(cache)
                self._to_sync = True
                self._computed = None

            return self._forward_cache

    __call__ = forward

    def _forward_fused(self, *args: Any, **kwargs: Any):
        """One-update forward for ``_fused_forward`` metrics: batch stats are
        computed once (on fresh default state), the batch-local value comes
        from them, and they are folded into the accumulated state with
        :meth:`_merge_states`."""
        accumulated = self._snapshot_state()
        self.reset()
        try:
            self.update(*args, **kwargs)  # the ONLY update: batch stats
        except BaseException:
            # update rejected the batch: the accumulated state is untouched,
            # as on the classic path
            self._restore_state(accumulated)
            self._to_sync = True
            raise
        try:
            self._to_sync = self.dist_sync_on_step
            self._batch_local_compute = True
            self._forward_cache = self.compute()
        finally:
            # once update() accepted the batch it stays in the epoch state
            # even if the batch-local compute() raises
            self._batch_local_compute = False
            self._merge_states(accumulated)
            self._to_sync = True
            self._computed = None
        return self._forward_cache

    @staticmethod
    def _merge_reduction_supported(reduction: Optional[Callable]) -> bool:
        """True iff a registered reduction folds (accumulated, batch) pairs purely."""
        return reduction in (dim_zero_sum, dim_zero_min, dim_zero_max)

    @staticmethod
    def _merge_state_value(reduction: Optional[Callable], prior: Any, batch: Any) -> Any:
        """(accumulated, batch) → merged state by its registered reduction:
        sum → add, min/max → elementwise min/max, list states → concat."""
        if isinstance(batch, list):
            return prior + batch
        if reduction is dim_zero_sum:
            return prior + batch
        if reduction is dim_zero_min:
            return torch.minimum(prior, batch)
        if reduction is dim_zero_max:
            return torch.maximum(prior, batch)
        raise TypeError("state reduction does not support a pure (accumulated, batch) merge")

    def _merge_states(self, accumulated: Dict[str, Any]) -> None:
        """Fold the current (batch-only) states into ``accumulated``."""
        for name, reduction in self._reductions.items():
            batch = getattr(self, name)
            if not isinstance(batch, list) and not self._merge_reduction_supported(reduction):
                raise TypeError(
                    f"state {name!r} of {type(self).__name__} has a reduction that"
                    " does not support fused forward; unset `_fused_forward`"
                )
            setattr(self, name, self._merge_state_value(reduction, accumulated[name], batch))

    def _sync_dist(self, dist_sync_fn: Callable = gather_all_tensors) -> None:
        """All-gather every registered state and apply its reduction."""
        input_dict = {attr: getattr(self, attr) for attr in self._reductions}
        output_dict = apply_to_collection(input_dict, torch.Tensor, dist_sync_fn, group=self.process_group)

        for attr, reduction_fn in self._reductions.items():
            # tensor states stack to (world, ...); list states flatten
            if len(output_dict[attr]) and isinstance(output_dict[attr][0], torch.Tensor):
                output_dict[attr] = torch.stack(list(output_dict[attr]))
            elif len(output_dict[attr]) and isinstance(output_dict[attr][0], list):
                output_dict[attr] = _flatten(output_dict[attr])
            reduced = reduction_fn(output_dict[attr]) if reduction_fn is not None else output_dict[attr]
            setattr(self, attr, reduced)

    def _to_own_device(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device)

    def _wrap_update(self, update: Callable) -> Callable:
        @functools.wraps(update)
        def wrapped_func(*args: Any, **kwargs: Any):
            self._computed = None
            args = apply_to_collection(args, torch.Tensor, self._to_own_device)
            kwargs = apply_to_collection(kwargs, torch.Tensor, self._to_own_device)
            return update(*args, **kwargs)

        return wrapped_func

    def _wrap_compute(self, compute: Callable) -> Callable:
        @functools.wraps(compute)
        def wrapped_func(*args: Any, **kwargs: Any):
            # the cache carries its provenance: a value computed under
            # batch-local (forward) semantics must never serve an epoch-end
            # compute, or vice versa
            if self._computed is not None and self._computed_batch_local == self._batch_local_compute:
                return self._computed

            dist_sync_fn = self.dist_sync_fn
            if dist_sync_fn is None and is_distributed_initialized():
                dist_sync_fn = gather_all_tensors

            synced = False
            cache = {}
            if self._to_sync and dist_sync_fn is not None:
                # cache prior to syncing so accumulation continues un-synced
                cache = self._snapshot_state()
                self._sync_dist(dist_sync_fn)
                synced = True

            self._computed = compute(*args, **kwargs)
            self._computed_batch_local = self._batch_local_compute
            if synced:
                self._restore_state(cache)
            return self._computed

        return wrapped_func

    def _snapshot_state(self) -> Dict[str, Any]:
        """Snapshot everything ``reset()`` touches, so forward's
        snapshot/reset/restore cycle is lossless."""
        return {attr: getattr(self, attr) for attr in self._defaults}

    def _restore_state(self, cache: Dict[str, Any]) -> None:
        for attr, val in cache.items():
            setattr(self, attr, val)

    @abstractmethod
    def update(self) -> None:
        """Override to update the metric state from a batch of inputs."""

    @abstractmethod
    def compute(self):
        """Override to compute the final value from (synced) state."""

    def reset(self) -> None:
        """Reset all state variables to their registered defaults."""
        self._computed = None
        for attr, default in self._defaults.items():
            setattr(self, attr, [] if isinstance(default, list) else default.clone())

    def clone(self) -> "Metric":
        """Make a copy of the metric."""
        return deepcopy(self)

    def __getstate__(self) -> dict:
        # drop the wrapped bound methods for pickling
        return {k: v for k, v in self.__dict__.items() if k not in ["update", "compute"]}

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self.update = self._wrap_update(self.update)
        self.compute = self._wrap_compute(self.compute)

    def to(self, device: Union[str, torch.device]) -> "Metric":
        """Move every state and default to ``device``; later inputs follow."""
        self.device = torch.device(device)
        for key, default in self._defaults.items():
            current_val = getattr(self, key)
            if isinstance(current_val, torch.Tensor):
                setattr(self, key, current_val.to(self.device))
            elif isinstance(current_val, list):
                setattr(self, key, [v.to(self.device) for v in current_val])
            else:
                raise TypeError(
                    "Expected metric state to be either a torch.Tensor"
                    f" or a list of torch.Tensor, but encountered {current_val}"
                )
            if isinstance(default, torch.Tensor):
                self._defaults[key] = default.to(self.device)
        self._computed = None
        return self

    def astype(self, dtype: torch.dtype) -> "Metric":
        """Cast floating-point tensor states (and their defaults) to ``dtype``.

        Integer counter states keep their dtype, as ``nn.Module.half`` does.
        List states are cast elementwise.
        """

        def _cast(v):
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                return v.to(dtype)
            return v

        for key in self._defaults:
            val = getattr(self, key)
            setattr(self, key, [_cast(v) for v in val] if isinstance(val, list) else _cast(val))
            default = self._defaults[key]
            self._defaults[key] = [_cast(v) for v in default] if isinstance(default, list) else _cast(default)
        self._computed = None
        return self

    def persistent(self, mode: bool = False) -> None:
        """Post-init toggle: should states be saved in ``state_dict``?"""
        for key in self._persistent:
            self._persistent[key] = mode

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "") -> dict:
        """Collect persistent states into a checkpointable dict."""
        destination = {} if destination is None else destination
        for key in self._defaults:
            if self._persistent[key]:
                destination[prefix + key] = getattr(self, key)
        return destination

    def _owned(self, v: Any) -> torch.Tensor:
        """A checkpoint value as a tensor on this metric's device that aliases
        nothing the caller holds."""
        return torch.as_tensor(v).detach().to(self.device, copy=True)

    def load_state_dict(
        self,
        state_dict: dict,
        prefix: str = "",
        strict: bool = False,
        _warn_on_zero_match: bool = True,
    ) -> None:
        """Restore states saved by :meth:`state_dict`, from tensors on any
        device (or numpy arrays).

        Args:
            strict: require every registered state (at ``prefix + name``)
                to be present in ``state_dict``; raises ``KeyError`` listing
                the missing keys otherwise.
            _warn_on_zero_match: internal — a collection passes False and runs
                the zero-match check over ALL its members instead.
        """
        if strict:
            missing = [prefix + key for key in self._defaults if prefix + key not in state_dict]
            if missing:
                raise KeyError(
                    f"strict load_state_dict: {type(self).__name__} is missing"
                    f" state keys {missing}"
                )
        loaded = False
        for key in self._defaults:
            name = prefix + key
            if name in state_dict:
                val = state_dict[name]
                if isinstance(val, list):
                    setattr(self, key, [self._owned(v) for v in val])
                else:
                    setattr(self, key, self._owned(val))
                loaded = True
        if loaded:
            # a cached pre-load result no longer describes the state
            self._computed = None
        elif _warn_on_zero_match and state_dict and self._defaults:
            # a mistyped prefix matches ZERO keys and would otherwise return
            # without a sound, the state silently keeping its priors
            warn_once(
                f"load_state_dict: none of {type(self).__name__}'s"
                f" {len(self._defaults)} state keys (prefix={prefix!r}) matched"
                f" the non-empty state_dict ({len(state_dict)} entries); nothing"
                " was loaded. Check the prefix used at save time, or pass"
                " strict=True to make this an error.",
                key=f"load-zero-match:{type(self).__name__}:{prefix}",
            )

    def _named_states(self, prefix: str = "") -> list:
        """Every loadable ``(key, value)`` pair, prefixed as :meth:`state_dict`
        prefixes it, whatever the ``persistent`` flags say."""
        return [(prefix + key, getattr(self, key)) for key in self._defaults]

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Filter kwargs to those accepted by this metric's ``update`` signature."""
        _params = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
        _sign_params = self._update_signature.parameters
        filtered_kwargs = {
            k: v for k, v in kwargs.items() if (k in _sign_params and _sign_params[k].kind not in _params)
        }
        if not filtered_kwargs:
            filtered_kwargs = kwargs
        return filtered_kwargs

    def __hash__(self) -> int:
        # identity-based: unique per instance and stable across update()/reset()
        return hash((self.__class__.__name__, id(self)))

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}()"
