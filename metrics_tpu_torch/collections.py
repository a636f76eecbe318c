"""MetricCollection: chain same-call-pattern metrics into one object.

Port of ``metrics_tpu/collections.py``: an ordered mapping of metrics with
fan-out forward/update/compute/reset (sharing the canonicalization, the
stat-score counts and the regression family's pass over a batch among
siblings), prefixes, cloning, checkpointing and device/dtype moves, and
the step engine behind ``compiled=True`` (``engine.py``), and
``as_cohort`` (``cohort.py``).
"""
from collections import OrderedDict
from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.regression.sufficient_stats import regression_family_sharing
from metrics_tpu_torch.metric import Metric, _decode_session_cursor, _encode_session_cursor
from metrics_tpu_torch.utilities.checks import shared_canonicalization
from metrics_tpu_torch.utilities.prints import warn_once


class MetricCollection:
    """Chain metrics with the same call pattern into one single class.

    Args:
        metrics: One of the following

            * list or tuple: uses the metric class names as output-dict keys;
              two metrics of the same class cannot be chained this way.
            * dict: uses the given keys, allowing multiple instances of the
              same metric class with different parameters.

        prefix: a string to append in front of the keys of the output dict
        sync_precision: apply a quantized sync tier to every member's
            eligible (``"sum"``-reduced tensor) states at construction —
            ``"bf16"`` or ``"int8"`` (block-scaled with error-feedback
            residuals; see :meth:`Metric.set_sync_precision`). Ineligible
            states (lists, other reductions) stay exact. Default None leaves
            everything exact.
        compiled: route ``forward`` through the step engine
            (:class:`~metrics_tpu_torch.engine.CompiledStepEngine`): on a
            CUDA device the whole fan-out (shared canonicalization, every
            member's update, the batch-local computes and the state merges)
            is one CUDA graph replay per step, captured once per input
            signature. Members whose forward is not one pure step (list
            states, host-level sync) keep their eager forward and are named
            in :attr:`eager_fallbacks`. Compiled steps skip the eager-only
            value checks, as the JAX package's compiled steps do.

    Example:
        >>> from metrics_tpu_torch import AUROC, Accuracy
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> preds = torch.tensor([0.1, 0.8, 0.6, 0.7, 0.2, 0.4])
        >>> metrics = MetricCollection([Accuracy(device="cpu"), AUROC(pos_label=1, device="cpu")])
        >>> {k: round(float(v), 4) for k, v in metrics(preds, target).items()}
        {'Accuracy': 0.6667, 'AUROC': 0.8889}
        >>> compiled = MetricCollection([Accuracy(device="cpu"), AUROC(pos_label=1, device="cpu")], compiled=True)
        >>> {k: round(float(v), 4) for k, v in compiled(preds, target).items()}
        {'Accuracy': 0.6667, 'AUROC': 0.8889}
        >>> sorted(compiled.eager_fallbacks)  # AUROC keeps every prediction: a list state
        ['AUROC']
    """

    def __init__(
        self,
        metrics: Union[List[Metric], Tuple[Metric, ...], Dict[str, Metric]],
        prefix: Optional[str] = None,
        compiled: bool = False,
        sync_precision: Optional[str] = None,
    ):
        self._metrics: "OrderedDict[str, Metric]" = OrderedDict()
        self.compiled = bool(compiled)
        self._engine = None
        if isinstance(metrics, dict):
            for name, metric in metrics.items():
                if not isinstance(metric, Metric):
                    raise ValueError(
                        f"Value {metric} belonging to key {name} is not an instance of `metrics_tpu_torch.Metric`"
                    )
                self[name] = metric
        elif isinstance(metrics, (tuple, list)):
            for metric in metrics:
                if not isinstance(metric, Metric):
                    raise ValueError(
                        f"Input {metric} to `MetricCollection` is not a instance of `metrics_tpu_torch.Metric`"
                    )
                name = metric.__class__.__name__
                if name in self:
                    raise ValueError(f"Encountered two metrics both named {name}")
                self[name] = metric
        else:
            raise ValueError("Unknown input to MetricCollection.")

        self.prefix = self._check_prefix_arg(prefix)
        if sync_precision is not None:
            self.set_sync_precision(sync_precision)

    def set_sync_precision(self, precision: str) -> Dict[str, Dict[str, str]]:
        """Switch every member's eligible states onto a sync tier
        (``"exact"`` | ``"bf16"`` | ``"int8"``); returns the applied
        ``{member: {state: precision}}`` map. Members with no eligible state
        (curve and list-state metrics) stay exact and map to ``{}``. The step
        engine keys its signatures on the precisions, so a flip never
        replays a graph built for another tier."""
        return {name: m.set_sync_precision(precision) for name, m in self.items()}

    def sync_precisions(self) -> Dict[str, Dict[str, str]]:
        """Per-member ``{state: precision}`` maps of the quantized tier."""
        return {name: m.sync_precisions() for name, m in self.items()}

    # --- mapping protocol (stands in for the reference's nn.ModuleDict) ---
    def __getitem__(self, key: str) -> Metric:
        return self._metrics[key]

    def __setitem__(self, key: str, value: Metric) -> None:
        self._metrics[key] = value
        self._engine = None  # membership changed: stale compiled steps

    def __contains__(self, key: str) -> bool:
        return key in self._metrics

    def __len__(self) -> int:
        return len(self._metrics)

    def __iter__(self):
        return iter(self._metrics)

    def keys(self):
        return self._metrics.keys()

    def values(self):
        return self._metrics.values()

    def items(self):
        return self._metrics.items()

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Call forward for each metric; kwargs are filtered per metric signature.

        The members share the step's work on the batch: siblings with the
        same options canonicalize it once and count it once (Precision /
        Recall / F1 share one stat-score count), and the regression family
        computes its moments of ``(preds, target)`` once, in one pass
        (``functional/regression/sufficient_stats.py``). With
        ``compiled=True`` the whole fan-out runs through the step engine
        instead."""
        if self.compiled:
            if self._engine is None:
                from metrics_tpu_torch.engine import CompiledStepEngine

                self._engine = CompiledStepEngine(self._metrics)
            values = self._engine.step(*args, **kwargs)
            return {self._set_prefix(k): values[k] for k in self._metrics}
        with shared_canonicalization(), regression_family_sharing():
            return {self._set_prefix(k): m(*args, **m._filter_kwargs(**kwargs)) for k, m in self.items()}

    __call__ = forward

    @property
    def eager_fallbacks(self) -> Dict[str, str]:
        """``name -> reason`` for members the step engine runs eager (empty
        when nothing is demoted, when ``compiled=False``, or before the
        first compiled forward builds the engine)."""
        if self._engine is None:
            return {}
        return self._engine.eager_fallbacks

    def __repr__(self) -> str:
        body = "\n".join(f"  ({k}): {m!r}" for k, m in self.items())
        header = "MetricCollection("
        if self.prefix is not None:
            header = f"MetricCollection(prefix={self.prefix!r},"
        fallbacks = self.eager_fallbacks
        note = ""
        if fallbacks:
            note = (
                f"\n  # {len(fallbacks)}/{len(self)} metric(s) demoted to eager"
                f" forward under compiled=True: {sorted(fallbacks)}"
            )
        return f"{header}\n{body}{note}\n)"

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Call update for each metric; kwargs are filtered per metric
        signature. The members share the step's work (see :meth:`forward`)."""
        with shared_canonicalization(), regression_family_sharing():
            for _, m in self.items():
                m.update(*args, **m._filter_kwargs(**kwargs))

    def compute(self) -> Dict[str, Any]:
        """Epoch values from every member's (possibly synced) state. On a
        collection enrolled in an
        :class:`~metrics_tpu_torch.serving.AsyncServingEngine` this is a
        drain barrier: every batch already staged folds in first."""
        if self._serving_pipeline is not None:
            pipe = self._serving_pipeline()
            if pipe is not None:
                pipe.drain()
        return {self._set_prefix(k): m.compute() for k, m in self.items()}

    def reset(self) -> None:
        """Call reset for each metric."""
        for _, m in self.items():
            m.reset()

    def clone(self, prefix: Optional[str] = None) -> "MetricCollection":
        """Make a copy of the metric collection, optionally with a new prefix."""
        mc = deepcopy(self)
        mc.prefix = self._check_prefix_arg(prefix)
        return mc

    def as_cohort(self, tenants: int = 1, cache_size: int = 16, track_health: Optional[bool] = None):
        """Stack ``tenants`` independent copies of this collection into a
        :class:`~metrics_tpu_torch.cohort.MetricCohort`: one step then
        updates every tenant's state. Tenant 0 adopts THIS collection's
        current state (the others start from the registered defaults); the
        collection itself is left untouched. Every member must be
        engine-eligible; ``track_health`` passes through to the cohort."""
        from metrics_tpu_torch.cohort import MetricCohort

        cohort = MetricCohort(deepcopy(self), tenants=tenants, cache_size=cache_size, track_health=track_health)
        cohort._adopt_state(0, cohort._extract_states(self))
        return cohort

    # a compiled step closes over THESE metric instances and holds CUDA
    # graphs: a copy or pickle drops the engine and rebuilds it lazily
    # against its own metrics on the next forward; a copy serves its own
    # stream, so the serving enrollment is dropped too
    def __getstate__(self) -> dict:
        return {k: v for k, v in self.__dict__.items() if k not in ("_engine", "_serving_pipeline")}

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._engine = None

    def persistent(self, mode: bool = True) -> None:
        """Change whether metric states are saved to ``state_dict``."""
        for _, m in self.items():
            m.persistent(mode)

    # Durable-session step cursor (reliability/session.py): one for the
    # whole collection (the members advance in lockstep under one forward),
    # riding state_dict / _named_states as Metric's does
    _session_cursor: Optional[int] = None

    # Serving enrollment (serving/async_engine.py): a weakref to the
    # pipeline whose worker steps this collection; compute() drains it first
    _serving_pipeline: Optional[Any] = None

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "") -> dict:
        destination = {} if destination is None else destination
        for k, m in self.items():
            m.state_dict(destination, prefix=f"{prefix}{k}.")
        if self._session_cursor is not None:
            destination[prefix + Metric._SESSION_CURSOR_KEY] = _encode_session_cursor(self._session_cursor)
        return destination

    def load_state_dict(self, state_dict: dict, prefix: str = "", strict: bool = False) -> None:
        """Restore member states saved by :meth:`state_dict`.

        ``strict=True`` additionally rejects *unexpected* keys — entries under
        ``prefix`` that belong to no member — and requires every member state
        to be present (each member's own strict check). For checksum- and
        schema-validated restores see
        :func:`metrics_tpu_torch.reliability.load_envelope`.
        """
        if strict:
            # only keys under OUR prefix can be "unexpected": a shared flat
            # dict legitimately carries other objects' entries
            expected = {key for key, _ in self._named_states(prefix)}
            unexpected = sorted(k for k in set(state_dict) - expected if k.startswith(prefix))
            if unexpected:
                raise KeyError(
                    f"strict load_state_dict: state_dict carries keys under"
                    f" prefix {prefix!r} that no member of this"
                    f" MetricCollection registers: {unexpected}"
                )
        cursor_key = prefix + Metric._SESSION_CURSOR_KEY
        if cursor_key in state_dict:
            self._session_cursor = _decode_session_cursor(state_dict[cursor_key])
        for k, m in self.items():
            m.load_state_dict(state_dict, prefix=f"{prefix}{k}.", strict=strict, _warn_on_zero_match=False)
        # one member matching nothing is legitimate (no persistent states at
        # save time); NO member matching a non-empty dict is a mistyped prefix
        if state_dict and self._metrics and not any(key in state_dict for key, _ in self._named_states(prefix)):
            warn_once(
                f"load_state_dict: no member state of this MetricCollection"
                f" (prefix={prefix!r}) matched the non-empty state_dict"
                f" ({len(state_dict)} entries); nothing was loaded. Check the"
                " prefix used at save time, or pass strict=True to make this an error.",
                key=f"load-zero-match:MetricCollection:{prefix}",
            )

    def _named_states(self, prefix: str = "") -> list:
        """Member-prefixed ``(key, value)`` pairs across the collection, plus
        the collection's session cursor when enrolled: an envelope then
        checksums the cursor together with the state it describes."""
        pairs = []
        for k, m in self.items():
            pairs += m._named_states(f"{prefix}{k}.")
        if self._session_cursor is not None:
            pairs.append((prefix + Metric._SESSION_CURSOR_KEY, _encode_session_cursor(self._session_cursor)))
        return pairs

    def to(self, device: Union[str, torch.device]) -> "MetricCollection":
        """Move every member's states to ``device`` (see :meth:`Metric.to`);
        a compiled collection rebuilds its engine there on the next forward."""
        for _, m in self.items():
            m.to(device)
        self._engine = None
        return self

    def astype(self, dtype: torch.dtype) -> "MetricCollection":
        """Apply a precision policy to every metric (see :meth:`Metric.astype`)."""
        for _, m in self.items():
            m.astype(dtype)
        return self

    def bfloat16(self) -> "MetricCollection":
        return self.astype(torch.bfloat16)

    def float16(self) -> "MetricCollection":
        return self.astype(torch.float16)

    def half(self) -> "MetricCollection":
        """Shorthand for :meth:`bfloat16`, as in the JAX package (not
        ``nn.Module.half()``'s float16)."""
        return self.bfloat16()

    def float(self) -> "MetricCollection":
        return self.astype(torch.float32)

    def _set_prefix(self, k: str) -> str:
        return k if self.prefix is None else self.prefix + k

    @staticmethod
    def _check_prefix_arg(prefix: Optional[str]) -> Optional[str]:
        if prefix is not None:
            if isinstance(prefix, str):
                return prefix
            raise ValueError("Expected input `prefix` to be a string")
        return None
