"""MetricCollection: chain same-call-pattern metrics into one object.

Port of ``metrics_tpu/collections.py``: an ordered mapping of metrics with
fan-out forward/update/compute/reset, prefixes, cloning, checkpointing and
device/dtype moves.
"""
from collections import OrderedDict
from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.metric import Metric
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

    Example:
        >>> from metrics_tpu_torch import AUROC, Accuracy
        >>> target = torch.tensor([0, 1, 0, 1, 0, 1])
        >>> preds = torch.tensor([0.1, 0.8, 0.6, 0.7, 0.2, 0.4])
        >>> metrics = MetricCollection([Accuracy(device="cpu"), AUROC(pos_label=1, device="cpu")])
        >>> {k: round(float(v), 4) for k, v in metrics(preds, target).items()}
        {'Accuracy': 0.6667, 'AUROC': 0.8889}
    """

    def __init__(
        self,
        metrics: Union[List[Metric], Tuple[Metric, ...], Dict[str, Metric]],
        prefix: Optional[str] = None,
    ):
        self._metrics: "OrderedDict[str, Metric]" = OrderedDict()
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

    # --- mapping protocol (stands in for the reference's nn.ModuleDict) ---
    def __getitem__(self, key: str) -> Metric:
        return self._metrics[key]

    def __setitem__(self, key: str, value: Metric) -> None:
        self._metrics[key] = value

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
        """Call forward for each metric; kwargs are filtered per metric signature."""
        return {self._set_prefix(k): m(*args, **m._filter_kwargs(**kwargs)) for k, m in self.items()}

    __call__ = forward

    def __repr__(self) -> str:
        body = "\n".join(f"  ({k}): {m!r}" for k, m in self.items())
        header = "MetricCollection("
        if self.prefix is not None:
            header = f"MetricCollection(prefix={self.prefix!r},"
        return f"{header}\n{body}\n)"

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Call update for each metric; kwargs are filtered per metric signature."""
        for _, m in self.items():
            m.update(*args, **m._filter_kwargs(**kwargs))

    def compute(self) -> Dict[str, Any]:
        """Epoch values from every member's (possibly synced) state."""
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

    def persistent(self, mode: bool = True) -> None:
        """Change whether metric states are saved to ``state_dict``."""
        for _, m in self.items():
            m.persistent(mode)

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "") -> dict:
        destination = {} if destination is None else destination
        for k, m in self.items():
            m.state_dict(destination, prefix=f"{prefix}{k}.")
        return destination

    def load_state_dict(self, state_dict: dict, prefix: str = "", strict: bool = False) -> None:
        """Restore member states saved by :meth:`state_dict`.

        ``strict=True`` additionally rejects *unexpected* keys — entries under
        ``prefix`` that belong to no member — and requires every member state
        to be present (each member's own strict check).
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
        """Member-prefixed ``(key, value)`` pairs across the collection."""
        pairs = []
        for k, m in self.items():
            pairs += m._named_states(f"{prefix}{k}.")
        return pairs

    def to(self, device: Union[str, torch.device]) -> "MetricCollection":
        """Move every member's states to ``device`` (see :meth:`Metric.to`)."""
        for _, m in self.items():
            m.to(device)
        return self

    def astype(self, dtype: torch.dtype) -> "MetricCollection":
        """Apply a precision policy to every metric (see :meth:`Metric.astype`)."""
        for _, m in self.items():
            m.astype(dtype)
        return self

    def _set_prefix(self, k: str) -> str:
        return k if self.prefix is None else self.prefix + k

    @staticmethod
    def _check_prefix_arg(prefix: Optional[str]) -> Optional[str]:
        if prefix is not None:
            if isinstance(prefix, str):
                return prefix
            raise ValueError("Expected input `prefix` to be a string")
        return None
