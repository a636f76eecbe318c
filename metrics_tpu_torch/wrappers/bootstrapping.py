"""BootStrapper: confidence intervals by resampled metric replicas.

Port of ``metrics_tpu/wrappers/bootstrapping.py``: ``num_bootstraps``
deep copies of the base metric, each updated on its own resampling of the
batch along dim 0. The indices are drawn on the metric's device from an
explicit ``torch.Generator``:

* ``'multinomial'``: ``N`` indices with replacement per replica
  (``torch.randint``), read nothing to the host;
* ``'poisson'``: per-sample counts ``n ~ Poisson(1)`` for every replica in
  one draw, each sample repeated ``n`` times (approximating the true
  bootstrap for large N); the replicas' totals, which size their batches,
  are read to the host in one copy per update. A replica whose counts are
  all zero (probability ``e^-N``) gets one sample drawn uniformly instead.

The wrapper registers no state of its own (the replicas hold it), so the
step engine keeps it eager, as the JAX package's does.
"""
from copy import deepcopy
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utilities.data import apply_to_collection


def _bootstrap_sampler(
    size: int,
    sampling_strategy: str = "poisson",
    num_samples: int = 1,
    generator: Optional[torch.Generator] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> List[torch.Tensor]:
    """``num_samples`` int64 index tensors, each resampling ``size``
    elements along dim 0 with replacement, on ``device`` (module docstring).

    Example:
        >>> gen = torch.Generator().manual_seed(0)
        >>> [(idx.numel(), 0 <= int(idx.min()), int(idx.max()) < 4) for idx in _bootstrap_sampler(4, "multinomial", 2, gen)]
        [(4, True, True), (4, True, True)]
    """
    device = torch.device("cpu") if device is None else torch.device(device)
    if sampling_strategy == "multinomial":
        return [torch.randint(0, size, (size,), generator=generator, device=device) for _ in range(num_samples)]
    if sampling_strategy != "poisson":
        raise ValueError("Unknown sampling strategy")
    counts = torch.poisson(torch.ones((num_samples, size), device=device), generator=generator).to(torch.int64)
    totals = counts.sum(1).tolist()  # the one host read: the batches' sizes
    positions = torch.arange(size, device=device)
    return [
        torch.repeat_interleave(positions, row, output_size=total)
        if total
        else torch.randint(0, size, (1,), generator=generator, device=device)
        for row, total in zip(counts, totals)
    ]


class BootStrapper(Metric):
    r"""Turn a metric into a bootstrapped metric for confidence intervals.

    Keeps ``num_bootstraps`` copies of the base metric; every ``update`` /
    ``forward`` resamples the input tensors (with replacement) along dim 0
    once per copy.

    Args:
        base_metric: base metric instance to wrap.
        num_bootstraps: number of resampled copies.
        mean: if True, ``compute`` returns the mean of the bootstraps.
        std: if True, ``compute`` returns the standard deviation (``ddof=1``).
        quantile: if given, returns this quantile of the bootstraps.
        raw: if True, return all bootstrapped values.
        sampling_strategy: ``'poisson'`` or ``'multinomial'`` (module docstring).
        generator: the ``torch.Generator`` the indices are drawn from, on the
            metric's device. Default: a new one, seeded from PyTorch's
            default generator (so ``torch.manual_seed`` fixes the draws).
        device: where the indices are drawn and the inputs resampled;
            default: the base metric's device.

    Example:
        >>> from metrics_tpu_torch import Accuracy
        >>> _ = torch.manual_seed(123)
        >>> bootstrap = BootStrapper(Accuracy(device="cpu"), num_bootstraps=20)
        >>> bootstrap.update(torch.randint(5, (20,)), torch.randint(5, (20,)))
        >>> sorted(bootstrap.compute())
        ['mean', 'std']
    """

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, torch.Tensor]] = None,
        raw: bool = False,
        sampling_strategy: str = "poisson",
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        generator: Optional[torch.Generator] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of metrics_tpu_torch.Metric but received {base_metric}"
            )
        super().__init__(
            compute_on_step, dist_sync_on_step, process_group, dist_sync_fn,
            device=base_metric.device if device is None else device,
        )

        self.metrics = [deepcopy(base_metric) for _ in range(num_bootstraps)]
        self.num_bootstraps = num_bootstraps

        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw

        allowed_sampling = ("poisson", "multinomial")
        if sampling_strategy not in allowed_sampling:
            raise ValueError(
                f"Expected argument ``sampling_strategy`` to be one of {allowed_sampling}"
                f" but recieved {sampling_strategy}"
            )
        self.sampling_strategy = sampling_strategy
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(int(torch.randint(0, 2**62, ())))
        self.generator = generator

    def forward(self, *args: Any, **kwargs: Any):
        """Batch-value forward with the snapshot taken over the replicas:
        ``Metric.forward`` snapshots only states registered on self, which
        is empty here, so it would wipe the accumulated bootstrap state."""
        self.update(*args, **kwargs)
        self._forward_cache = None

        if self.compute_on_step:
            caches = [m._snapshot_state() for m in self.metrics]
            for m in self.metrics:
                m.reset()
            self.update(*args, **kwargs)
            self._computed = None
            self._forward_cache = self.compute()
            for m, cache in zip(self.metrics, caches):
                m._restore_state(cache)
                m._computed = None
            self._computed = None
            return self._forward_cache

    __call__ = forward

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update all replicas, each on its own resampling of the inputs."""
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        tensors += [v for v in kwargs.values() if isinstance(v, torch.Tensor)]
        if not tensors:
            raise ValueError("None of the input contained tensors, so could not determine the sampling size")
        samples = _bootstrap_sampler(
            len(tensors[0]), self.sampling_strategy, self.num_bootstraps, self.generator, self.device
        )
        for metric, idx in zip(self.metrics, samples):
            pick = lambda x: x.index_select(0, idx.to(x.device))  # noqa: E731
            metric.update(*apply_to_collection(args, torch.Tensor, pick),
                          **apply_to_collection(kwargs, torch.Tensor, pick))

    def compute(self) -> Dict[str, torch.Tensor]:
        """Bootstrapped metric values: dict of ``mean``/``std``/``quantile``/``raw``."""
        computed_vals = torch.stack([m.compute() for m in self.metrics], dim=0)
        output_dict = {}
        if self.mean:
            output_dict["mean"] = torch.mean(computed_vals, dim=0)
        if self.std:
            output_dict["std"] = torch.std(computed_vals, dim=0, correction=1)
        if self.quantile is not None:
            q = torch.as_tensor(self.quantile, dtype=computed_vals.dtype).to(computed_vals.device)
            output_dict["quantile"] = torch.quantile(computed_vals, q)
        if self.raw:
            output_dict["raw"] = computed_vals
        return output_dict

    def reset(self) -> None:
        self._computed = None
        for m in self.metrics:
            m.reset()

    # the replicas own the state: persistence, checkpoints and moves recurse
    # into them, under ``metrics.<i>.``
    def persistent(self, mode: bool = False) -> None:
        for m in self.metrics:
            m.persistent(mode)

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "") -> dict:
        destination = {} if destination is None else destination
        for i, m in enumerate(self.metrics):
            m.state_dict(destination, prefix=f"{prefix}metrics.{i}.")
        return destination

    def load_state_dict(
        self, state_dict: dict, prefix: str = "", strict: bool = False, _warn_on_zero_match: bool = True
    ) -> None:
        for i, m in enumerate(self.metrics):
            m.load_state_dict(state_dict, prefix=f"{prefix}metrics.{i}.", strict=strict, _warn_on_zero_match=False)
        self._computed = None

    def _named_states(self, prefix: str = "") -> list:
        pairs = []
        for i, m in enumerate(self.metrics):
            pairs += m._named_states(f"{prefix}metrics.{i}.")
        return pairs

    def to(self, device: Union[str, torch.device]) -> "BootStrapper":
        """Move the replicas to ``device``; the generator is drawn anew there
        from the current one."""
        self.device = torch.device(device)
        for m in self.metrics:
            m.to(self.device)
        if self.generator.device != self.device:
            seed = int(torch.randint(0, 2**62, (), generator=self.generator, device=self.generator.device))
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(seed)
        self._computed = None
        return self

    def astype(self, dtype: torch.dtype) -> "BootStrapper":
        for m in self.metrics:
            m.astype(dtype)
        self._computed = None
        return self

    def __getstate__(self) -> dict:
        # a generator does not pickle: keep its device and state
        state = super().__getstate__()
        gen = state.pop("generator")
        state["_generator_state"] = (str(gen.device), gen.get_state())
        return state

    def __setstate__(self, state: dict) -> None:
        device, gen_state = state.pop("_generator_state")
        super().__setstate__(state)
        self.generator = torch.Generator(device=device)
        self.generator.set_state(gen_state)
