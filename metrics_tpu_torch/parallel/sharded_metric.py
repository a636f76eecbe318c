"""Fixed-capacity append streams, one shard per process, as metric state.

Port of ``metrics_tpu/parallel/sharded_metric.py`` for the port's
multi-device model: one process per card over ``torch.distributed`` (the
JAX package's multi-controller contract). Each rank holds
``capacity_per_device`` slots of every stream on its own device, with its
own fill count, and appends its own local batch; ``world`` is the size of
the metric's process group (1 without one), fixed at construction.
Overflow is loud and checked on the host before anything is written.

Appends write into the preallocated buffers in place (bounded memory is
the point of this state); ``forward``'s snapshot stays intact because
``reset`` replaces the buffers before the batch-local update writes.

``ShardedStreamsMixin`` precedes :class:`~metrics_tpu_torch.Metric` in the
MRO: it implements the pickling, checkpoint, reset and forward-snapshot
hooks in terms of the stream states.
"""
from typing import Dict, Tuple

import torch

from metrics_tpu_torch.parallel.backend import get_sync_backend
from metrics_tpu_torch.parallel.collective import masked_cat_sync


class ShardedStreamsMixin:
    """State layout and lifecycle for metrics with per-rank append streams.

    Subclasses call :meth:`_init_streams` in ``__init__`` (after the
    ``Metric`` base init), then use :meth:`_append_streams` in ``update``
    and :meth:`_gather_streams` (or the local buffers) in ``compute``.

    The ``counts`` state is a ``(world,)`` int32 vector laid out as the JAX
    package's global one: this rank's fill at index ``rank``, 0 elsewhere,
    so a checkpoint records the world it was saved in.
    """

    def _init_streams(self, stream_specs: Dict[str, Tuple[torch.dtype, Tuple[int, ...]]], capacity_per_device: int):
        """``stream_specs``: ordered ``{state_name: (dtype, trailing_shape)}``."""
        if capacity_per_device < 1:
            raise ValueError(f"`capacity_per_device` must be positive, got {capacity_per_device}")
        backend = get_sync_backend()
        self.world = backend.size(self.process_group)
        self.rank = backend.rank(self.process_group)
        self.capacity_per_device = capacity_per_device
        self.capacity = capacity_per_device * self.world
        self._stream_names = tuple(stream_specs)
        self._n_seen = 0  # this rank's fill, on the host
        for name, (dtype, suffix) in stream_specs.items():
            zeros = torch.zeros((capacity_per_device, *suffix), dtype=dtype, device=self.device)
            self.add_state(name, default=zeros, dist_reduce_fx=None)
        self.add_state("counts", default=torch.zeros(self.world, dtype=torch.int32, device=self.device))

    def _append_streams(self, *tensors: torch.Tensor) -> None:
        """Append this rank's batch (first dim = n) to every stream, in spec
        order, cast to the stream's dtype. Raises before writing anything
        when the batch would overflow this rank's capacity."""
        n = int(tensors[0].shape[0])
        if self._n_seen + n > self.capacity_per_device:
            owner = "capacity" if self.world == 1 else f"rank {self.rank}'s capacity"
            raise ValueError(
                f"sharded stream state overflow: {self._n_seen} + {n} samples exceed {owner}"
                f" {self.capacity_per_device} ({self.capacity_per_device}/device ×"
                f" {self.world} devices). Construct with a larger"
                " `capacity_per_device` for this evaluation size."
            )
        lo = self._n_seen
        for name, t in zip(self._stream_names, tensors):
            getattr(self, name)[lo:lo + n].copy_(t)
        counts = self.counts.clone()
        counts[self.rank] += n
        self.counts = counts
        self._n_seen += n

    def _fill(self) -> int:
        """This rank's valid prefix: its fill, clamped at the capacity."""
        return min(self._n_seen, self.capacity_per_device)

    def _gather_streams(self) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
        """Every stream gathered over the ranks, ``(world*capacity, ...)`` in
        rank order, and the validity mask (``masked_cat_sync``)."""
        count = self.counts[self.rank]
        gathered = [masked_cat_sync(getattr(self, name), count, self.process_group) for name in self._stream_names]
        return tuple(g[0] for g in gathered), gathered[0][2]

    # -- lifecycle -----------------------------------------------------

    def reset(self) -> None:
        super().reset()
        self._n_seen = 0

    def _snapshot_state(self):
        # forward()'s snapshot/reset/restore cycle must carry the host-side
        # fill level too, or the overflow guard would forget prior batches
        cache = super()._snapshot_state()
        cache["_n_seen"] = self._n_seen
        return cache

    def __setstate__(self, state: dict) -> None:
        super().__setstate__(state)
        # a shard belongs to one rank of one world
        backend = get_sync_backend()
        here = (backend.rank(self.process_group), backend.size(self.process_group))
        if here != (self.rank, self.world):
            raise RuntimeError(
                f"unpickling the shard of rank {self.rank} of {self.world} as rank {here[0]} of {here[1]};"
                " each rank restores its own shard in a world of the same size"
            )

    def load_state_dict(
        self,
        state_dict: dict,
        prefix: str = "",
        strict: bool = False,
        _warn_on_zero_match: bool = True,
    ) -> None:
        # a checkpoint from another world size cannot be resharded blindly:
        # counts are per rank and the mask logic depends on world/capacity
        counts = state_dict.get(prefix + "counts")
        if counts is not None:
            counts = torch.as_tensor(counts)
            if counts.shape[0] != self.world:
                raise ValueError(
                    f"checkpoint was saved on a {counts.shape[0]}-device mesh axis but"
                    f" this metric shards over {self.world} devices; rebuild the"
                    " metric on a matching mesh (or re-accumulate)"
                )
            others = torch.cat([counts[: self.rank], counts[self.rank + 1:]])
            if bool((others != 0).any()):
                raise ValueError(
                    f"checkpoint holds the fill of another rank ({counts.tolist()}), not of rank {self.rank}"
                )
        first = self._stream_names[0]
        if prefix + first in state_dict:
            saved_cap = torch.as_tensor(state_dict[prefix + first]).shape[0] * self.world
            if saved_cap != self.capacity:
                raise ValueError(
                    f"checkpoint capacity {saved_cap} != this metric's capacity"
                    f" {self.capacity} ({self.capacity_per_device}/device)"
                )
        super().load_state_dict(state_dict, prefix, strict=strict, _warn_on_zero_match=_warn_on_zero_match)
        if counts is not None:
            self._n_seen = int(counts.sum())
