"""Host-level synchronization backends.

Port of ``metrics_tpu/parallel/backend.py``. Each process holds replica
metric state; a :class:`SyncBackend` supplies ``world_size`` and an
all-gather, and, for the sharded metrics that hold one shard per process,
the process's ``rank`` and an ``all_to_all``. :class:`TorchDistributedBackend` takes the place of the JAX
package's ``MultiHostBackend``: it gathers over ``torch.distributed`` (NCCL
for CUDA tensors, gloo for CPU tensors; the process group's backend decides,
see :meth:`TorchDistributedBackend.process_group_backend`).

``process_group`` in the reference maps to the ``group`` argument here.
"""
from abc import ABC, abstractmethod
from typing import Any, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F


class SyncBackend(ABC):
    """Strategy object providing DDP-style all-gather of metric state."""

    @property
    @abstractmethod
    def world_size(self) -> int:
        ...

    @abstractmethod
    def gather(self, x: torch.Tensor, group: Optional[Any] = None) -> List[torch.Tensor]:
        """Return ``[x_rank0, x_rank1, ...]``, identical on every rank."""

    def size(self, group: Optional[Any] = None) -> int:
        """The number of ranks in ``group`` (default: the world)."""
        return self.world_size

    def rank(self, group: Optional[Any] = None) -> int:
        """This process's rank in ``group``."""
        if self.size(group) == 1:
            return 0
        raise NotImplementedError(f"{type(self).__name__} does not say which rank this process is")

    def all_to_all(
        self, x: torch.Tensor, send_splits: Sequence[int], recv_splits: Sequence[int], group: Optional[Any] = None
    ) -> torch.Tensor:
        """Send the next ``send_splits[j]`` rows of ``x`` to rank ``j``;
        return the rows received, ``recv_splits[i]`` from rank ``i``,
        concatenated in rank order."""
        if self.size(group) == 1:
            return x
        raise NotImplementedError(f"{type(self).__name__} has no all_to_all")


class SingleProcessBackend(SyncBackend):
    """Trivial backend for one process: gather returns ``[x]``, all_to_all
    returns ``x``."""

    @property
    def world_size(self) -> int:
        return 1

    def gather(self, x: torch.Tensor, group: Optional[Any] = None) -> List[torch.Tensor]:
        return [x]


class TorchDistributedBackend(SyncBackend):
    """All-gather over an initialized ``torch.distributed`` process group.

    Tensors whose shapes differ across ranks (cat states of uneven batches)
    are padded to the largest shape, gathered, and cut back to each rank's
    own shape, as the reference's ``gather_all_tensors`` does.
    """

    @staticmethod
    def process_group_backend(device: Union[str, torch.device]) -> str:
        """The ``torch.distributed`` backend for state on ``device``:
        ``"nccl"`` for CUDA, ``"gloo"`` for the CPU."""
        return "nccl" if torch.device(device).type == "cuda" else "gloo"

    @property
    def world_size(self) -> int:
        return dist.get_world_size()

    def size(self, group: Optional[Any] = None) -> int:
        return dist.get_world_size(group)

    def rank(self, group: Optional[Any] = None) -> int:
        return dist.get_rank(group)

    def all_to_all(
        self, x: torch.Tensor, send_splits: Sequence[int], recv_splits: Sequence[int], group: Optional[Any] = None
    ) -> torch.Tensor:
        """``all_to_all_single`` with per-rank split sizes along dim 0: no
        padding to a common block size."""
        out = x.new_empty((sum(recv_splits), *x.shape[1:]))
        dist.all_to_all_single(
            out, x.contiguous(), output_split_sizes=list(recv_splits), input_split_sizes=list(send_splits), group=group
        )
        return out

    def gather(self, x: torch.Tensor, group: Optional[Any] = None) -> List[torch.Tensor]:
        x = x.contiguous()
        world = dist.get_world_size(group)
        if x.ndim == 0:
            out = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(out, x, group=group)
            return out
        local_size = torch.tensor(x.shape, device=x.device)
        sizes = [torch.zeros_like(local_size) for _ in range(world)]
        dist.all_gather(sizes, local_size, group=group)
        max_size = torch.stack(sizes).max(dim=0).values
        if all(bool((s == max_size).all()) for s in sizes):
            out = [torch.empty_like(x) for _ in range(world)]
            dist.all_gather(out, x, group=group)
            return out
        pad = []
        for by in reversed((max_size - local_size).tolist()):
            pad += [0, by]
        padded = F.pad(x, pad)
        out = [torch.empty_like(padded) for _ in range(world)]
        dist.all_gather(out, padded, group=group)
        return [o[tuple(slice(d) for d in s.tolist())] for o, s in zip(out, sizes)]


_BACKEND: Optional[SyncBackend] = None


def set_sync_backend(backend: Optional[SyncBackend]) -> Optional[SyncBackend]:
    """Install a process-global sync backend (None restores auto-detection).

    Returns the previously installed backend so callers that replace it
    temporarily (tests) can restore it exactly."""
    global _BACKEND
    prev = _BACKEND
    _BACKEND = backend
    return prev


def _process_group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_sync_backend() -> SyncBackend:
    """Active backend: explicit > initialized ``torch.distributed`` > single-process."""
    if _BACKEND is not None:
        return _BACKEND
    if _process_group_up():
        return TorchDistributedBackend()
    return SingleProcessBackend()


def is_distributed_initialized() -> bool:
    """True when an explicit backend is installed or a ``torch.distributed``
    process group is initialized (reference ``metric.py:213-216``)."""
    return _BACKEND is not None or _process_group_up()
