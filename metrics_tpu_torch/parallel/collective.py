"""Collectives over the sync backend that the sharded metrics need.

Port of ``masked_cat_sync`` from ``metrics_tpu/parallel/collective.py``; the
rest of that module (quantized and hierarchical sync) is not ported yet.
"""
from typing import Any, Optional, Tuple

import torch

from metrics_tpu_torch.parallel.backend import get_sync_backend


def masked_cat_sync(
    buffer: torch.Tensor, count: torch.Tensor, group: Optional[Any] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All-gather a fixed-capacity "cat" buffer plus its fill count.

    Each rank holds a preallocated ``(capacity, ...)`` buffer and a scalar
    ``count``. Returns the gathered ``(world*capacity, ...)`` buffer in rank
    order, the gathered per-rank counts ``(world,)``, and a validity mask
    aligned with the gathered buffer. The mask clamps each count at the
    capacity: a count that ran past it never validates slots that were never
    written.
    """
    backend = get_sync_backend()
    gathered = torch.cat(backend.gather(buffer, group), 0)
    counts = torch.stack(backend.gather(count.reshape(()), group))
    capacity = buffer.shape[0]
    slots = torch.arange(capacity, device=buffer.device)
    mask = (slots < torch.clamp_max(counts, capacity)[:, None]).reshape(-1)
    return gathered, counts, mask
