"""Collectives over the sync backend that the sharded metrics need.

Port of ``masked_cat_sync`` and its telemetry (``_count_collective``) from
``metrics_tpu/parallel/collective.py``; the rest of that module (quantized
and hierarchical sync) is not ported yet.
"""
from typing import Any, Optional, Tuple

import torch

from metrics_tpu_torch.observability import telemetry as _obs
from metrics_tpu_torch.parallel.backend import get_sync_backend


def _count_collective(op: str, logical_bytes: int, wire_bytes: int, n_ops: int = 1) -> None:
    """Telemetry for one collective: ``collective.payload_bytes`` counts the
    logical state bytes (what the metric syncs, dtype as registered) and
    ``collective.wire_bytes`` the bytes sent (equal on the exact path; the
    gap is the quantized tier's compression). The JAX package counts at
    trace time, once per compiled program; the port's collectives run
    eagerly, so every executed collective counts."""
    tel = _obs.get()
    tel.count(f"collective.{op}")
    tel.count("collective.ops", n_ops)
    tel.count("collective.payload_bytes", logical_bytes)
    tel.count("collective.wire_bytes", wire_bytes)
    tel.observe_hist("collective.payload_bytes", logical_bytes, _obs.PAYLOAD_BUCKETS_BYTES)
    tel.observe_hist("collective.wire_bytes", wire_bytes, _obs.PAYLOAD_BUCKETS_BYTES)


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
    if _obs.enabled():
        payload = _obs.array_nbytes(buffer) + _obs.array_nbytes(count)
        _count_collective("cat", payload, payload, n_ops=2)
    backend = get_sync_backend()
    gathered = torch.cat(backend.gather(buffer, group), 0)
    counts = torch.stack(backend.gather(count.reshape(()), group))
    capacity = buffer.shape[0]
    slots = torch.arange(capacity, device=buffer.device)
    mask = (slots < torch.clamp_max(counts, capacity)[:, None]).reshape(-1)
    return gathered, counts, mask
