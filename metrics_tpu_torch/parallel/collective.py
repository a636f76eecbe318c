"""Collectives for metric-state synchronization.

Port of ``metrics_tpu/parallel/collective.py``. Sync keeps the
all-gather-then-locally-reduce contract: every rank ends with identical
synced state.

* ``"sum"`` / ``"mean"`` / ``"min"`` / ``"max"`` states: ``all_reduce`` over
  ``torch.distributed`` when the active backend is a
  :class:`~metrics_tpu_torch.parallel.backend.TorchDistributedBackend`;
  over any other backend (one process, a threaded test world, a
  hierarchical one) a gather and the same reduction as
  ``Metric._sync_dist`` applies.
* ``"cat"`` states: the rank-order concatenation along dim 0 (an
  ``all_gather``, tiled); ``None`` keeps the gathered ``(world, ...)``
  stack.
* :func:`qsync_sum` / :func:`qsync_state`: the quantized tier, which
  gathers the int8 / bf16 wire payload and merges it through
  :func:`~metrics_tpu_torch.parallel.quantize.merge_dequantized`.

``group`` takes the place of the JAX package's mesh ``axis_name``. The JAX
collectives run inside a ``shard_map`` program and count their telemetry at
trace time, once per compiled program; these run eagerly, once per call, and
count every executed collective.
"""
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from metrics_tpu_torch.observability import telemetry as _obs
from metrics_tpu_torch.parallel import quantize as _q
from metrics_tpu_torch.parallel.backend import TorchDistributedBackend, get_sync_backend
from metrics_tpu_torch.utilities.data import dim_zero_max, dim_zero_mean, dim_zero_min, dim_zero_sum

Reduction = Union[str, None]

_VALID = ("sum", "mean", "min", "max", "cat", None)

_ALL_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX, "mean": dist.ReduceOp.SUM}
_GATHER_REDUCTIONS = {"sum": dim_zero_sum, "mean": dim_zero_mean, "min": dim_zero_min, "max": dim_zero_max}


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


def sync_array(x: torch.Tensor, reduction: Reduction, group: Optional[Any] = None) -> torch.Tensor:
    """Synchronize one tensor across the ranks of ``group`` per the reduction
    spec. With telemetry on, each call counts one ``collective.<reduction>``
    op (``collective.gather`` for None) and its bytes: on this exact path
    the wire bytes equal the logical bytes."""
    if reduction not in _VALID:
        raise ValueError(f"`reduction` must be one of {_VALID}, got {reduction!r}")
    if _obs.enabled():
        payload = _obs.array_nbytes(x)
        _count_collective(reduction if reduction is not None else "gather", payload, payload)
    backend = get_sync_backend()
    if reduction in _ALL_REDUCE_OPS and isinstance(backend, TorchDistributedBackend):
        out = x.clone()
        dist.all_reduce(out, op=_ALL_REDUCE_OPS[reduction], group=group)
        return out / backend.size(group) if reduction == "mean" else out
    gathered = backend.gather(x, group=group)
    if reduction == "cat":
        return torch.cat(list(gathered), 0) if x.ndim else torch.stack(list(gathered))
    stacked = torch.stack(list(gathered))
    return stacked if reduction is None else _GATHER_REDUCTIONS[reduction](stacked)


def sync_state(state: Dict[str, Any], reductions: Dict[str, Reduction], group: Optional[Any] = None) -> Dict[str, Any]:
    """Synchronize a metric-state dict: ``reductions`` maps state names to
    specs (missing names default to ``"sum"``); a state may be a nested
    structure of tensors."""
    out = {}
    for name, val in state.items():
        red = reductions.get(name, "sum")
        out[name] = pytree.tree_map(lambda v, _red=red: sync_array(v, _red, group), val)
    return out


def qsync_sum(
    x: torch.Tensor,
    precision: str,
    group: Optional[Any] = None,
    residual: Optional[torch.Tensor] = None,
    block_size: int = _q.DEFAULT_BLOCK_SIZE,
):
    """Quantized cross-rank sum of ``x``: block-scaled quantize → all-gather
    the low-precision payload → dequantize and sum in f32, in rank order.

    The wire carries only the quantized form (int8 codes + f32 block scales,
    or a bf16 cast): ~3.9× (int8) / 2× (bf16) fewer bytes than the f32 sum.
    Every rank computes the same sum of the same contributions, so the
    result is the same on every rank and does not depend on the layout.

    With ``residual`` (a persistent f32 tensor shaped like ``x``), error
    feedback is applied: the previous sync's quantization error is folded
    into this contribution and the new error returned, as
    ``(synced, new_residual)``. Without it, only the synced sum is returned.

    ``precision="exact"`` is :func:`sync_array`'s sum; a given residual
    passes through unchanged.
    """
    if precision == "exact":
        out = sync_array(x, "sum", group)
        return out if residual is None else (out, residual)
    payload, new_residual = _q.compensate_and_quantize(x, residual, precision, block_size)
    if _obs.enabled():
        _count_collective(
            f"qsum_{precision}", _obs.array_nbytes(x), _q.payload_wire_nbytes(payload), n_ops=len(payload)
        )
    backend = get_sync_backend()
    gathered = {k: backend.gather(v, group=group) for k, v in payload.items()}
    world = len(gathered["q"])
    out = _q.merge_dequantized([{k: v[r] for k, v in gathered.items()} for r in range(world)], x.shape, x.dtype)
    return out if residual is None else (out, new_residual)


def qsync_state(
    state: Dict[str, Any],
    reductions: Dict[str, Reduction],
    precisions: Dict[str, str],
    group: Optional[Any] = None,
    residuals: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """:func:`sync_state` with a per-state precision map: states named in
    ``precisions`` with a tier other than ``"exact"`` sync through
    :func:`qsync_sum` (their reduction must be ``"sum"``), every other state
    through the exact path. Returns ``(synced_state, new_residuals)``; pass
    the returned residuals back on the next sync to keep the error-feedback
    loop closed."""
    residuals = residuals or {}
    out: Dict[str, Any] = {}
    new_residuals: Dict[str, torch.Tensor] = {}
    for name, val in state.items():
        red = reductions.get(name, "sum")
        precision = precisions.get(name, "exact")
        if precision != "exact":
            if red != "sum":
                raise ValueError(
                    f"state {name!r}: sync_precision={precision!r} requires a 'sum' reduction, got {red!r}"
                )
            residual = residuals.get(name)
            if residual is None:
                residual = torch.zeros(val.shape, dtype=torch.float32, device=val.device)
            out[name], new_residuals[name] = qsync_sum(val, precision, group, residual=residual)
        else:
            out[name] = pytree.tree_map(lambda v, _red=red: sync_array(v, _red, group), val)
    return out, new_residuals
