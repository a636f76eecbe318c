"""Carry metric state from the JAX package into this one.

A ``metrics_tpu`` metric's or collection's ``state_dict()`` holds JAX
arrays (or lists of them). Turn each into a numpy array on the JAX side
(``numpy.asarray``), hand the dict to :func:`state_from_jax`, and load the
result with ``load_state_dict`` on the matching metric or collection of this
package, on any device: an epoch accumulated by the JAX package then
computes the same values here. This module imports neither JAX nor the JAX
package; it reads only numpy arrays.

A JAX sharded metric (``ShardedAUROC``, ...) holds its streams as global
``(capacity, ...)`` arrays laid out over a mesh of ``world`` devices, with
``(world,)`` fill counts. The port holds one shard per rank, so
``state_from_jax(state, rank=r, world=W)`` gives rank ``r`` its shard: slots
``[r·cap, (r+1)·cap)`` of every stream and ``counts[r]`` at index ``r`` of
its counts. With ``world=1`` and a one-device mesh this is the identity.

A JAX ``BootStrapper`` registers no state of its own: its replicas hold it.
Pass ``[numpy state dict of each replica]`` (``m.state_dict()`` of each of
its ``metrics``, as numpy arrays); the result carries replica ``i``'s
states under ``metrics.<i>.``, which this package's ``BootStrapper`` loads.
"""
from typing import Any, Dict, Sequence, Union

import numpy as np
import torch

StateValue = Union[torch.Tensor, list]


def _tensor(value: Any) -> torch.Tensor:
    # np.array copies, so the tensor shares no memory with the caller's array
    array = np.array(value)
    if array.dtype.name == "bfloat16":
        # JAX's bfloat16 (ml_dtypes) has no numpy buffer type torch reads;
        # widening to float32 is exact, and the cast back restores the bits
        return torch.from_numpy(array.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(array)


def _shard(state: Dict[str, torch.Tensor], rank: int, world: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s shard of every sharded metric's state in ``state``:
    each ``<prefix>counts`` marks one, whose ``<prefix>buf_*`` streams are
    cut to the rank's slots."""
    out = dict(state)
    for key, counts in state.items():
        if key.rsplit(".", 1)[-1] != "counts" or not isinstance(counts, torch.Tensor):
            continue
        if counts.shape != (world,):
            raise ValueError(f"{key} holds the fills of {counts.shape[0]} devices, not of a world of {world}")
        prefix = key[: -len("counts")]
        own = torch.zeros_like(counts)
        own[rank] = counts[rank]
        out[key] = own
        for name, value in state.items():
            if name.startswith(prefix + "buf_") and "." not in name[len(prefix):]:
                cap = value.shape[0] // world
                out[name] = value[rank * cap:(rank + 1) * cap].clone()
    return out


def state_from_jax(
    state_dict: Union[Dict[str, Any], Sequence[Dict[str, Any]]], rank: int = 0, world: int = 1
) -> Dict[str, StateValue]:
    """Convert a JAX ``state_dict`` of numpy arrays (or lists of them) into
    this package's state dict of CPU tensors (or lists of them), key for key
    and dtype for dtype. Sharded metrics' states are cut to rank ``rank``'s
    shard of a world of ``world`` ranks. A sequence of state dicts is a
    ``BootStrapper``'s replicas, keyed ``metrics.<i>.`` (module docstring)."""
    if isinstance(state_dict, (list, tuple)):
        return {
            f"metrics.{i}.{key}": value
            for i, replica in enumerate(state_dict)
            for key, value in state_from_jax(replica, rank, world).items()
        }
    converted = {
        key: [_tensor(v) for v in value] if isinstance(value, (list, tuple)) else _tensor(value)
        for key, value in state_dict.items()
    }
    return converted if world == 1 else _shard(converted, rank, world)
