"""Carry metric state from the JAX package into this one.

A ``metrics_tpu`` metric's or collection's ``state_dict()`` holds JAX
arrays (or lists of them). Turn each into a numpy array on the JAX side
(``numpy.asarray``), hand the dict to :func:`state_from_jax`, and load the
result with ``load_state_dict`` on the matching metric or collection of this
package, on any device: an epoch accumulated by the JAX package then
computes the same values here. This module imports neither JAX nor the JAX
package; it reads only numpy arrays.
"""
from typing import Any, Dict, Union

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


def state_from_jax(state_dict: Dict[str, Any]) -> Dict[str, StateValue]:
    """Convert a JAX ``state_dict`` of numpy arrays (or lists of them) into
    this package's state dict of CPU tensors (or lists of them), key for key
    and dtype for dtype."""
    return {
        key: [_tensor(v) for v in value] if isinstance(value, (list, tuple)) else _tensor(value)
        for key, value in state_dict.items()
    }
