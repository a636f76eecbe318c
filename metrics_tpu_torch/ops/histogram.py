"""Label-space counts.

Port of ``label_bincount`` from ``metrics_tpu/ops/histogram.py``. The JAX
package routes small lengths through a one-hot contraction because XLA:TPU
lowers scatter-add serially; on a GPU ``torch.bincount`` is the direct form.
No Pallas kernel is involved: the package's Pallas histogram was retired.
"""
import torch


def label_bincount(indices: torch.Tensor, length: int) -> torch.Tensor:
    """Counts of each label in ``[0, length)``, under the JAX package's
    out-of-range contract: negatives clamp to bucket 0, labels ``>= length``
    are dropped.

    Example:
        >>> label_bincount(torch.tensor([-1, 0, 2, 2, 5]), length=3)
        tensor([2, 0, 2])
    """
    idx = indices.reshape(-1).to(torch.int64).clamp_min(0)
    # out-of-range labels go to one spare bucket, cut off below
    idx = torch.where(idx < length, idx, length)
    return torch.bincount(idx, minlength=length + 1)[:length]
