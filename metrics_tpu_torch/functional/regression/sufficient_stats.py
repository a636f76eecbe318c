"""Shared single-pass sufficient statistics for the regression family.

Port of ``metrics_tpu/functional/regression/sufficient_stats.py``. Every
streaming regression metric accumulates some subset of the same moments of
``(preds, target)``:

==================  =============================================
metric              sufficient statistics
==================  =============================================
MeanSquaredError    ``Σd²``, ``n``            (``d = target − preds``)
MeanAbsoluteError   ``Σ|d|``, ``n``
PSNR (dim=None)     ``Σd²``, ``n``, ``min y``, ``max y``
R2Score             ``Σy``, ``Σy²``, ``Σd²``, ``n``   (per output)
ExplainedVariance   ``Σd``, ``Σd²``, ``Σy``, ``Σy²``, ``n``
==================  =============================================

Run separately, a collection of k regression metrics reads the inputs k
times. :func:`regression_sufficient_stats` computes the union once (per
output for ≤2-D inputs, over the full stream above that, plus the target's
min and max) and the family's ``_*_update`` helpers derive their states
from it.

Sharing is scoped twice: inside :func:`regression_family_sharing` (opened
by ``MetricCollection``'s forward and update only) AND inside
:func:`~metrics_tpu_torch.utilities.checks.shared_canonicalization` (whose
memo keys the stats on input identity). Outside either, each metric keeps
its own minimal update: a lone MeanSquaredError never pays for moments it
does not use.
"""
import threading
from contextlib import contextmanager
from typing import Dict, Optional

import torch

from metrics_tpu_torch.utilities.checks import _canon_memo, _check_same_shape, fast_path_memo
from metrics_tpu_torch.utilities.data import promote_accumulator

__all__ = ["regression_family_sharing", "regression_sufficient_stats"]


_sharing = threading.local()


@contextmanager
def regression_family_sharing():
    """Scope in which the regression family pools its input moments.

    Entered by the multi-metric fan-out only (``MetricCollection``'s
    forward and update). It is a separate gate from
    ``shared_canonicalization`` on purpose: a composite opens a
    canonicalization scope too, and a metric on its own must keep its
    single-moment update, since eagerly every unused moment is a real pass
    over the inputs."""
    prev = getattr(_sharing, "active", False)
    _sharing.active = True
    try:
        yield
    finally:
        _sharing.active = prev


def _compute_stats(preds: torch.Tensor, target: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The single pass. Per-output (``dim=0``) moments when the inputs are
    ≤2-D (the R2/ExplainedVariance layout); full-stream moments otherwise
    (image-shaped PSNR/MSE inputs have no output axis)."""
    preds, target = promote_accumulator(preds, target)
    diff = target - preds
    per_output = preds.ndim <= 2

    def total(x: torch.Tensor) -> torch.Tensor:
        return torch.sum(x, dim=0) if per_output else torch.sum(x)

    return {
        "sum_diff": total(diff),
        "sum_abs_diff": total(torch.abs(diff)),
        "sum_sq_diff": total(diff * diff),
        "sum_target": total(target),
        "sum_sq_target": total(target * target),
        "min_target": torch.min(target),
        "max_target": torch.max(target),
    }


def regression_sufficient_stats(preds: torch.Tensor, target: torch.Tensor) -> Optional[Dict[str, torch.Tensor]]:
    """Shared moments of ``(preds, target)``, or None outside a sharing
    context.

    Inside both scopes (module docstring) the dict is memoized on input
    identity: the first regression sibling computes every moment in one
    pass, the rest hit the memo. Keys: ``sum_diff`` / ``sum_abs_diff`` /
    ``sum_sq_diff`` (``d = target − preds``), ``sum_target`` /
    ``sum_sq_target``, per output for ≤2-D inputs and full-stream
    otherwise, plus 0-d ``min_target`` / ``max_target``. Derive full sums
    with :func:`full_sum`.
    """
    if not getattr(_sharing, "active", False):
        return None
    if getattr(_canon_memo, "store", None) is None:
        return None
    _check_same_shape(preds, target)
    key = (
        "regression_sufficient_stats",
        id(preds),
        id(target),
        tuple(preds.shape),
        str(preds.dtype),
        str(target.dtype),
    )
    return fast_path_memo(key, (preds, target), lambda: _compute_stats(preds, target))


def full_sum(stat: torch.Tensor) -> torch.Tensor:
    """Collapse a per-output moment to the full-stream sum (the identity for
    the already-0-d >2-D layout)."""
    return torch.sum(stat)
