"""Process-zero-only warnings.

Own copy of ``metrics_tpu/utilities/prints.py``. The rank comes from
``torch.distributed`` when a process group is up, else from the
``LOCAL_RANK`` environment variable that torchrun-style launchers set.
"""
import os
import warnings
from functools import wraps

def _get_rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("LOCAL_RANK", 0))


def rank_zero_only(fn):
    @wraps(fn)
    def wrapped_fn(*args, **kwargs):
        rank = rank_zero_only.rank
        if rank is None:
            # resolved at first use: a process group may come up after import
            rank = rank_zero_only.rank = _get_rank()
        if rank == 0:
            return fn(*args, **kwargs)

    return wrapped_fn


# LOCAL_RANK (torchrun-style) wins when set; otherwise the process group's rank at first use.
rank_zero_only.rank = int(os.environ["LOCAL_RANK"]) if "LOCAL_RANK" in os.environ else None


def _warn(*args, **kwargs):
    warnings.warn(*args, **kwargs)


# warn_once dedup registry; bounded so a caller generating unbounded
# distinct keys cannot grow memory — past the cap new keys are dropped,
# which is the right failure mode for a rate limiter.
_WARN_ONCE_SEEN = set()
_WARN_ONCE_CAP = 4096


def warn_once(message: str, *args, key: str = None, **kwargs) -> bool:
    """Rank-zero warning emitted at most once per ``key`` per process.

    ``key`` defaults to the message itself; pass an explicit key when the
    message embeds variable detail that should not defeat deduplication.
    Returns True iff the warning was emitted.
    """
    k = key if key is not None else str(message)
    if k in _WARN_ONCE_SEEN or len(_WARN_ONCE_SEEN) >= _WARN_ONCE_CAP:
        return False
    _WARN_ONCE_SEEN.add(k)
    rank_zero_warn(message, *args, **kwargs)
    return True


rank_zero_warn = rank_zero_only(_warn)
