"""Process and rank identity for observability artifacts.

Port of ``metrics_tpu/observability/identity.py``. Every artifact this
process writes (trace snapshots, flight dumps, telemetry snapshots,
Prometheus text) is stamped with which rank of which world produced it, so
a fleet monitor, or ``scripts/trace_export.py --merge``, can correlate
per-rank evidence. The identity comes from the sync backend's world view
(:func:`~metrics_tpu_torch.parallel.backend.get_sync_backend`): an installed
backend, else an initialized ``torch.distributed`` process group (under
torchrun that is the :class:`TorchDistributedBackend`), else rank 0 of a
world of 1.

Tests and harnesses that simulate several ranks in one process pin the
identity with :func:`set_process_identity` or, per thread, with
:func:`identity_scope`.

Resolving the identity reads the backend and nothing on the device; it is
called on cold paths (snapshot, dump, scrape time) and, with tracing on,
once per sync span.
"""
import os
import socket
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional

__all__ = [
    "process_identity",
    "current_rank",
    "set_process_identity",
    "identity_scope",
]

# explicit overrides: (rank, world_size) or None = auto-detect. The
# process-wide override is what a launcher sets once; the thread-local one
# is for simulated rank threads sharing one process.
_override: Optional[Dict[str, int]] = None
_tls = threading.local()


def _detect() -> Dict[str, int]:
    """Rank and world from the sync backend. Never raises: identity is
    diagnostics, and a half-initialized process group must not break a
    flight dump."""
    try:
        from metrics_tpu_torch.parallel.backend import get_sync_backend

        backend = get_sync_backend()
        return {"rank": int(backend.rank()), "world_size": int(backend.world_size)}
    except Exception:  # noqa: BLE001 - advisory metadata only
        return {"rank": 0, "world_size": 1}


def process_identity() -> Dict[str, Any]:
    """The identity stamp: ``{"rank", "world_size", "host", "pid"}``.

    Resolution order: thread-local :func:`identity_scope` > process-wide
    :func:`set_process_identity` > the active sync backend's rank and world
    size > single-process defaults.
    """
    ident = getattr(_tls, "pinned", None) or _override or _detect()
    return {
        "rank": ident["rank"],
        "world_size": ident["world_size"],
        "host": socket.gethostname(),
        "pid": os.getpid(),
    }


def current_rank() -> int:
    """Just the rank, for call sites that stamp it on a per-step artifact
    (sync spans): no hostname lookup, no stamp dict. Same resolution order
    as :func:`process_identity`."""
    ident = getattr(_tls, "pinned", None) or _override or _detect()
    return ident["rank"]


def set_process_identity(rank: Optional[int] = None, world_size: Optional[int] = None) -> None:
    """Pin the process-wide rank identity (``None, None`` restores
    auto-detection). A launcher that knows its placement calls this once at
    start-up; everything observability writes afterwards carries it."""
    global _override
    if rank is None and world_size is None:
        _override = None
        return
    _override = {
        "rank": int(rank if rank is not None else 0),
        "world_size": int(world_size if world_size is not None else 1),
    }


@contextmanager
def identity_scope(rank: int, world_size: int) -> Iterator[None]:
    """Pin the identity on this thread for a ``with`` block, so a simulated
    rank thread's spans and dumps carry its own rank."""
    prev = getattr(_tls, "pinned", None)
    _tls.pinned = {"rank": int(rank), "world_size": int(world_size)}
    try:
        yield
    finally:
        _tls.pinned = prev
