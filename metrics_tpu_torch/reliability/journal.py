"""JSON artifacts written atomically.

Port of ``atomic_write_json`` from ``metrics_tpu/reliability/journal.py``;
the checkpoint journal of that module is not ported yet.
"""
import json
from typing import Any

from metrics_tpu_torch.reliability.checkpoint import atomic_file

__all__ = ["atomic_write_json"]


def atomic_write_json(path: Any, obj: Any) -> None:
    """Serialize ``obj`` as JSON to ``path`` through :func:`atomic_file`: a
    crash mid-write leaves the previous file, never a torn one."""
    with atomic_file(path) as f:
        f.write(json.dumps(obj, indent=1).encode())
