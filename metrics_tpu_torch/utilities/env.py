"""Single point of truth for the ``METRICS_TPU_*`` debug and telemetry flags.

Own copy of ``metrics_tpu/utilities/env.py``; the flag names are the JAX
package's, so one environment configures either package. Flags that gate
process-wide behaviour are parsed once, at import, and cached here; call
:func:`refresh` after changing the environment (tests do this with
``monkeypatch`` and ``refresh()``).
"""
import os
from typing import Dict, Optional

__all__ = [
    "parse_flag",
    "debug_enabled",
    "telemetry_requested",
    "trace_requested",
    "flight_dir",
    "exporter_port",
    "cost_ledger_requested",
    "refresh",
    "san_enabled",
    "san_requested",
    "set_san_enabled",
]

_TRUTHY = frozenset(("1", "true", "yes", "on"))


def parse_flag(value: Optional[str]) -> bool:
    """Canonical truthiness rule for every METRICS_TPU_* boolean flag."""
    return value is not None and value.strip().lower() in _TRUTHY


def _parse_port(value: Optional[str]) -> Optional[int]:
    """``METRICS_TPU_EXPORTER=<port>``: a base-10 port number (0 = assigned
    by the OS); unset or empty = disabled; anything else = -1 (set but
    unparseable: the exporter warns once and stays off)."""
    value = (value or "").strip()
    if not value:
        return None
    try:
        port = int(value, 10)
    except ValueError:
        return -1
    return port if 0 <= port <= 65535 else -1


def _read() -> Dict[str, object]:
    return {
        "debug": parse_flag(os.environ.get("METRICS_TPU_DEBUG")),
        "telemetry": parse_flag(os.environ.get("METRICS_TPU_TELEMETRY")),
        "trace": parse_flag(os.environ.get("METRICS_TPU_TRACE")),
        "flight": (os.environ.get("METRICS_TPU_FLIGHT") or "").strip() or None,
        "exporter": _parse_port(os.environ.get("METRICS_TPU_EXPORTER")),
        "san": parse_flag(os.environ.get("METRICS_TPU_SAN")),
        "cost_ledger": parse_flag(os.environ.get("METRICS_TPU_COST_LEDGER")),
    }


_flags = _read()


def debug_enabled() -> bool:
    """``METRICS_TPU_DEBUG``: eager value-level precondition asserts (the
    0/1-indicator check in ``_stat_scores``)."""
    return _flags["debug"]


def telemetry_requested() -> bool:
    """``METRICS_TPU_TELEMETRY``: enable the observability registry at
    import (as ``metrics_tpu_torch.observability.enable()`` does)."""
    return _flags["telemetry"]


def trace_requested() -> bool:
    """``METRICS_TPU_TRACE``: enable span tracing at import (as
    ``metrics_tpu_torch.observability.enable_tracing()`` does)."""
    return _flags["trace"]


def flight_dir() -> Optional[str]:
    """``METRICS_TPU_FLIGHT=<dir>``: arm the failure flight recorder at
    import with ``<dir>`` as its dump directory (None = disabled)."""
    return _flags["flight"]


def cost_ledger_requested() -> bool:
    """``METRICS_TPU_COST_LEDGER``: arm the compiled-program cost ledger at
    import (read by ``observability/costledger.py``)."""
    return _flags["cost_ledger"]


def exporter_port() -> Optional[int]:
    """``METRICS_TPU_EXPORTER=<port>``: the Prometheus export surface's port
    (read by ``observability/exporter.py`` at import). None = disabled;
    -1 = set but unparseable."""
    return _flags["exporter"]


# The runtime sanitizer's switch. Unlike the flags above it is flipped at
# run time by the sanitizer's enable/disable, and its hooks read this flag
# (one call and a global read) instead of importing the sanitizer.
_san_runtime = False


def san_requested() -> bool:
    """``METRICS_TPU_SAN``: arm the runtime sanitizer at import."""
    return _flags["san"]


def san_enabled() -> bool:
    """Is the runtime sanitizer armed? Keep it a plain global read."""
    return _san_runtime


def set_san_enabled(value: bool) -> None:
    """Flip the runtime sanitizer flag (the sanitizer's enable/disable call
    it; not user API)."""
    global _san_runtime
    _san_runtime = bool(value)


def refresh() -> Dict[str, object]:
    """Re-read the environment (for tests that change flags after import).
    Returns the new flag values."""
    global _flags
    _flags = _read()
    return dict(_flags)
