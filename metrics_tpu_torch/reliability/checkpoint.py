"""Validated checkpointing: a versioned, checksummed state envelope.

Port of ``metrics_tpu/reliability/checkpoint.py``. ``Metric.state_dict()`` /
``load_state_dict()`` move raw tensors with no provenance: a checkpoint
written by a differently configured metric loads *silently partially*. The
envelope closes that hole:

.. code-block:: python

    env = {
        "format":         "metrics_tpu.state_envelope",
        "schema_version": 1,
        "metric_type":    "MetricCollection",       # informational
        "complete":       True,                      # covers every state?
        "spec":  {key: {"kind": "array", "dtype": "float32", "shape": [3]},
                  key2: {"kind": "list", "len": 2, "dtype": [...], "shape": [...]}},
        "payload": {key: <array>, key2: [<array>, <array>]},
        "checksum": "crc32:xxxxxxxx",                # over payload bytes
    }

:func:`load_envelope` verifies, in order: the format marker, the schema
version, the payload checksum (bit rot, truncation), and, under
``strict=True``, that the envelope's keys and per-state dtype/shape specs
exactly match the receiving metric's registered states. A rejection raises
a typed :class:`CheckpointError` subclass and counts
``reliability.checkpoint_rejects`` in telemetry.

The envelope is the JAX package's, both ways: the same state gives the same
spec, the same ``checksum`` string and the same decoded header, and a file
or blob written by either package loads strictly into the other. So specs
and checksums use numpy's dtype names (``float32``, ``int32``) and shape
reprs, and the payload holds host numpy arrays: one device-to-host copy per
state at save time, owned by the envelope. numpy has no ``bfloat16``
without the ``ml_dtypes`` package (which this package does not need), so a
``bfloat16`` state is held in the payload as a CPU ``torch.bfloat16``
tensor; its spec and checksum text say ``bfloat16``, and it travels in a
file as its raw 2-byte words, exactly as JAX writes it. A payload entry
that already is an ``ml_dtypes`` bfloat16 array (a JAX envelope in memory)
is read the same way. The ``.npz`` bytes of two packages' files can still
differ: ``np.savez`` stamps zip times.
"""
import io
import json
import os
import zlib
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from metrics_tpu_torch.observability import telemetry as _obs
from metrics_tpu_torch.utilities.prints import warn_once

__all__ = [
    "ENVELOPE_FORMAT",
    "SCHEMA_VERSION",
    "CheckpointError",
    "CheckpointSchemaError",
    "CheckpointCorruptionError",
    "CheckpointMismatchError",
    "atomic_file",
    "envelope_from_bytes",
    "envelope_from_pairs",
    "envelope_to_bytes",
    "save_envelope",
    "load_envelope",
    "write_envelope",
    "read_envelope",
]

ENVELOPE_FORMAT = "metrics_tpu.state_envelope"
SCHEMA_VERSION = 1

_BF16 = "bfloat16"


class CheckpointError(RuntimeError):
    """Base of every envelope rejection."""


class CheckpointSchemaError(CheckpointError):
    """Not an envelope, or written by an incompatible schema version."""


class CheckpointCorruptionError(CheckpointError):
    """The payload checksum does not match (bit rot, truncation, tamper)."""


class CheckpointMismatchError(CheckpointError):
    """Strict load: envelope keys/dtypes/shapes do not match the metric."""


def _reject(exc: CheckpointError) -> CheckpointError:
    if _obs.enabled():
        _obs.get().count("reliability.checkpoint_rejects")
        _obs.get().event("checkpoint_reject", error=f"{type(exc).__name__}: {exc}")
    return exc


# ----------------------------------------------------------------------
# payload plumbing
# ----------------------------------------------------------------------
def _np(v: Any) -> Any:
    """One state value as an owned host array: a numpy array, or a CPU
    ``torch.bfloat16`` tensor for bfloat16 (module docstring). A CUDA
    tensor costs one device-to-host copy."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            return v.to("cpu", copy=True)
        return v.cpu().numpy().copy() if v.device.type == "cpu" else v.cpu().numpy()
    arr = np.asarray(v)
    if not isinstance(v, np.ndarray):
        return np.array(arr)
    # ascontiguousarray alone promotes 0-d to 1-d; keep the true shape
    return np.ascontiguousarray(arr).reshape(arr.shape)


def _dtype_name(arr: Any) -> str:
    return _BF16 if isinstance(arr, torch.Tensor) else str(arr.dtype)


def _shape(arr: Any) -> Tuple[int, ...]:
    return tuple(int(d) for d in arr.shape)


def _raw_bytes(arr: Any) -> bytes:
    """The value's bytes as the JAX package hashes and writes them (a
    bfloat16 value: its 2-byte words)."""
    if isinstance(arr, torch.Tensor):
        return arr.contiguous().view(torch.int16).numpy().tobytes()
    return arr.tobytes()


def _dtype(name: str) -> np.dtype:
    """numpy's dtype of a spec name; bfloat16 decodes as its uint16 words."""
    return np.dtype(np.uint16) if name == _BF16 else np.dtype(name)


def _spec_of(value: Any) -> Dict[str, Any]:
    if isinstance(value, list):
        return {
            "kind": "list",
            "len": len(value),
            "dtype": [_dtype_name(_np(v)) for v in value],
            "shape": [list(_shape(_np(v))) for v in value],
        }
    arr = _np(value)
    return {"kind": "array", "dtype": _dtype_name(arr), "shape": list(_shape(arr))}


def _checksum(payload: Dict[str, Any]) -> str:
    crc = 0
    for key in sorted(payload):
        crc = zlib.crc32(key.encode(), crc)
        val = payload[key]
        for v in val if isinstance(val, list) else [val]:
            arr = _np(v)
            crc = zlib.crc32(f"{_dtype_name(arr)}{_shape(arr)}".encode(), crc)
            crc = zlib.crc32(_raw_bytes(arr), crc)
    return f"crc32:{crc:08x}"


def _to_tensor(v: Any) -> Any:
    """A payload value as a CPU tensor ``load_state_dict`` accepts (an
    ``ml_dtypes`` bfloat16 array is read as its 2-byte words), sharing the
    payload's memory: ``load_state_dict`` copies it onto the metric's
    device."""
    if isinstance(v, list):
        return [_to_tensor(x) for x in v]
    if isinstance(v, torch.Tensor):
        return v
    arr = np.asarray(v)
    if not arr.flags.writeable:  # torch wraps writable memory only
        arr = arr.copy()
    if arr.dtype.name == _BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


# ----------------------------------------------------------------------
# save
# ----------------------------------------------------------------------
def save_envelope(obj: Any, persistent_only: bool = False) -> Dict[str, Any]:
    """Capture ``obj``'s state into a validated envelope.

    By default every registered state is captured (a reliability checkpoint
    should be complete); ``persistent_only=True`` honors the metric's
    ``persistent()`` flags instead, i.e. wraps exactly what
    ``obj.state_dict()`` would return. Each state is copied to the host
    once, here: the payload aliases no live state (a later update appending
    to a list state cannot change it under its own checksum)."""
    named = obj._named_states()
    source = obj.state_dict() if persistent_only else dict(named)
    payload = {k: ([_np(x) for x in v] if isinstance(v, list) else _np(v)) for k, v in source.items()}
    complete = set(payload) == {k for k, _ in named}
    return _assemble_envelope(payload, type(obj).__name__, complete)


def envelope_from_pairs(
    pairs: List[Tuple[str, Any]], metric_type: str = "snapshot", fmt: str = ENVELOPE_FORMAT
) -> Dict[str, Any]:
    """Build a validated envelope from captured ``(key, value)`` pairs
    instead of a live metric. ``metric_type`` is the informational type
    label; ``fmt`` lets a sibling artifact family reuse the spec/checksum
    machinery under its own format marker."""
    payload = {k: ([_np(x) for x in v] if isinstance(v, list) else _np(v)) for k, v in pairs}
    return _assemble_envelope(payload, metric_type, complete=True, fmt=fmt)


def _assemble_envelope(
    payload: Dict[str, Any], metric_type: str, complete: bool, fmt: str = ENVELOPE_FORMAT
) -> Dict[str, Any]:
    return {
        "format": fmt,
        "schema_version": SCHEMA_VERSION,
        "metric_type": metric_type,
        "complete": complete,
        "spec": {k: _spec_of(v) for k, v in payload.items()},
        "payload": payload,
        "checksum": _checksum(payload),
    }


# ----------------------------------------------------------------------
# load
# ----------------------------------------------------------------------
def _validate_envelope(envelope: Any, fmt: str = ENVELOPE_FORMAT) -> None:
    if not isinstance(envelope, dict) or envelope.get("format") != fmt:
        raise _reject(
            CheckpointSchemaError(
                f"not a {fmt} envelope (missing/unknown 'format'"
                " marker); raw state dicts load via load_state_dict()"
            )
        )
    version = envelope.get("schema_version")
    if not isinstance(version, int) or version < 1 or version > SCHEMA_VERSION:
        raise _reject(
            CheckpointSchemaError(
                f"envelope schema_version {version!r} is not supported by this"
                f" library build (supports 1..{SCHEMA_VERSION}); refusing to"
                " guess at its layout"
            )
        )
    for field in ("spec", "payload", "checksum"):
        if field not in envelope:
            raise _reject(CheckpointSchemaError(f"envelope is missing required field {field!r}"))
    got = _checksum(envelope["payload"])
    if got != envelope["checksum"]:
        raise _reject(
            CheckpointCorruptionError(
                f"envelope payload checksum mismatch: stored"
                f" {envelope['checksum']}, recomputed {got} — the checkpoint"
                " is corrupted (bit rot, truncation, or tampering)"
            )
        )


def _state_dtype_shape(cur: torch.Tensor) -> Tuple[str, List[int]]:
    """A live state's spec dtype name (numpy's) and shape, from metadata
    alone: no device read."""
    if cur.dtype == torch.bfloat16:
        return _BF16, list(cur.shape)
    return str(torch.empty((), dtype=cur.dtype).numpy().dtype), list(cur.shape)


def _shape_dtype_problems(envelope: Dict[str, Any], current: Dict[str, Any]) -> List[str]:
    problems = []
    for key, spec in envelope["spec"].items():
        if key not in current:
            continue
        cur = current[key]
        if spec["kind"] == "list":
            if not isinstance(cur, list):
                problems.append(f"{key}: envelope has a list state, metric an array")
            continue  # list lengths grow with batches; no shape pin
        if isinstance(cur, list):
            problems.append(f"{key}: envelope has an array state, metric a list")
            continue
        dtype, shape = _state_dtype_shape(cur)
        if shape != list(spec["shape"]):
            problems.append(f"{key}: shape {list(spec['shape'])} != metric state shape {shape}")
        elif dtype != spec["dtype"]:
            problems.append(f"{key}: dtype {spec['dtype']} != metric state dtype {dtype}")
    return problems


def load_envelope(obj: Any, envelope: Dict[str, Any], strict: bool = True) -> None:
    """Validate ``envelope`` and restore it into ``obj``.

    ``strict=True`` (default): the envelope must carry exactly the metric's
    registered state keys, each with matching dtype and shape — missing
    keys, unexpected keys, or spec mismatches raise
    :class:`CheckpointMismatchError` *before any state is touched*.
    ``strict=False``: the valid intersection is loaded; everything skipped
    is reported through one rate-limited warning. The restored states are
    copies on the metric's device.
    """
    _validate_envelope(envelope)
    current = dict(obj._named_states())
    have = set(envelope["payload"])
    want = set(current)
    missing = sorted(want - have)
    unexpected = sorted(have - want)
    problems = _shape_dtype_problems(envelope, current)

    if strict:
        if missing or unexpected or problems:
            detail = []
            if missing:
                detail.append(f"missing keys: {missing}")
            if unexpected:
                detail.append(f"unexpected keys: {unexpected}")
            if problems:
                detail.append(f"spec mismatches: {problems}")
            raise _reject(
                CheckpointMismatchError(
                    "strict envelope load rejected — " + "; ".join(detail)
                    + ". The checkpoint was written by a differently-configured"
                    " metric (or a different library version); load with"
                    " strict=False to restore the matching subset."
                )
            )
        loadable = dict(envelope["payload"])
    else:
        bad_keys = {p.split(":", 1)[0] for p in problems}
        loadable = {k: v for k, v in envelope["payload"].items() if k in want and k not in bad_keys}
        skipped = sorted((have - set(loadable)) | set(missing))
        if missing or unexpected or problems:
            warn_once(
                "non-strict envelope load skipped incompatible entries"
                f" (missing={missing}, unexpected={unexpected},"
                f" mismatched={sorted(bad_keys)}); loaded"
                f" {len(loadable)}/{len(have)} states, skipped {skipped}",
                key=f"envelope-partial:{type(obj).__name__}",
            )
    obj.load_state_dict({k: _to_tensor(v) for k, v in loadable.items()})


# ----------------------------------------------------------------------
# file round-trip (single .npz; dtype-agnostic raw-byte payload)
# ----------------------------------------------------------------------
@contextmanager
def atomic_file(path: Any) -> Iterator[Any]:
    """Open ``<path>.tmp`` for writing; on clean exit flush and fsync it and
    ``os.replace`` it over ``path`` (fsyncing the directory where the file
    system allows), so a crash at any point leaves either the old file or
    the new one at ``path``, never a half-written one. On error the temp
    file is removed and ``path`` is untouched."""
    path = os.fspath(path)
    tmp = path + ".tmp"
    # metrics-tpu: allow(MTL107) — this IS the atomic primitive MTL107
    # steers writers toward: the raw open targets the .tmp sidecar, and
    # the fsync + os.replace below are the discipline itself
    f = open(tmp, "wb")
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
        f.close()
        os.replace(tmp, path)
        # the rename itself must survive a power cut: fsync the directory
        # entry (not every file system supports directory descriptors)
        try:
            dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
    except BaseException:
        f.close()
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _pack_arrays(envelope: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Flatten an envelope into named raw-byte uint8 arrays (the on-disk and
    on-wire form shared by :func:`write_envelope` and
    :func:`envelope_to_bytes`). Arrays are stored as raw bytes and rebuilt
    from the spec, so every dtype (bfloat16 included) survives the trip
    without pickling."""
    header = {k: envelope[k] for k in envelope if k != "payload"}
    arrays = {"__header__": np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)}
    for key, val in envelope["payload"].items():
        if isinstance(val, list):
            for i, v in enumerate(val):
                arrays[f"l::{key}::{i}"] = np.frombuffer(_raw_bytes(_np(v)), dtype=np.uint8)
        else:
            arrays[f"a::{key}"] = np.frombuffer(_raw_bytes(_np(val)), dtype=np.uint8)
    return arrays


def write_envelope(path: Any, envelope: Dict[str, Any]) -> None:
    """Serialize an envelope to one ``.npz`` file, **atomically**: the bytes
    go to ``<path>.tmp`` and are fsync'd before an ``os.replace`` over
    ``path`` (see :func:`atomic_file`)."""
    with atomic_file(path) as f:
        np.savez(f, **_pack_arrays(envelope))


def envelope_to_bytes(envelope: Dict[str, Any]) -> bytes:
    """Serialize an envelope to a self-contained ``bytes`` blob: the same
    ``.npz`` layout :func:`write_envelope` puts on disk, in memory. The
    checksum rides inside the header, so :func:`envelope_from_bytes` and a
    validating load detect corruption picked up in transit."""
    buf = io.BytesIO()
    np.savez(buf, **_pack_arrays(envelope))
    return buf.getvalue()


def envelope_from_bytes(raw: bytes) -> Dict[str, Any]:
    """Decode a blob produced by :func:`envelope_to_bytes`. Structural
    decoding only (like :func:`read_envelope`); checksum and spec validation
    happen at load time. Undecodable bytes raise
    :class:`CheckpointCorruptionError`."""
    try:
        with np.load(io.BytesIO(bytes(raw))) as data:
            return _decode_npz(data, "<bytes>")
    except CheckpointError:
        raise
    except Exception as err:
        raise _reject(
            CheckpointCorruptionError(
                f"envelope bytes are unreadable (corrupted in transit?): {type(err).__name__}: {err}"
            )
        ) from err


def read_envelope(path: Any) -> Dict[str, Any]:
    """Read an envelope written by :func:`write_envelope`. Performs only
    structural decoding; validation happens in :func:`load_envelope`. A file
    that cannot even be decoded (a torn write, a truncated download) raises
    :class:`CheckpointCorruptionError` rather than leaking zipfile or zlib
    internals (a missing file stays ``FileNotFoundError``)."""
    try:
        # own the file object: np.load(path) leaks it when zipfile decoding
        # raises mid-construction (torn files)
        with open(path, "rb") as fobj, np.load(fobj) as data:
            return _decode_npz(data, path)
    except (CheckpointError, FileNotFoundError):
        raise
    except Exception as err:  # zipfile.BadZipFile, zlib.error, ValueError...
        raise _reject(
            CheckpointCorruptionError(
                f"envelope file {path!r} is unreadable (torn write or truncation): {type(err).__name__}: {err}"
            )
        ) from err


def _decode_npz(data: Any, origin: Any) -> Dict[str, Any]:
    if "__header__" not in data:
        raise _reject(CheckpointSchemaError(f"{origin!r} is not a metrics_tpu envelope file"))
    try:
        header = json.loads(bytes(data["__header__"]).decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as err:
        raise _reject(CheckpointCorruptionError(f"envelope header is unreadable: {err}")) from err
    spec = header.get("spec", {})
    payload: Dict[str, Any] = {}
    for name in data.files:
        if name == "__header__":
            continue
        kind, _, rest = name.partition("::")
        if kind == "a":
            s = spec.get(rest)
            if s is None:
                raise _reject(CheckpointCorruptionError(f"payload entry {rest!r} has no spec"))
            payload[rest] = _decode(data[name], s["dtype"], s["shape"])
        elif kind == "l":
            key, _, idx = rest.rpartition("::")
            s = spec.get(key)
            if s is None:
                raise _reject(CheckpointCorruptionError(f"payload entry {key!r} has no spec"))
            i = int(idx)
            payload.setdefault(key, {})[i] = _decode(data[name], s["dtype"][i], s["shape"][i])
    for key, val in list(payload.items()):
        if isinstance(val, dict):  # reassemble list states in index order
            payload[key] = [val[i] for i in sorted(val)]
    # empty list states write zero npz entries; rebuild them from the spec
    # (only for len == 0: a len > 0 list with missing entries is genuine
    # truncation and must keep failing the checksum)
    for key, s in spec.items():
        if s.get("kind") == "list" and s.get("len") == 0 and key not in payload:
            payload[key] = []
    header["payload"] = payload
    return header


def _decode(raw: np.ndarray, dtype: str, shape: List[int]) -> Any:
    dt = _dtype(dtype)
    expected = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
    buf = raw.tobytes()
    if len(buf) != expected:
        raise _reject(
            CheckpointCorruptionError(
                f"payload byte length {len(buf)} does not match spec"
                f" {dtype}{shape} ({expected} bytes) — truncated checkpoint"
            )
        )
    # .copy(): the payload must be owned, writable memory, not a view of
    # the bytes object
    arr = np.frombuffer(buf, dtype=dt).reshape(shape).copy()
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr
