"""Crash-consistent checkpoint rotation: generation-numbered envelopes
behind an atomically replaced manifest.

Port of ``metrics_tpu/reliability/journal.py``. One checkpoint file is not
durability: the crash being defended against can land *during* the
checkpoint write. The :class:`CheckpointJournal` turns the single-envelope
primitives (``checkpoint.write_envelope``, itself atomic through tmp, fsync
and ``os.replace``) into a rotation protocol:

* every :meth:`~CheckpointJournal.commit` writes a **new generation**
  (``gen-00000007.npz``), never overwriting one, then atomically replaces
  ``MANIFEST.json`` (generation list, per-generation step cursor, wall
  time, git SHA);
* **keep-last-K garbage collection** deletes the oldest generations only
  *after* the manifest no longer references them: a crash between the two
  steps leaves an unreferenced file (collected next commit), never a
  referenced hole;
* :meth:`~CheckpointJournal.load_latest_good` walks generations newest to
  oldest, skipping any that fail structural decode or checksum validation
  (torn write, bit rot) with one warning and a
  ``reliability.session_torn_write_fallbacks`` count per skip, and raises
  :class:`CheckpointCorruptionError` only when *no* generation survives;
* a manifest that is itself unreadable degrades to a directory scan of
  ``gen-*.npz``: the files are the ground truth, the manifest an index.

The directory layout, the manifest and the generation files are the JAX
package's: a journal written by either package resumes in the other.
:class:`~metrics_tpu_torch.reliability.EvalSession` composes the journal
with the step cursor and multi-host agreement into a durable eval loop.
"""
import glob
import json
import os
import re
import subprocess
import time
from typing import Any, Dict, List, Optional, Tuple

from metrics_tpu_torch.observability import flight as _flight
from metrics_tpu_torch.observability import telemetry as _obs
from metrics_tpu_torch.observability import trace as _trace
from metrics_tpu_torch.reliability.checkpoint import (
    CheckpointCorruptionError,
    CheckpointError,
    _validate_envelope,
    atomic_file,
    read_envelope,
    write_envelope,
)
from metrics_tpu_torch.utilities.prints import warn_once

__all__ = [
    "MANIFEST_NAME",
    "CheckpointJournal",
    "atomic_write_json",
    "current_git_sha",
]

MANIFEST_NAME = "MANIFEST.json"
MANIFEST_FORMAT = "metrics_tpu.checkpoint_manifest"
MANIFEST_VERSION = 1

_GEN_RE = re.compile(r"^gen-(\d{8})\.npz$")


def atomic_write_json(path: Any, obj: Any) -> None:
    """Serialize ``obj`` as JSON to ``path`` through :func:`atomic_file`: a
    crash mid-write leaves the previous file, never a torn one."""
    with atomic_file(path) as f:
        f.write(json.dumps(obj, indent=1).encode())


_GIT_SHA: Optional[str] = None


def current_git_sha() -> str:
    """HEAD SHA of the repository containing the current working directory
    ("" when git or a repository is unavailable), cached per process: the
    journal records it per generation, so a resume can warn when the code
    that wrote a checkpoint is not the code restoring it."""
    global _GIT_SHA
    if _GIT_SHA is None:
        try:
            proc = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True, timeout=10)
            _GIT_SHA = proc.stdout.strip() if proc.returncode == 0 else ""
        except Exception:
            _GIT_SHA = ""
    return _GIT_SHA


class CheckpointJournal:
    """Rotated, manifest-indexed envelope storage in one directory.

    Args:
        directory: where generations and the manifest live (created if
            missing). One journal per directory; a multi-process run gives
            each rank its own directory.
        keep_last: generations retained after each commit (>= 1): the depth
            of the torn-write and rollback fallback.
    """

    def __init__(self, directory: Any, keep_last: int = 3):
        if keep_last < 1:
            raise ValueError("keep_last must be >= 1")
        self.directory = os.fspath(directory)
        self.keep_last = int(keep_last)
        os.makedirs(self.directory, exist_ok=True)

    # ------------------------------------------------------------------
    # paths / manifest
    # ------------------------------------------------------------------
    @property
    def manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST_NAME)

    def _gen_path(self, generation: int) -> str:
        return os.path.join(self.directory, f"gen-{generation:08d}.npz")

    def _read_manifest(self) -> Optional[Dict[str, Any]]:
        try:
            with open(self.manifest_path) as f:
                manifest = json.load(f)
            if manifest.get("format") != MANIFEST_FORMAT:
                return None
            return manifest
        except FileNotFoundError:
            return None
        except Exception as err:
            warn_once(
                f"checkpoint journal manifest {self.manifest_path!r} is"
                f" unreadable ({type(err).__name__}: {err}); falling back to"
                " scanning generation files on disk",
                key=f"journal-manifest-unreadable:{self.directory}",
            )
            return None

    def records(self) -> List[Dict[str, Any]]:
        """Known generations, oldest to newest: from the manifest when it is
        readable and its files exist, else rebuilt from a directory scan
        (``cursor`` then unknown until the envelope is read)."""
        manifest = self._read_manifest()
        if manifest is not None:
            recs = [r for r in manifest.get("generations", []) if os.path.exists(self._gen_path(int(r["generation"])))]
            if recs:
                return sorted(recs, key=lambda r: int(r["generation"]))
        recs = []
        for path in glob.glob(os.path.join(self.directory, "gen-*.npz")):
            m = _GEN_RE.match(os.path.basename(path))
            if m:
                recs.append({"generation": int(m.group(1)), "cursor": None})
        return sorted(recs, key=lambda r: int(r["generation"]))

    def newest_generation(self) -> Optional[int]:
        """Number of the newest generation present on disk, or None when the
        journal is empty."""
        recs = self.records()
        return int(recs[-1]["generation"]) if recs else None

    def cursors_on_disk(self) -> List[int]:
        """The step cursors of the generations that actually load (oldest to
        newest): what multi-process resume agreement intersects across
        ranks. Each generation is validated (decode and checksum) before it
        is advertised: a torn newest file must not be offered to peers as a
        rollback target this rank cannot honor. Without a manifest the
        cursor is recovered from the envelope payload."""
        out = []
        for record in self.records():
            envelope = self._loadable_envelope(int(record["generation"]))
            if envelope is None:
                continue
            cursor = record.get("cursor")
            if cursor is None:
                cursor = _cursor_from_envelope(envelope)
            if cursor is not None:
                out.append(int(cursor))
        return out

    def _loadable_envelope(self, generation: int) -> Optional[Dict[str, Any]]:
        """The generation's envelope if it decodes and passes checksum
        validation; None otherwise (torn write, bit rot, missing file)."""
        try:
            envelope = read_envelope(self._gen_path(generation))
            _validate_envelope(envelope)
            return envelope
        except (CheckpointError, FileNotFoundError):
            return None

    # ------------------------------------------------------------------
    # commit + GC
    # ------------------------------------------------------------------
    def commit(
        self,
        envelope: Dict[str, Any],
        cursor: int,
        note: Optional[str] = None,
        epoch: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Durably persist ``envelope`` as the next generation and return its
        manifest record. The write order is the crash-safety argument:
        envelope (atomic), then manifest (atomic), then GC; dying between
        any two steps leaves a valid journal. ``epoch`` is the writer's
        ownership epoch, recorded in the manifest when given."""
        records = self.records()
        generation = (int(records[-1]["generation"]) + 1) if records else 1
        with _trace.span("journal.write_envelope", phase="checkpoint", generation=generation):
            write_envelope(self._gen_path(generation), envelope)
        record = {
            "generation": generation,
            "cursor": int(cursor),
            "written_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "git_sha": current_git_sha(),
        }
        if note:
            record["note"] = note
        if epoch is not None:
            record["epoch"] = int(epoch)
        records.append(record)
        keep = records[-self.keep_last:]
        with _trace.span("journal.rotate", phase="checkpoint", generation=generation):
            atomic_write_json(
                self.manifest_path,
                {
                    "format": MANIFEST_FORMAT,
                    "schema_version": MANIFEST_VERSION,
                    "keep_last": self.keep_last,
                    "generations": keep,
                },
            )
            kept = {int(r["generation"]) for r in keep}
            for r in records[:-self.keep_last]:
                self._remove_generation(int(r["generation"]), kept)
            # stray files from a crash between manifest write and GC, or
            # from a prior run with a larger keep_last
            for path in glob.glob(os.path.join(self.directory, "gen-*.npz")):
                m = _GEN_RE.match(os.path.basename(path))
                if m and int(m.group(1)) not in kept:
                    self._remove_generation(int(m.group(1)), kept)
        _flight.record("journal_commit", generation=generation, cursor=int(cursor))
        return record

    def _remove_generation(self, generation: int, kept: set) -> None:
        if generation in kept:
            return
        try:
            os.remove(self._gen_path(generation))
        except OSError:
            pass

    # ------------------------------------------------------------------
    # recovery
    # ------------------------------------------------------------------
    def load_latest_good(
        self,
    ) -> Tuple[Optional[Dict[str, Any]], Optional[Dict[str, Any]], List[Dict[str, Any]]]:
        """``(envelope, record, skipped)`` for the newest generation that
        decodes and passes checksum validation; ``(None, None, [])`` for an
        empty journal (a fresh start, not an error). Each skipped generation
        is a torn-write fallback: one rate-limited warning and
        ``reliability.session_torn_write_fallbacks``. Raises
        :class:`CheckpointCorruptionError` when generations exist but none
        survives."""
        records = self.records()
        if not records:
            return None, None, []
        skipped: List[Dict[str, Any]] = []
        for record in reversed(records):
            generation = int(record["generation"])
            path = self._gen_path(generation)
            try:
                envelope = read_envelope(path)
                _validate_envelope(envelope)
            except CheckpointError as err:
                skipped.append(dict(record, error=f"{type(err).__name__}: {err}"))
                if _obs.enabled():
                    _obs.get().count("reliability.session_torn_write_fallbacks")
                    _obs.get().event(
                        "session_torn_write_fallback", generation=generation, error=f"{type(err).__name__}: {err}"
                    )
                # flight recorder: one dump per unusable generation
                _flight.record("session_torn_write_fallback", generation=generation)
                _flight.dump_on_failure(
                    "session_torn_write_fallback",
                    generation=generation,
                    directory=self.directory,
                    error=f"{type(err).__name__}: {err}",
                )
                warn_once(
                    f"checkpoint generation {generation} at {path!r} is"
                    f" unusable ({type(err).__name__}: {err}); falling back to"
                    " the previous good generation",
                    key=f"journal-torn:{self.directory}:{generation}",
                )
                continue
            if record.get("cursor") is None:
                # the manifest was lost: recover the cursor from the envelope
                cursor = _cursor_from_envelope(envelope)
                if cursor is not None:
                    record = dict(record, cursor=cursor)
            return envelope, record, skipped
        raise CheckpointCorruptionError(
            f"checkpoint journal at {self.directory!r} has"
            f" {len(records)} generation(s) but none is loadable:"
            f" {[s['error'] for s in skipped]}"
        )


def _cursor_from_envelope(envelope: Dict[str, Any]) -> Optional[int]:
    """The session step cursor embedded in an envelope's payload, if any
    (``Metric._SESSION_CURSOR_KEY``, under any member prefix)."""
    # lazy: the metric core imports this package
    from metrics_tpu_torch.metric import Metric, _decode_session_cursor

    for key, val in envelope.get("payload", {}).items():
        if key.endswith(Metric._SESSION_CURSOR_KEY):
            return _decode_session_cursor(val)
    return None
