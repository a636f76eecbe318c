"""Crash-safe file writes.

Port of ``atomic_file`` from ``metrics_tpu/reliability/checkpoint.py``; the
checksummed state envelope of that module is not ported yet.
"""
import os
from contextlib import contextmanager
from typing import Any, Iterator

__all__ = ["atomic_file"]


@contextmanager
def atomic_file(path: Any) -> Iterator[Any]:
    """Open ``<path>.tmp`` for writing; on clean exit flush and fsync it and
    ``os.replace`` it over ``path`` (fsyncing the directory where the file
    system allows), so a crash at any point leaves either the old file or
    the new one at ``path``, never a half-written one. On error the temp
    file is removed and ``path`` is untouched."""
    path = os.fspath(path)
    tmp = path + ".tmp"
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
