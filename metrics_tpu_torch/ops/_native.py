"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, and loaded with ``ctypes``. The
library's file name carries a hash of the sources and flags, so an edited
source is rebuilt at its first use and an unchanged one is loaded as built.
Libraries go to ``build/`` beside the package; nothing is built when a
module is imported, only when a kernel is first launched (or when
:func:`build` is called).
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc was not found (on PATH or under CUDA_HOME); the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives at the sources' current hash."""
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in [_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))]:
        digest.update(src.read_bytes())
    return _BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every missing library of ``names`` (default: every
    ``csrc/*.cu``), one ``nvcc`` per source, all started together. Raises
    with the compiler's output on failure."""
    if names is None:
        names = sorted(src.stem for src in _CSRC.glob("*.cu"))
    paths = {name: library_path(name) for name in names}
    todo = {name: path for name, path in paths.items() if not path.exists()}
    if not todo:
        return paths
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{output}")
            continue
        # atomic publish: the bytes reach the disk before the name does, and a
        # concurrent builder of the same hash writes the same bytes
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, todo[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """Load the library of ``csrc/<name>.cu``, built first if needed. Each
    kernel module loads its library once and binds the argument types."""
    return ctypes.CDLL(str(build([name])[name]))
