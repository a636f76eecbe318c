"""Version and availability gating.

Port of ``metrics_tpu/utilities/imports.py``: the same helpers, with flags
for what this package depends on. Whether a CUDA device is present is asked
when the flag is read, not when the module is imported.
"""
import re
from importlib import import_module
from importlib.util import find_spec
from typing import Callable, Tuple


def _module_available(module_path: str) -> bool:
    """Check if a module path is importable in this environment.

    >>> _module_available('os')
    True
    >>> _module_available('bla.bla')
    False
    """
    try:
        return find_spec(module_path) is not None
    except (AttributeError, ModuleNotFoundError, ValueError):
        return False


def _version_tuple(version: str) -> Tuple[int, ...]:
    """The leading numeric parts of a version string (the JAX package's
    helper also reads the digits of a suffix: ``0+cu128`` as 128).

    >>> _version_tuple("2.11.0+cu128")
    (2, 11, 0)
    """
    parts = []
    for chunk in version.split("."):
        # the chunk's leading digits: "0+cu128" is 0, not 128
        digits = re.match(r"\d*", chunk).group()
        if not digits:
            break
        parts.append(int(digits))
    return tuple(parts)


def _compare_version(package: str, op: Callable, version: str) -> bool:
    """Compare an installed package's version against a requirement.

    >>> import operator
    >>> _compare_version("torch", operator.ge, "0.1")
    True
    >>> _compare_version("no_such_package", operator.ge, "0.1")
    False
    """
    try:
        pkg = import_module(package)
    except ModuleNotFoundError:
        return False
    pkg_version = getattr(pkg, "__version__", None)
    if pkg_version is None:
        return False
    return op(_version_tuple(pkg_version), _version_tuple(version))


def _cuda_available() -> bool:
    """True when PyTorch sees a CUDA device (asked at each call)."""
    import torch

    return torch.cuda.is_available()


_TORCH_AVAILABLE = _module_available("torch")
_TRITON_AVAILABLE = _module_available("triton")
