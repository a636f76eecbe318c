"""The port stands alone: nothing under ``metrics_tpu_torch/``, and not
``chip_smoke.py``, imports JAX or the JAX package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "metrics_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "metrics_tpu"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_the_port_has_files_to_check():
    assert len(PORT_FILES) > 10


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_jax_package_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, metrics_tpu_torch, metrics_tpu_torch.functional, metrics_tpu_torch.interop;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'metrics_tpu')];"
        "assert not bad, bad"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


JAX_RETRIEVAL_INITS = {
    "metrics_tpu_torch.retrieval": REPO / "metrics_tpu" / "retrieval" / "__init__.py",
    "metrics_tpu_torch.functional.retrieval": REPO / "metrics_tpu" / "functional" / "retrieval" / "__init__.py",
}


@pytest.mark.parametrize("port_module", sorted(JAX_RETRIEVAL_INITS))
def test_the_port_exports_every_jax_retrieval_name(port_module):
    """Every name the JAX package's retrieval packages export (read from
    their source, not imported) is exported by the port's counterpart."""
    import importlib

    tree = ast.parse(JAX_RETRIEVAL_INITS[port_module].read_text())
    names = {a.asname or a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) for a in n.names}
    module = importlib.import_module(port_module)
    assert len(names) >= 4 and not sorted(n for n in names if not hasattr(module, n))
