"""The port stands alone: nothing under ``metrics_tpu_torch/``, not
``chip_smoke.py`` and no ``scripts/torch_*.py``, imports JAX or the JAX
package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = (
    sorted((REPO / "metrics_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    + sorted((REPO / "scripts").glob("torch_*.py"))
)
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
        "import sys, metrics_tpu_torch, metrics_tpu_torch.functional, metrics_tpu_torch.interop,"
        " metrics_tpu_torch.observability;"
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


# package __init__ pairs: the port's module -> the JAX package's __init__
JAX_INITS = {
    "metrics_tpu_torch": REPO / "metrics_tpu" / "__init__.py",
    "metrics_tpu_torch.parallel": REPO / "metrics_tpu" / "parallel" / "__init__.py",
    "metrics_tpu_torch.ops": REPO / "metrics_tpu" / "ops" / "__init__.py",
    "metrics_tpu_torch.utilities": REPO / "metrics_tpu" / "utilities" / "__init__.py",
    "metrics_tpu_torch.functional": REPO / "metrics_tpu" / "functional" / "__init__.py",
    "metrics_tpu_torch.classification": REPO / "metrics_tpu" / "classification" / "__init__.py",
    "metrics_tpu_torch.regression": REPO / "metrics_tpu" / "regression" / "__init__.py",
    "metrics_tpu_torch.retrieval": REPO / "metrics_tpu" / "retrieval" / "__init__.py",
    "metrics_tpu_torch.wrappers": REPO / "metrics_tpu" / "wrappers" / "__init__.py",
    "metrics_tpu_torch.observability": REPO / "metrics_tpu" / "observability" / "__init__.py",
    "metrics_tpu_torch.reliability": REPO / "metrics_tpu" / "reliability" / "__init__.py",
    "metrics_tpu_torch.serving": REPO / "metrics_tpu" / "serving" / "__init__.py",
    "metrics_tpu_torch.fleet": REPO / "metrics_tpu" / "fleet" / "__init__.py",
    "metrics_tpu_torch.analysis": REPO / "metrics_tpu" / "analysis" / "__init__.py",
}

# names JAX exports that the port does not have yet, by the part of the
# JAX package whose port brings them
NOT_YET_PORTED = {
    # not ported by design: the JAX package's numpy twin of its SPMD sample
    # sort for CPU meshes, where XLA's co-sort is slow; the port's
    # sample_sort_auroc_ap runs on any device
    "host_sample_sort_auroc_ap": "by design: the port's sample_sort_auroc_ap runs on the CPU itself",
}


def _exported_names(init: Path) -> set:
    tree = ast.parse(init.read_text())
    return {a.asname or a.name for n in tree.body if isinstance(n, ast.ImportFrom) for a in n.names}


@pytest.mark.parametrize("port_module", sorted(JAX_INITS))
def test_the_port_exports_every_name_jax_exports(port_module):
    """Every name a JAX package ``__init__`` imports (read from its source,
    not imported) is exported by the port's counterpart, but the names of
    the unported items listed above; and no listed name is exported yet
    (the list shrinks as items land). What the port's ``__init__`` exports
    is read from its source too: a subpackage another test imported (the
    flight recorder's lazy ``reliability.journal``) is an attribute of the
    package without being one of its exports."""
    import importlib

    names = _exported_names(JAX_INITS[port_module])
    module = importlib.import_module(port_module)
    missing = sorted(n for n in names if not hasattr(module, n) and n not in NOT_YET_PORTED)
    assert names and not missing, f"{port_module} lacks {missing}"
    port_init = Path(module.__file__)
    stale = sorted(n for n in names if n in NOT_YET_PORTED and n in _exported_names(port_init))
    assert not stale, f"{port_module} now exports {stale}: take them off NOT_YET_PORTED"
