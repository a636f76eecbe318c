"""Nothing under ``portbench/`` imports JAX or the JAX package; top-level
module names are compared whole (the port's name begins with the JAX
package's)."""
import ast
import re
from pathlib import Path

import pytest

from portbench.harness import FORBIDDEN_MODULES, forbidden_modules

BENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


# the JAX package's benchmark and its records, spelled so as not to name them here
JAX_BENCH = re.compile("(^|/)" + "bench" + r"\.py$|^" + "BENCH_r" + r"\d|^" + "MULTICHIP_r" + r"\d")


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & set(FORBIDDEN_MODULES)
    strings = [n.value for n in ast.walk(ast.parse(path.read_text())) if isinstance(n, ast.Constant)
               and isinstance(n.value, str)]
    assert not [s for s in strings if JAX_BENCH.search(s)]


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "oracles").glob("*.py"):
        assert "metrics_tpu_torch" not in top_level_imports(path)


def test_loaded_modules_are_compared_by_whole_top_level_name():
    loaded = ["metrics_tpu_torch", "metrics_tpu_torch.ops", "jaxlib.xla_client", "metrics_tpu.ops", "flax",
              "jaxtyping", "metrics_tpu_extra"]
    assert forbidden_modules(loaded) == ["flax", "jaxlib.xla_client", "metrics_tpu.ops"]
