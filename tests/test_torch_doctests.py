"""Run the docstring examples of every ``metrics_tpu_torch`` module (on the
CPU: the examples pass ``device="cpu"`` or CPU tensors)."""
import doctest
import importlib
import pkgutil

import pytest

import metrics_tpu_torch

MODULES = sorted(
    ["metrics_tpu_torch"]
    + [m.name for m in pkgutil.walk_packages(metrics_tpu_torch.__path__, prefix="metrics_tpu_torch.")]
)


@pytest.mark.parametrize("name", MODULES)
def test_module_doctests(name):
    result = doctest.testmod(importlib.import_module(name), verbose=False)
    assert result.failed == 0, f"{result.failed} doctest failure(s) in {name}"


def test_doctests_exist():
    finder = doctest.DocTestFinder()
    total = sum(len(t.examples) for n in MODULES for t in finder.find(importlib.import_module(n)))
    assert total >= 15, total
