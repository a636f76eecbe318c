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


RETRIEVAL_MODULES = [m for m in MODULES if ".retrieval." in m or m.endswith((".segment", ".utilities.data"))]


def test_retrieval_modules_carry_their_doctests():
    """The retrieval family's modules and functional forms each show their
    example (run by ``test_module_doctests``)."""
    finder = doctest.DocTestFinder()
    with_examples = {n for n in RETRIEVAL_MODULES
                     if sum(len(t.examples) for t in finder.find(importlib.import_module(n)))}
    want = {f"metrics_tpu_torch.retrieval.{m}" for m in ("mean_average_precision", "mean_reciprocal_rank",
                                                         "precision", "recall", "sharded")}
    want |= {f"metrics_tpu_torch.functional.retrieval.{m}" for m in ("average_precision", "reciprocal_rank",
                                                                    "precision", "recall")}
    want |= {"metrics_tpu_torch.ops.segment", "metrics_tpu_torch.utilities.data"}
    assert want <= with_examples, sorted(want - with_examples)


def test_engine_wrapper_and_extras_modules_carry_their_doctests():
    """The step engine, the collection's ``compiled=True`` form, the
    BootStrapper and the functional extras each show their example (run by
    ``test_module_doctests``)."""
    finder = doctest.DocTestFinder()
    want = {f"metrics_tpu_torch.{m}" for m in ("engine", "collections", "wrappers.bootstrapping",
                                               "functional.nlp", "functional.self_supervised",
                                               "functional.image_gradients", "utilities.imports")}
    with_examples = {n for n in want if sum(len(t.examples) for t in finder.find(importlib.import_module(n)))}
    assert want == with_examples, sorted(want - with_examples)


def test_cohort_modules_carry_their_doctests():
    """The cohort, the count primitives and the one-hot canonicalization
    each show their example (run by ``test_module_doctests``)."""
    finder = doctest.DocTestFinder()
    want = {f"metrics_tpu_torch.{m}" for m in ("cohort", "ops.histogram", "utilities.checks")}
    with_examples = {n for n in want if sum(len(t.examples) for t in finder.find(importlib.import_module(n)))}
    assert want == with_examples, sorted(want - with_examples)
