"""The port's thread-shared-state model (``metrics_tpu_torch/analysis/
concurrency.py``, the MTL106 leg) against the JAX package's, on the CPU.

The MTL106 cases of ``tests/analysis/test_concurrency.py`` are mirrored
under their own names, and two more hold the port's own tree: its thread
model is clean, and the JAX package's model of the same tree is the same.
"""
from metrics_tpu_torch.analysis import concurrency as conc
from metrics_tpu_torch.analysis import register_threadsan_target, thread_shared_model
from metrics_tpu_torch.analysis.lint import default_lint_root, lint_paths


# ---------------------------------------------------------------------------
# the thread-shared model + runtime target registry
# ---------------------------------------------------------------------------
def test_in_tree_thread_shared_model_is_clean():
    """The package's own threaded modules (sync workers, the exporter, the
    serving worker, the background checkpoint writer) share no instance
    attribute across threads without an owning lock."""
    model = thread_shared_model()
    for spec in model:
        assert spec["lock"], (
            f"thread-shared attrs {spec['attrs']} of {spec['qualname']}"
            " have no owning lock"
        )


def test_register_threadsan_target_roundtrips():
    class _Shared:
        pass

    register_threadsan_target(_Shared, ("other", "value"), "_lock")
    try:
        targets = conc.threadsan_targets()
        match = [t for t in targets if t[0] is _Shared]
        assert match == [(_Shared, ("other", "value"), "_lock")]
        # re-registration replaces, never duplicates
        register_threadsan_target(_Shared, ("value",), "_lock")
        match = [t for t in conc.threadsan_targets() if t[0] is _Shared]
        assert match == [(_Shared, ("value",), "_lock")]
    finally:
        with conc._TARGET_LOCK:
            conc._EXTRA_TARGETS[:] = [t for t in conc._EXTRA_TARGETS if t[0] is not _Shared]


def test_explicit_registration_extends_the_static_model():
    """UnlockedSharedCounter is in the statically inferred model (the
    fixture module spawns a thread); an explicit registration for the same
    class must UNION the watched attrs into ONE merged target."""
    from metrics_tpu_torch.analysis import fixtures as fx

    in_model = [s for s in thread_shared_model() if s["qualname"] == "UnlockedSharedCounter"]
    assert in_model and in_model[0]["attrs"] == ("value",)
    assert in_model[0]["module"] == "metrics_tpu_torch.analysis.fixtures"
    register_threadsan_target(fx.UnlockedSharedCounter, ("extra",), "_lock")
    try:
        match = [t for t in conc.threadsan_targets() if t[0] is fx.UnlockedSharedCounter]
        assert len(match) == 1  # merged, not duplicated
        assert set(match[0][1]) == {"value", "extra"}
        assert match[0][2] == "_lock"
    finally:
        with conc._TARGET_LOCK:
            conc._EXTRA_TARGETS[:] = [t for t in conc._EXTRA_TARGETS if t[0] is not fx.UnlockedSharedCounter]


# ---------------------------------------------------------------------------
# the port's own tree
# ---------------------------------------------------------------------------
def test_the_port_tree_thread_model_is_clean():
    """Every MTL106 finding over the port's tree is one of the fixture's two
    deliberate, suppressed writes; every other thread-shared class of the
    package (the serving worker, the background writer, the exporter, the
    sync workers) names its owning lock; and the JAX package's model of the
    port's tree is the port's own, class for class."""
    from metrics_tpu.analysis.concurrency import thread_shared_model as jax_model

    mtl106 = [f for f in lint_paths() if f.rule == "MTL106"]
    assert [(f.subject.split(":")[0], f.suppressed) for f in mtl106] == [("analysis/fixtures.py", True)] * 2
    model = thread_shared_model()
    assert {s["qualname"] for s in model} >= {"UnlockedSharedCounter"}
    assert all(s["lock"] for s in model)
    assert model == jax_model(root=default_lint_root())


def test_the_threaded_modules_are_seen():
    """The model is built from every module that spawns a thread: the port's
    serving worker and exporter are among them (a model that saw no module
    would pass the cleanliness case above vacuously)."""
    import ast
    import os

    root = default_lint_root()
    spawning = set()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in filenames:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path, encoding="utf-8") as fh:
                    if conc._spawns_threads(ast.parse(fh.read())):
                        spawning.add(os.path.relpath(path, root))
    assert {"serving/async_engine.py", "observability/exporter.py", "analysis/fixtures.py"} <= spawning
