"""The lint gate over the port's own tree: zero unsuppressed findings, and a
suppressed bucket held as the JAX package's
``tests/analysis/test_lint_clean.py`` holds its own."""
from metrics_tpu_torch.analysis import lint_paths
from metrics_tpu_torch.analysis.lint import default_lint_root


def test_repo_lint_has_zero_unsuppressed_findings():
    findings = lint_paths()
    live = [str(f) for f in findings if not f.suppressed]
    assert live == [], live


def test_suppressions_are_rare_and_deliberate():
    """The suppressed bucket is an allowlist, not a loophole: it stays
    small, and every entry is an MTL101/MTL104 design exception (host
    probes read under a concreteness guard, the per-rank streams that merge
    through their own gather), a deliberately broken fixture kept broken to
    keep proving its rule (MTL106 thread race, MTL107 non-atomic manifest
    writer), or one of the audited MTL107 primitives-and-injectors allows
    (atomic_file's own tmp write, the at-exit telemetry fallback, the
    torn-write injector)."""
    findings = [f for f in lint_paths() if f.suppressed]
    assert len(findings) <= 15, [str(f) for f in findings]
    assert {f.rule for f in findings} <= {"MTL101", "MTL104", "MTL106", "MTL107"}
    mtl106 = [f for f in findings if f.rule == "MTL106"]
    assert all("fixtures.py" in f.subject for f in mtl106), [str(f) for f in mtl106]
    mtl107 = [f for f in findings if f.rule == "MTL107"]
    allowed_homes = ("fixtures.py", "checkpoint.py", "telemetry.py", "faultinject.py")
    assert all(any(home in f.subject for home in allowed_homes) for f in mtl107), [str(f) for f in mtl107]


def test_the_kernel_build_publishes_durably():
    """The one MTL107 site only the port has (the built kernel library
    published with ``os.replace``) is fixed, not suppressed: it fsyncs the
    library first."""
    findings = [f for f in lint_paths() if "_native.py" in f.subject]
    assert findings == [], [str(f) for f in findings]


def test_gate_script_strict_fails_on_violation(tmp_path):
    """Pointed at a tree with one capture outside the engine, the gate goes
    red with exactly that finding."""
    pkg = tmp_path / "metrics_tpu_torch"
    pkg.mkdir()
    (pkg / "bad.py").write_text("import torch\ng = torch.cuda.CUDAGraph()\n")
    findings = lint_paths(paths=[str(pkg / "bad.py")], root=str(tmp_path))
    assert [f.rule for f in findings] == ["MTL102"]
    assert not findings[0].suppressed
    assert findings[0].subject == "metrics_tpu_torch/bad.py:2"
    assert default_lint_root().endswith("metrics_tpu_torch")
