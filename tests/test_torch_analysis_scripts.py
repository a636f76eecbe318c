"""The port's gate and exporter scripts, on the CPU.

``scripts/torch_lint_metrics.py`` is the port's ``scripts/lint_metrics.py``
and ``scripts/torch_metrics_exporter.py`` its ``scripts/metrics_exporter.py``;
both import nothing of the JAX package. The refusal-ladder cases mirror the
JAX package's by name (``tests/analysis/test_numerics.py``,
``tests/analysis/test_protocol.py``); the gate runs in-process on the
port's tree (green), on a copy of it with one CUDA graph outside the engine
(red, ``--strict``), and against the committed ``FINGERPRINTS_TORCH.json``
(no drift). Every refresh writes only the path it is given: the cases hold
the root baselines byte-identical.
"""
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_BASELINES = ("FINGERPRINTS.json", "SEAM_BASELINE.json", "NUMERICS_BASELINE.json", "PROTOCOL_BASELINE.json")


def _load(name):
    spec = importlib.util.spec_from_file_location(f"{name}_under_test", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def lm():
    return _load("torch_lint_metrics")


@pytest.fixture(scope="module")
def exporter_script():
    return _load("torch_metrics_exporter")


@pytest.fixture()
def root_baselines_untouched():
    """The JAX package's committed baselines stay byte-identical."""
    def digests():
        return {n: hashlib.sha256(open(os.path.join(REPO, n), "rb").read()).hexdigest() for n in ROOT_BASELINES}

    before = digests()
    yield
    assert digests() == before


def _entry(rows, budget, states=("s",)):
    return {
        "states": sorted(states),
        "horizons": {s: {"kind": "int-overflow", "rows": rows} for s in states},
        "error_budget": budget,
    }


def test_refresh_refuses_red_partial_and_missing(tmp_path, lm, root_baselines_untouched):
    """The refusal ladder: red audit, partial audit, and a missing
    committed file all leave the baseline byte-identical."""
    path = tmp_path / "NUMERICS_BASELINE.json"
    committed = {"schema": "metrics_tpu.numerics_baseline", "version": 1,
                 "fixtures": [], "entries": {"Fam": _entry(100.0, 0.25)}}
    path.write_text(json.dumps(committed))
    ev = {"horizons": {"s": {"kind": "int-overflow", "rows": 500.0}},
          "cancellation": {"budget": 0.01, "sites": []}, "equivariance": None}

    msg = lm.refresh_numerics_baseline(str(path), {"Fam": ev}, findings=3, partial=False)
    assert "NOT refreshed" in msg and "3 unsuppressed" in msg
    assert json.loads(path.read_text()) == committed

    msg = lm.refresh_numerics_baseline(str(path), {"Fam": ev}, findings=0, partial=True)
    assert "NOT refreshed" in msg and "partial" in msg
    assert json.loads(path.read_text()) == committed

    missing = tmp_path / "nope.json"
    msg = lm.refresh_numerics_baseline(str(missing), {"Fam": ev}, findings=0, partial=False)
    assert "NOT refreshed" in msg and not missing.exists()

    # and the green path round-trips: tighten + prune
    msg = lm.refresh_numerics_baseline(str(path), {"Fam": ev}, findings=0, partial=False)
    assert msg.startswith("refreshed")
    after = json.loads(path.read_text())
    assert after["entries"]["Fam"]["horizons"]["s"]["rows"] == 500.0


def test_refresh_refusal_ladder(tmp_path, lm, root_baselines_untouched):
    """The script's protocol refresh refuses skipped passes, red
    explorations, and missing committed files — a regression is never
    laundered by a rerun."""
    refresh = lm.refresh_protocol_baseline
    assert "NOT refreshed" in refresh(str(tmp_path / "x.json"), {}, skipped=True)
    red = {"summary": {"findings": 2}, "evidence": {"baseline_entries": {}}}
    assert "NOT refreshed" in refresh(str(tmp_path / "x.json"), red, skipped=False)
    green = {"summary": {"findings": 0},
             "evidence": {"baseline_entries": {"crash_consistency": {
                 "states_explored": 6, "schedules": 25, "crash_points": 14}}}}
    assert "NOT refreshed" in refresh(str(tmp_path / "missing.json"), green, skipped=False)
    assert not (tmp_path / "missing.json").exists()

    path = tmp_path / "PROTOCOL_BASELINE.json"
    path.write_text(json.dumps({
        "schema": "metrics_tpu.protocol_baseline",
        "fixtures": [],
        "entries": {"crash_consistency": {"states_explored": 2, "schedules": 2, "crash_points": 2}},
    }))
    out = refresh(str(path), green, skipped=False)
    assert "refreshed" in out and "NOT" not in out
    assert json.loads(path.read_text())["entries"]["crash_consistency"]["schedules"] == 25


def test_seam_refresh_refuses_red_partial_and_missing(tmp_path, lm, root_baselines_untouched):
    """The seam refresh's ladder, and its green path: registry budgets
    rebuilt, a fixture entry kept, a retired family pruned."""
    path = tmp_path / "SEAM_BASELINE.json"
    committed = {"fixtures": ["SeamRegressor"], "budgets": {
        "SeamRegressor": {"states": ["s"], "budget": {"per_step": 9}},
        "Retired": {"states": ["s"], "budget": {"per_step": 1}},
    }}
    path.write_text(json.dumps(committed))
    seam = {"Fam": {"states": ["s"], "per_step": {"device_fetches": 0}, "per_sync": {"collectives": 1}}}
    for findings, partial, word in ((2, False, "unsuppressed"), (0, True, "partial")):
        msg = lm.refresh_seam_baseline(str(path), seam, findings=findings, partial=partial)
        assert "NOT refreshed" in msg and word in msg
        assert json.loads(path.read_text()) == committed
    missing = tmp_path / "nope.json"
    assert "NOT refreshed" in lm.refresh_seam_baseline(str(missing), seam, findings=0, partial=False)
    assert not missing.exists()
    msg = lm.refresh_seam_baseline(str(path), seam, findings=0, partial=False)
    assert msg.startswith("refreshed") and "Retired" in msg
    after = json.loads(path.read_text())["budgets"]
    assert set(after) == {"SeamRegressor", "Fam"} and after["SeamRegressor"] == committed["budgets"]["SeamRegressor"]


def test_strict_lint_gate_is_green_on_the_tree(tmp_path, lm, capsys, root_baselines_untouched):
    """``--strict --skip-audit --skip-protocol`` exits 0 on the port's tree
    and writes a parseable report."""
    report = tmp_path / "ANALYSIS_TORCH.json"
    assert lm.main(["--strict", "--skip-audit", "--skip-protocol", "--device", "cpu", "--json", str(report)]) == 0
    out = json.loads(report.read_text())
    assert out["schema"] == "metrics_tpu_torch.analysis_report" and out["version"] == 4
    assert out["summary"] == {"unsuppressed_findings": 0}
    assert out["lint"]["summary"]["findings"] == 0 and "program_audit" not in out
    assert "pass 2 (repo lint): 0 findings" in capsys.readouterr().out


def test_strict_lint_gate_goes_red_on_a_graph_outside_the_engine(tmp_path, lm, monkeypatch, capsys):
    """The same gate over a copy of the tree with one ``torch.cuda.CUDAGraph()``
    outside ``engine.py``: MTL102, exit 1."""
    from metrics_tpu_torch.analysis import lint

    tree = tmp_path / "metrics_tpu_torch"
    shutil.copytree(lint.default_lint_root(), tree, ignore=shutil.ignore_patterns("__pycache__"))
    (tree / "rogue_capture.py").write_text(
        "import torch\n\n\ndef capture():\n    return torch.cuda.CUDAGraph()\n"
    )
    monkeypatch.setattr(lint, "default_lint_root", lambda: str(tree))
    report = tmp_path / "red.json"
    assert lm.main(["--strict", "--skip-audit", "--skip-protocol", "--device", "cpu", "--json", str(report)]) == 1
    out = json.loads(report.read_text())
    live = [f for f in out["lint"]["findings"] if not f.get("suppressed")]
    assert [f["rule"] for f in live] == ["MTL102"] and "rogue_capture.py" in live[0]["subject"]
    assert "STRICT: 1 unsuppressed" in capsys.readouterr().err


def test_diff_fingerprints_against_the_committed_file_shows_no_drift(tmp_path, lm, capsys, root_baselines_untouched):
    """The full CPU audit's digests equal ``FINGERPRINTS_TORCH.json``'s,
    program by program (the default file of ``--diff-fingerprints``)."""
    report = tmp_path / "fp.json"
    rc = lm.main(["--skip-lint", "--skip-protocol", "--device", "cpu", "--diff-fingerprints", "--json", str(report)])
    assert rc == 0
    out = json.loads(report.read_text())
    with open(os.path.join(REPO, "FINGERPRINTS_TORCH.json")) as fh:
        committed = json.load(fh)
    assert committed["schema"] == "metrics_tpu_torch.program_fingerprints"
    assert out["fingerprints"] == committed["fingerprints"] and out["fingerprint_drift"] == 0
    # the JAX package's committed file digests the same 49 programs (its
    # digests are of another IR and never equal these)
    with open(os.path.join(REPO, "FINGERPRINTS.json")) as fh:
        assert set(committed["fingerprints"]) == set(json.load(fh)["fingerprints"])
    assert "fingerprint diff: no drift" in capsys.readouterr().out


def test_fingerprint_diff_names_a_drifted_family(tmp_path, lm, capsys):
    committed = {"Fam": {"update": "a", "step": "b"}, "Gone": {"update": "c"}}
    current = {"Fam": {"update": "a", "step": "B"}, "New": {"update": "d"}}
    assert lm._diff_fingerprints(current, committed, "F.json") == 3
    out = capsys.readouterr().out
    assert "DRIFTED  Fam.step: b -> B" in out and "NEW      New" in out and "REMOVED  Gone" in out


def test_device_cuda_without_a_card_raises_before_building(lm):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        lm.main(["--skip-lint", "--skip-protocol", "--json", "-"])


# ---------------------------------------------------------------------------
# the exporter script
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_dump(tmp_path_factory):
    """A telemetry snapshot the port wrote: one compiled forward of a
    two-metric collection with telemetry on, dumped atomically."""
    import metrics_tpu_torch as M
    import metrics_tpu_torch.observability as obs
    from metrics_tpu_torch.reliability.journal import atomic_write_json

    rng = np.random.RandomState(0)
    p, t = (torch.as_tensor(rng.rand(64).astype(np.float32)) for _ in range(2))
    with obs.telemetry_scope() as tel:
        col = M.MetricCollection(
            {"mse": M.MeanSquaredError(device="cpu"), "mae": M.MeanAbsoluteError(device="cpu")}, compiled=True
        )
        col(p, t)
        col(p, t)
        path = tmp_path_factory.mktemp("dump") / "telemetry.json"
        atomic_write_json(str(path), tel.snapshot())
    return path


def test_exporter_snapshot_renders_a_port_dump_that_check_accepts(tmp_path, exporter_script, port_dump, capsys):
    from metrics_tpu_torch.observability.exporter import parse_prometheus_text

    assert exporter_script.main(["--snapshot", str(port_dump)]) == 0
    text = capsys.readouterr().out
    samples = parse_prometheus_text(text)
    assert "metrics_tpu_engine_dispatches_total" in samples
    scrape = tmp_path / "scrape.txt"
    scrape.write_text(text)
    assert exporter_script.main(["--check", str(scrape), "--require", "metrics_tpu_engine_*"]) == 0
    assert "valid Prometheus text format" in capsys.readouterr().out


def test_exporter_check_returns_one_on_a_malformed_exposition(tmp_path, exporter_script, capsys):
    bad = tmp_path / "bad.txt"
    bad.write_text("# TYPE x counter\nx{le=\"0.1\" 1\n")
    assert exporter_script.main(["--check", str(bad)]) == 1
    assert "INVALID exposition" in capsys.readouterr().err
    good = tmp_path / "good.txt"
    good.write_text("# TYPE x_total counter\nx_total 1\n")
    assert exporter_script.main(["--check", str(good), "--require", "absent_family"]) == 1
    assert exporter_script.main(["--check", str(good)]) == 0


_RUN_WITHOUT_JAX = """
import runpy, sys
sys.argv = sys.argv[1:]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit as stop:
    rc = stop.code
sys.exit(3 if "jax" in sys.modules or "metrics_tpu" in sys.modules else rc)
"""


def test_exporter_check_reads_stdin_in_a_subprocess(port_dump):
    """The CI spelling: ``--snapshot`` piped into ``--check -``, as two
    processes, neither of which imports the JAX package (exit 3 if one did)."""
    script = os.path.join(REPO, "scripts", "torch_metrics_exporter.py")
    rendered = subprocess.run([sys.executable, "-c", _RUN_WITHOUT_JAX, script, "--snapshot", str(port_dump)],
                              capture_output=True, text=True, timeout=120)
    assert rendered.returncode == 0, rendered.stderr
    checked = subprocess.run([sys.executable, "-c", _RUN_WITHOUT_JAX, script, "--check", "-"],
                             input=rendered.stdout, capture_output=True, text=True, timeout=120)
    assert checked.returncode == 0, checked.stderr
    assert "valid Prometheus text format" in checked.stdout


def test_exporter_demo_serves_a_cohort_on_the_cpu(exporter_script, capsys):
    """``--demo --device cpu``'s loop, stopped after N steps, drives the
    poisoned-tenant cohort behind a live exporter on an OS-assigned port."""
    assert exporter_script._demo_loop(0, 8, 3, torch.device("cpu"), steps=5) == 0
    out = capsys.readouterr().out
    assert "8-tenant cohort on cpu" in out and "stopped after 5 steps" in out
