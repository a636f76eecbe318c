"""``scripts/torch_serving_demo.py`` on the CPU.

The demo drives the port's serving observability surface once and checks
what it writes: one flow chain across the submitting, worker and writer
threads, the required families in a live scrape, ``/healthz`` answering, a
program in the cost ledger. Its scrape must pass the exporter script's
``--check`` with the families the JAX package's ``make serve-bench``
requires; a missing family must make it exit 1.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import metrics_tpu_torch.observability as obs

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import torch_serving_demo as demo  # noqa: E402

REQUIRES = ("metrics_tpu_serving_slo_*", "metrics_tpu_serving_latency_*", "metrics_tpu_serving_queue_depth",
            "metrics_tpu_serving_queue_age_ms", "metrics_tpu_engine_compile_*", "metrics_tpu_engine_program_*")


def _run(*argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *map(str, argv)], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def _paths(tmp_path):
    return {"out": tmp_path / "scrape.txt", "trace": tmp_path / "traces", "ledger": tmp_path / "ledger.json"}


def _demo_argv(paths):
    return ["--out", paths["out"], "--trace-out", paths["trace"], "--ledger-out", paths["ledger"], "--device", "cpu"]


def test_demo_writes_and_checks_its_artifacts(tmp_path):
    paths = _paths(tmp_path)
    proc = _run("scripts/torch_serving_demo.py", *_demo_argv(paths))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("torch_serving_demo OK (cpu): batch ") and "across 3 threads" in proc.stdout
    blob = json.loads((paths["trace"] / "serving_flow.perfetto.json").read_text())
    flows = [e for e in blob["traceEvents"] if e.get("cat") == "flow"]
    assert flows and {e["ph"] for e in flows} >= {"s", "f"}
    ledger = json.loads(paths["ledger"].read_text())
    assert ledger["programs"]
    scrape = paths["out"].read_text()
    assert all(family in scrape for family in demo.REQUIRED_FAMILIES)
    check = _run("scripts/torch_metrics_exporter.py", "--check", paths["out"],
                 *[a for req in REQUIRES for a in ("--require", req)])
    assert check.returncode == 0, check.stderr[-2000:]
    assert "6 required families present" in check.stdout


def test_a_missing_family_fails_the_demo(tmp_path, monkeypatch, capsys):
    """A required family the scrape lacks is a failed self-check: exit 1,
    the family named, and every recorder disarmed afterwards."""
    monkeypatch.setattr(demo, "REQUIRED_FAMILIES", demo.REQUIRED_FAMILIES + ("metrics_tpu_no_such_family",))
    assert demo.main([str(a) for a in _demo_argv(_paths(tmp_path))]) == 1
    assert "FAIL: scrape is missing metrics_tpu_no_such_family" in capsys.readouterr().err
    assert not obs.enabled() and not obs.tracing_enabled() and not obs.cost_ledger_enabled()
    assert obs.get_exporter() is None


def test_the_card_is_the_default(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    paths = _paths(tmp_path)
    proc = _run("scripts/torch_serving_demo.py", *_demo_argv(paths)[:-2])
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert not paths["out"].exists()


def test_a_health_armed_cohort_knows_its_built_step_whatever_its_device_is_called():
    """Found by the demo on the card, where every step of its health-armed
    cohort ran on the caller: ``_step_is_built`` keyed the health leaves on
    the cohort's device as given ("cuda"), while the built step keyed them
    on its tensors' ("cuda:0"), so the pipeline never handed a step to its
    worker. A device spelled unlike its tensors' (here "meta" against
    "cpu") must not unbuild the step."""
    import torch

    import metrics_tpu_torch as tm

    cohort = tm.MetricCohort(tm.Accuracy(device="cpu"), tenants=4, track_health=True)
    p = torch.rand(4, 32, generator=torch.Generator().manual_seed(0))
    t = (p > 0.5).to(torch.int32)
    cohort(p, t)
    assert cohort._step_is_built((p, t), {})
    cohort._device = torch.device("meta")
    assert cohort._step_is_built((p, t), {})
