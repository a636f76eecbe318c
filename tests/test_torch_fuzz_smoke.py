"""The port's two randomized fuzzers at small N with a pinned seed.

``scripts/torch_fuzz_sharded.py`` (the port's bounded-state designs against
its exact metrics, in a gloo world of 4) and ``tests/torch_fuzz_parity.py``
(the port against the JAX package) run as subprocesses, as their users run
them, and must end in "0 MISMATCHES". Each of the parity fuzz's 64 domains
also runs a few seeded trials in this process, so a divergence names its
domain. A broken port function must show as a mismatch, and a carve-out
must count only what it names.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import torch_fuzz_parity as fp

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
DOMAIN_TRIALS = 2


def _run(argv, timeout=600):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, *argv], cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, f"{argv} exit={proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}"
    return proc.stdout.strip().splitlines()[-1]


def test_torch_fuzz_sharded_smoke_in_a_gloo_world_of_4():
    last = _run(["scripts/torch_fuzz_sharded.py", "--trials", "20", "--seed", "7", "--device", "cpu"])
    assert last.startswith("torch_fuzz_sharded: 20 trials on 4 ranks (cpu), ") and last.endswith(" 0 MISMATCHES"), last


def test_torch_fuzz_parity_smoke():
    last = _run(["-m", "tests.torch_fuzz_parity", "--trials", "20", "--seed", "7", "--device", "cpu"])
    assert last.startswith("torch_fuzz_parity: 20 trials, ") and last.endswith(" 0 MISMATCHES"), last


@pytest.mark.parametrize("layer,name", fp.domain_names(), ids=[f"{lay}-{n}" for lay, n in fp.domain_names()])
def test_parity_domain(layer, name):
    seed = sum(map(ord, name)) + (1_000 if layer == "mod" else 0)
    counts = fp.run_trials(DOMAIN_TRIALS, seed, CPU, [(layer, name)], log=print)
    assert counts["mismatch"] == 0, counts
    assert counts["match"] + counts["reject"] + counts["carved"] == DOMAIN_TRIALS


def test_the_domains_are_the_jax_files_64():
    assert len(fp.domain_names("functional")) == 34 and len(fp.domain_names("module")) == 30
    assert fp.domain_names(domain="auroc") == [("fn", "auroc")]


def test_a_broken_port_function_is_a_mismatch(monkeypatch):
    """The harness compares: a port functional moved by 1e-3 and a port
    class whose forward value moves both fail, with their domain named."""
    real = fp.PF.mean_squared_error
    monkeypatch.setattr(fp.PF, "mean_squared_error", lambda *a, **k: real(*a, **k) + 1e-3)
    lines = []
    counts = fp.run_trials(3, 0, CPU, [("fn", "mean_squared_error")], log=lines.append)
    assert counts["mismatch"] == 3 and all(line.startswith("MISMATCH fn mean_squared_error") for line in lines)

    compute = fp.P.MeanAbsoluteError.compute
    monkeypatch.setattr(fp.P.MeanAbsoluteError, "compute", lambda self: compute(self) * 2)
    counts = fp.run_trials(2, 0, CPU, [("mod", "MeanAbsoluteError")], log=lines.append)
    assert counts["mismatch"] == 2 and "MISMATCH mod MeanAbsoluteError" in lines[-1]


def test_a_carve_out_counts_only_the_inputs_it_names(monkeypatch):
    """A carve-out's predicate turns a difference into a counted carve-out
    only where it matches; elsewhere the difference stays a mismatch."""
    real = fp.PF.mean_absolute_error
    monkeypatch.setattr(fp.PF, "mean_absolute_error", lambda p, t, **k: real(p, t, **k) + (p.numel() == 1))
    monkeypatch.setitem(fp.CARVE_OUTS, "one_element", fp.CarveOut(
        lambda layer, name, kwargs, inputs: name == "mean_absolute_error" and np.asarray(inputs[0]).size == 1,
        "a test's own difference"))
    counts = fp.run_trials(40, 3, CPU, [("fn", "mean_absolute_error")], log=lambda line: None)
    assert counts["carved"] == counts["carved:one_element"] > 0
    assert counts["mismatch"] == 0 and counts["match"] + counts["carved"] == 40
    monkeypatch.setattr(fp.PF, "mean_absolute_error", lambda p, t, **k: real(p, t, **k) + 1)
    counts = fp.run_trials(40, 3, CPU, [("fn", "mean_absolute_error")], log=lambda line: None)
    assert counts["mismatch"] == 40 - counts["carved"] > 0


def test_every_carve_out_cites_roadmap_queue_3():
    roadmap = (REPO / "ROADMAP.md").read_text()
    for key, carve in fp.CARVE_OUTS.items():
        assert "Queue 3 item" in carve.cites, key
        assert carve.cites.split(": ", 1)[-1] in roadmap, key
