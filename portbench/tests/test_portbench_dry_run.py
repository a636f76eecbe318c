"""Each cell, cut tiny, runs on the CPU through the port's plain paths and
ends in a well-formed result line; without a card or without the port the
command prints no result."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness, run
from portbench.tests.tiny import CELLS, load, shrink

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**33 + 17


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("workload", CELLS)
def test_tiny_cell_on_the_cpu_ends_in_a_well_formed_line(workload, traced):
    result = run.run_cell(workload, SEED, 0.3, traced, device_type="cpu", shrink=shrink)
    line = json.loads(json.dumps(result))
    assert list(line)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    spec = load(workload, traced)
    wanted = {m["name"]: m["unit"] for m in spec["metrics"]}
    for name, metric in line["metrics"].items():
        assert metric["unit"] == wanted[name] and isinstance(metric["value"], float)
    if traced:
        # no device here: only the host clock has something to read
        assert set(line["metrics"]) == {"update_host_ms"} & set(wanted)
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == set(wanted)
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 1
    for check in line["checks"].values():
        assert 0 <= check["value"] <= check["limit"]


def test_the_same_seed_gives_the_same_inputs():
    spec = load("criteo_dac_epoch", False)
    import torch

    a = harness.make_inputs(spec["config"], SEED, 1, torch.device("cpu"))
    b = harness.make_inputs(spec["config"], SEED, 1, torch.device("cpu"))
    c = harness.make_inputs(spec["config"], SEED, 0, torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_updates_cover_the_rows_once():
    rows = 45_840_617
    bounds = harness.update_bounds(0, rows, 1_048_576)
    assert len(bounds) == 44 and bounds[-1][1] - bounds[-1][0] == 751_849
    assert bounds[0][0] == 0 and bounds[-1][1] == rows
    assert all(bounds[i][1] == bounds[i + 1][0] for i in range(len(bounds) - 1))


def test_without_a_card_the_command_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "criteo_dac_epoch", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_with_only_the_benchmark_files_the_command_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "criteo_dac_epoch", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout
