"""``BENCHMARK.json`` keeps to the contract's names, units, keys and sizes,
and every file it names is under its paths."""
import json
import re
from pathlib import Path

import pytest

from portbench.harness import load_manifest

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|experts_per_tok)|(_dim|_rank)$")
MANIFEST = load_manifest()


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MANIFEST["command"]) <= 32 and all(text_ok(w) for w in MANIFEST["command"])
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    for word in MANIFEST["command"]:
        assert not word.startswith("/") and ".." not in word.split("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MANIFEST["paths"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    cells = len(MANIFEST["workloads"])
    assert 2 + 14 * 24 * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200 or cells < 24


def test_names_units_and_entries():
    names = {"configs": set(), "workloads": set(), "metrics": set()}
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and text_ok(c["source"]) and text_ok(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in MANIFEST["paths"]) and (ROOT / c["file"]).exists()
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["reduced"] == c["reduced"] and config["name"] == c["name"]
        names["configs"].add(c["name"])
    assert len(names["configs"]) == len(MANIFEST["configs"]) and len({c["file"] for c in MANIFEST["configs"]}) == len(
        MANIFEST["configs"])
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and text_ok(w["why"])
        assert w["config"] in names["configs"] and w["chips"] in (1, 4)
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").exists()
        pairs.add((w["config"], w["traffic"]))
        names["workloads"].add(w["name"])
    assert len(pairs) == len(names["workloads"]) == len(MANIFEST["workloads"])
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == names["configs"]
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for kind in ("end_to_end", "per_layer"):
        for m in MANIFEST[kind]:
            keys = {"name", "unit", "better", "source"} | ({"bound"} if kind == "end_to_end" else {"layer", "moves"})
            assert set(m) - {"workloads"} == keys
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            assert m["name"] not in names["metrics"]
            names["metrics"].add(m["name"])
            assert set(m.get("workloads", [])) <= names["workloads"]
            if kind == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
            else:
                assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
                assert text_ok(m["layer"]) and m["moves"] in e2e
    for w in names["workloads"]:
        reported = [m for m in MANIFEST["per_layer"] if w in m.get("workloads", [w])]
        assert reported
        for m in reported:
            moved = next(e for e in MANIFEST["end_to_end"] if e["name"] == m["moves"])
            assert w in moved.get("workloads", [w])


@pytest.mark.parametrize("config", [c["file"] for c in MANIFEST["configs"]])
def test_configuration_files_state_their_check(config):
    c = json.loads((ROOT / config).read_text())
    limits = {k for k in c["limits"] if k != "why"}
    assert {m["check"] for m in c["collection"]} == limits
    assert all(0 < float(c["limits"][k]) for k in limits)
    assert {"source", "assumed", "reduced", "generator", "rows", "guarantees"} <= set(c)
    assert (ROOT / "portbench" / "generators" / f"{c['generator']}.py").exists()
    for m in c["collection"]:
        assert (ROOT / "portbench" / "oracles" / f"{m['class']}.py").exists()
