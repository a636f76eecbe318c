"""``scripts/torch_trace_export.py`` against ``scripts/trace_export.py``.

The port writes the dumps (a native trace with flows on several threads, a
flight dump, two ranks' traces); both scripts convert each one, and their
JSON must be equal. Their ``--merge`` errors must be the same too. Both run
as subprocesses, so the port's script runs where JAX is never imported.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

import metrics_tpu_torch.observability as obs
from metrics_tpu_torch.observability import trace as trace_mod

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = {"jax": REPO / "scripts" / "trace_export.py", "port": REPO / "scripts" / "torch_trace_export.py"}


@pytest.fixture(autouse=True)
def _pristine_tracing():
    """The recorders are process-global: each case starts and ends with
    them off and empty."""
    def reset():
        obs.disable_tracing()
        obs.get_tracer().reset()
        obs.disable_flight()

    reset()
    yield
    reset()


def _export(which, *argv):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, str(SCRIPTS[which]), *map(str, argv)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def _both(tmp_path, make_argv):
    """Run both scripts, each into a directory of its own; returns
    ``{which: (proc, out_dir)}``."""
    runs = {}
    for which in SCRIPTS:
        out = tmp_path / which
        out.mkdir()
        runs[which] = (_export(which, *make_argv(out)), out)
    return runs


def _rank_dump(path, rank, world, steps, skew_s=0.0):
    """A native dump of one rank: spans pinned to ``steps``, one with a flow."""
    with obs.identity_scope(rank, world), obs.tracing_scope() as tracer:
        for step in steps:
            with trace_mod.step_scope(step), trace_mod.flow_scope(step + 100):
                with trace_mod.span("dispatch", phase="dispatch", rows=8):
                    with trace_mod.span("sync", phase="sync"):
                        pass
        path.write_text(tracer.to_json())
    return path


def test_native_dump_with_cross_thread_flows_converts_alike(tmp_path):
    """A dump whose flow crosses three threads (flow arrows on each
    track), converted next to its input and with ``-o``."""
    with obs.tracing_scope() as tracer:
        def worker(name):
            with trace_mod.flow_scope(7), trace_mod.span(name, phase="dispatch"):
                pass

        with trace_mod.flow_scope(7), trace_mod.span("admit", phase="other", tenant=3):
            pass
        for name in ("dispatch", "commit"):
            t = threading.Thread(target=worker, args=(name,))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        trace_mod.instant("marker", phase="other", note="hi")
        dump = tmp_path / "dump.json"
        dump.write_text(tracer.to_json())
    runs = _both(tmp_path, lambda out: [dump, "-o", out / "out.json"])
    blobs = {}
    for which, (proc, out) in runs.items():
        assert proc.returncode == 0, (which, proc.stderr[-2000:])
        blobs[which] = json.loads((out / "out.json").read_text())
    assert blobs["port"] == blobs["jax"]
    flows = [e for e in blobs["port"]["traceEvents"] if e.get("cat") == "flow"]
    assert [e["ph"] for e in flows][0] == "s" and flows[-1]["ph"] == "f"
    assert len({e["tid"] for e in flows}) == 3
    # with no -o the output lands next to the input
    proc = _export("port", dump)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads((tmp_path / "dump.perfetto.json").read_text()) == blobs["jax"]


def test_flight_dump_and_passthrough_convert_alike(tmp_path):
    with obs.flight_scope(tmp_path / "flight") as rec:
        rec.record("session_step", step=3)
        rec.record("sync_failure", step=4, timeout=True)
        dump = rec.dump("sync_timeout")
    runs = _both(tmp_path, lambda out: [dump, "-o", out / "out.json"])
    blobs = {which: json.loads((out / "out.json").read_text()) for which, (_, out) in runs.items()}
    assert all(proc.returncode == 0 for proc, _ in runs.values())
    assert blobs["port"] == blobs["jax"]
    assert [e["name"] for e in blobs["port"]["traceEvents"] if e["ph"] == "i"] == ["session_step", "sync_failure"]
    # an already-converted file passes through unchanged
    proc = _export("port", tmp_path / "port" / "out.json", "-o", tmp_path / "again.json")
    assert proc.returncode == 0 and json.loads((tmp_path / "again.json").read_text()) == blobs["jax"]


def test_two_rank_merge_is_equal_and_anchored(tmp_path):
    """Two ranks with overlapping step ranges (rank 1 starts a step later)
    merge on the first common step into one track per rank."""
    paths = [_rank_dump(tmp_path / "rank0.json", 0, 2, steps=(4, 5, 6)),
             _rank_dump(tmp_path / "rank1.json", 1, 2, steps=(5, 6, 7))]
    runs = _both(tmp_path, lambda out: ["--merge", *paths, "-o", out / "merged.json"])
    blobs = {}
    for which, (proc, out) in runs.items():
        assert proc.returncode == 0, (which, proc.stderr[-2000:])
        blobs[which] = json.loads((out / "merged.json").read_text())
        assert proc.stdout.strip() == f"wrote {out / 'merged.json'} (ranks [0, 1], anchored on step 5)"
    assert blobs["port"] == blobs["jax"]
    assert blobs["port"]["metadata"] == {"merged_ranks": [0, 1], "anchor_step": 5}
    names = {e["args"]["name"] for e in blobs["port"]["traceEvents"] if e["ph"] == "M"}
    assert names == {"metrics_tpu rank 0/2", "metrics_tpu rank 1/2"}


def test_merge_of_duplicate_ranks_reassigns_alike(tmp_path):
    """Two dumps stamped with the same rank: the second gets the next free
    track, with the same warning from both scripts."""
    paths = [_rank_dump(tmp_path / "a.json", 0, 2, steps=(1, 2)), _rank_dump(tmp_path / "b.json", 0, 2, steps=(1, 2))]
    runs = _both(tmp_path, lambda out: ["--merge", *paths, "-o", out / "merged.json"])
    procs = {which: proc for which, (proc, _) in runs.items()}
    assert procs["port"].returncode == procs["jax"].returncode == 0
    assert procs["port"].stderr.splitlines()[-1] == procs["jax"].stderr.splitlines()[-1]
    assert "assigning it track rank 1" in procs["port"].stderr
    blobs = {which: json.loads((out / "merged.json").read_text()) for which, (_, out) in runs.items()}
    assert blobs["port"] == blobs["jax"]


def _error_cases(tmp_path):
    native = _rank_dump(tmp_path / "native.json", 0, 2, steps=(1, 2))
    disjoint = _rank_dump(tmp_path / "disjoint.json", 1, 2, steps=(8, 9))
    with obs.flight_scope(tmp_path / "flight") as rec:
        rec.record("session_step", step=3)
        flight = rec.dump("boom")
    telemetry = tmp_path / "telemetry.json"
    with obs.telemetry_scope() as tel:
        tel.count("a")
        tel.event("custom")
        telemetry.write_text(tel.to_json())
    return {
        "merge_needs_two": (["--merge", native], "--merge needs at least two per-rank trace dumps"),
        "merge_takes_native_dumps": (["--merge", native, flight], "--merge takes native metrics_tpu trace dumps"),
        "merge_needs_a_common_step": (["--merge", native, disjoint], "no step index common to every input"),
        "output_needs_one_input": ([native, disjoint, "-o", tmp_path / "x.json"], "-o/--output needs exactly one input"),
        "telemetry_refused": ([telemetry], "telemetry snapshots have no timeline"),
    }


@pytest.mark.parametrize("case", ["merge_needs_two", "merge_takes_native_dumps", "merge_needs_a_common_step",
                                  "output_needs_one_input", "telemetry_refused"])
def test_error_paths_fail_alike(tmp_path, case):
    argv, message = _error_cases(tmp_path)[case]
    procs = {which: _export(which, *argv) for which in SCRIPTS}
    assert procs["jax"].returncode != 0
    assert procs["port"].returncode == procs["jax"].returncode
    assert message in procs["port"].stderr
    assert procs["port"].stderr.strip().splitlines()[-1] == procs["jax"].stderr.strip().splitlines()[-1] \
        .replace("trace_export.py", "torch_trace_export.py")
