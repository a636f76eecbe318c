"""Every per-layer reader on a small profiler trace whose answers are
known, and the trace reading beneath them."""
import json
import math
from pathlib import Path

import pytest

from portbench import trace as trace_mod
from portbench.harness import load_manifest
from portbench.roofline import scan_call_bound_ms

FIXTURES = Path(__file__).resolve().parent / "fixtures"


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def synthetic_events():
    """One epoch in a 1,000 µs stretch: two updates, a compute, a reset.
    Device µs launched in compute: a sort 100, the scan 200, an operation
    whose launch the trace lost (it takes the scan's span) 10, an all-gather
    20, a copy 10. The device is busy 390 µs."""
    return [
        _x("user_annotation", "portbench.stretch", 0, 1000),
        _x("user_annotation", "portbench.update", 10, 90),
        _x("user_annotation", "portbench.compute", 200, 400),
        _x("user_annotation", "portbench.reset", 600, 20),
        _x("user_annotation", "portbench.update", 700, 80),
        _x("user_annotation", "metrics_tpu.AUROC.update", 12, 50),
        _x("cpu_op", "aten::item", 300, 290),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 5, correlation=1),
        _x("kernel", "void at::native::elementwise_kernel", 30, 30, correlation=1, stream=7),
        _x("cuda_runtime", "cudaLaunchKernel", 210, 5, correlation=2),
        _x("kernel", "void cub::DeviceRadixSortOnesweepKernel<int>", 250, 100, correlation=2, stream=7),
        _x("cuda_driver", "cuLaunchKernel", 220, 5, correlation=3),
        _x("kernel", "(anonymous namespace)::tie_scan_kernel(Stream, long long)", 350, 200, correlation=3,
           stream=7),
        _x("kernel", "void at::native::reduce_kernel", 550, 10, correlation=99, stream=7),
        _x("cuda_runtime", "cudaLaunchKernel", 230, 5, correlation=4),
        _x("kernel", "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 560, 20,
           correlation=4, stream=9),
        _x("cuda_runtime", "cudaMemcpyAsync", 590, 5, correlation=5),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 585, 10, correlation=5, stream=7),
        _x("cuda_runtime", "cudaLaunchKernel", 710, 5, correlation=6),
        _x("kernel", "void at::native::elementwise_kernel", 720, 20, correlation=6, stream=7),
        {"ph": "i", "cat": "cpu_instant_event", "name": "marker", "ts": 5},
    ]


def context(events, **extra):
    ctx = {"trace": trace_mod.Trace(events), "epochs": 1, "update_host_s": [0.001, 0.003],
           "syncs": {"update": (6, 3), "compute": (5, 1)}, "scan_shape": (1, 10_000_000)}
    ctx.update(extra)
    return ctx


def read(name, ctx):
    import importlib

    return importlib.import_module(f"portbench.layers.{name}").read(ctx)


def test_trace_ties_device_operations_to_the_spans_that_launched_them():
    tr = trace_mod.Trace(synthetic_events())
    assert [op["span"] for op in tr.ops] == ["update", "compute", "compute", "compute", "compute", "compute",
                                              "update"]
    assert tr.count("compute") == 1 and tr.count("update") == 2
    assert tr.window() == (0.0, 1000.0)
    assert tr.busy_us(0, 1000) == 390.0
    assert tr.idle_gaps(0, 100) == [(0, 30), (60, 100)]
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] == "(anonymous namespace)::tie_scan_kernel(Stream, long long)"
    assert bd["device_ops"][0][1] == pytest.approx(200e-6)
    assert len(bd["idle_gaps"]) <= 10
    assert bd["idle_gaps"][0][1] == pytest.approx(260e-6)  # after the last update
    labels = {label for label, _ in bd["idle_gaps"]}
    assert "compute: aten::item" in labels and "between epochs: no host op" in labels


@pytest.mark.parametrize("name, want", [
    ("update_host_ms", 2.0),
    ("host_syncs_per_update", 2.0),
    ("host_syncs_per_compute", 5.0),
    ("compute_device_ms", 0.34),
    ("cosort_device_ms", 0.1),
    ("tie_scan_roofline", 100 * scan_call_bound_ms(1, 10_000_000) / 0.2),
])
def test_each_reader_on_the_synthetic_trace(name, want):
    assert read(name, context(synthetic_events())) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["compute_device_ms", "cosort_device_ms", "tie_scan_roofline",
                                  "host_syncs_per_update", "host_syncs_per_compute", "update_host_ms"])
def test_a_reader_that_finds_nothing_returns_nothing(name):
    empty = [e for e in synthetic_events() if e.get("cat") not in trace_mod.DEVICE_CATEGORIES]
    ctx = context(empty, syncs={}, update_host_s=[])
    assert read(name, ctx) is None
    assert read(name, {"trace": None, "epochs": 0}) is None


def test_every_per_layer_metric_has_a_reader():
    for metric in load_manifest()["per_layer"]:
        assert (Path(trace_mod.__file__).parent / "layers" / f"{metric['name']}.py").exists()


def recorded():
    path = FIXTURES / "recorded_trace.json"
    return json.loads(path.read_text()) if path.exists() else None


def test_readers_on_a_recorded_trace():
    fixture = recorded()
    if fixture is None:
        pytest.skip("no recorded trace in fixtures/")
    ctx = context(fixture["traceEvents"], **fixture["context"])
    for name, want in fixture["expected"].items():
        got = read(name, ctx)
        assert got is not None and math.isclose(got, want, rel_tol=1e-9), (name, got, want)
