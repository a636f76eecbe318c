"""One cell of the benchmark: set-up, the measured window, the traced
stretch, the check against the float64 reference, and the result line.

A cell is one entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``portbench/configs/<config>.json``: the data's shape, its generator, the
collection the port builds, the limits of the check) under a traffic mix
(``portbench/traffic/<traffic>.json``: rows per update, traced epochs).
One caller runs a closed loop of epochs on one card: the updates, then
``compute()``, the values read on the host, then ``reset()``. The input
sets, made at set-up from the seed, take turns, so no two epochs in a row
hand the port the same tensors.
"""
import contextlib
import hashlib
import importlib
import json
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import trace as trace_mod

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
BUILD = ROOT / "build" / "portbench"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "metrics_tpu")
INPUT_SETS = 2
WARM_EPOCHS = 2
SYNC_EPOCHS = 2
PROFILE_PAD_S = 0.05
TRACE_ATTEMPTS = 3
SYNC_WARNING = "synchroniz"


# ---- the manifest and a cell's files ----------------------------------------

def load_manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(manifest: dict, workload: str) -> dict:
    """The cell's manifest entry with its configuration and traffic read."""
    cells = {c["name"]: c for c in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    with open(ROOT / configs[cell["config"]]["file"]) as f:
        config = json.load(f)
    with open(BENCH / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return {"cell": cell, "config": config, "traffic": traffic}


def cell_metrics(manifest: dict, workload: str, traced: bool) -> List[dict]:
    """The metrics this cell reports: its end-to-end ones untraced, its
    per-layer ones traced; a metric without ``workloads`` is every cell's."""
    kind = "per_layer" if traced else "end_to_end"
    return [m for m in manifest[kind] if workload in m.get("workloads", [workload])]


# ---- inputs -----------------------------------------------------------------

def set_seed(seed: int, index: int) -> int:
    """The seed of input set ``index`` of a run seeded ``seed``."""
    digest = hashlib.sha256(f"portbench:{seed}:{index}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def make_inputs(config: dict, seed: int, index: int, device: torch.device):
    generator = importlib.import_module(f"portbench.generators.{config['generator']}")
    return generator.make(config, set_seed(seed, index), device)


def update_bounds(start: int, stop: int, update_rows: int):
    return [(a, min(a + update_rows, stop)) for a in range(start, stop, update_rows)]


def scan_shape(config: dict):
    """``(rows, n)`` of each tie-scan call of an epoch's compute."""
    return (int(config.get("classes", 1)), int(config["rows"]))


# ---- the port -----------------------------------------------------------------

def build_collection(config: dict, device: torch.device):
    import metrics_tpu_torch

    members = [getattr(metrics_tpu_torch, spec["class"])(**spec["kwargs"], device=device)
               for spec in config["collection"]]
    return metrics_tpu_torch.MetricCollection(members)


def read_values(values: Dict[str, object]) -> np.ndarray:
    """Every value ``compute()`` returned, read on the host in one copy:
    float64, flattened in the collection's order (a list value, such as
    per-class average precision, in its order)."""
    parts = []
    for value in values.values():
        if isinstance(value, (list, tuple)):
            value = torch.stack(list(value))
        parts.append(value.reshape(-1).to(torch.float64))
    return torch.cat(parts).cpu().numpy()


class Epochs:
    """The caller's loop: its collection, its input sets and update
    bounds, and what the loop records."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device, collection=None, cast=None):
        self.device = device
        self.collection = build_collection(config, device) if collection is None else collection
        self.rows = int(config["rows"])
        # ``whole`` keeps the sets as made, for the reference; ``sets`` as fed
        self.whole, self.sets = [], []
        for index in range(INPUT_SETS):
            preds, target = make_inputs(config, seed, index, device)
            self.whole.append((preds, target))
            self.sets.append((preds if cast is None else preds.to(cast), target))
        self.bounds = update_bounds(0, self.rows, int(traffic["update_rows"]))
        self.count = 0
        self.update_host_s: List[float] = []
        self.waits: List[float] = []
        self.epoch_s: List[float] = []
        self.values: List[np.ndarray] = []
        self.set_of_epoch: List[int] = []
        self.syncs: Dict[str, tuple] = {}  # phase: (host synchronizations, calls counted)
        self.errors = 0

    @contextlib.contextmanager
    def _syncs_counted(self, phase: str, on: bool):
        """Count the block's host synchronizations under ``phase`` (with
        ``torch.cuda.set_sync_debug_mode("warn")``) when ``on``."""
        if not on:
            yield
            return
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs, calls = self.syncs.get(phase, (0, 0))
        self.syncs[phase] = (syncs + sum(SYNC_WARNING in str(w.message) for w in caught), calls + 1)

    def run(self, span: Callable = None, record: bool = True, count_syncs: bool = False) -> None:
        """One epoch on the next input set. ``span(name)`` wraps each phase
        (a ``record_function`` while traced); ``record`` keeps the update
        times; ``count_syncs`` counts the host synchronizations of each
        update and of ``compute()`` (not of the benchmark's read)."""
        span = span or (lambda name: contextlib.nullcontext())
        started = time.perf_counter()
        index = self.count % len(self.sets)
        preds, target = self.sets[index]
        for a, b in self.bounds:
            t0 = time.perf_counter()
            with span("update"), self._syncs_counted("update", count_syncs):
                self.collection.update(preds[a:b], target[a:b])
            if record:
                self.update_host_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        with span("compute"):
            try:
                with self._syncs_counted("compute", count_syncs):
                    values = self.collection.compute()
                host = read_values(values)
            except Exception:  # an answer that never comes fails the check; the loop goes on
                if not self.errors:
                    traceback.print_exc()
                self.errors += 1
                host = None
        self.waits.append(time.perf_counter() - t0)
        with span("reset"):
            self.collection.reset()
        self.values.append(host)
        self.set_of_epoch.append(index)
        self.epoch_s.append(time.perf_counter() - started)
        self.count += 1


# ---- the check ----------------------------------------------------------------

def reference_values(config: dict, preds: torch.Tensor, target: torch.Tensor) -> Dict[str, np.ndarray]:
    """The float64 reference of each member, by its ``check`` name, over
    one whole input set as the benchmark made it."""
    out = {}
    for spec in config["collection"]:
        oracle = importlib.import_module(f"portbench.oracles.{spec['class']}")
        out[spec["check"]] = np.asarray(oracle.reference(preds, target, spec["kwargs"]), dtype=np.float64)
    return out


def split_values(config: dict, flat: np.ndarray, expected: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Cut a flat value row into members, each as long as its reference."""
    out, at = {}, 0
    for spec in config["collection"]:
        size = expected[spec["check"]].size
        out[spec["check"]] = flat[at:at + size]
        at += size
    if at != flat.size:
        raise ValueError(f"compute() returned {flat.size} values, the reference {at}")
    return out


def gap(got: np.ndarray, want: np.ndarray) -> float:
    """Widest absolute gap; a NaN on one side only is an infinite gap."""
    both_nan = np.isnan(got) & np.isnan(want)
    diff = np.abs(got - want)
    diff = np.where(both_nan, 0.0, np.where(np.isnan(diff), np.inf, diff))
    return float(diff.max()) if diff.size else 0.0


def judge(config: dict, answers: List[tuple], references: List[Dict[str, np.ndarray]]):
    """``(checks, attempted, failed)``: each number compared (its widest
    gap over every epoch) beside its limit, and the answers (one per
    epoch) of which any number passed its limit."""
    limits = {k: float(v) for k, v in config["limits"].items() if k != "why"}
    widest = {name: 0.0 for name in limits}
    attempted = failed = 0
    for set_index, flat in answers:
        attempted += 1
        try:
            if flat is None:
                raise ValueError("compute() raised")
            got = split_values(config, flat, references[set_index])
        except ValueError:
            failed += 1
            widest = {name: float("inf") for name in widest}
            continue
        bad = False
        for name in limits:
            g = gap(got[name], references[set_index][name])
            widest[name] = max(widest[name], g)
            bad |= not g <= limits[name]
        failed += bad
    checks = {name: {"value": widest[name], "limit": limits[name]} for name in limits}
    return checks, attempted, failed


# ---- the run --------------------------------------------------------------------

def _cuda(device: torch.device) -> bool:
    return device.type == "cuda"


def _card_power_limit(index: int) -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def _profile(epochs: Epochs, n: int, path: Path, step: Callable):
    """Profile ``n`` epochs (``step`` runs one) into a Chrome trace at
    ``path``; returns the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if _cuda(epochs.device) else [])
    if _cuda(epochs.device):
        torch.cuda.synchronize(epochs.device)
    with profile(activities=activities) as prof:
        time.sleep(PROFILE_PAD_S)
        with record_function("portbench.stretch"):
            for _ in range(n):
                step(lambda name: record_function(f"portbench.{name}"))
            if _cuda(epochs.device):
                torch.cuda.synchronize(epochs.device)
        time.sleep(PROFILE_PAD_S)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return trace_mod.Trace(trace_mod.load(path))


def run_device(device_type: str) -> torch.device:
    return torch.device("cuda", 0) if device_type == "cuda" else torch.device("cpu")


def run_main(spec: dict, seed: int, seconds: float, traced: bool, device_type: str, t_start: float) -> dict:
    """Run one cell on one card; returns the result object. ``spec`` is
    :func:`load_cell`'s, with ``metrics`` added."""
    config, traffic = spec["config"], spec["traffic"]
    device = run_device(device_type)
    cuda = _cuda(device)
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    epochs = Epochs(config, traffic, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    for _ in range(WARM_EPOCHS):
        epochs.run(record=False)
    print(f"set-up: {t0 - t_start!r} s of imports, CUDA context {t1 - t0!r} s, inputs {t2 - t1!r} s,"
          f" warm epochs {time.perf_counter() - t2!r} s", file=sys.stderr, flush=True)
    epochs.count, epochs.waits, epochs.epoch_s, epochs.values, epochs.set_of_epoch = 0, [], [], [], []
    if cuda:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        peak_before = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    window_start = time.perf_counter()
    setup_s = window_start - t_start

    ctx = {"trace": None, "epochs": 0, "update_host_s": epochs.update_host_s, "syncs": {},
           "scan_shape": scan_shape(config)}
    while True:
        epochs.run()
        if time.perf_counter() - window_start >= seconds:
            break
    window_s = time.perf_counter() - window_start
    if cuda:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
        state_peak = peak - base
        memory_peak = max(peak, peak_before)
    else:
        state_peak = memory_peak = 0
    if traced:
        # after the window, so that the window's times are untouched: the
        # synchronizations counted in epochs of their own, then the profiled
        # stretch with nothing else switched on
        if cuda:
            for _ in range(SYNC_EPOCHS):
                epochs.run(record=False, count_syncs=True)
            ctx["syncs"] = dict(epochs.syncs)
        for _ in range(TRACE_ATTEMPTS):
            _trace_stretch(epochs, traffic, ctx)
            if not cuda or ctx["trace"].device_us("compute"):  # else CUPTI lost the records: again
                break
    report = {
        "setup_s": setup_s,
        "window_s": window_s,
        "epochs": epochs.count,
        "rows": epochs.rows,
        "waits": epochs.waits,
        "epoch_s": epochs.epoch_s,
        "state_peak_bytes": state_peak,
        "memory_peak_bytes": memory_peak,
        "answers": list(zip(epochs.set_of_epoch, epochs.values)),
        "layers": _read_layers(spec["metrics"], ctx) if traced else {},
        "busy_s": None,
        "trace_window_s": None,
        "breakdown": None,
    }
    if traced and ctx["trace"] is not None and ctx["trace"].window() is not None:
        w0, w1 = ctx["trace"].window()
        report["busy_s"] = ctx["trace"].busy_us(w0, w1) * 1e-6
        report["trace_window_s"] = (w1 - w0) * 1e-6
        report["breakdown"] = ctx["trace"].breakdown()
    # the program's state goes before the reference runs
    whole = epochs.whole
    del epochs
    if cuda:
        torch.cuda.empty_cache()
    return finish(spec, report, device, whole, traced)


def _trace_stretch(epochs: Epochs, traffic: dict, ctx: dict) -> None:
    """Profile ``trace_epochs`` epochs and put what they show into ``ctx``."""
    trace = _profile(epochs, int(traffic["trace_epochs"]), BUILD / "trace.json",
                     lambda span: epochs.run(span=span, record=False))
    ctx["trace"] = trace
    ctx["epochs"] = trace.count("compute")


def _read_layers(metrics: List[dict], ctx: dict) -> Dict[str, float]:
    out = {}
    for metric in metrics:
        reader = importlib.import_module(f"portbench.layers.{metric['name']}")
        value = reader.read(ctx)
        if value is not None:
            out[metric["name"]] = float(value)
    return out


# ---- the check and the line ------------------------------------------------------

def finish(spec: dict, report: dict, device: torch.device, whole, traced: bool) -> dict:
    """The reference over each whole input set, the check of every answer,
    and the result line's object."""
    config = spec["config"]
    t0 = time.perf_counter()
    references = [reference_values(config, preds, target) for preds, target in whole]
    print(f"reference: {time.perf_counter() - t0!r} s over {len(whole)} input sets", file=sys.stderr, flush=True)
    checks, attempted, failed = judge(config, report["answers"], references)
    epochs = report["epochs"]
    correct = attempted > 0 and failed == 0
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": {}}
    units = {m["name"]: m["unit"] for m in spec["metrics"]}
    if traced:
        for name in units:
            if name in report["layers"]:
                result["metrics"][name] = {"value": report["layers"][name], "unit": units[name]}
    else:
        waits = np.array(report["waits"]) * 1e3
        e2e = {
            "rows_per_s": report["rows"] * epochs / report["window_s"],
            "compute_p95_ms": float(np.percentile(waits, 95)) if waits.size else None,
            "state_peak_gib": report["state_peak_bytes"] / 2**30,
            "setup_s": report["setup_s"],
        }
        for name in units:
            if e2e.get(name) is not None:
                result["metrics"][name] = {"value": e2e[name], "unit": units[name]}
        if waits.size:
            print(f"compute wait: {waits.size} epochs, median {statistics.median(waits.tolist())!r} ms,"
                  f" p95 {e2e['compute_p95_ms']!r} ms", flush=True)
            quartiles = statistics.quantiles([t * 1e3 for t in report["epoch_s"]], n=4) if epochs > 1 else []
            print(f"epoch ms, quartiles: {quartiles!r}", flush=True)
    result["device"] = describe_device(device, report, traced)
    if traced and report["breakdown"]:
        result["breakdown"] = report["breakdown"]
    result["checks"] = checks
    return result


def describe_device(device: torch.device, report: dict, traced: bool) -> dict:
    if device.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
               "memory_peak_bytes": report["memory_peak_bytes"], "power_limit": _card_power_limit(device.index)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if traced:
        out["busy_s"] = report["busy_s"] or 0.0
        out["window_s"] = report["trace_window_s"] or 0.0
    return out


def forbidden_modules(modules) -> List[str]:
    """The loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({name for name in modules if name.split(".")[0] in FORBIDDEN_MODULES})
