"""Spawned ``torch.distributed`` worlds for the port's tests.

One process per rank, joined over ``tcp://localhost`` on gloo (CPU tensors)
or NCCL (one card per rank). This module imports neither JAX nor the JAX
package, so the workers start quickly and run on a machine that has only
PyTorch; the tests that hold the results against JAX compute JAX's side in
the parent process.
"""
import multiprocessing
import queue as queue_module
import socket
import time
from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.distributed as dist

from metrics_tpu_torch import ShardedAUROC, ShardedAveragePrecision, ShardedPrecisionRecallCurve, ShardedROC
from metrics_tpu_torch.interop import state_from_jax
from metrics_tpu_torch.parallel.backend import TorchDistributedBackend
from metrics_tpu_torch.parallel.sample_sort import sample_sort_auroc_ap


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, device_type: str, fn: Callable, payload: Any, queue) -> None:
    device = torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")
    if device_type == "cuda":
        torch.cuda.set_device(device)
    torch.set_num_threads(1)
    dist.init_process_group(
        TorchDistributedBackend.process_group_backend(device),
        init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
    )
    try:
        queue.put((rank, fn(rank, world, device, payload)))
    except BaseException as err:  # reported by the parent
        queue.put((rank, err))
        raise
    finally:
        dist.destroy_process_group()


def run_world(world: int, fn: Callable, payload: Any, device_type: str = "cpu", timeout: float = 300) -> Dict[int, Any]:
    """Run ``fn(rank, world, device, payload)`` on every rank of a new world;
    returns ``{rank: result}``. ``fn`` must be a module-level function."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [
        ctx.Process(target=_entry, args=(r, world, port, device_type, fn, payload, queue)) for r in range(world)
    ]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, result = queue.get(timeout=1)
            except queue_module.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(f"a rank of the world of {world} failed (exit codes {dead}) or timed out")
                continue
            if isinstance(result, BaseException):
                raise result
            results[rank] = result
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    return results


# ---- what the workers run ------------------------------------------------------

_METRICS = {
    "auroc": ShardedAUROC, "ap": ShardedAveragePrecision, "roc": ShardedROC, "prc": ShardedPrecisionRecallCurve,
}


def _value(x):
    """A tensor as a numpy array; a curve's tuple (or per-class lists) of
    them as the same structure of arrays."""
    if isinstance(x, (tuple, list)):
        return type(x)(_value(v) for v in x)
    return x.detach().cpu().numpy()


def sharded_cases(rank: int, world: int, device: torch.device, cases: list) -> dict:
    """Run every case of ``cases`` on this rank; a case names the metric,
    its constructor kwargs, its global ``capacity`` (``capacity_per_device``
    is its ``world``-th part) and the global batches, each cut into
    ``world`` equal chunks of which this rank appends chunk ``rank``. Returns, per
    case, the computed value, the per-batch ``forward`` values (when the
    case asks for them) and this rank's buffers and counts."""
    out = {}
    for case in cases:
        kwargs = dict(case["kwargs"], capacity_per_device=case["capacity"] // world)
        m = _METRICS[case["metric"]](device=device, **kwargs)
        steps = []
        for batch in case["batches"]:
            chunk = [torch.from_numpy(np.array_split(a, world)[rank]) for a in batch]
            if case.get("forward"):
                steps.append(_value(m(*chunk[:2], *chunk[2:])))
            else:
                m.update(*chunk[:2], *chunk[2:])
        if "jax_state" in case:
            m.reset()
            m.load_state_dict(state_from_jax(case["jax_state"], rank=rank, world=world), strict=True)
        buffers = {k: _value(getattr(m, k).float() if k == "buf_preds" else getattr(m, k))
                   for k in (*m._stream_names, "counts")}
        out[case["name"]] = {"value": _value(m.compute()), "steps": steps, "buffers": buffers}
    return out


def sample_sort_cases(rank: int, world: int, device: torch.device, cases: list) -> dict:
    """``sample_sort_auroc_ap`` of every case: ``case["shards"][rank]`` is this
    rank's ``(preds, target, weights or None, fill)``."""
    out = {}
    for case in cases:
        preds, target, weights, fill = case["shards"][rank]
        w = None if weights is None else torch.from_numpy(weights).to(device)
        auroc, ap = sample_sort_auroc_ap(
            torch.from_numpy(preds).to(device), torch.from_numpy(target).to(device), fill,
            case.get("pos_label", 1), w,
        )
        out[case["name"]] = (float(auroc), float(ap), auroc.cpu().numpy().tobytes() + ap.cpu().numpy().tobytes())
    return out


def _seeded(seed: int, n: int, classes=None):
    """Scores, labels and lognormal weights of ``n`` samples from ``seed``."""
    rng = np.random.default_rng(seed)
    if classes is None:
        preds = rng.random(n, dtype=np.float32)
        target = (rng.random(n) < preds).astype(np.int32)
    else:
        preds = rng.random((n, classes), dtype=np.float32)
        target = rng.integers(0, classes, n).astype(np.int32)
    return preds, target, rng.lognormal(size=n).astype(np.float32)


def sharded_metric_values(rank: int, world: int, device: torch.device, specs: list) -> dict:
    """Each spec's sharded metric over its seeded stream, this rank holding
    its slice ``spec["fills"][rank]`` (the whole stream at world 1), appended
    in batches of 2^20. Returns per spec the value, its bytes, the median
    host time of three computes ending in a synchronize, and the kernel
    launches of one compute."""
    from metrics_tpu_torch.ops.tie_scan import tie_group_reduce, tie_group_reduce_rows

    def launches():
        return {"tie_scan": tie_group_reduce.launches, "tie_scan_w": tie_group_reduce.weighted_launches,
                "offsets": tie_group_reduce.offset_launches, "tie_scan_rows": tie_group_reduce_rows.launches,
                "tie_scan_rows_w": tie_group_reduce_rows.weighted_launches}

    out = {}
    for spec in specs:
        fills = spec["fills"] if world > 1 else [sum(spec["fills"])]
        lo = sum(fills[:rank])
        data = [torch.from_numpy(a[lo:lo + fills[rank]]) for a in _seeded(spec["seed"], sum(fills), spec.get("classes"))]
        m = _METRICS[spec["metric"]](capacity_per_device=max(fills), device=device, **spec["kwargs"])
        for b in range(0, fills[rank], 2**20):
            p, t, w = (x[b:b + 2**20] for x in data)
            m.update(p, t, **({"sample_weights": w} if m.with_sample_weights else {}))
        before = launches()
        value = m.compute()
        used = {k: v - before[k] for k, v in launches().items() if v != before[k]}
        times = []
        for _ in range(3):
            m._computed = None
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            m.compute()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
        v = value.cpu().numpy()
        out[spec["name"]] = {"value": v.tolist(), "bits": v.tobytes(), "ms": float(np.median(times)),
                             "launches": used}
    return out
