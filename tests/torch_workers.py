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

from metrics_tpu_torch import (
    PSNR,
    SSIM,
    ConfusionMatrix,
    RetrievalMAP,
    ShardedAUROC,
    ShardedAveragePrecision,
    ShardedPrecisionRecallCurve,
    ShardedROC,
    ShardedRetrievalMAP,
    ShardedRetrievalMRR,
    ShardedRetrievalPrecision,
    ShardedRetrievalRecall,
    StatScores,
)
from metrics_tpu_torch.functional import retrieval_average_precision
from metrics_tpu_torch.retrieval import ShardedRetrievalMetric
from metrics_tpu_torch.interop import state_from_jax
from metrics_tpu_torch.parallel.backend import TorchDistributedBackend
from metrics_tpu_torch.parallel.sample_sort import sample_sort_auroc_ap
from metrics_tpu_torch.utilities.distributed import gather_all_tensors as _gather


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


def stat_scores_world(rank: int, world: int, device: torch.device, payload: dict) -> dict:
    """A sum-state ``StatScores`` (macro, MDMC-global), a list-state
    ``StatScores(reduce="samples")`` and a sum-state ``ConfusionMatrix``
    over ``payload["batches"]``, rank r updating with batches r, r + world,
    ... (the order in which list states concatenate back to the
    one-process order). Returns each synced compute as a numpy array."""
    c = payload["num_classes"]
    metrics = {
        "macro": StatScores(reduce="macro", num_classes=c, mdmc_reduce="global", device=device),
        "samples": StatScores(reduce="samples", mdmc_reduce="global", device=device),
        "confmat": ConfusionMatrix(num_classes=c, device=device),
    }
    for preds, target in payload["batches"][rank::world]:
        for m in metrics.values():
            m.update(torch.from_numpy(preds).to(device), torch.from_numpy(target).to(device))
    return {name: m.compute().cpu().numpy() for name, m in metrics.items()}



def regression_world(rank: int, world: int, device: torch.device, payload: dict) -> dict:
    """``PSNR()`` (its ``min``/``max``-reduced target range and sum states)
    and ``SSIM`` (list states, mean and per-pixel maps) over
    ``payload["batches"]``, rank r updating with batches r, r + world, ...
    Returns each synced compute as numpy, and the synced range."""
    psnr = PSNR(device=device)
    ssim = SSIM(data_range=1.0, device=device)
    ssim_maps = SSIM(data_range=1.0, reduction="none", device=device)
    for preds, target in payload["batches"][rank::world]:
        for m in (psnr, ssim, ssim_maps):
            m.update(torch.from_numpy(preds).to(device), torch.from_numpy(target).to(device))
    value = psnr.compute().cpu().numpy()
    if dist.is_initialized():
        psnr._sync_dist(_gather)  # the synced range, as compute() sees it
    return {
        "psnr": value,
        "psnr_min": float(psnr.min_target),
        "psnr_max": float(psnr.max_target),
        "ssim": ssim.compute().cpu().numpy(),
        "ssim_maps": ssim_maps.compute().cpu().numpy(),
    }


class UserShardedMAP(ShardedRetrievalMetric):
    """A user subclass that scores through the per-query ``_metric`` only:
    its compute gathers every rank's streams and scores them on each rank."""

    def _metric(self, preds, target):
        return retrieval_average_precision(preds, target)


_RETRIEVAL = {"map": ShardedRetrievalMAP, "mrr": ShardedRetrievalMRR, "precision": ShardedRetrievalPrecision,
              "recall": ShardedRetrievalRecall, "user_map": UserShardedMAP, "replicated_map": RetrievalMAP}


def sharded_retrieval_cases(rank: int, world: int, device: torch.device, cases: list) -> dict:
    """Every case of ``cases`` on this rank: a ``ShardedRetrieval*`` of
    ``case["metric"]`` with ``case["kwargs"]`` and ``case["cap"]`` slots per
    rank (or the list-state ``RetrievalMAP``, synced at compute) appends this rank's shard ``case["shards"][rank]`` (``(idx, preds,
    target)`` of its fill) in batches of ``case["batch"]``, or loads this
    rank's cut of ``case["jax_state"]``. Returns per case the value and its
    bits, or the text of the error compute raised."""
    out = {}
    for case in cases:
        cls = _RETRIEVAL[case["metric"]]
        capacity = {"capacity_per_device": case["cap"]} if issubclass(cls, ShardedRetrievalMetric) else {}
        m = cls(device=device, **capacity, **case["kwargs"])
        if "jax_state" in case:
            m.load_state_dict(state_from_jax(case["jax_state"], rank=rank, world=world), strict=True)
        else:
            shard = [torch.from_numpy(a).to(device) for a in case["shards"][rank]]
            for lo in range(0, shard[0].shape[0], case["batch"]):
                m.update(*(a[lo:lo + case["batch"]] for a in shard))
        try:
            value = m.compute().cpu().numpy()
        except ValueError as err:
            out[case["name"]] = {"error": str(err)}
            continue
        out[case["name"]] = {"value": float(value), "bits": value.tobytes()}
    return out


def engine_world(rank: int, world: int, device: torch.device, payload: dict) -> dict:
    """A compiled and an eager 4-metric classification collection (Accuracy,
    macro Precision / Recall / F1) over ``payload["batches"]``, rank r
    taking batches r, r + world, ...: in a world the engine runs eager.
    Returns each step's values, the synced epoch values and the engine's
    fallbacks."""
    from metrics_tpu_torch import F1, Accuracy, MetricCollection, Precision, Recall

    def collection(compiled):
        c = payload["num_classes"]
        return MetricCollection([Accuracy(device=device), Precision(num_classes=c, average="macro", device=device),
                                 Recall(num_classes=c, average="macro", device=device),
                                 F1(num_classes=c, average="macro", device=device)], compiled=compiled)

    compiled, eager = collection(True), collection(False)
    steps = []
    for preds, target in payload["batches"][rank::world]:
        p, t = torch.from_numpy(preds).to(device), torch.from_numpy(target).to(device)
        vc, ve = compiled(p, t), eager(p, t)
        steps.append({k: (_value(vc[k]), _value(ve[k])) for k in vc})
    return {
        "steps": steps,
        "compiled": {k: _value(v) for k, v in compiled.compute().items()},
        "eager": {k: _value(v) for k, v in eager.compute().items()},
        "fallbacks": compiled.eager_fallbacks,
        "trace_count": compiled._engine.trace_count,
    }


def _grid(rng, shape, lo=0, hi=256):
    """Multiples of 1/256: float32 sums of their products stay exact, so
    sums taken in any order (per rank, per tenant, batched) give one bit
    pattern."""
    return (rng.randint(lo, hi, size=shape) / 256.0).astype(np.float32)


def cohort_sync_world(rank: int, world: int, device: torch.device, payload: dict) -> dict:
    """A 2-tenant ``MeanSquaredError`` cohort over this rank's own grid rows:
    its synced ``compute()``, the per-tenant oracle (each tenant's rows in a
    collection of its own, synced alone), and the stacked state after one
    more step, which must hold only this rank's rows (the sync restores the
    local states)."""
    from metrics_tpu_torch import MeanSquaredError, MetricCohort, MetricCollection

    rng = np.random.RandomState(payload["seed"] + rank)
    p = torch.from_numpy(_grid(rng, (2, 16))).to(device)
    t = torch.from_numpy(_grid(rng, (2, 16))).to(device)
    cohort = MetricCohort(MetricCollection([MeanSquaredError(device=device)]), tenants=2)
    cohort(p, t)
    synced = _value(cohort.compute()["MeanSquaredError"])
    oracle = []
    for i in range(2):
        col = MetricCollection([MeanSquaredError(device=device)])
        col(p[i], t[i])
        oracle.append(_value(col.compute()["MeanSquaredError"]))
    cohort(p, t)
    return {
        "synced": synced,
        "oracle": np.stack(oracle),
        "state_after": _value(cohort._states["MeanSquaredError"]["sum_squared_error"]),
        "local_twice": 2 * _value(((p - t) ** 2).sum(1)),
    }


def distributed_paths_world(rank: int, world: int, device: torch.device, payload: dict) -> dict:
    """The paths of the port that run in a ``torch.distributed`` world and
    no other world case drives, rank r taking batches r, r + world, ...:

    * a ``compiled=True`` 4-metric classification collection (the engine
      runs eager in a world and syncs at ``compute()``);
    * the regression pack in a collection and the composite
      ``MeanSquaredError() ** 0.5`` on grid rows;
    * ``BootStrapper(Accuracy())`` on the fixed resamplings of the payload;
    * a ``payload["tenants"]``-tenant ``MetricCohort`` of the classification
      template, whose ``compute()`` gathers each stacked state once: the
      backend's gathers are counted.

    Returns every synced value as numpy, the engine's fallbacks and the
    cohort's gathers and stacked states."""
    from metrics_tpu_torch import (
        F1,
        PSNR,
        Accuracy,
        BootStrapper,
        ExplainedVariance,
        MeanAbsoluteError,
        MeanSquaredError,
        MetricCohort,
        MetricCollection,
        Precision,
        R2Score,
        Recall,
    )
    from metrics_tpu_torch.parallel.backend import get_sync_backend
    from metrics_tpu_torch.wrappers import bootstrapping

    c = payload["num_classes"]

    def to(*arrays):
        return tuple(torch.from_numpy(a).to(device) for a in arrays)

    def classification(compiled=False):
        return MetricCollection([Accuracy(device=device), Precision(num_classes=c, average="macro", device=device),
                                 Recall(num_classes=c, average="macro", device=device),
                                 F1(num_classes=c, average="macro", device=device)], compiled=compiled)

    out = {}
    compiled = classification(compiled=True)
    for batch in payload["cls_batches"][rank::world]:
        compiled(*to(*batch))
    out["compiled"] = {k: _value(v) for k, v in compiled.compute().items()}
    out["compiled_fallbacks"] = compiled.eager_fallbacks

    regression = MetricCollection([MeanSquaredError(device=device), MeanAbsoluteError(device=device),
                                   R2Score(device=device), PSNR(device=device), ExplainedVariance(device=device)])
    rmse = MeanSquaredError(device=device) ** 0.5
    for batch in payload["reg_batches"][rank::world]:
        regression(*to(*batch))
        rmse.update(*to(*batch))
    out["regression"] = {k: _value(v) for k, v in regression.compute().items()}
    out["rmse"] = _value(rmse.compute())

    draws = iter(payload["resamples"][rank::world])
    sampler = bootstrapping._bootstrap_sampler
    bootstrapping._bootstrap_sampler = lambda *args, **kwargs: [torch.from_numpy(i).to(device) for i in next(draws)]
    try:
        boot = BootStrapper(Accuracy(device=device), num_bootstraps=payload["num_bootstraps"], raw=True)
        for batch in payload["cls_batches"][rank::world]:
            boot.update(*to(*batch))
    finally:
        bootstrapping._bootstrap_sampler = sampler
    out["bootstrap"] = {k: _value(v) for k, v in boot.compute().items()}

    cohort = MetricCohort(classification(), tenants=payload["tenants"])
    for batch in payload["cohort_batches"][rank::world]:
        cohort(*to(*batch))
    gathers = []
    backend = type(get_sync_backend())  # made anew at each gather: count on its class
    gather = backend.gather

    def counted(self, x, group=None):
        gathers.append(tuple(x.shape))
        return gather(self, x, group=group)

    backend.gather = counted
    try:
        out["cohort"] = {k: _value(v) for k, v in cohort.compute().items()}
    finally:
        backend.gather = gather
    out["cohort_gathers"] = len(gathers)
    out["cohort_stacked_states"] = sum(len(d) for d in cohort._states.values())
    out["cohort_gathered_shapes"] = sorted(set(gathers))
    return out
