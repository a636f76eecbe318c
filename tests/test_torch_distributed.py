"""``TorchDistributedBackend`` over a real ``torch.distributed`` process group,
one spawned process per rank joined over ``tcp://localhost``: on gloo (CPU
states) here, and on NCCL (one card per rank) where the machine has two or
more CUDA devices. This file imports neither JAX nor the JAX package, so the
worker processes start quickly and the NCCL cases run on a machine that has
only PyTorch: ``python -m pytest --noconftest -m cuda -s tests/test_torch_distributed.py``.

The NCCL cases include the sharded metrics across the cards: the splitter
sample sort (binary, weighted or not) and the class transpose by
``all_to_all`` (one-vs-rest), each rank holding an uneven slice, against the
same stream in one process; and the sharded curves (``ShardedROC``,
``ShardedPrecisionRecallCurve``), whose every rank must return the same
curve, bit for bit, as one process holding the whole stream; and the
stat-score family's states (a sum-state ``ConfusionMatrix(1000)`` and
``StatScores``, a list-state ``StatScores(reduce="samples")``), whose every
rank must equal one process; and the sharded retrieval metrics (the
retrieval sample sort over NCCL), whose every rank must return the same
bits, within 1e-6 of one card holding the whole stream; and the paths no
other world case drives (a ``compiled=True`` collection, the regression
pack with a ``CompositionalMetric``, ``BootStrapper`` on fixed
resamplings, a 1,024-tenant ``MetricCohort`` whose ``compute()`` gathers
each stacked state once), every rank's bits equal to one process, on gloo
in a world of 4 and on NCCL.
"""
import json
import multiprocessing
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from metrics_tpu_torch import AUROC, Accuracy, MetricCollection
from metrics_tpu_torch.parallel.backend import TorchDistributedBackend, get_sync_backend
from tests.torch_workers import (
    _grid,
    distributed_paths_world,
    run_world,
    sharded_cases,
    sharded_metric_values,
    sharded_retrieval_cases,
    stat_scores_world,
)


def _rows(rank):
    return 3 + 2 * rank  # uneven first dims, so the gather pads and trims


def _data(rank):
    rng = np.random.default_rng(rank)
    n = 300 + 200 * rank  # uneven cat states
    p = rng.random(n).astype(np.float32)
    t = (rng.random(n) < p).astype(np.int64)
    return torch.from_numpy(p), torch.from_numpy(t)


def _worker(rank, world, port, device_type, queue):
    device = torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")
    if device_type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        TorchDistributedBackend.process_group_backend(device),
        init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
    )
    try:
        backend = get_sync_backend()
        assert isinstance(backend, TorchDistributedBackend) and backend.world_size == world
        gathered = backend.gather(torch.full((_rows(rank), 2), float(rank), device=device))
        shapes = [tuple(g.shape) for g in gathered]
        values = [float(g.sum()) for g in gathered]
        scalars = [float(s) for s in backend.gather(torch.tensor(rank + 0.5, device=device))]
        coll = MetricCollection([Accuracy(device=device), AUROC(pos_label=1, device=device)])
        coll.update(*_data(rank))
        synced = {k: float(v) for k, v in coll.compute().items()}
        queue.put((rank, shapes, values, scalars, synced))
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_world(world, device_type):
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, port, device_type, queue)) for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            rank, *rest = queue.get(timeout=180)
            results[rank] = rest
    finally:
        for p in procs:
            p.join(timeout=60)
    assert not any(p.is_alive() for p in procs)
    assert all(p.exitcode == 0 for p in procs)

    for rank in range(world):
        shapes, values, scalars, _ = results[rank]
        assert shapes == [(_rows(r), 2) for r in range(world)]
        assert values == [float(r * _rows(r) * 2) for r in range(world)]
        assert scalars == [r + 0.5 for r in range(world)]
    single = MetricCollection([Accuracy(device="cpu"), AUROC(pos_label=1, device="cpu")])
    for rank in range(world):
        single.update(*_data(rank))
    want = {k: float(v) for k, v in single.compute().items()}
    for rank in range(world):
        synced = results[rank][3]
        assert synced == results[0][3]
        assert synced["Accuracy"] == want["Accuracy"]
        assert abs(synced["AUROC"] - want["AUROC"]) < 1e-6


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_sync_pads_uneven_shapes_and_equals_one_process(world):
    _run_world(world, "cpu")


@pytest.mark.cuda
def test_nccl_sync_across_the_cards_equals_one_process():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    _run_world(torch.cuda.device_count(), "cuda")


def _sharded_specs(world, binary_per_rank=2**22, classes=1000, ovr_total=50_000):
    """Uneven fills: rank r holds up to ``binary_per_rank`` binary samples and
    about ``ovr_total / world`` one-vs-rest rows."""
    binary = [binary_per_rank - (r % 3) * binary_per_rank // 4 - r * (binary_per_rank // 340) for r in range(world)]
    ovr = [ovr_total // world + (r % 3 - 1) * ovr_total // (8 * world) for r in range(world)]
    weighted = {"with_sample_weights": True}
    return [
        {"name": "binary_auroc", "metric": "auroc", "kwargs": {}, "seed": 1, "fills": binary},
        {"name": "binary_weighted_auroc", "metric": "auroc", "kwargs": weighted, "seed": 2, "fills": binary},
        {"name": "binary_weighted_ap", "metric": "ap", "kwargs": weighted, "seed": 3, "fills": binary},
        {"name": "ovr_weighted_auroc", "metric": "auroc", "seed": 4, "fills": ovr, "classes": classes,
         "kwargs": {"num_classes": classes, "average": "weighted", **weighted}},
        {"name": "ovr_macro_ap", "metric": "ap", "seed": 5, "fills": ovr, "classes": classes,
         "kwargs": {"num_classes": classes, "average": "macro"}},
    ]


def _assert_sharded_world(specs, ranks, one):
    for spec in specs:
        name = spec["name"]
        assert all(ranks[r][name]["bits"] == ranks[0][name]["bits"] for r in ranks), name
        assert abs(ranks[0][name]["value"] - one[name]["value"]) <= 1e-6, (name, ranks[0][name], one[name])


def test_gloo_sharded_metrics_equal_one_process():
    specs = _sharded_specs(2, binary_per_rank=3000, classes=7, ovr_total=400)
    ranks = run_world(2, sharded_metric_values, specs)
    _assert_sharded_world(specs, ranks, sharded_metric_values(0, 1, torch.device("cpu"), specs))


@pytest.mark.cuda
def test_nccl_sharded_metrics_across_the_cards_equal_one_process():
    """The sample sort and the one-vs-rest ``all_to_all`` over NCCL, one rank
    per card, at 2^22 binary samples per rank (uneven fills) and ImageNet-1k
    val's 50,000 x 1,000 split unevenly: every rank returns the same bits,
    within 1e-6 of one process holding the whole stream on one card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    world = torch.cuda.device_count()
    specs = _sharded_specs(world)
    ranks = run_world(world, sharded_metric_values, specs, device_type="cuda", timeout=900)
    one = sharded_metric_values(0, 1, torch.device("cuda", 0), specs)
    print(json.dumps({"nccl_sharded": {
        "world": world, "card": torch.cuda.get_device_name(0),
        "fills": {s["name"]: s["fills"] for s in specs},
        "ranks": {n: {k: v for k, v in r.items() if k != "bits"} for n, r in ranks[0].items()},
        "one_process": {n: {k: v for k, v in r.items() if k != "bits"} for n, r in one.items()},
    }}))
    _assert_sharded_world(specs, ranks, one)


def _curve_cases(world, n=2**20, classes=100, ovr_n=50_000):
    rng = np.random.default_rng(7)
    preds = np.round(rng.random(n), 4).astype(np.float32)
    target = (rng.random(n) < preds).astype(np.int32)
    logits = rng.standard_normal((ovr_n, classes)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    labels = rng.integers(0, classes, ovr_n).astype(np.int32)
    batches = [(preds[i:i + n // 4], target[i:i + n // 4]) for i in range(0, n, n // 4)]
    return [
        {"name": "roc_binary", "metric": "roc", "capacity": n, "kwargs": {}, "batches": batches},
        {"name": "prc_binary", "metric": "prc", "capacity": n, "kwargs": {}, "batches": batches},
        {"name": "roc_ovr", "metric": "roc", "capacity": ovr_n, "kwargs": {"num_classes": classes},
         "batches": [(probs, labels)]},
        {"name": "prc_ovr", "metric": "prc", "capacity": ovr_n, "kwargs": {"num_classes": classes},
         "batches": [(probs, labels)]},
    ]


def _leaves(x):
    return [a for v in x for a in _leaves(v)] if isinstance(x, (tuple, list)) else [x]


@pytest.mark.cuda
def test_nccl_sharded_curves_are_the_same_on_every_card():
    """``ShardedROC`` / ``ShardedPrecisionRecallCurve`` over NCCL, one rank
    per card, binary at 2^20 samples and one-vs-rest at 50,000 x 100: every
    rank's curves equal rank 0's and one process's on one card, bit for bit
    (only tie-group ends are read, so the rank order of the rows cannot
    move a point)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    world = torch.cuda.device_count()
    cases = _curve_cases(world)
    ranks = run_world(world, sharded_cases, cases, device_type="cuda", timeout=900)
    one = sharded_cases(0, 1, torch.device("cuda", 0), cases)
    points = {}
    for case in cases:
        name = case["name"]
        want = _leaves(one[name]["value"])
        points[name] = sum(len(a) for a in want) // 3
        for r in range(world):
            got = _leaves(ranks[r][name]["value"])
            assert len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want)), (name, r)
    print(json.dumps({"nccl_sharded_curves": {"world": world, "card": torch.cuda.get_device_name(0),
                                              "points": points}}))


@pytest.mark.cuda
def test_nccl_stat_scores_and_confmat_are_the_same_on_every_card():
    """Sum states (``ConfusionMatrix(1000)``, macro ``StatScores``) and a
    list state (``StatScores(reduce="samples")``) synced over NCCL, one rank
    per card, each rank updating with every world-th of 8 batches of 2,000
    ImageNet-shaped rows (1,000 classes): every rank's value equals one
    process's on one card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    world = torch.cuda.device_count()
    rng = np.random.default_rng(8)
    batches = []
    for _ in range(8):
        logits = rng.standard_normal((2_000, 1_000)).astype(np.float32)
        target = rng.integers(0, 1_000, 2_000)
        logits[np.arange(2_000), target] += 3.0
        e = np.exp(logits - logits.max(1, keepdims=True))
        batches.append(((e / e.sum(1, keepdims=True)).astype(np.float32), target))
    payload = {"batches": batches, "num_classes": 1_000}
    ranks = run_world(world, stat_scores_world, payload, device_type="cuda", timeout=600)
    one = stat_scores_world(0, 1, torch.device("cuda", 0), payload)
    for r in range(world):
        for name, value in one.items():
            assert np.array_equal(ranks[r][name], value), (name, r)
    print(json.dumps({"nccl_stat_scores": {
        "world": world, "card": torch.cuda.get_device_name(0),
        "shapes": {name: list(v.shape) for name, v in one.items()},
        "confmat_total": float(one["confmat"].sum()),
    }}))



@pytest.mark.cuda
def test_nccl_sharded_retrieval_is_the_same_on_every_card():
    """``ShardedRetrievalMAP`` / ``MRR`` / ``Precision(k=10)`` /
    ``Recall(k=100)`` over NCCL, one rank per card, each holding an uneven
    slice of 1M rows over 10,000 queries (5% relevant, some targets
    excluded, tied scores): every rank returns the same bits, within 1e-6 of
    one card holding the whole stream in rank order."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    world = torch.cuda.device_count()
    rng = np.random.default_rng(9)
    n = 1_000_000
    idx = rng.integers(0, 10_000, n).astype(np.int32)
    preds = np.round(rng.random(n), 4).astype(np.float32)
    target = (rng.random(n) < 0.05).astype(np.int32)
    target[rng.random(n) < 0.01] = -100
    cuts = np.linspace(0, n, world + 1).astype(int)
    cuts[1:-1] += rng.integers(-50_000, 50_000, world - 1)
    shards = [tuple(a[cuts[r]:cuts[r + 1]] for a in (idx, preds, target)) for r in range(world)]
    cap = int(np.diff(cuts).max())
    cases = [{"name": metric, "metric": metric, "kwargs": kwargs, "shards": shards, "cap": cap, "batch": 100_000}
             for metric, kwargs in (("map", {}), ("mrr", {}), ("precision", {"k": 10}), ("recall", {"k": 100}))]
    ranks = run_world(world, sharded_retrieval_cases, cases, device_type="cuda", timeout=600)
    whole = [tuple(np.concatenate([s[i] for s in shards]) for i in range(3))]
    one = sharded_retrieval_cases(0, 1, torch.device("cuda", 0),
                                  [{**c, "shards": whole, "cap": n, "batch": 100_000} for c in cases])
    print(json.dumps({"nccl_sharded_retrieval": {
        "world": world, "card": torch.cuda.get_device_name(0), "fills": np.diff(cuts).tolist(),
        "ranks": {k: v["value"] for k, v in ranks[0].items()}, "one_card": {k: v["value"] for k, v in one.items()}}}))
    for case in cases:
        name = case["name"]
        assert all(ranks[r][name]["bits"] == ranks[0][name]["bits"] for r in range(world)), name
        assert abs(ranks[0][name]["value"] - one[name]["value"]) <= 1e-6, (name, ranks[0][name], one[name])



def _distributed_paths_payload(tenants, rows=500, batches=8, classes=4):
    """Grid-valued rows (multiples of 1/256: every float sum is exact in any
    order, so a world's bits can equal one process's), fixed resamplings
    for ``BootStrapper``, and cohort batches of ``tenants`` x 64 rows."""
    rng = np.random.RandomState(3)

    def probs(shape):
        return (rng.multinomial(256, [1.0 / classes] * classes, size=shape) / 256.0).astype(np.float32)

    return {
        "num_classes": classes,
        "cls_batches": [(probs(rows), rng.randint(classes, size=rows)) for _ in range(batches)],
        "reg_batches": [(_grid(rng, (48,)), _grid(rng, (48,))) for _ in range(batches)],
        "resamples": [[rng.randint(0, rows, rows) for _ in range(5)] for _ in range(batches)],
        "num_bootstraps": 5,
        "tenants": tenants,
        "cohort_batches": [(probs((tenants, 64)), rng.randint(classes, size=(tenants, 64))) for _ in range(batches)],
    }


def _assert_paths_equal(ranks, one):
    def equal(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                equal(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, np.ndarray):
            assert np.array_equal(a, b), path
        else:
            assert a == b, path

    skip = ("cohort_gathers", "cohort_gathered_shapes")
    for rank, out in ranks.items():
        equal({k: v for k, v in out.items() if k not in skip}, {k: v for k, v in one.items() if k not in skip},
              f"rank {rank}")
        assert out["compiled_fallbacks"] == {}, rank
        # one gather per stacked state, each of the whole cohort's slots
        assert out["cohort_gathers"] == out["cohort_stacked_states"] == 14, (rank, out["cohort_gathers"])
        assert all(shape[0] == one["cohort"]["Accuracy"].shape[0] for shape in out["cohort_gathered_shapes"])


def test_gloo_compiled_regression_bootstrap_and_cohort_equal_one_process():
    payload = _distributed_paths_payload(tenants=64)
    ranks = run_world(4, distributed_paths_world, payload)
    _assert_paths_equal(ranks, distributed_paths_world(0, 1, torch.device("cpu"), payload))


@pytest.mark.cuda
def test_nccl_compiled_regression_bootstrap_and_cohort_are_the_same_on_every_card():
    """A compiled collection (eager in a world), the regression pack with
    ``MeanSquaredError() ** 0.5``, ``BootStrapper(Accuracy())`` on fixed
    resamplings and a 1,024-tenant cohort over NCCL, one rank per card,
    rank r taking batches r, r + world, ...: every rank's bits equal one
    process's on one card, and the cohort's ``compute()`` gathers each of
    its 14 stacked states once."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    world = torch.cuda.device_count()
    payload = _distributed_paths_payload(tenants=1024)
    ranks = run_world(world, distributed_paths_world, payload, device_type="cuda", timeout=600)
    one = distributed_paths_world(0, 1, torch.device("cuda", 0), payload)
    print(json.dumps({"nccl_distributed_paths": {
        "world": world, "card": torch.cuda.get_device_name(0),
        "cohort_gathers": {r: out["cohort_gathers"] for r, out in ranks.items()},
        "cohort_gathered_shapes": ranks[0]["cohort_gathered_shapes"],
        "compiled": {k: v.tolist() for k, v in one["compiled"].items()},
        "rmse": one["rmse"].tolist(),
        "bootstrap_mean": one["bootstrap"]["mean"].tolist(),
    }}))
    _assert_paths_equal(ranks, one)
