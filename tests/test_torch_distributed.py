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
curve, bit for bit, as one process holding the whole stream.
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
from tests.torch_workers import run_world, sharded_cases, sharded_metric_values


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
