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
in a world of 4 and on NCCL; and each rank's observability stamp (the
rank on its sync spans and Perfetto track, the identity read from the
backend, the sync counters equal on every rank), on gloo in a world of 2
and on NCCL; and the sync tiers (exact, bf16 and int8 states synced flat and
two-level over a 2 x (world / 2) topology, both ``over_flat`` and over
``new_group`` slices whose level-1 exchange carries one entry per slice),
every rank's bits equal to one process's codec and merge, on gloo in a world
of 4 and on NCCL; and a durable ``EvalSession`` whose one rank checkpointed
a skewed cursor: every rank resumes at the same agreed cursor with the same
state bits and ends on the same synced values, on gloo in a world of 4 and
on NCCL; and serving: each rank stages its batches through an
``AsyncServingEngine`` with an ``EvalSession(background_checkpoints=True)``
checkpointing behind drains, and every rank's ``compute()`` after the last
drain equals one process's bits, on gloo in a world of 4 and on NCCL. Every
NCCL case prints the cards' names and power limits (``nvidia-smi``).
"""
import json
import multiprocessing
import socket
import subprocess

import numpy as np
import pytest
import torch
import torch.distributed as dist

from metrics_tpu_torch import AUROC, Accuracy, MetricCollection
from metrics_tpu_torch.parallel.backend import TorchDistributedBackend, get_sync_backend
from tests.torch_workers import (
    _grid,
    distributed_paths_world,
    identity_world,
    run_world,
    serving_world,
    session_world,
    sharded_cases,
    sharded_metric_values,
    sharded_retrieval_cases,
    stat_scores_world,
    sync_tiers_world,
)


@pytest.fixture(autouse=True)
def _card_and_power_limit(request):
    """Every case across the cards prints the cards' names and power limits
    (``nvidia-smi``) beside its numbers."""
    if request.node.name.startswith("test_nccl_") and torch.cuda.is_available():
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        print(json.dumps({"cards": out.stdout.strip().splitlines(), "test": request.node.name}))
    yield


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


def _identity_payload(world, classes=4):
    rng = np.random.RandomState(17)
    batches = []
    for rank in range(world):
        n = 100 + 37 * rank  # uneven batches: the states, not the rows, cross the wire
        probs = rng.rand(n, classes).astype(np.float32)
        batches.append((probs / probs.sum(1, keepdims=True), rng.randint(classes, size=n)))
    return {"num_classes": classes, "batches": batches}


def _assert_identities(ranks, world):
    for rank, out in ranks.items():
        assert out["identity"] == {"rank": rank, "world_size": world}, rank
        assert out["sync_spans"] == [
            ("metrics_tpu.Accuracy.sync", {"rank": rank}),
            ("metrics_tpu.Precision.sync", {"rank": rank}),
        ], rank
        assert out["tracks"] == [f"metrics_tpu rank {rank}/{world}"], rank
        assert out["counters"]["sync.calls"] == 2 and out["counters"]["sync.payload_bytes"] > 0, rank
        assert out["counters"] == ranks[0]["counters"] and out["payload_histogram"] == ranks[0]["payload_histogram"]
        for k, v in out["values"].items():
            assert np.array_equal(v, ranks[0]["values"][k]), (rank, k)


def test_gloo_ranks_stamp_their_own_identity():
    ranks = run_world(2, identity_world, _identity_payload(2))
    _assert_identities(ranks, 2)


@pytest.mark.cuda
def test_nccl_ranks_stamp_their_own_identity():
    """The gloo case's twin, one rank per card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    world = torch.cuda.device_count()
    ranks = run_world(world, identity_world, _identity_payload(world), device_type="cuda", timeout=600)
    print(json.dumps({"nccl_identity": {r: out["tracks"] + [out["counters"]] for r, out in ranks.items()}}))
    _assert_identities(ranks, world)


def _tiers_payload(world, bins, seed=13):
    rng = np.random.RandomState(seed)
    return {"locals": [((rng.randint(0, 512, size=bins) / 256.0).astype(np.float32),
                        rng.randint(0, 50, size=bins).astype(np.int32)) for _ in range(world)]}


def _tiers_reference(payload, world):
    """One process's sync of every tier: the flat merge of every rank's
    contribution, and the two-level merge (exact level 0 inside each slice,
    the tier at level 1 over the slice partials), with each rank's residual."""
    from metrics_tpu_torch.parallel import quantize as q
    from metrics_tpu_torch.utilities.data import dim_zero_sum

    locals_ = [(torch.from_numpy(h), torch.from_numpy(n)) for h, n in payload["locals"]]
    half = world // 2
    peak = np.max([h.max() for h, _ in payload["locals"]]).astype(np.float32)
    ref = {}
    for precision in ("exact", "bf16", "int8"):
        for mode in ("flat", "two_level"):
            if mode == "flat":
                contribs = {r: [locals_[r]] for r in range(world)}
                parts = [(h, n) for h, n in locals_]
                owner = list(range(world))
            else:
                parts = [tuple(dim_zero_sum(torch.stack([locals_[r][i] for r in range(s * half, (s + 1) * half)]))
                               for i in (0, 1)) for s in range(2)]
                owner = [r // half for r in range(world)]
            synced, residuals = {}, {r: {} for r in range(world)}
            for i, key in enumerate(("hist", "n")):
                values = [p[i] for p in parts]
                if precision == "exact":
                    synced[key] = dim_zero_sum(torch.stack(values)).numpy()
                    continue
                pays = [q.compensate_and_quantize(v, torch.zeros(v.shape), precision) for v in values]
                synced[key] = q.merge_dequantized([p for p, _ in pays], values[0].shape, values[0].dtype).numpy()
                for r in range(world):
                    residuals[r][key + "__qres"] = pays[owner[r]][1].numpy()
            synced["peak"] = peak
            ref[(mode, precision)] = (synced, residuals)
    return ref


def _assert_tiers(ranks, payload, world):
    ref = _tiers_reference(payload, world)
    for rank, out in ranks.items():
        for name in ("flat", "over_flat", "new_group"):
            mode = "flat" if name == "flat" else "two_level"
            for precision in ("exact", "bf16", "int8"):
                got = out[(name, precision)]
                want_synced, want_res = ref[(mode, precision)]
                for key, value in want_synced.items():
                    assert np.array_equal(got["synced"][key], value), (rank, name, precision, key)
                    assert np.array_equal(got["synced"][key], ranks[0][(name, precision)]["synced"][key])
                assert set(got["residuals"]) == set(want_res[rank]), (rank, name, precision)
                for key, value in want_res[rank].items():
                    assert np.array_equal(got["residuals"][key], value), (rank, name, precision, key)
                counters = got["counters"]
                assert counters["sync.calls"] == 1, (rank, name, precision, counters)
                if precision != "exact":
                    # the wire carries the tier: int8 ~3.9x, bf16 2x fewer bytes than
                    # the payload (the exact 4-byte peak left out of both)
                    wire = counters["sync.level1.wire_bytes"] if mode == "two_level" else counters["sync.wire_bytes"]
                    floor = 2.0 if precision == "bf16" else 3.0
                    assert (counters["sync.payload_bytes"] - 4) / (wire - 4) >= floor, (rank, name, precision, counters)
        # the new_group leaders' exchange carries one entry per slice, never
        # the world: 11 level-1 gathers a leader per sync of the three tiers
        # (3 states exact, 3 bf16, and int8's codes and scales of 2 states
        # plus the exact peak), for the checked sync and each timed repeat;
        # none on the other ranks, which take the leaders' list by a broadcast
        syncs = 1 + payload.get("repeats", 0)
        expected_widths = [2] * 11 * syncs if rank in (0, world // 2) else []
        assert out["leader_widths"] == expected_widths, (rank, out["leader_widths"])
        locals_ = payload["locals"]
        stacked = np.stack([h for h, _ in locals_])
        assert np.array_equal(out["collectives"]["sum"], stacked.sum(0))
        assert np.array_equal(out["collectives"]["max"], stacked.max(0))
        assert np.array_equal(out["collectives"]["mean"], stacked.sum(0) / world)
        assert np.array_equal(out["collectives"]["cat"], stacked.reshape(-1))
        for precision in ("int8", "bf16"):
            assert np.array_equal(out["collectives"][f"qsum_{precision}"], ref[("flat", precision)][0]["hist"])


def test_gloo_sync_tiers_flat_and_two_level_equal_one_process():
    """A gloo world of 4: exact / bf16 / int8 flat and over a 2 x 2
    topology (``over_flat`` and ``new_group`` slices): every rank's synced
    states and residuals equal one process's codec and merge, bit for bit;
    the leaders' gathers carry 2 entries."""
    payload = _tiers_payload(4, bins=2048)
    _assert_tiers(run_world(4, sync_tiers_world, payload), payload, 4)


@pytest.mark.cuda
def test_nccl_sync_tiers_are_the_same_on_every_card():
    """The gloo case's twin over NCCL, one rank per card, at the size of a
    ``ConfusionMatrix(num_classes=1000)`` state (10^6 elements, f32 and
    int32): every card's bits equal one process's on the CPU; prints the
    wire bytes per level and the host ms of each tier's sync."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    world = 4
    payload = {**_tiers_payload(world, bins=1_000_000), "repeats": 5}
    ranks = run_world(world, sync_tiers_world, payload, device_type="cuda", timeout=300)
    print(json.dumps({"nccl_sync_tiers": {
        "world": world, "card": torch.cuda.get_device_name(0),
        "ms": {f"{name}/{precision}": ranks[0][(name, precision)]["ms"]
               for name in ("flat", "over_flat", "new_group") for precision in ("exact", "bf16", "int8")},
        "counters": {f"{name}/{precision}": ranks[0][(name, precision)]["counters"]
                     for name in ("flat", "new_group") for precision in ("exact", "bf16", "int8")},
    }}))
    _assert_tiers(ranks, payload, world)


def _session_payload(directory, n_batches=6, rows=256, seed=29):
    rng = np.random.RandomState(seed)
    batches = [((rng.randint(0, 64, size=rows) / 64).astype(np.float32), rng.randint(2, size=rows).astype(np.int32))
               for _ in range(n_batches)]
    return {"dir": str(directory), "batches": batches, "skewed": 1}


def _assert_sessions_agree(ranks, payload):
    last = len(payload["batches"]) - 1
    for rank, out in ranks.items():
        # the skewed rank advertises last + 1, the others last: all roll back
        # to the newest cursor every rank holds on disk
        assert out["cursor"] == last - 1, (rank, out["cursor"])
        assert out["rollbacks"] == 1 and out["replays"] == last, (rank, out)
        for key, value in out["states"].items():
            want = ranks[0]["states"][key]
            if isinstance(value, list):
                assert len(value) == len(want) and all(np.array_equal(a, b) for a, b in zip(value, want)), (rank, key)
            else:
                assert value.dtype == want.dtype and np.array_equal(value, want), (rank, key)
        for key, value in out["values"].items():
            assert np.array_equal(value, ranks[0]["values"][key]), (rank, key)


def test_gloo_session_resume_agrees_on_every_rank(tmp_path):
    """A gloo world of 4: rank 1's last checkpoint carries a skewed cursor
    (``cursor_skew(+1)``); every rank resumes at the same cursor, rolls back
    once, holds the same state bits and ends on the same synced values."""
    payload = _session_payload(tmp_path)
    _assert_sessions_agree(run_world(4, session_world, payload), payload)


@pytest.mark.cuda
def test_nccl_session_resume_agrees_on_every_card(tmp_path):
    """The gloo case's twin over NCCL, one rank per card (the cursor
    agreement's gathers are CUDA tensors)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    payload = _session_payload(tmp_path)
    ranks = run_world(4, session_world, payload, device_type="cuda", timeout=300)
    print(json.dumps({"nccl_session": {r: {"cursor": out["cursor"], "rollbacks": out["rollbacks"],
                                           "values": {k: float(v) for k, v in out["values"].items()}}
                                       for r, out in ranks.items()}}))
    _assert_sessions_agree(ranks, payload)


def _serving_payload(directory, world=4, n_batches=6, rows=5_000, seed=31):
    rng = np.random.RandomState(seed)
    batches = []
    for _ in range(world):
        mine = []
        for _ in range(n_batches):
            p = rng.rand(rows, 4).astype(np.float32)
            p /= p.sum(1, keepdims=True)
            mine.append((p, rng.randint(4, size=rows).astype(np.int64)))
        batches.append(mine)
    return {"dir": str(directory), "batches": batches}


def _assert_serving_world(ranks, payload):
    from metrics_tpu_torch import F1

    one = MetricCollection([Accuracy(device="cpu"), F1(num_classes=4, average="macro", device="cpu")])
    for mine in payload["batches"]:
        for p, t in mine:
            one.update(torch.from_numpy(p), torch.from_numpy(t))
    want = {k: v.numpy() for k, v in one.compute().items()}
    n = len(payload["batches"][0])
    for rank, out in ranks.items():
        for k, v in want.items():
            assert np.array_equal(out["values"][k], v), (rank, k)
        assert out["stats"]["dispatches"] == n and out["stats"]["errors"] == 0, (rank, out["stats"])
        assert out["writer"]["errors"] == 0 and out["cursors"][-1] == n - 1 and out["same_checksum"], (rank, out)


def test_gloo_serving_with_background_checkpoints_equals_one_process(tmp_path):
    """A gloo world of 4: every rank serves its batches asynchronously and
    checkpoints in the background; every rank's synced values equal one
    process's bits."""
    payload = _serving_payload(tmp_path)
    _assert_serving_world(run_world(4, serving_world, payload), payload)


@pytest.mark.cuda
def test_nccl_serving_with_background_checkpoints_is_the_same_on_every_card(tmp_path):
    """The gloo case's twin over NCCL, one rank per card: each rank's worker
    steps on its own stream of its own card, the writer fetches on its own,
    and every rank's ``compute()`` after the drain equals one process's
    bits."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    payload = _serving_payload(tmp_path)
    ranks = run_world(4, serving_world, payload, device_type="cuda", timeout=300)
    print(json.dumps({"nccl_serving": {r: {"stats": out["stats"], "writer": out["writer"], "cursors": out["cursors"],
                                           "values": {k: v.tolist() for k, v in out["values"].items()}}
                                       for r, out in ranks.items()}}))
    _assert_serving_world(ranks, payload)
