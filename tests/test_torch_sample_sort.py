"""The port's splitter sample sort (``metrics_tpu_torch.parallel.sample_sort``)
against the JAX package's, on the CPU.

Each case is a set of per-rank shards made with numpy from a seed. The port
runs it in gloo worlds of 2 and 4 spawned processes (one world per size,
every case inside it; the workers import no JAX) and in one process; the
parent process runs the JAX package's host twins
(``host_sample_sort_auroc_ap``, ``host_sample_sort_auroc_ap_weighted``) and
its SPMD programs (``sample_sort_auroc_ap`` on a mesh of as many CPU
devices) on the same shards. The cases are those that make the algorithm
exact, as the JAX suite's (``tests/parallel/test_sample_sort.py``): uneven
fills with empty ranks, a tie storm where every group spans every rank, NaN
scores (the largest key), ±inf and signed zeros, ``pos_label=0``, zero and
lognormal weights, one class only. Tolerances: 1e-5 against JAX, 1e-6
between the port's worlds, whose ranks all return the same bits.

Weights whose per-class totals multiply below float32's range are held
against a float64 oracle instead: ``ShardedAUROC(with_sample_weights=True)``
at world 1 (the weighted scan, normalized factor by factor in float64) and
in a 2-process world (the sample sort, which divides in float64) give the
same value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from sklearn.metrics import average_precision_score, roc_auc_score

from metrics_tpu.parallel.sample_sort import (
    host_sample_sort_auroc_ap,
    host_sample_sort_auroc_ap_weighted,
    sample_sort_auroc_ap as jax_sample_sort_auroc_ap,
)
from metrics_tpu_torch.parallel.sample_sort import _tie_stats, _tie_stats_w, sample_sort_auroc_ap
from metrics_tpu_torch.ops.auroc_kernel import _co_sort
from metrics_tpu_torch.ops.tie_scan import tie_group_reduce
from tests.torch_workers import run_world, sample_sort_cases, sharded_cases

JAX_TOL = 1e-5
PORT_TOL = 1e-6
WORLDS = (2, 4)
CAP = 96


def _case(name, world, seed, fills=None, distinct=None, weights=None, special=None, pos_label=1, one_class=False):
    rng = np.random.default_rng(seed)
    fills = fills or [CAP] * world
    preds = rng.random((world, CAP)).astype(np.float32)
    if distinct:
        preds = (rng.integers(0, distinct, (world, CAP)) / distinct).astype(np.float32)
    target = (rng.random((world, CAP)) < np.nan_to_num(preds, nan=0.5)).astype(np.int32)
    if special == "nan":
        preds[:, 5] = np.nan
        preds[:, 9] = np.nan
    if special == "inf_zero":
        preds[:, 0], preds[:, 1] = np.inf, -np.inf
        preds[:, 2:6] = np.array([0.0, -0.0, 0.0, -0.0], np.float32)
    if one_class:
        target[:] = 1
    w = None
    if weights == "lognormal":
        w = rng.lognormal(size=(world, CAP)).astype(np.float32)
    elif weights == "zero_one":
        w = (rng.random((world, CAP)) < 0.6).astype(np.float32)
    shards = [(preds[r], target[r], None if w is None else w[r], fills[r]) for r in range(world)]
    return {"name": name, "shards": shards, "pos_label": pos_label}


def _cases(world):
    uneven = [CAP, 0, 37, 1][:world] if world == 4 else [CAP, 13]
    return [
        _case("random", world, 1),
        _case("uneven_fills_empty_rank", world, 2, fills=uneven),
        _case("tie_storm", world, 3, distinct=5),
        _case("nan_scores", world, 4, special="nan", fills=[CAP, 40, 70, CAP][:world]),
        _case("inf_and_signed_zeros", world, 5, special="inf_zero"),
        _case("pos_label_0", world, 6, pos_label=0),
        _case("one_class", world, 7, one_class=True),
        _case("weighted", world, 8, weights="lognormal", fills=uneven),
        _case("weighted_tie_storm", world, 9, distinct=4, weights="lognormal"),
        _case("zero_weights", world, 10, weights="zero_one"),
        _case("weighted_nan_scores", world, 11, special="nan", weights="lognormal"),
    ]


NAMES = [c["name"] for c in _cases(2)]


def _jax_results(case):
    """(host twin, SPMD) (auroc, ap) of the JAX package on the same shards."""
    shards, pos_label = case["shards"], case["pos_label"]
    world = len(shards)
    weighted = shards[0][2] is not None
    if weighted:
        host = host_sample_sort_auroc_ap_weighted(shards, pos_label)
    else:
        host = host_sample_sort_auroc_ap([(p, t, c) for p, t, _, c in shards], pos_label)
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    sharding = NamedSharding(mesh, P("data"))

    def put(i):
        return jax.device_put(jnp.asarray(np.concatenate([s[i] for s in shards])), sharding)

    counts = jax.device_put(jnp.asarray(np.array([s[3] for s in shards], np.int32)), sharding)
    spmd = jax_sample_sort_auroc_ap(put(0), put(1), counts, mesh, "data", pos_label,
                                    weights=put(2) if weighted else None)
    return tuple(float(x) for x in host), tuple(float(x) for x in spmd)


@pytest.fixture(scope="module")
def results():
    out = {}
    for world in WORLDS:
        cases = _cases(world)
        out[world] = {
            "jax": {c["name"]: _jax_results(c) for c in cases},
            "port": run_world(world, sample_sort_cases, cases),
            "cases": {c["name"]: c for c in cases},
        }
    return out


def _close(a, b, tol):
    return (np.isnan(a) and np.isnan(b)) or abs(a - b) <= tol


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", NAMES)
def test_sample_sort_matches_jax(results, world, name):
    host, spmd = results[world]["jax"][name]
    port = results[world]["port"]
    auroc, ap, _ = port[0][name]
    for got, want_host, want_spmd in ((auroc, host[0], spmd[0]), (ap, host[1], spmd[1])):
        assert _close(got, want_host, JAX_TOL), (name, got, want_host)
        assert _close(got, want_spmd, JAX_TOL), (name, got, want_spmd)
    # every rank returns the same bits
    assert all(port[r][name][2] == port[0][name][2] for r in range(world))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", NAMES)
def test_sample_sort_equals_one_process_and_sklearn(results, world, name):
    case = results[world]["cases"][name]
    shards, pos_label = case["shards"], case["pos_label"]
    preds = np.concatenate([p[:c] for p, _, _, c in shards])
    target = np.concatenate([t[:c] for _, t, _, c in shards])
    weights = None if shards[0][2] is None else np.concatenate([w[:c] for _, _, w, c in shards])
    # the same stream in one process (world 1: one bucket, no offsets)
    one = sample_sort_auroc_ap(torch.from_numpy(preds), torch.from_numpy(target), len(preds), pos_label,
                               None if weights is None else torch.from_numpy(weights))
    auroc, ap, _ = results[world]["port"][0][name]
    assert _close(auroc, float(one[0]), PORT_TOL) and _close(ap, float(one[1]), PORT_TOL)
    rel = target == pos_label
    if case["name"] in ("one_class",):
        assert np.isnan(auroc) and not np.isnan(ap)
        return
    # rank-equivalent finite stand-ins: NaN has the largest key, which ranks
    # below every score (+0.0 and -0.0 compare equal, so they stay exact)
    finite = np.nan_to_num(preds.astype(np.float64), nan=-2e30, posinf=1e30, neginf=-1e30)
    keep = slice(None) if weights is None else weights > 0
    want_auroc = roc_auc_score(rel[keep], finite[keep], sample_weight=None if weights is None else weights[keep])
    want_ap = average_precision_score(rel[keep], finite[keep], sample_weight=None if weights is None else weights[keep])
    assert abs(auroc - want_auroc) <= JAX_TOL and abs(ap - want_ap) <= JAX_TOL


def test_bucket_epilogues_sum_to_the_one_stream_result():
    """_tie_stats / _tie_stats_w on key-range buckets with their lower-bucket
    class totals as offsets: the bucket sums equal the one-stream result."""
    rng = np.random.default_rng(12)
    n = 5000
    preds = torch.from_numpy(np.round(rng.random(n), 2).astype(np.float32))
    rel = torch.from_numpy((rng.random(n) < 0.4).astype(np.float32))
    w = torch.from_numpy(rng.lognormal(size=n).astype(np.float32))
    for weights in (None, w):
        streams = _co_sort(preds, rel, None, weights)
        key_s = streams[0]
        bounds = [0, *torch.searchsorted(key_s, key_s[[n // 4, n // 2, 3 * n // 4]], right=True).tolist(), n]
        area = ap = off_p = off_n = 0.0
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            parts = [s[lo:hi] for s in streams]
            stats = _tie_stats(*parts, off_p, off_n) if weights is None else _tie_stats_w(*parts, off_p, off_n)
            area, ap = area + float(stats[0]), ap + float(stats[1])
            off_p, off_n = off_p + float(stats[2]), off_n + float(stats[3])
        whole = tie_group_reduce(*streams[:2], weights_s=None if weights is None else streams[2]).double()
        assert abs(area - float(whole[0])) <= PORT_TOL * abs(float(whole[0]))
        assert abs(ap - float(whole[1])) <= PORT_TOL * abs(float(whole[1]))
        assert abs(off_p - float(whole[2])) <= PORT_TOL * float(whole[2])


@pytest.mark.parametrize("weight, tol", [(1e-16, 1e-6), (1e-20, 1e-5)])
def test_tiny_weight_totals_agree_at_world_1_and_2(weight, tol):
    """Scores [0.9, 0.1, 0.6, 0.3], targets [1, 0, 0, 1], every weight tiny:
    the float64 oracle (and the JAX package's functional AUROC) is 0.75."""
    preds = np.array([0.9, 0.1, 0.6, 0.3], np.float32)
    target = np.array([1, 0, 0, 1], np.int32)
    w = np.full(4, weight, np.float32)
    case = {"name": "tiny", "metric": "auroc", "capacity": 4, "kwargs": {"with_sample_weights": True},
            "batches": [(preds, target, w)]}
    one = sharded_cases(0, 1, torch.device("cpu"), [case])["tiny"]["value"]
    two = run_world(2, sharded_cases, [case])
    assert abs(float(one) - 0.75) < tol
    for r in range(2):
        assert abs(float(two[r]["tiny"]["value"]) - 0.75) < tol
