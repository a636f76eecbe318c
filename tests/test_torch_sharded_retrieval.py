"""The port's ``ShardedRetrieval*`` and its retrieval sample sort against the
JAX package's, on the CPU.

At world 1 (in this process) each sharded metric equals its unsharded
module bit for bit, under every ``empty_target_action`` and with ``exclude``;
overflow raises before anything is written; pickle and checkpoints round
trip; a user subclass scores through ``_metric``; a JAX ``state_dict``
carries in. In gloo worlds of 2 and 4 (one spawn per world, every case
inside it; the workers import no JAX) each rank appends its own shard, and
the value must equal JAX's ``sample_sort_retrieval`` on a CPU mesh of the
same size holding the same shards, and JAX's replicated module over the
rank-major concatenation of the valid slots, within 1e-6, with the same bits
on every rank. The cases are those of JAX's
``tests/parallel/test_sample_sort_retrieval.py``: uneven fills, an empty
rank, a query spread over every rank, excluded targets, every
``empty_target_action`` (``"error"`` raises on every rank), and tied scores
across ranks, which must rank in the world-1 gather order. The
list-state ``RetrievalMAP`` synced across the same world gives the same
value.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import metrics_tpu as jm
from metrics_tpu.parallel.sample_sort import sample_sort_retrieval as jax_sample_sort_retrieval
from metrics_tpu.retrieval.mean_average_precision import _map_segments
from metrics_tpu.retrieval.mean_reciprocal_rank import _mrr_segments
from metrics_tpu.retrieval.precision import _precision_segments
from metrics_tpu.retrieval.recall import _recall_segments
from metrics_tpu_torch import (
    RetrievalMAP,
    RetrievalMRR,
    RetrievalPrecision,
    RetrievalRecall,
    ShardedRetrievalMAP,
    ShardedRetrievalMRR,
    ShardedRetrievalPrecision,
    ShardedRetrievalRecall,
)
from metrics_tpu_torch.interop import state_from_jax
from tests.torch_workers import UserShardedMAP, run_world, sharded_retrieval_cases

TOL = 1e-6
CPU = torch.device("cpu")
CAP = 64
WORLDS = (2, 4)

_PORT = {"map": (RetrievalMAP, ShardedRetrievalMAP), "mrr": (RetrievalMRR, ShardedRetrievalMRR),
         "precision": (RetrievalPrecision, ShardedRetrievalPrecision),
         "recall": (RetrievalRecall, ShardedRetrievalRecall)}
_JAX = {"map": (jm.RetrievalMAP, _map_segments), "mrr": (jm.RetrievalMRR, _mrr_segments),
        "precision": (jm.RetrievalPrecision, _precision_segments), "recall": (jm.RetrievalRecall, _recall_segments),
        "user_map": (jm.RetrievalMAP, _map_segments), "replicated_map": (jm.RetrievalMAP, _map_segments)}


def _stream(n, n_queries, seed, ties=False, excluded=False, empty=(), first_id=0):
    rng = np.random.default_rng(seed)
    idx = (first_id + rng.integers(0, n_queries, n)).astype(np.int32)
    preds = (rng.integers(0, 3, n) / 3).astype(np.float32) if ties else rng.random(n).astype(np.float32)
    target = (rng.random(n) < 0.4).astype(np.int32)
    target[np.isin(idx - first_id, empty)] = 0
    if excluded:
        target[rng.random(n) < 0.25] = -100
    return idx, preds, target


# ---- world 1 ---------------------------------------------------------------------------------


def _pair(name, kwargs, batches, cap=CAP):
    plain_cls, sharded_cls = _PORT[name]
    plain, sharded = plain_cls(device=CPU, **kwargs), sharded_cls(capacity_per_device=cap, device=CPU, **kwargs)
    for batch in batches:
        plain.update(*batch)
        sharded.update(*batch)
    return plain, sharded


WORLD1 = [(name, action, excluded) for name in _PORT for action in ("skip", "pos", "neg", "error")
          for excluded in (False, True)]


@pytest.mark.parametrize("name, action, excluded", WORLD1)
def test_world_1_equals_the_unsharded_module_bit_for_bit(name, action, excluded):
    empty = () if action == "error" else (1, 4)
    idx, preds, target = _stream(150, 7, seed=len(name) + 10 * excluded, ties=True, excluded=excluded, empty=empty)
    if action == "error":
        target[[int(np.flatnonzero(idx == q)[0]) for q in np.unique(idx)]] = 1
    kwargs = {"empty_target_action": action, **({"k": 3} if name in ("precision", "recall") else {})}
    batches = [tuple(torch.from_numpy(a[lo:lo + 50]) for a in (idx, preds, target)) for lo in range(0, 150, 50)]
    plain, sharded = _pair(name, kwargs, batches, cap=160)
    want = plain.compute()
    got = sharded.compute()
    assert got.dtype == torch.float32 and got.numpy().tobytes() == want.numpy().tobytes()


def test_world_1_error_action_raises_as_the_unsharded_module():
    idx, preds, target = (torch.from_numpy(a) for a in _stream(60, 5, seed=3, empty=(2,)))
    plain, sharded = _pair("map", {"empty_target_action": "error"}, [(idx, preds, target)])
    with pytest.raises(ValueError, match="no positive target") as want:
        plain.compute()
    with pytest.raises(ValueError) as got:
        sharded.compute()
    assert str(got.value) == str(want.value)


def test_overflow_raises_before_writing():
    m = ShardedRetrievalMAP(capacity_per_device=10, device=CPU)
    m.update(torch.arange(6), torch.rand(6), torch.ones(6, dtype=torch.int64))
    before = [getattr(m, k).clone() for k in ("buf_idx", "buf_preds", "buf_target", "counts")]
    with pytest.raises(ValueError, match="overflow"):
        m.update(torch.arange(5), torch.rand(5), torch.ones(5, dtype=torch.int64))
    assert all(torch.equal(b, getattr(m, k)) for b, k in zip(before, ("buf_idx", "buf_preds", "buf_target", "counts")))
    m.update(torch.arange(4), torch.rand(4), torch.ones(4, dtype=torch.int64))  # exactly full is fine
    assert int(m.counts[0]) == 10


def test_pickle_and_checkpoint_round_trip():
    idx, preds, target = (torch.from_numpy(a) for a in _stream(90, 6, seed=5, excluded=True))
    m = ShardedRetrievalPrecision(capacity_per_device=100, k=2, device=CPU)
    m.update(idx[:40], preds[:40], target[:40])
    restored = pickle.loads(pickle.dumps(m))
    for metric in (m, restored):
        metric.update(idx[40:], preds[40:], target[40:])
    assert torch.equal(restored.compute(), m.compute())
    m.persistent(True)
    loaded = ShardedRetrievalPrecision(capacity_per_device=100, k=2, device=CPU)
    loaded.load_state_dict(m.state_dict(), strict=True)
    assert torch.equal(loaded.compute(), m.compute())
    with pytest.raises(ValueError, match="overflow"):  # the fill came along
        loaded.update(torch.arange(11), torch.rand(11), torch.ones(11, dtype=torch.int64))


def test_user_subclass_scores_through_metric():
    idx, preds, target = (torch.from_numpy(a) for a in _stream(120, 8, seed=9, ties=True, excluded=True))
    user = UserShardedMAP(capacity_per_device=128, device=CPU)
    builtin = ShardedRetrievalMAP(capacity_per_device=128, device=CPU)
    for m in (user, builtin):
        m.update(idx, preds, target)
    assert user._samplesort_scorer() is None and builtin._samplesort_scorer() is not None
    assert abs(float(user.compute()) - float(builtin.compute())) <= TOL


def test_state_from_jax_sharded_world_1():
    idx, preds, target = _stream(96, 7, seed=12, excluded=True)
    jmetric = jm.ShardedRetrievalMAP(capacity_per_device=128, mesh=Mesh(np.array(jax.devices()[:1]), ("data",)))
    jmetric.update(jnp.asarray(idx), jnp.asarray(preds), jnp.asarray(target))
    jmetric.persistent(True)
    state = {k: np.asarray(v) for k, v in jmetric.state_dict().items()}
    m = ShardedRetrievalMAP(capacity_per_device=128, device=CPU)
    m.load_state_dict(state_from_jax(state), strict=True)
    assert abs(float(m.compute()) - float(jmetric.compute())) <= TOL


# ---- worlds of 2 and 4 over gloo ----------------------------------------------------------------


def _shards(world, seed, fills=None, n_queries=9, **stream):
    fills = fills or [CAP] * world
    idx, preds, target = _stream(sum(fills), n_queries, seed, **stream)
    cuts = np.cumsum([0, *fills])
    return [tuple(a[cuts[r]:cuts[r + 1]] for a in (idx, preds, target)) for r in range(world)]


def _cases(world):
    uneven = [CAP, 13, 40, 7][:world]
    empty_rank = [CAP, 0, 50, 0][:world]
    cases = []
    for metric in ("map", "mrr", "precision", "recall"):
        kw = {"k": 3} if metric in ("precision", "recall") else {}
        for label, shards in (
            ("uneven", _shards(world, 1, uneven)),
            ("empty_rank", _shards(world, 2, empty_rank)),
            ("every_rank", _shards(world, 3, n_queries=3)),
            ("excluded", _shards(world, 4, excluded=True)),
            ("ties_across_ranks", _shards(world, 5, ties=True, n_queries=4)),
            ("negative_ids", _shards(world, 6, first_id=-40, n_queries=30)),
        ):
            cases.append({"name": f"{metric}_{label}", "metric": metric, "kwargs": kw, "shards": shards})
        for action in ("skip", "pos", "neg", "error"):
            cases.append({"name": f"{metric}_{action}", "metric": metric,
                          "kwargs": {**kw, "empty_target_action": action},
                          "shards": _shards(world, 7, empty=(1, 4), excluded=True)})
    cases.append({"name": "all_queries_empty", "metric": "map", "kwargs": {},
                  "shards": _shards(world, 8, empty=tuple(range(9)))})
    cases.append({"name": "user_map_gathers", "metric": "user_map", "kwargs": {},
                  "shards": _shards(world, 9, uneven, ties=True, excluded=True)})
    # the unsharded list-state metric, synced by gathering every rank's
    # batches (equal fills: every rank appends as many batches)
    cases.append({"name": "replicated_map_synced", "metric": "replicated_map", "kwargs": {},
                  "shards": _shards(world, 11, excluded=True)})
    # query id -1 is JAX's padding sentinel once cast to uint32, so its SPMD
    # sample sort drops that query; the port keeps it (replicated value only)
    cases.append({"name": "map_query_id_minus_one", "metric": "map", "kwargs": {},
                  "shards": _shards(world, 10, first_id=-2, n_queries=4)})
    # one query, every score equal: the first relevant document in rank-major
    # slot order (rank 1's second slot, global position 6) decides MRR
    quiet = (np.zeros(4, np.int32), np.full(4, 0.5, np.float32), np.zeros(4, np.int32))
    loud = (np.zeros(4, np.int32), np.full(4, 0.5, np.float32), np.array([0, 1, 0, 1], np.int32))
    cases.append({"name": "mrr_ties_in_gather_order", "metric": "mrr", "kwargs": {},
                  "shards": [quiet] + [loud] * (world - 1)})
    for case in cases:
        case.update(cap=CAP, batch=16)
    return cases


def _jax_values(case):
    """(SPMD sample sort, replicated module) of the JAX package on the same
    shards; an error text in place of a value where JAX raises."""
    shards, world = case["shards"], len(case["shards"])
    kwargs = case["kwargs"]
    action = kwargs.get("empty_target_action", "skip")
    module_cls, scorer = _JAX[case["metric"]]
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    sharding = NamedSharding(mesh, P("data"))

    def put(i):
        buf = np.zeros((world, CAP), shards[0][i].dtype)
        for r, shard in enumerate(shards):
            buf[r, :len(shard[i])] = shard[i]
        return jax.device_put(jnp.asarray(buf.reshape(-1)), sharding)

    counts = jax.device_put(jnp.asarray(np.array([len(s[0]) for s in shards], np.int32)), sharding)
    static = (("k", kwargs["k"]),) if "k" in kwargs else ()
    out = []
    try:
        out.append(float(jax_sample_sort_retrieval(put(0), put(1), put(2), counts, mesh, "data", scorer, static,
                                                   action, -100)))
    except ValueError as err:
        out.append(str(err))
    replicated = module_cls(**kwargs)
    replicated.update(*(jnp.asarray(np.concatenate([s[i] for s in shards])) for i in range(3)))
    try:
        out.append(float(replicated.compute()))
    except ValueError as err:
        out.append(str(err))
    return out


def _jax_state_case(world):
    """A JAX ``ShardedRetrievalMAP`` epoch on a mesh of ``world`` CPU devices,
    carried to each rank by ``state_from_jax``; its JAX value."""
    idx, preds, target = _stream(world * 48, 11, seed=14, excluded=True)
    jmetric = jm.ShardedRetrievalMAP(capacity_per_device=CAP, mesh=Mesh(np.array(jax.devices()[:world]), ("data",)))
    jmetric.update(jnp.asarray(idx), jnp.asarray(preds), jnp.asarray(target))
    jmetric.persistent(True)
    state = {k: np.asarray(v) for k, v in jmetric.state_dict().items()}
    case = {"name": "jax_state", "metric": "map", "kwargs": {}, "cap": CAP, "jax_state": state}
    return case, float(jmetric.compute())


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for world in WORLDS:
        cases = _cases(world)
        jax_values = {c["name"]: _jax_values(c) for c in cases}
        state_case, state_value = _jax_state_case(world)
        jax_values["jax_state"] = [state_value, state_value]
        out[world] = {"cases": {c["name"]: c for c in cases}, "jax": jax_values,
                      "port": run_world(world, sharded_retrieval_cases, cases + [state_case])}
    return out


NAMES = [c["name"] for c in _cases(2)] + ["jax_state"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", NAMES)
def test_world_matches_jax_sample_sort_and_replicated_module(worlds, world, name):
    ranks = worlds[world]["port"]
    spmd, replicated = worlds[world]["jax"][name]
    got = ranks[0][name]
    if isinstance(replicated, str):  # "error": every rank raises JAX's text
        assert all(ranks[r][name] == {"error": replicated} for r in range(world))
        assert spmd == replicated
        return
    assert all(ranks[r][name]["bits"] == got["bits"] for r in range(world))
    if name != "map_query_id_minus_one":
        assert abs(got["value"] - spmd) <= TOL, (got["value"], spmd)
    assert abs(got["value"] - replicated) <= TOL, (got["value"], replicated)
    if name == "mrr_ties_in_gather_order":
        assert abs(got["value"] - 1 / 6) <= TOL


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", [n for n in NAMES if not n.endswith("_error") and n != "jax_state"])
def test_world_equals_world_1(worlds, world, name):
    """The same shards in one process (rank-major order) give the value of
    the world, within 1e-6: per-query scores are the same, only the float64
    sum of the query means is added in another order."""
    case = worlds[world]["cases"][name]
    one = sharded_retrieval_cases(0, 1, CPU, [{**case, "cap": CAP * world, "batch": CAP * world,
                                               "shards": [tuple(np.concatenate([s[i] for s in case["shards"]])
                                                                for i in range(3))]}])[name]
    assert abs(worlds[world]["port"][0][name]["value"] - one["value"]) <= TOL
