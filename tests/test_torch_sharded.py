"""The port's ``ShardedAUROC`` / ``ShardedAveragePrecision`` and
``ShardedROC`` / ``ShardedPrecisionRecallCurve`` against the JAX package's,
on the CPU.

The JAX metrics run on the suite's 8-device CPU mesh. The port runs the same
cases at world 1 (in this process) and in 8 spawned gloo processes (one
world for every case; the workers import no JAX), each rank fed its chunk
of every global batch: its buffers then equal JAX's shard ``r`` bit for
bit. Cases mirror ``tests/classification/test_sharded.py`` and
``tests/parallel/test_sample_sort.py``: binary and one-vs-rest, weighted or
not, partial fills, ties, ±inf and NaN scores, bf16 buffers, ``average`` in
{None, macro, weighted}, ``forward``'s batch-local value, the binary and
per-class curves, and a JAX ``state_dict`` carried across by
``state_from_jax``. Errors are compared message for message. Tolerances are
the JAX suite's: 1e-5 against JAX, 1e-6 between the port's worlds; curves
have equal lengths and thresholds.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from sklearn.metrics import roc_auc_score

import metrics_tpu as jm
from metrics_tpu_torch import AUROC, MetricCollection, ShardedAUROC, ShardedAveragePrecision
from metrics_tpu_torch.classification.sharded import ShardedCurveMetric
from metrics_tpu_torch.interop import state_from_jax
from tests.torch_workers import run_world, sharded_cases

WORLD = 8
JAX_TOL = 1e-5
PORT_TOL = 1e-6
CPU = torch.device("cpu")

_JAX = {"auroc": jm.ShardedAUROC, "ap": jm.ShardedAveragePrecision, "roc": jm.ShardedROC,
        "prc": jm.ShardedPrecisionRecallCurve}


def _binary(n, seed, ties=False, special=None):
    rng = np.random.default_rng(seed)
    preds = rng.random(n).astype(np.float32)
    if ties:
        preds = np.round(preds * 10) / 10
    target = (rng.random(n) < preds).astype(np.int32)
    if special == "inf_nan":
        preds[::17], preds[3::17], preds[5::23] = np.inf, -np.inf, np.nan
    return preds.astype(np.float32), target


def _multiclass(n, c, seed):
    rng = np.random.default_rng(seed)
    logits = rng.random((n, c)).astype(np.float32)
    return (logits / logits.sum(1, keepdims=True)).astype(np.float32), rng.integers(0, c, n).astype(np.int32)


def _weights(n, seed):
    return np.random.default_rng(seed).lognormal(size=n).astype(np.float32)


def _split(arrays, at):
    return [tuple(a[:at] for a in arrays), tuple(a[at:] for a in arrays)]


def _cases():
    p, t = _binary(512, 1)
    pt, tt = _binary(512, 2, ties=True)
    pi, ti = _binary(256, 3, special="inf_nan")
    w = _weights(512, 4)
    mp, mt = _multiclass(256, 11, 5)
    mw = _weights(256, 6)
    sp, st = _multiclass(128, 5, 7)
    fp, ft = _multiclass(64, 4, 8)
    ft[:32] = np.minimum(ft[:32], 2)  # the first batch lacks class 3
    cases = [
        ("binary_partial", "auroc", 1024, {}, _split((p, t), 256)),
        ("binary_ties_ap", "ap", 512, {}, [(pt, tt)]),
        ("binary_inf_nan", "auroc", 256, {}, [(pi, ti)]),
        ("binary_inf_nan_ap", "ap", 512, {}, [(pi, ti)]),
        ("binary_pos_label_0", "ap", 512, {"pos_label": 0}, [(p, t)]),
        ("binary_weighted", "auroc", 1024, {"with_sample_weights": True}, _split((p, t, w), 256)),
        ("binary_weighted_ties_ap", "ap", 512, {"with_sample_weights": True}, [(pt, tt, w)]),
        ("binary_bf16", "auroc", 512, {"bf16": True}, [(p, t)]),
        ("binary_bf16_weighted_ap", "ap", 512, {"bf16": True, "with_sample_weights": True}, [(p, t, w)]),
        ("ovr_none", "auroc", 512, {"num_classes": 11, "average": None}, _split((mp, mt), 128)),
        ("ovr_macro_ap", "ap", 256, {"num_classes": 11, "average": "macro"}, [(mp, mt)]),
        ("ovr_weighted_average", "auroc", 256, {"num_classes": 11, "average": "weighted"}, [(mp, mt)]),
        ("ovr_weighted_samples", "auroc", 256,
         {"num_classes": 11, "average": None, "with_sample_weights": True}, [(mp, mt, mw)]),
        ("ovr_weighted_samples_ap", "ap", 512,
         {"num_classes": 11, "average": "weighted", "with_sample_weights": True}, _split((mp, mt, mw), 64)),
        ("ovr_fewer_classes_than_ranks", "auroc", 128,
         {"num_classes": 5, "average": "macro", "with_sample_weights": True}, [(sp, st, _weights(128, 9))]),
        ("ovr_bf16", "ap", 256, {"num_classes": 11, "average": None, "bf16": True}, [(mp, mt)]),
        ("forward_binary", "auroc", 1024, {"forward": True}, _split((p, t), 256)),
        ("forward_ovr_absent_class", "auroc", 64, {"num_classes": 4, "forward": True}, _split((fp, ft), 32)),
        ("forward_weighted_ap", "ap", 1024, {"forward": True, "with_sample_weights": True}, _split((p, t, w), 256)),
        ("roc_binary_partial", "roc", 1024, {}, _split((p, t), 256)),
        ("roc_inf_nan", "roc", 256, {}, [(pi, ti)]),
        ("roc_pos_label_0", "roc", 512, {"pos_label": 0}, [(pt, tt)]),
        ("prc_ties", "prc", 512, {}, [(pt, tt)]),
        ("roc_ovr", "roc", 256, {"num_classes": 11}, [(mp, mt)]),
        ("prc_ovr_partial", "prc", 512, {"num_classes": 11}, _split((mp, mt), 128)),
    ]
    return [dict(name=n, metric=m, capacity=cap, options=o, batches=b) for n, m, cap, o, b in cases]


CASES = _cases()
NAMES = [c["name"] for c in CASES]


def _kwargs(options, bf16_dtype):
    kwargs = {k: v for k, v in options.items() if k not in ("bf16", "forward")}
    if options.get("bf16"):
        kwargs["preds_dtype"] = bf16_dtype
    return kwargs


def _numpy(x):
    """A value as numpy, a curve's tuple (or per-class lists) as the same
    structure of arrays."""
    return type(x)(_numpy(v) for v in x) if isinstance(x, (tuple, list)) else np.asarray(x)


def _jax_run(case):
    """The JAX metric on the 8-device mesh: value, forward values, state."""
    m = _JAX[case["metric"]](capacity_per_device=case["capacity"] // WORLD, **_kwargs(case["options"], jnp.bfloat16))
    steps = []
    for batch in case["batches"]:
        args = [jnp.asarray(a) for a in batch]
        kw = {"sample_weights": args.pop()} if len(args) == 3 else {}
        if case["options"].get("forward"):
            steps.append(np.asarray(m(*args, **kw)))
        else:
            m.update(*args, **kw)
    m.persistent(True)
    state = {k: np.asarray(v) for k, v in m.state_dict().items()}
    return {"value": _numpy(m.compute()), "steps": steps, "state": state}


def _port_payload(case):
    return dict(name=case["name"], metric=case["metric"], capacity=case["capacity"],
                kwargs=_kwargs(case["options"], torch.bfloat16), batches=case["batches"],
                forward=case["options"].get("forward", False))


def _state_case(case, jax_state):
    payload = _port_payload(case)
    return dict(payload, name=case["name"] + "/from_jax", batches=[], forward=False, jax_state=jax_state)


@pytest.fixture(scope="module")
def results():
    jax_results = {c["name"]: _jax_run(c) for c in CASES}
    port_cases = [_port_payload(c) for c in CASES]
    carried = [_state_case(c, jax_results[c["name"]]["state"]) for c in CASES if not c["options"].get("forward")]
    return {
        "jax": jax_results,
        "world1": sharded_cases(0, 1, CPU, port_cases),
        "world8": run_world(WORLD, sharded_cases, port_cases + carried),
    }


def _leaves(x):
    return [a for v in x for a in _leaves(v)] if isinstance(x, (tuple, list)) else [np.asarray(x, np.float64)]


def _assert_close(got, want, tol):
    """Values, or curves (of equal lengths) with their points, within ``tol``."""
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, equal_nan=True)


def _same_bits(a, b):
    return all(np.array_equal(x, y, equal_nan=True) for x, y in zip(_leaves(a), _leaves(b)))


@pytest.mark.parametrize("name", NAMES)
def test_port_in_8_gloo_processes_matches_jax(results, name):
    want = results["jax"][name]
    ranks = results["world8"]
    for r in range(WORLD):
        _assert_close(ranks[r][name]["value"], want["value"], JAX_TOL)
        assert _same_bits(ranks[r][name]["value"], ranks[0][name]["value"])
    for got, step in zip(ranks[0][name]["steps"], want["steps"]):
        _assert_close(got, step, JAX_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_port_at_world_1_matches_jax_and_world_8(results, name):
    one = results["world1"][name]
    _assert_close(one["value"], results["jax"][name]["value"], JAX_TOL)
    _assert_close(one["value"], results["world8"][0][name]["value"], PORT_TOL)
    for got, step in zip(one["steps"], results["world8"][0][name]["steps"]):
        _assert_close(got, step, PORT_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_rank_buffers_equal_the_jax_shards(results, name):
    state = results["jax"][name]["state"]
    for r in range(WORLD):
        buffers = results["world8"][r][name]["buffers"]
        for key, got in buffers.items():
            want = state[key]
            if key == "counts":
                assert got[r] == want[r] and not np.delete(got, r).any()
                continue
            cap = want.shape[0] // WORLD
            shard = np.asarray(jnp.asarray(want[r * cap:(r + 1) * cap]).astype(jnp.float32)) if key == "buf_preds" \
                else want[r * cap:(r + 1) * cap]
            assert np.array_equal(got, shard, equal_nan=True), (key, r)


@pytest.mark.parametrize("name", [n for n, c in zip(NAMES, CASES) if not c["options"].get("forward")])
def test_jax_state_carried_to_every_rank_computes_the_same_value(results, name):
    for r in range(WORLD):
        _assert_close(results["world8"][r][name + "/from_jax"]["value"], results["jax"][name]["value"], JAX_TOL)


# ---- world 1 only ------------------------------------------------------------

def _one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def _raises_alike(jax_call, port_call, exc=ValueError):
    with pytest.raises(exc) as want:
        jax_call()
    with pytest.raises(exc) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_state_from_jax_at_world_1_is_the_identity():
    p, t = _binary(64, 10)
    w = _weights(64, 10)
    ref = jm.ShardedAveragePrecision(capacity_per_device=100, mesh=_one_device_mesh(), with_sample_weights=True)
    ref.update(jnp.asarray(p), jnp.asarray(t), sample_weights=jnp.asarray(w))
    ref.persistent(True)
    ours = ShardedAveragePrecision(capacity_per_device=100, with_sample_weights=True, device=CPU)
    ours.load_state_dict(state_from_jax({k: np.asarray(v) for k, v in ref.state_dict().items()}), strict=True)
    assert ours._n_seen == 64
    _assert_close(float(ours.compute()), float(ref.compute()), JAX_TOL)


def test_errors_match_the_jax_package():
    mesh = _one_device_mesh()
    p, t = _binary(8, 11)

    def both(make_jax, make_port, call):
        _raises_alike(lambda: call(make_jax(), jnp), lambda: call(make_port(), torch))

    # overflow, at the same fill
    both(lambda: jm.ShardedAUROC(capacity_per_device=12, mesh=mesh), lambda: ShardedAUROC(12, device=CPU),
         lambda m, xp: (m.update(xp.asarray(p), xp.asarray(t)), m.update(xp.asarray(p), xp.asarray(t))))
    # the weight contract, both ways, and the weights' shape and values
    weighted = (lambda: jm.ShardedAUROC(capacity_per_device=16, mesh=mesh, with_sample_weights=True),
                lambda: ShardedAUROC(16, with_sample_weights=True, device=CPU))
    both(*weighted, lambda m, xp: m.update(xp.asarray(p), xp.asarray(t)))
    both(lambda: jm.ShardedAUROC(capacity_per_device=16, mesh=mesh), lambda: ShardedAUROC(16, device=CPU),
         lambda m, xp: m.update(xp.asarray(p), xp.asarray(t), sample_weights=xp.asarray(np.ones(8, np.float32))))
    both(*weighted, lambda m, xp: m.update(xp.asarray(p), xp.asarray(t), sample_weights=xp.asarray(np.ones(4, np.float32))))
    for bad in (-1.0, np.nan, np.inf):
        w = np.ones(8, np.float32)
        w[3] = bad
        both(*weighted, lambda m, xp: m.update(xp.asarray(p), xp.asarray(t), sample_weights=xp.asarray(w)))
    # preds of the wrong shape; labels out of range (either side)
    both(lambda: jm.ShardedAUROC(capacity_per_device=16, mesh=mesh), lambda: ShardedAUROC(16, device=CPU),
         lambda m, xp: m.update(xp.asarray(np.zeros((8, 2), np.float32)), xp.asarray(t)))
    probs = np.full((8, 3), 1 / 3, np.float32)
    for labels in ([0, 1, 2, 7, 0, 1, 2, 0], [0, -1, 2, 0, 0, 1, 2, 0]):
        lab = np.asarray(labels, np.int32)
        both(lambda: jm.ShardedAUROC(capacity_per_device=16, num_classes=3, mesh=mesh),
             lambda: ShardedAUROC(16, num_classes=3, device=CPU),
             lambda m, xp: m.update(xp.asarray(probs), xp.asarray(lab)))
    # an averaged one-vs-rest score over a stream that lacks a class
    onehot = np.eye(4, dtype=np.float32)[np.zeros(16, int)]
    for average in ("macro", "weighted"):
        both(lambda: jm.ShardedAUROC(capacity_per_device=16, num_classes=4, average=average, mesh=mesh),
             lambda: ShardedAUROC(16, num_classes=4, average=average, device=CPU),
             lambda m, xp: (m.update(xp.asarray(onehot), xp.asarray(np.zeros(16, np.int32))), m.compute()))
    # constructor contracts
    _raises_alike(lambda: jm.ShardedAUROC(capacity_per_device=0, mesh=mesh), lambda: ShardedAUROC(0, device=CPU))
    _raises_alike(lambda: jm.ShardedAUROC(capacity_per_device=4, average="micro", mesh=mesh),
                  lambda: ShardedAUROC(4, average="micro", device=CPU))


def test_load_state_dict_rejects_another_world_or_capacity():
    p, t = _binary(64, 12)
    saved8 = jm.ShardedAUROC(capacity_per_device=16)
    saved8.update(jnp.asarray(p), jnp.asarray(t))
    saved8.persistent(True)
    state8 = {k: np.asarray(v) for k, v in saved8.state_dict().items()}
    # an 8-device checkpoint into one device / one rank
    _raises_alike(lambda: jm.ShardedAUROC(capacity_per_device=128, mesh=_one_device_mesh()).load_state_dict(state8),
                  lambda: ShardedAUROC(128, device=CPU).load_state_dict(state_from_jax(state8)))
    saved1 = jm.ShardedAUROC(capacity_per_device=64, mesh=_one_device_mesh())
    saved1.update(jnp.asarray(p), jnp.asarray(t))
    saved1.persistent(True)
    state1 = {k: np.asarray(v) for k, v in saved1.state_dict().items()}
    _raises_alike(lambda: jm.ShardedAUROC(capacity_per_device=32, mesh=_one_device_mesh()).load_state_dict(state1),
                  lambda: ShardedAUROC(32, device=CPU).load_state_dict(state_from_jax(state1)))
    # the port's own: the shard of another rank
    m = ShardedAUROC(64, device=CPU)
    m.rank, m.world = 0, 2  # as rank 0 of a world of 2
    with pytest.raises(ValueError, match="another rank"):
        m.load_state_dict({"counts": torch.tensor([0, 5], dtype=torch.int32)})


def test_with_sample_weights_needs_the_scalar_family():
    class Curve(ShardedCurveMetric):
        def compute(self):
            return None

    with pytest.raises(ValueError, match="does not support sample weights"):
        Curve(4, with_sample_weights=True, device=CPU)


def test_lifecycle_at_world_1():
    """Reset and reuse, pickling and clone mid-accumulation, a checkpoint
    round trip, a count past capacity, a collection with AUROC: each keeps
    the exact value."""
    p, t = _binary(256, 13)
    w = _weights(256, 13)
    want = roc_auc_score(t, p, sample_weight=w)
    m = ShardedAUROC(256, with_sample_weights=True, device=CPU)
    m.update(torch.from_numpy(p[:128]), torch.from_numpy(t[:128]), sample_weights=torch.from_numpy(w[:128]))
    copy = pickle.loads(pickle.dumps(m))
    clone = m.clone()
    for x in (m, copy, clone):
        x.update(torch.from_numpy(p[128:]), torch.from_numpy(t[128:]), sample_weights=torch.from_numpy(w[128:]))
        assert abs(float(x.compute()) - want) < JAX_TOL and x._n_seen == 256
    m.persistent(True)
    restored = ShardedAUROC(256, with_sample_weights=True, device=CPU)
    assert np.isnan(float(restored.compute()))  # empty; the load below drops this cached value
    restored.load_state_dict(m.state_dict(), strict=True)
    assert restored._n_seen == 256 and abs(float(restored.compute()) - want) < JAX_TOL
    # a count past capacity never validates slots that were never written
    restored.counts = torch.tensor([512], dtype=torch.int32)
    restored._n_seen = 512
    restored._computed = None
    assert abs(float(restored.compute()) - want) < JAX_TOL
    m.reset()
    assert m._n_seen == 0 and int(m.counts.sum()) == 0
    # forward keeps the fill across its snapshot, and overflow stays loud
    f = ShardedAUROC(200, device=CPU)
    f(torch.from_numpy(p[:100]), torch.from_numpy(t[:100]))
    f(torch.from_numpy(p[100:200]), torch.from_numpy(t[100:200]))
    with pytest.raises(ValueError, match="overflow"):
        f(torch.from_numpy(p[200:]), torch.from_numpy(t[200:]))
    assert abs(float(f.compute()) - roc_auc_score(t[:200], p[:200])) < JAX_TOL
    # beside the replicated AUROC in a collection
    coll = MetricCollection([AUROC(pos_label=1, device=CPU), ShardedAUROC(256, device=CPU)])
    coll.update(torch.from_numpy(p), torch.from_numpy(t))
    values = coll.compute()
    assert abs(float(values["AUROC"]) - float(values["ShardedAUROC"])) < PORT_TOL


def _bf16_rounded(preds: np.ndarray) -> np.ndarray:
    return torch.from_numpy(preds).to(torch.bfloat16).float().numpy()


def test_bf16_preds_buffer_quantizes_scores():
    """Port of JAX's case at world 1: ``preds_dtype=torch.bfloat16`` halves
    the buffer, and the value is the exact AUROC of the bf16-rounded scores,
    equal to JAX's over its mesh."""
    preds, target = _binary(512, 29)
    m = ShardedAUROC(capacity_per_device=512, preds_dtype=torch.bfloat16, device=CPU)
    m.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert m.buf_preds.dtype == torch.bfloat16
    assert m.buf_preds.nbytes * 2 == ShardedAUROC(capacity_per_device=512, device=CPU).buf_preds.nbytes
    got = float(m.compute())
    _assert_close(got, roc_auc_score(target, _bf16_rounded(preds)), PORT_TOL)
    ref = jm.ShardedAUROC(capacity_per_device=512 // WORLD, preds_dtype=jnp.bfloat16)
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    _assert_close(got, float(ref.compute()), JAX_TOL)


def test_astype_mid_accumulation_quantizes_the_buffer():
    """Port of JAX's ``test_astype_preserves_sharding_mid_accumulation`` at
    world 1: ``bfloat16()`` after an update casts the buffer in place of its
    slots (fill kept), and later updates are written in bf16; the value is
    the exact AUROC of the bf16-rounded scores."""
    preds, target = _binary(512, 31)
    m = ShardedAUROC(capacity_per_device=512, device=CPU)
    m.update(torch.from_numpy(preds[:256]), torch.from_numpy(target[:256]))
    assert m.bfloat16() is m
    assert m.buf_preds.dtype == torch.bfloat16 and m.buf_target.dtype == torch.int32 and m._n_seen == 256
    m.update(torch.from_numpy(preds[256:]), torch.from_numpy(target[256:]))
    assert m.buf_preds.dtype == torch.bfloat16
    _assert_close(float(m.compute()), roc_auc_score(target, _bf16_rounded(preds)), PORT_TOL)
