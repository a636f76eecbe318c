"""The port's stateful API (``Metric``, ``Accuracy``, ``AUROC``,
``MetricCollection``, sync, checkpoints, ``interop.state_from_jax``) against
the JAX package, on the CPU (``device="cpu"``).

The same seeded numpy batches go through both packages. Accuracy must be
equal exactly (both divide exact integer counts in f32); AUROC within 1e-5.
Bad inputs must raise the same exception type with the same message.
"""
import pickle
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
from metrics_tpu.functional import accuracy as jax_accuracy
from metrics_tpu.functional import auroc as jax_auroc
from metrics_tpu_torch import AUROC, Accuracy, Metric, MetricCollection
from metrics_tpu_torch.functional import accuracy, auroc
from metrics_tpu_torch.interop import state_from_jax
from metrics_tpu_torch.parallel.backend import SyncBackend, set_sync_backend

AUROC_TOL = 1e-5
CPU = "cpu"


def _softmax(x):
    e = np.exp(x - x.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def _batches(case, seed, n_batches=3, n=64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        if case == "binary":
            p = rng.random(n).astype(np.float32)
            t = (rng.random(n) < p).astype(np.int32)
        elif case == "multiclass_probs":
            p = _softmax(rng.standard_normal((n, 4)))
            t = rng.integers(0, 4, n).astype(np.int32)
        elif case == "multiclass_labels":
            p = rng.integers(0, 4, n).astype(np.int32)
            t = rng.integers(0, 4, n).astype(np.int32)
        elif case == "multilabel":
            p = rng.random((n, 3)).astype(np.float32)
            t = rng.integers(0, 2, (n, 3)).astype(np.int32)
        elif case == "multidim_multiclass":
            p = _softmax(rng.standard_normal((n, 3, 5)))
            t = rng.integers(0, 3, (n, 5)).astype(np.int32)
        else:
            raise ValueError(case)
        out.append((p, t))
    return out


def _tt(a):
    return torch.from_numpy(np.array(a))


ACCURACY_CASES = [
    ("binary", {}),
    ("multiclass_probs", {}),
    ("multiclass_probs", {"top_k": 2}),
    ("multiclass_labels", {}),
    ("multilabel", {}),
    ("multilabel", {"subset_accuracy": True}),
    ("multidim_multiclass", {}),
    ("multidim_multiclass", {"subset_accuracy": True}),
]


@pytest.mark.parametrize("case, kwargs", ACCURACY_CASES)
def test_accuracy_forward_compute_reset_match_jax(case, kwargs):
    ours = Accuracy(device=CPU, **kwargs)
    ref = jm.Accuracy(**kwargs)
    for epoch in range(2):
        for p, t in _batches(case, seed=epoch):
            step = ours(_tt(p), _tt(t))
            assert float(step) == float(ref(jnp.asarray(p), jnp.asarray(t)))
        assert float(ours.compute()) == float(ref.compute())
        ours.reset()
        ref.reset()


@pytest.mark.parametrize("case, kwargs", ACCURACY_CASES)
def test_functional_accuracy_matches_jax(case, kwargs):
    p, t = _batches(case, seed=4, n_batches=1, n=257)[0]
    assert float(accuracy(_tt(p), _tt(t), **kwargs)) == float(jax_accuracy(jnp.asarray(p), jnp.asarray(t), **kwargs))


def test_auroc_forward_and_compute_match_jax():
    ours = AUROC(pos_label=1, device=CPU)
    ref = jm.AUROC(pos_label=1)
    for p, t in _batches("binary", seed=5, n_batches=4, n=500):
        assert abs(float(ours(_tt(p), _tt(t))) - float(ref(jnp.asarray(p), jnp.asarray(t)))) < AUROC_TOL
    assert abs(float(ours.compute()) - float(ref.compute())) < AUROC_TOL
    ours.reset()
    assert ours.preds == [] and ours.target == []


def test_functional_auroc_matches_jax():
    p, t = _batches("binary", seed=6, n_batches=1, n=3000)[0]
    p = np.round(p, 2).astype(np.float32)  # tie-heavy
    assert abs(float(auroc(_tt(p), _tt(t), pos_label=1)) - float(jax_auroc(jnp.asarray(p), jnp.asarray(t), pos_label=1))) < AUROC_TOL


def _collections(prefix=None):
    ours = MetricCollection([Accuracy(device=CPU), AUROC(pos_label=1, device=CPU)], prefix=prefix)
    ref = jm.MetricCollection([jm.Accuracy(), jm.AUROC(pos_label=1)], prefix=prefix)
    return ours, ref


def _close(ours: dict, ref: dict):
    assert sorted(ours) == sorted(ref)
    for k in ours:
        tol = 0.0 if "Accuracy" in k else AUROC_TOL
        assert abs(float(ours[k]) - float(ref[k])) <= tol, (k, ours[k], ref[k])


@pytest.mark.parametrize("prefix", [None, "val_"])
def test_collection_forward_compute_reset_match_jax(prefix):
    ours, ref = _collections(prefix)
    for epoch in range(2):
        for p, t in _batches("binary", seed=10 + epoch, n_batches=3, n=400):
            _close(ours(_tt(p), _tt(t)), ref(jnp.asarray(p), jnp.asarray(t)))
        _close(ours.compute(), ref.compute())
        ours.reset()
        ref.reset()


def test_collection_update_clone_and_keys():
    ours, ref = _collections()
    for p, t in _batches("binary", seed=12):
        ours.update(_tt(p), _tt(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    twin = ours.clone(prefix="twin_")
    assert list(twin.compute()) == ["twin_Accuracy", "twin_AUROC"]
    _close(ours.compute(), ref.compute())
    assert len(ours) == 2 and "AUROC" in ours and list(ours.keys()) == ["Accuracy", "AUROC"]
    with pytest.raises(ValueError, match="two metrics both named"):
        MetricCollection([Accuracy(device=CPU), Accuracy(device=CPU)])
    with pytest.raises(ValueError, match="prefix"):
        MetricCollection([Accuracy(device=CPU)], prefix=3)


def _error(fn, *args, **kwargs):
    with pytest.raises(Exception) as info:
        fn(*args, **kwargs)
    return type(info.value).__name__, str(info.value)


_R = np.random.default_rng(20)
_P1 = _R.random(10).astype(np.float32)
_T1 = _R.integers(0, 2, 10).astype(np.int32)
_P3 = _softmax(_R.standard_normal((10, 3)))
_T3 = _R.integers(0, 3, 10).astype(np.int32)
BAD_ACCURACY_INPUTS = [
    ("float target", _P1, _P1, {}),
    ("threshold", _P1, _T1, {"threshold": 1.5}),
    ("first dim", _P1, np.zeros(11, np.int32), {}),
    ("not probabilities", _P1 * 2, _T1, {}),
    ("negative target", _P1, _T1 - 1, {}),
    ("negative int preds", _T3 - 1, _T3, {}),
    ("probs do not sum to 1", _P3 * 2, _T3, {}),
    ("top_k on binary", _P1, _T1, {"top_k": 1}),
    ("top_k too large", _P3, _T3, {"top_k": 3}),
    ("top_k zero", _P3, _T3, {"top_k": 0}),
    ("top_k on multilabel", _R.random((10, 3)).astype(np.float32), _R.integers(0, 2, (10, 3)).astype(np.int32), {"top_k": 1}),
    ("same ndim, other shape", _R.random((10, 3)).astype(np.float32), np.zeros((10, 4), np.int32), {}),
    ("int preds with a C dim", _R.integers(0, 3, (10, 3)).astype(np.int32), _T3, {}),
    ("label beyond C", _P3, np.full(10, 3, np.int32), {}),
    ("two extra dims", _R.random((10, 3, 2, 2)).astype(np.float32), _T3, {}),
    ("non-binary target for float preds", _P1, np.full(10, 2, np.int32), {}),
]


@pytest.mark.parametrize("name, p, t, kwargs", BAD_ACCURACY_INPUTS, ids=[c[0] for c in BAD_ACCURACY_INPUTS])
def test_accuracy_validation_errors_match_jax(name, p, t, kwargs):
    ours = _error(accuracy, _tt(p), _tt(t), **kwargs)
    ref = _error(jax_accuracy, jnp.asarray(p), jnp.asarray(t), **kwargs)
    assert ours == ref


@pytest.mark.parametrize(
    "ctor, kwargs",
    [("Accuracy", {"threshold": 2.0}), ("Accuracy", {"top_k": 0}), ("AUROC", {"average": "median"}),
     ("AUROC", {"max_fpr": 1.5})],
)
def test_construction_errors_match_jax(ctor, kwargs):
    ours = _error(getattr(__import__("metrics_tpu_torch"), ctor), device=CPU, **kwargs)
    assert ours == _error(getattr(jm, ctor), **kwargs)


@pytest.mark.parametrize("t", [np.ones(6, np.int32), np.zeros(6, np.int32)], ids=["all positive", "all negative"])
def test_degenerate_auroc_targets_raise_like_jax(t):
    p = np.linspace(0.1, 0.9, 6).astype(np.float32)
    assert _error(auroc, _tt(p), _tt(t), pos_label=1) == _error(jax_auroc, jnp.asarray(p), jnp.asarray(t), pos_label=1)


def test_auroc_mode_change_raises_like_jax():
    p1, t1 = _batches("binary", seed=21, n_batches=1)[0]
    p2, t2 = _batches("multilabel", seed=21, n_batches=1)[0]
    ours = AUROC(device=CPU, compute_on_step=False)
    ref = jm.AUROC(compute_on_step=False)
    ours.update(_tt(p1), _tt(t1))
    ref.update(jnp.asarray(p1), jnp.asarray(t1))
    assert _error(ours.update, _tt(p2), _tt(t2)) == _error(ref.update, jnp.asarray(p2), jnp.asarray(t2))


def test_branches_left_for_later_slices_raise_not_implemented():
    """The curve-path branches once left for later slices now match the JAX
    package: its error for multi-class scores without `num_classes`, its
    values with `max_fpr` and `sample_weights`."""
    p3, t3 = _batches("multiclass_probs", seed=22, n_batches=1)[0]
    assert _error(auroc, _tt(p3), _tt(t3)) == _error(jax_auroc, jnp.asarray(p3), jnp.asarray(t3))
    p1, t1 = _batches("binary", seed=22, n_batches=1)[0]
    for kwargs in ({"max_fpr": 0.5}, {"sample_weights": [1.0] * len(t1)}):
        want = float(jax_auroc(jnp.asarray(p1), jnp.asarray(t1), **kwargs))
        assert abs(float(auroc(_tt(p1), _tt(t1), **kwargs)) - want) < AUROC_TOL
    # invalid arguments stay ValueErrors, as in the JAX package
    assert _error(auroc, _tt(p1), _tt(t1), max_fpr=2.0) == _error(jax_auroc, jnp.asarray(p1), jnp.asarray(t1), max_fpr=2.0)


def test_compute_on_step_false_returns_none_and_accumulates():
    m = Accuracy(device=CPU, compute_on_step=False)
    batches = _batches("binary", seed=23)
    for p, t in batches:
        assert m(_tt(p), _tt(t)) is None
    ref = jm.Accuracy()
    for p, t in batches:
        ref.update(jnp.asarray(p), jnp.asarray(t))
    assert float(m.compute()) == float(ref.compute())


def test_compute_caches_until_the_next_update():
    m = Accuracy(device=CPU)
    p, t = _batches("binary", seed=24, n_batches=1)[0]
    m.update(_tt(p), _tt(t))
    first = m.compute()
    assert m.compute() is first
    m.update(_tt(p), _tt(t))
    assert m.compute() is not first


def test_pickle_round_trip_mid_accumulation():
    ours, ref = _collections()
    batches = _batches("binary", seed=25, n_batches=4, n=300)
    for p, t in batches[:2]:
        ours(_tt(p), _tt(t))
    restored = pickle.loads(pickle.dumps(ours))
    for p, t in batches[2:]:
        ours(_tt(p), _tt(t))
        restored(_tt(p), _tt(t))
    for p, t in batches:
        ref(jnp.asarray(p), jnp.asarray(t))
    _close(restored.compute(), ref.compute())
    _close(ours.compute(), ref.compute())


def test_state_dict_round_trip_and_strict_load():
    ours, _ = _collections()
    ours.persistent(True)
    for p, t in _batches("binary", seed=26, n_batches=3, n=300):
        ours(_tt(p), _tt(t))
    saved = ours.state_dict()
    assert sorted(saved) == ["AUROC.preds", "AUROC.target", "Accuracy.correct", "Accuracy.total"]
    fresh, _ = _collections()
    fresh.load_state_dict(saved, strict=True)
    _close(fresh.compute(), ours.compute())
    # loaded state owns its tensors
    assert fresh["Accuracy"].correct.data_ptr() != ours["Accuracy"].correct.data_ptr()
    with pytest.raises(KeyError, match="missing"):
        _collections()[0].load_state_dict({"Accuracy.correct": saved["Accuracy.correct"]}, strict=True)
    with pytest.raises(KeyError, match="no member"):
        _collections()[0].load_state_dict({**saved, "Other.x": torch.zeros(())}, strict=True)
    with pytest.warns(UserWarning, match="nothing was loaded"):
        _collections()[0].load_state_dict({"typo.correct": torch.zeros(())}, prefix="val/")


def test_non_persistent_states_stay_out_of_the_state_dict():
    m = Accuracy(device=CPU)
    assert m.state_dict() == {}
    m.persistent(True)
    assert sorted(m.state_dict()) == ["correct", "total"]


def test_state_from_jax_carries_an_epoch_across():
    ours, ref = _collections()
    ref.persistent(True)
    for p, t in _batches("binary", seed=27, n_batches=5, n=600):
        ref(jnp.asarray(p), jnp.asarray(t))
    jax_state = {
        k: [np.asarray(x) for x in v] if isinstance(v, list) else np.asarray(v)
        for k, v in ref.state_dict().items()
    }
    carried = state_from_jax(jax_state)
    assert isinstance(carried["AUROC.preds"], list) and isinstance(carried["Accuracy.correct"], torch.Tensor)
    assert carried["AUROC.target"][0].dtype == torch.int32
    ours.load_state_dict(carried, strict=True)
    assert ours["AUROC"].mode == "binary"
    _close(ours.compute(), ref.compute())


def test_state_from_jax_keeps_bfloat16_states():
    ref = jm.Accuracy()
    p, t = _batches("binary", seed=31, n_batches=1)[0]
    ref.update(jnp.asarray(p), jnp.asarray(t))
    ref.astype(jnp.bfloat16)
    ref.persistent(True)
    carried = state_from_jax({k: np.asarray(v) for k, v in ref.state_dict().items()})
    assert carried["correct"].dtype == torch.bfloat16
    ours = Accuracy(device=CPU).astype(torch.bfloat16)
    ours.load_state_dict(carried, strict=True)
    assert float(ours.correct) == float(ref.correct) and float(ours.compute()) == float(ref.compute())


class _ThreadWorld(SyncBackend):
    """All-gather across simulated ranks, one thread each: the k-th gather of
    every rank writes slot k and waits for the others."""

    def __init__(self, world_size: int):
        self._world = world_size
        self._barrier = threading.Barrier(world_size)
        self._slots = {}
        self._calls = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    @property
    def world_size(self) -> int:
        return self._world

    def gather(self, x, group=None):
        rank = self._local.rank
        with self._lock:
            call = self._calls.get(rank, 0)
            self._calls[rank] = call + 1
            slot = self._slots.setdefault(call, [None] * self._world)
        slot[rank] = x
        self._barrier.wait(timeout=60)
        return list(slot)


def _run_ranks(world, fn):
    results, errors = {}, []

    def target(rank):
        world._local.rank = rank
        try:
            results[rank] = fn(rank)
        except BaseException as err:  # reported below, in the test's thread
            errors.append(err)
            world._barrier.abort()

    threads = [threading.Thread(target=target, args=(r,)) for r in range(world.world_size)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    return results


def test_two_rank_sync_equals_compute_on_all_batches():
    batches = _batches("binary", seed=28, n_batches=4, n=500)
    shards = {0: batches[0::2], 1: batches[1::2]}
    world = _ThreadWorld(2)

    def rank_fn(rank):
        coll = MetricCollection([Accuracy(device=CPU), AUROC(pos_label=1, device=CPU)])
        for p, t in shards[rank]:
            coll.update(_tt(p), _tt(t))
        out = {k: float(v) for k, v in coll.compute().items()}
        # the local accumulation is restored after the synced compute
        assert float(coll["Accuracy"].total) == sum(len(t) for _, t in shards[rank])
        return out

    prev = set_sync_backend(world)
    try:
        results = _run_ranks(world, rank_fn)
    finally:
        set_sync_backend(prev)
    single, ref = _collections()
    for p, t in batches:
        single.update(_tt(p), _tt(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    want = {k: float(v) for k, v in single.compute().items()}
    assert results[0] == results[1]
    assert results[0]["Accuracy"] == want["Accuracy"]
    assert abs(results[0]["AUROC"] - want["AUROC"]) < AUROC_TOL
    _close(results[0], {k: float(v) for k, v in ref.compute().items()})


def test_custom_dist_sync_fn_is_used():
    calls = []

    def twice(x, group=None):
        calls.append(group)
        return [x, x]

    m = Accuracy(device=CPU, dist_sync_fn=twice, process_group="g")
    p, t = _batches("binary", seed=29, n_batches=1)[0]
    m.update(_tt(p), _tt(t))
    value = m.compute()
    assert calls == ["g", "g"]
    assert float(value) == float(jax_accuracy(jnp.asarray(p), jnp.asarray(t)))
    assert float(m.total) == len(t)  # unsynced state restored


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Accuracy()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AUROC(pos_label=1)


def test_inputs_move_to_the_metric_device_and_states_follow_to():
    m = Accuracy(device=CPU)
    assert m.correct.device.type == "cpu" and m.device == torch.device("cpu")
    m.to("cpu")
    assert m.correct.device.type == "cpu"
    m.astype(torch.float64)
    p, t = _batches("binary", seed=30, n_batches=1)[0]
    m(_tt(p), _tt(t))
    assert m.correct.dtype == torch.float64 and m._defaults["correct"].dtype == torch.float64
    m.reset()
    assert m.correct.dtype == torch.float64 and float(m.correct) == 0.0


def test_reset_never_aliases_the_default():
    m = Accuracy(device=CPU)
    m.correct.add_(5)  # an in-place update, as a user's metric might do
    m.reset()
    assert float(m.correct) == 0.0


def test_add_state_rejects_bad_defaults():
    class Bad(Metric):
        def update(self):
            pass

        def compute(self):
            pass

    bad = Bad(device=CPU)
    with pytest.raises(ValueError, match="state variable must be a tensor"):
        bad.add_state("x", [torch.zeros(1)])
    with pytest.raises(ValueError, match="state variable must be a tensor"):
        bad.add_state("x", 3.0)
    with pytest.raises(ValueError, match="dist_reduce_fx"):
        bad.add_state("x", torch.zeros(()), dist_reduce_fx="median")


def test_filter_kwargs_routes_by_update_signature():
    m = Accuracy(device=CPU)
    assert m._filter_kwargs(preds=1, target=2, extra=3) == {"preds": 1, "target": 2}
    assert m._filter_kwargs(extra=3) == {"extra": 3}
