"""Metric arithmetic (``CompositionalMetric``) of the port against the JAX package.

Every case of ``tests/bases/test_composition.py`` is mirrored on the CPU:
the same expression is built from the JAX package's metrics and from the
port's (``device="cpu"``), and both must give the expected value. Beyond
those: every operator and reflected operator, ``%`` as ``fmod`` (the sign
follows the dividend), unary ``-`` as ``-abs``, ``__getitem__``, sequence
operands raising, ``forward`` preserving the operands' accumulation,
pickling mid-epoch, ``state_dict`` round trips (and a JAX composite's state
through ``state_from_jax``), ``to`` / ``astype`` / ``persistent`` /
``reset`` recursion, the zero-match warning, and identity hashing now that
``==`` builds a composite. Values are exact, or within 1e-6 where a float32
sum is taken in another order.
"""
import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu_torch as tm
from metrics_tpu.metric import Metric as JaxMetric
from metrics_tpu_torch import CompositionalMetric, Metric
from metrics_tpu_torch.interop import state_from_jax

CPU = "cpu"
TOL = 1e-6


class DummyMetric(Metric):
    def __init__(self, val_to_return):
        super().__init__(device=CPU)
        self.add_state("_num_updates", torch.tensor(0), dist_reduce_fx="sum")
        self._val_to_return = val_to_return

    def update(self, *args, **kwargs) -> None:
        self._num_updates = self._num_updates + 1

    def compute(self):
        return torch.tensor(self._val_to_return)


class JaxDummyMetric(JaxMetric):
    def __init__(self, val_to_return):
        super().__init__()
        self.add_state("_num_updates", jnp.asarray(0), dist_reduce_fx="sum")
        self._val_to_return = val_to_return

    def update(self, *args, **kwargs) -> None:
        self._num_updates = self._num_updates + 1

    def compute(self):
        return jnp.asarray(self._val_to_return)


class DummyMetricSum(Metric):
    def __init__(self):
        super().__init__(device=CPU)
        self.add_state("x", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, x):
        self.x = self.x + x

    def compute(self):
        return self.x


def _both(build):
    """``build(make, const)`` with each package's dummy metric and tensor
    constructor; updates both once and returns their computes."""
    ours = build(DummyMetric, torch.tensor)
    ref = build(JaxDummyMetric, jnp.asarray)
    assert isinstance(ours, CompositionalMetric)
    ours.update()
    ref.update()
    return ours.compute(), ref.compute()


def _check(build, expected):
    ours, ref = _both(build)
    assert np.allclose(expected, np.asarray(ours))
    assert np.allclose(np.asarray(ours), np.asarray(ref))
    assert np.asarray(ours).dtype.kind == np.asarray(ref).dtype.kind


# ---- tests/bases/test_composition.py, case by case ----------------------------
# an operand is ("m", v): a dummy metric returning v, ("t", v): a tensor, or a number


def _operand(spec, make, const):
    if isinstance(spec, tuple):
        kind, v = spec
        return make(v) if kind == "m" else const(v)
    return spec


@pytest.mark.parametrize("second, expected", [(("m", 2), 4), (2, 4), (2.0, 4.0), (("t", 2), 4)])
def test_metrics_add(second, expected):
    _check(lambda make, const: make(2) + _operand(second, make, const), expected)
    _check(lambda make, const: _operand(second, make, const) + make(2), expected)


@pytest.mark.parametrize("second, expected", [(("m", 3), 2), (3, 2), (3.0, 2.0)])
def test_metrics_floordiv(second, expected):
    _check(lambda make, const: make(8) // _operand(second, make, const), expected)


@pytest.mark.parametrize("second, expected", [(("m", 2), 6), (2, 6), (2.0, 6.0)])
def test_metrics_mul(second, expected):
    _check(lambda make, const: make(3) * _operand(second, make, const), expected)
    _check(lambda make, const: _operand(second, make, const) * make(3), expected)


@pytest.mark.parametrize("second, expected", [(("m", 2), 1), (2, 1), (2.0, 1.0)])
def test_metrics_mod(second, expected):
    _check(lambda make, const: make(5) % _operand(second, make, const), expected)


@pytest.mark.parametrize("second, expected", [(("m", 2), 4), (2, 4), (2.0, 4.0)])
def test_metrics_pow(second, expected):
    _check(lambda make, const: make(2) ** _operand(second, make, const), expected)


@pytest.mark.parametrize("first, expected", [(5, 2), (5.0, 2.0)])
def test_metrics_rfloordiv(first, expected):
    _check(lambda make, const: first // make(2), expected)


@pytest.mark.parametrize("first, expected", [(2, 8), (2.0, 8.0)])
def test_metrics_rpow(first, expected):
    _check(lambda make, const: first ** make(3), expected)


@pytest.mark.parametrize("first, expected", [(3, 1), (3.0, 1.0)])
def test_metrics_rsub(first, expected):
    _check(lambda make, const: first - make(2), expected)


@pytest.mark.parametrize("first, expected", [(6, 2.0), (6.0, 2.0)])
def test_metrics_rtruediv(first, expected):
    _check(lambda make, const: first / make(3), expected)


@pytest.mark.parametrize("second, expected", [(("m", 2), 1), (2, 1), (2.0, 1.0)])
def test_metrics_sub(second, expected):
    _check(lambda make, const: make(3) - _operand(second, make, const), expected)


@pytest.mark.parametrize("second, expected", [(("m", 3), 2.0), (3, 2.0), (3.0, 2.0)])
def test_metrics_truediv(second, expected):
    _check(lambda make, const: make(6) / _operand(second, make, const), expected)


@pytest.mark.parametrize("second, expected", [(("m", 1), 0), (1, 0)])
def test_metrics_xor(second, expected):
    _check(lambda make, const: make(1) ^ _operand(second, make, const), expected)
    _check(lambda make, const: _operand(second, make, const) ^ make(1), expected)


@pytest.mark.parametrize("second, expected", [(("m", 1), 1), (1, 1)])
def test_metrics_and_or(second, expected):
    _check(lambda make, const: make(1) & _operand(second, make, const), expected)
    _check(lambda make, const: make(1) | _operand(second, make, const), expected)
    _check(lambda make, const: _operand(second, make, const) & make(1), expected)
    _check(lambda make, const: _operand(second, make, const) | make(1), expected)


@pytest.mark.parametrize("second, expected", [(("m", 2), False), (2, False), (2.0, False)])
def test_metrics_eq_ne(second, expected):
    _check(lambda make, const: make(3) == _operand(second, make, const), expected)
    _check(lambda make, const: make(3) != _operand(second, make, const), not expected)


@pytest.mark.parametrize("second", [("m", 2), 2, 2.0])
def test_metrics_comparisons(second):
    _check(lambda make, const: make(3) > _operand(second, make, const), True)
    _check(lambda make, const: make(3) >= _operand(second, make, const), True)
    _check(lambda make, const: make(3) < _operand(second, make, const), False)
    _check(lambda make, const: make(3) <= _operand(second, make, const), False)


def test_metrics_abs_neg_pos_invert():
    _check(lambda make, const: abs(make(-2)), 2)
    _check(lambda make, const: -make(-2), -2)  # -abs(x)
    _check(lambda make, const: -make(2), -2)
    _check(lambda make, const: +make(-2), 2)
    _check(lambda make, const: ~make(1), -2)  # bitwise_not(1) == -2


def test_metrics_matmul():
    _check(lambda make, const: make([2, 2, 2]) @ const([4, 4, 4]), 24)
    _check(lambda make, const: const([4, 4, 4]) @ make([2, 2, 2]), 24)


def test_metrics_getitem():
    _check(lambda make, const: make([1, 2, 3])[1], 2)
    _check(lambda make, const: make([[1, 2], [3, 4]])[:, 1], [2, 4])


@pytest.mark.parametrize("dividend, divisor", [(-7.0, 3), (7.0, -3), (-7, 3), (5.5, 2.0)])
def test_mod_is_fmod_whose_sign_follows_the_dividend(dividend, divisor):
    expected = np.fmod(dividend, divisor)
    _check(lambda make, const: make(dividend) % divisor, expected)
    _check(lambda make, const: dividend % make(divisor), expected)
    _check(lambda make, const: make(dividend) % make(divisor), expected)


def test_compositional_metrics_update():
    compos = DummyMetric(5) + DummyMetric(4)
    assert isinstance(compos, CompositionalMetric)
    for _ in range(3):
        compos.update()
    assert isinstance(compos.metric_a, DummyMetric) and isinstance(compos.metric_b, DummyMetric)
    assert compos.metric_a._num_updates == 3
    assert compos.metric_b._num_updates == 3


def test_compositional_reset():
    compos = DummyMetric(5) + DummyMetric(4)
    compos.update()
    compos.reset()
    assert compos.metric_a._num_updates == 0
    assert compos.metric_b._num_updates == 0


def test_update_filters_kwargs_per_operand():
    class Scaled(DummyMetricSum):
        def update(self, x, scale=1.0):
            self.x = self.x + x * scale

    class Shifted(DummyMetricSum):
        def update(self, x, offset=0.0):
            self.x = self.x + x + offset

    comp = Scaled() + Shifted()
    comp.update(torch.tensor(2.0), scale=3.0, offset=1.0)
    assert float(comp.metric_a.x) == 6.0 and float(comp.metric_b.x) == 3.0
    assert float(comp.compute()) == 9.0


def _four_class_batches():
    rng = np.random.RandomState(51)
    probs = rng.rand(3, 64, 4).astype(np.float32)
    probs /= probs.sum(axis=2, keepdims=True)
    return probs, rng.randint(4, size=(3, 64))


def test_forward_preserves_operand_accumulation():
    """The snapshot/reset/restore cycle of forward recurses into the
    operands: each step value is the batch's, the epoch value every batch's."""
    probs, labels = _four_class_batches()
    comp, ref = tm.Accuracy(device=CPU) + 0.0, jm.Accuracy() + 0.0
    for i in range(3):
        step = comp(torch.from_numpy(probs[i]), torch.from_numpy(labels[i]))
        assert abs(float(step) - np.mean(probs[i].argmax(1) == labels[i])) < TOL
        assert float(step) == float(ref(jnp.asarray(probs[i]), jnp.asarray(labels[i])))
    want = np.mean(probs.reshape(-1, 4).argmax(1) == labels.reshape(-1))
    assert abs(float(comp.compute()) - want) < TOL
    assert float(comp.compute()) == float(ref.compute())


def test_forward_of_a_macro_mean_of_precision_and_recall_keeps_the_epoch():
    probs, labels = _four_class_batches()
    comp = (tm.Precision(num_classes=4, average="macro", device=CPU)
            + tm.Recall(num_classes=4, average="macro", device=CPU)) / 2
    ref = (jm.Precision(num_classes=4, average="macro") + jm.Recall(num_classes=4, average="macro")) / 2
    for i in range(3):
        step = comp(torch.from_numpy(probs[i]), torch.from_numpy(labels[i]))
        assert abs(float(step) - float(ref(jnp.asarray(probs[i]), jnp.asarray(labels[i])))) < TOL
    epoch = (tm.Precision(num_classes=4, average="macro", device=CPU)
             + tm.Recall(num_classes=4, average="macro", device=CPU)) / 2
    epoch.update(torch.from_numpy(probs.reshape(-1, 4)), torch.from_numpy(labels.reshape(-1)))
    assert abs(float(comp.compute()) - float(epoch.compute())) < TOL
    assert abs(float(comp.compute()) - float(ref.compute())) < TOL


def test_epoch_compute_not_served_from_batch_local_cache():
    rng = np.random.RandomState(53)
    probs = (np.floor(rng.rand(64, 3) * 16) / 16).astype(np.float32)
    target = rng.randint(2, size=64)  # class 2 never occurs
    comp = tm.BinnedAUROC(num_bins=16, num_classes=3, average="macro", device=CPU) + 0.0
    ref = jm.BinnedAUROC(num_bins=16, num_classes=3, average="macro") + 0.0
    step = comp(torch.from_numpy(probs), torch.from_numpy(target))
    assert np.isfinite(float(step))  # tolerant batch-local value
    assert abs(float(step) - float(ref(jnp.asarray(probs), jnp.asarray(target)))) < TOL
    with pytest.raises(ValueError, match="never occurred"):
        comp.compute()  # epoch-end keeps the loud failure


def test_composite_pickles_mid_accumulation():
    expr = 2 * tm.MeanSquaredError(device=CPU) + abs(tm.MeanAbsoluteError(device=CPU)) / 4 - 1
    ref = 2 * jm.MeanSquaredError() + abs(jm.MeanAbsoluteError()) / 4 - 1
    expr.update(torch.tensor([1.0, 2.0]), torch.tensor([1.5, 3.0]))
    ref.update(jnp.asarray([1.0, 2.0]), jnp.asarray([1.5, 3.0]))
    clone = pickle.loads(pickle.dumps(expr))
    assert float(clone.compute()) == float(expr.compute()) == float(ref.compute())
    # the clone keeps accumulating on its own
    clone.update(torch.tensor([0.0]), torch.tensor([4.0]))
    assert float(clone.compute()) != float(expr.compute())
    comp = pickle.loads(pickle.dumps(DummyMetricSum() % 3))
    comp.metric_a.update(torch.tensor(-7.0))
    assert float(comp.compute()) == -1.0


def test_sequence_valued_operand_raises():
    preds, target = [0.2, 0.8, 0.5, 0.7], [0, 1, 0, 1]
    for build in (lambda pkg, kw: pkg.ROC(**kw) + pkg.ROC(**kw), lambda pkg, kw: 2 * pkg.ROC(**kw),
                  lambda pkg, kw: pkg.ROC(**kw) == pkg.ROC(**kw), lambda pkg, kw: pkg.ROC(**kw) < 1):
        for pkg, kw, arr in ((tm, {"device": CPU}, torch.tensor), (jm, {}, jnp.asarray)):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                comp = build(pkg, kw)
                comp.update(arr(preds), arr(target))
                with pytest.raises(TypeError, match="tuple/list-valued"):
                    comp.compute()
    # indexing a curve metric stays supported
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fpr = tm.ROC(device=CPU)[0]
        fpr.update(torch.tensor(preds), torch.tensor(target))
        ref = jm.ROC()[0]
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        assert fpr.compute().ndim == 1
        np.testing.assert_allclose(fpr.compute().numpy(), np.asarray(ref.compute()), rtol=0, atol=TOL)


def test_state_dict_round_trip_and_prefixes():
    comp = tm.MeanSquaredError(device=CPU) + tm.MeanAbsoluteError(device=CPU)
    comp.persistent(True)
    comp.update(torch.tensor([1.0, 2.0, 4.0]), torch.tensor([1.5, 3.0, 3.0]))
    state = comp.state_dict()
    assert sorted(state) == ["metric_a.sum_squared_error", "metric_a.total", "metric_b.sum_abs_error",
                             "metric_b.total"]
    fresh = tm.MeanSquaredError(device=CPU) + tm.MeanAbsoluteError(device=CPU)
    fresh.load_state_dict(state, strict=True)
    assert float(fresh.compute()) == float(comp.compute())
    # under a container prefix too
    fresh = tm.MeanSquaredError(device=CPU) + tm.MeanAbsoluteError(device=CPU)
    fresh.load_state_dict(comp.state_dict(prefix="outer."), prefix="outer.")
    assert float(fresh.compute()) == float(comp.compute())
    with pytest.raises(KeyError, match="missing"):
        (tm.MeanSquaredError(device=CPU) + 1).load_state_dict({"metric_a.total": torch.tensor(1.0)}, strict=True)


def test_load_state_dict_warns_once_when_nothing_matches():
    comp = tm.MeanSquaredError(device=CPU) * tm.MeanAbsoluteError(device=CPU)
    with pytest.warns(UserWarning, match="no operand state of this CompositionalMetric"):
        comp.load_state_dict({"metric_c.total": torch.tensor(1.0)}, prefix="unique-prefix-for-this-test.")
    # one operand matching is legitimate partial persistence: no warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        comp.load_state_dict({"metric_a.total": torch.tensor(2.0)})
    assert float(comp.metric_a.total) == 2.0


def test_state_from_jax_carries_a_jax_composite():
    rng = np.random.RandomState(3)
    preds, target = rng.rand(3, 50).astype(np.float32), rng.rand(3, 50).astype(np.float32)
    ref = (jm.MeanSquaredError() + jm.MeanAbsoluteError()) / 2
    for b in range(3):
        ref.update(jnp.asarray(preds[b]), jnp.asarray(target[b]))
    ref.persistent(True)
    state = {k: np.asarray(v) for k, v in ref.state_dict().items()}
    ours = (tm.MeanSquaredError(device=CPU) + tm.MeanAbsoluteError(device=CPU)) / 2
    ours.load_state_dict(state_from_jax(state), strict=True)
    assert abs(float(ours.compute()) - float(ref.compute())) < TOL
    ours.update(torch.from_numpy(preds[0]), torch.from_numpy(target[0]))
    ref.update(jnp.asarray(preds[0]), jnp.asarray(target[0]))
    assert abs(float(ours.compute()) - float(ref.compute())) < TOL


def test_to_astype_and_persistent_recurse():
    comp = tm.MeanSquaredError(device=CPU) - torch.tensor(1.0)
    assert comp.device == torch.device(CPU)
    comp.to(CPU)
    assert comp.metric_a.device == torch.device(CPU) and comp.metric_b.device == torch.device(CPU)
    comp.astype(torch.float64)
    assert comp.metric_a.sum_squared_error.dtype == torch.float64
    comp.update(torch.tensor([1.0, 3.0], dtype=torch.float64), torch.tensor([2.0, 1.0], dtype=torch.float64))
    assert float(comp.compute()) == 1.5
    comp.persistent(True)
    assert comp.metric_a._persistent["sum_squared_error"]
    assert sorted(k for k, _ in comp._named_states()) == ["metric_a.sum_squared_error", "metric_a.total"]


def test_repr():
    text = repr(tm.MeanSquaredError(device=CPU) + 2)
    assert text == "CompositionalMetric(\n  _add(\n    MeanSquaredError(),\n    2\n  )\n)"
    assert text == repr(jm.MeanSquaredError() + 2)


def test_hash_is_identity_so_metrics_stay_usable_as_keys():
    a, b = tm.MeanSquaredError(device=CPU), tm.MeanSquaredError(device=CPU)
    assert hash(a) != hash(b) and hash(a) == hash(a)
    table = {a: "a", b: "b"}
    assert table[a] == "a" and table[b] == "b"
    assert len({a, b, a}) == 2
    assert isinstance(a == b, CompositionalMetric)
    assert any(m is a for m in [b, a]) and not any(m is a for m in [b])


def test_composite_device_follows_its_metric_operand():
    assert (3 * tm.MeanSquaredError(device=CPU)).device == torch.device(CPU)
    assert (torch.tensor(3.0) - tm.MeanSquaredError(device=CPU)).metric_a.device == torch.device(CPU)
