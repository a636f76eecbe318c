"""The port's shared utilities and input canonicalization against the JAX
package's, on the same seeded numpy inputs: every output must be equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.utilities import checks as jchecks
from metrics_tpu.utilities import data as jdata
from metrics_tpu.utilities import distributed as jdist
from metrics_tpu_torch.utilities import checks, data, distributed
from metrics_tpu_torch.utilities.enums import DataType


def _np(x):
    return np.asarray(x)


def _softmax(x):
    e = np.exp(x - x.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


R = np.random.default_rng(0)


@pytest.mark.parametrize("labels, num_classes", [
    (R.integers(0, 4, 20), None), (R.integers(0, 3, (6, 5)), 5), (np.array([0, 0, 0]), 2),
])
def test_to_onehot_matches_jax(labels, num_classes):
    labels = labels.astype(np.int32)
    got = data.to_onehot(torch.from_numpy(labels), num_classes)
    want = jdata.to_onehot(jnp.asarray(labels), num_classes)
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("x, k, dim", [
    (np.array([[1.0, 1.0, 0.5], [0.2, 0.2, 0.2]], np.float32), 1, 1),  # ties: lower index first
    (np.array([[1.0, 1.0, 0.5, 1.0]], np.float32), 2, 1),
    (R.random((7, 5, 3)).astype(np.float32), 2, 1),
    (R.random((4, 6)).astype(np.float32), 3, 0),
])
def test_select_topk_matches_jax(x, k, dim):
    got = data.select_topk(torch.from_numpy(x), k, dim)
    want = jdata.select_topk(jnp.asarray(x), k, dim)
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("name", ["dim_zero_sum", "dim_zero_mean", "dim_zero_min", "dim_zero_max"])
def test_dim_zero_reductions_match_jax(name):
    x = R.random((4, 3)).astype(np.float32)
    np.testing.assert_allclose(getattr(data, name)(torch.from_numpy(x)).numpy(),
                               _np(getattr(jdata, name)(jnp.asarray(x))), rtol=1e-6)


def test_dim_zero_cat_matches_jax():
    parts = [np.float32(1.5), R.random(3).astype(np.float32), R.random(2).astype(np.float32)]
    got = data.dim_zero_cat([torch.tensor(p) for p in parts])
    want = jdata.dim_zero_cat([jnp.asarray(p) for p in parts])
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_get_num_classes_matches_jax_and_warns():
    p, t = np.array([0, 2, 1]), np.array([0, 1, 3])
    assert data.get_num_classes(torch.tensor(p), torch.tensor(t)) == jdata.get_num_classes(jnp.asarray(p), jnp.asarray(t)) == 4
    with pytest.warns(RuntimeWarning, match="different from predicted"):
        assert data.get_num_classes(torch.tensor(p), torch.tensor(t), num_classes=6) == 6


@pytest.mark.parametrize("reduction", ["elementwise_mean", "none", "sum"])
def test_reduce_matches_jax(reduction):
    x = R.random(7).astype(np.float32)
    np.testing.assert_allclose(distributed.reduce(torch.from_numpy(x), reduction).numpy(),
                               _np(jdist.reduce(jnp.asarray(x), reduction)), rtol=1e-6)


@pytest.mark.parametrize("class_reduction", ["micro", "macro", "weighted", "none", None])
def test_class_reduce_matches_jax(class_reduction):
    num = np.array([1.0, 0.0, 3.0, 2.0], np.float32)
    denom = np.array([2.0, 0.0, 4.0, 5.0], np.float32)  # a 0/0 class → NaN → 0
    weights = np.array([1, 0, 3, 2], np.int32)
    got = distributed.class_reduce(torch.from_numpy(num), torch.from_numpy(denom), torch.from_numpy(weights), class_reduction)
    want = jdist.class_reduce(jnp.asarray(num), jnp.asarray(denom), jnp.asarray(weights), class_reduction)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6)


def test_reduction_errors_match_jax():
    x = torch.ones(3)
    with pytest.raises(ValueError, match="Reduction parameter unknown"):
        distributed.reduce(x, "median")
    with pytest.raises(ValueError) as ours:
        distributed.class_reduce(x, x, x, "median")
    with pytest.raises(ValueError) as ref:
        jdist.class_reduce(jnp.ones(3), jnp.ones(3), jnp.ones(3), "median")
    assert str(ours.value) == str(ref.value)


def _case(name):
    n = 12
    if name == "binary":
        return R.random(n).astype(np.float32), R.integers(0, 2, n).astype(np.int32)
    if name == "binary (N, 1)":
        return R.random((n, 1)).astype(np.float32), R.integers(0, 2, (n, 1)).astype(np.int32)
    if name == "multiclass probs":
        return _softmax(R.standard_normal((n, 4))), R.integers(0, 4, n).astype(np.int32)
    if name == "two-class probs":
        return _softmax(R.standard_normal((n, 2))), R.integers(0, 2, n).astype(np.int32)
    if name == "multiclass labels":
        return R.integers(0, 4, n).astype(np.int32), R.integers(0, 4, n).astype(np.int32)
    if name == "multilabel":
        return R.random((n, 3)).astype(np.float32), R.integers(0, 2, (n, 3)).astype(np.int32)
    if name == "multidim probs":
        return _softmax(R.standard_normal((n, 3, 5))), R.integers(0, 3, (n, 5)).astype(np.int32)
    if name == "multidim labels":
        return R.integers(0, 3, (n, 5)).astype(np.int32), R.integers(0, 3, (n, 5)).astype(np.int32)
    raise ValueError(name)


CANON_CASES = [
    ("binary", {}),
    ("binary", {"threshold": 0.3}),
    ("binary", {"is_multiclass": True, "num_classes": 2}),
    ("binary (N, 1)", {}),
    ("multiclass probs", {}),
    ("multiclass probs", {"top_k": 2}),
    ("two-class probs", {"is_multiclass": False}),
    ("multiclass labels", {}),
    ("multiclass labels", {"num_classes": 6}),
    ("multilabel", {}),
    ("multilabel", {"top_k": 2}),
    ("multilabel", {"is_multiclass": True}),
    ("multidim probs", {}),
    ("multidim labels", {}),
    ("multidim labels", {"num_classes": 3}),
]


@pytest.mark.parametrize("name, kwargs", CANON_CASES, ids=[f"{c[0]}-{c[1]}" for c in CANON_CASES])
def test_input_format_classification_matches_jax(name, kwargs):
    p, t = _case(name)
    got_p, got_t, got_case = checks._input_format_classification(torch.from_numpy(p), torch.from_numpy(t), **kwargs)
    want_p, want_t, want_case = jchecks._input_format_classification(jnp.asarray(p), jnp.asarray(t), **kwargs)
    assert got_case == want_case and isinstance(got_case, DataType)
    assert got_p.dtype == got_t.dtype == torch.int32
    np.testing.assert_array_equal(got_p.numpy(), _np(want_p))
    np.testing.assert_array_equal(got_t.numpy(), _np(want_t))


def test_half_precision_probabilities_use_the_wider_sum_tolerance():
    p = _softmax(R.standard_normal((64, 8)))
    t = R.integers(0, 8, 64).astype(np.int32)
    got = checks._input_format_classification(torch.from_numpy(p).to(torch.bfloat16), torch.from_numpy(t))
    want = jchecks._input_format_classification(jnp.asarray(p).astype(jnp.bfloat16), jnp.asarray(t))
    np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))


def test_check_same_shape():
    checks._check_same_shape(torch.zeros(3), torch.ones(3))
    with pytest.raises(RuntimeError, match="same shape"):
        checks._check_same_shape(torch.zeros(3), torch.ones(4))
