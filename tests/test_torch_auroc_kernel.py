"""The port's exact AUROC/AP path (``metrics_tpu_torch.ops.auroc_kernel``)
against the JAX package and sklearn, on the CPU.

The sort key must be bit-identical to the JAX package's; the scores must
match the JAX functions (which run their CPU path here) and sklearn's
``roc_auc_score``/``average_precision_score`` at 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import average_precision_score, roc_auc_score

from metrics_tpu.ops import auroc_kernel as jak
from metrics_tpu_torch.ops import auroc_kernel as tak

TOL = 1e-5


def _special_floats():
    f32 = np.finfo(np.float32)
    rng = np.random.default_rng(0)
    special = np.array(
        [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1.0, -1.0, f32.max, -f32.max, f32.tiny, -f32.tiny,
         f32.smallest_subnormal, -f32.smallest_subnormal, f32.tiny / 2, -f32.tiny / 2, 0.5, -0.5],
        dtype=np.float32,
    )
    randoms = (rng.standard_normal(4000) * 10.0 ** rng.integers(-30, 30, 4000)).astype(np.float32)
    bits = rng.integers(0, 2**32, 4000, dtype=np.uint64).astype(np.uint32).view(np.float32)
    return np.concatenate([special, randoms, bits])


def test_descending_key_is_bit_identical_to_jax():
    x = _special_floats()
    want = np.asarray(jak._descending_key(jnp.asarray(x)))
    got = tak._descending_key(torch.from_numpy(x))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sortable_key_orders_like_the_uint32_key():
    x = _special_floats()
    u = tak._descending_key(torch.from_numpy(x)).numpy().astype(np.int64)
    s = tak._sortable_key(torch.from_numpy(x)).numpy().astype(np.int64)
    np.testing.assert_array_equal(s, u - 2**31)


def test_score_from_key_round_trips():
    x = _special_floats()
    key = tak._descending_key(torch.from_numpy(x))
    back = tak._score_from_key(key).numpy()
    nan = np.isnan(x)
    assert np.isnan(back[nan]).all()
    canon = np.where(x == 0, np.float32(0.0), x)  # -0.0 comes back as +0.0
    np.testing.assert_array_equal(back[~nan].view(np.uint32), canon[~nan].view(np.uint32))
    want = np.asarray(jak._score_from_key(jnp.asarray(key.numpy())))
    np.testing.assert_array_equal(back[~nan].view(np.uint32), want[~nan].view(np.uint32))


def _case(n, seed, ties):
    rng = np.random.default_rng(seed)
    preds = rng.random(n).astype(np.float32)
    if ties:
        preds = np.round(preds, 2).astype(np.float32)
    target = (rng.random(n) < preds).astype(np.int32)
    return preds, target


CASES = [(4, 1, False), (100, 2, True), (5000, 3, True), (33000, 4, False), (70000, 5, True)]


@pytest.mark.parametrize("n, seed, ties", CASES)
def test_binary_auroc_matches_jax_and_sklearn(n, seed, ties):
    preds, target = _case(n, seed, ties)
    got = tak.binary_auroc(torch.from_numpy(preds), torch.from_numpy(target))
    assert got.dtype == torch.float32 and got.shape == ()
    want_jax = float(jak.binary_auroc(jnp.asarray(preds), jnp.asarray(target)))
    assert abs(float(got) - want_jax) < TOL
    assert abs(float(got) - roc_auc_score(target, preds)) < TOL


@pytest.mark.parametrize("n, seed, ties", CASES)
def test_binary_average_precision_matches_jax_and_sklearn(n, seed, ties):
    preds, target = _case(n, seed, ties)
    got = float(tak.binary_average_precision(torch.from_numpy(preds), torch.from_numpy(target)))
    want_jax = float(jak.binary_average_precision(jnp.asarray(preds), jnp.asarray(target)))
    assert abs(got - want_jax) < TOL
    assert abs(got - average_precision_score(target, preds)) < TOL


@pytest.mark.parametrize("n, seed", [(1000, 6), (40000, 7)])
def test_masked_variants_match_jax_and_sklearn(n, seed):
    preds, target = _case(n, seed, ties=True)
    mask = np.random.default_rng(seed + 100).random(n) < 0.6
    garbage = np.where(mask, preds, np.float32(1e30)).astype(np.float32)
    args_t = (torch.from_numpy(garbage), torch.from_numpy(target), torch.from_numpy(mask))
    args_j = (jnp.asarray(garbage), jnp.asarray(target), jnp.asarray(mask))
    got_a = float(tak.masked_binary_auroc(*args_t))
    got_p = float(tak.masked_binary_average_precision(*args_t))
    assert abs(got_a - float(jak.masked_binary_auroc(*args_j))) < TOL
    assert abs(got_p - float(jak.masked_binary_average_precision(*args_j))) < TOL
    assert abs(got_a - roc_auc_score(target[mask], preds[mask])) < TOL
    assert abs(got_p - average_precision_score(target[mask], preds[mask])) < TOL


def test_pos_label_selects_the_positive_class():
    preds, target = _case(2000, 8, ties=True)
    labels = np.where(target == 1, 4, 9).astype(np.int32)
    got = float(tak.binary_auroc(torch.from_numpy(preds), torch.from_numpy(labels), pos_label=4))
    want = float(jak.binary_auroc(jnp.asarray(preds), jnp.asarray(labels), pos_label=4))
    assert abs(got - want) < TOL


def test_single_class_is_nan():
    preds = torch.tensor([0.1, 0.4, 0.35, 0.8])
    assert np.isnan(float(tak.binary_auroc(preds, torch.ones(4, dtype=torch.int64))))
    assert np.isnan(float(tak.binary_average_precision(preds, torch.zeros(4, dtype=torch.int64))))


def test_group_formulas_match_the_jax_epilogue():
    """The plain group formulas, term for term against the JAX XLA epilogue."""
    preds, target = _case(3000, 9, ties=True)
    rel = target.astype(np.float32)
    t = tak._tie_groups(*tak._co_sort(torch.from_numpy(preds), torch.from_numpy(rel)))
    j = jak._sorted_tie_groups(jnp.asarray(preds), jnp.asarray(rel))
    # tps/fps and the forward-filled *_prev are sums over whole tie groups,
    # so they agree at group ends whatever order the unstable sorts left
    # inside a group
    last_t, last_j = t[2].numpy(), np.asarray(j[2])
    np.testing.assert_array_equal(last_t, last_j)
    for a, b in zip(t[:2] + t[3:], j[:2] + j[3:]):
        np.testing.assert_array_equal(a.numpy()[last_t], np.asarray(b)[last_j])
    assert abs(float(tak._auroc_from_groups(*t)) - float(jak._auroc_from_groups(*j))) < 2e-6
    assert abs(float(tak._ap_from_groups(*t[:4])) - float(jak._ap_from_groups(*j[:4]))) < 2e-5


def test_non_cpu_non_cuda_tensors_raise():
    meta = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tak.binary_auroc(meta, torch.empty(4, device="meta"))
