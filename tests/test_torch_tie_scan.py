"""The port's tie-group scan (``metrics_tpu_torch.ops.tie_scan``) against the
JAX package's Pallas kernel, run in interpret mode on the same sorted stream.

Inputs are made with numpy from a seed; the JAX side co-sorts them
(``lax.sort`` of the u32 key and the ``rel + 2*weight`` payload) and both
packages reduce the identical sorted arrays. On the CPU the port's wrapper
runs its plain PyTorch version; the CUDA kernel itself is held against that
plain version on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
Tolerances are the JAX suite's own (``tests/ops/test_tie_scan_pallas.py``):
AUROC 2e-6, AP 2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from metrics_tpu.ops.auroc_kernel import _descending_key as jax_descending_key
from metrics_tpu.ops.tie_scan_pallas import auroc_ap_from_stats as jax_auroc_ap_from_stats
from metrics_tpu.ops.tie_scan_pallas import tie_group_reduce as jax_tie_group_reduce
from metrics_tpu_torch.ops.tie_scan import (
    auroc_ap_from_stats,
    tie_group_reduce,
    tie_group_reduce_reference,
)

AUROC_TOL = 2e-6
AP_TOL = 2e-5


def _sorted_stream(preds, rel, w=None):
    preds = jnp.asarray(preds, jnp.float32)
    rel = jnp.asarray(rel, jnp.float32)
    w = jnp.ones_like(rel) if w is None else jnp.asarray(w, jnp.float32)
    key_s, pay_s = lax.sort((jax_descending_key(preds), rel + 2.0 * w), num_keys=1, is_stable=False)
    return np.array(key_s), np.array(pay_s)  # writable copies for torch.from_numpy


def _both_stats(preds, rel, w=None, offsets=None):
    key_s, pay_s = _sorted_stream(preds, rel, w)
    jax_offsets = None if offsets is None else jnp.asarray(offsets, jnp.float32)
    want = np.asarray(jax_tie_group_reduce(jnp.asarray(key_s), jnp.asarray(pay_s), offsets=jax_offsets, interpret=True))
    got = tie_group_reduce(torch.from_numpy(key_s), torch.from_numpy(pay_s), offsets)
    return got, want


def _scores(stats_port, stats_jax):
    pa, pp = (float(x) for x in auroc_ap_from_stats(stats_port))
    ja, jp = (float(x) for x in jax_auroc_ap_from_stats(jnp.asarray(stats_jax)))
    return (pa, pp), (ja, jp)


def _assert_matches(preds, rel, w=None):
    got, want = _both_stats(preds, rel, w)
    assert got.dtype == torch.float32 and got.shape == (4,)
    # class totals are exact counts
    assert got[2].item() == want[2] and got[3].item() == want[3], (got, want)
    (pa, pp), (ja, jp) = _scores(got, want)
    assert (np.isnan(pa) and np.isnan(ja)) or abs(pa - ja) < AUROC_TOL, (pa, ja)
    assert (np.isnan(pp) and np.isnan(jp)) or abs(pp - jp) < AP_TOL, (pp, jp)


def test_canonical_four_points():
    _assert_matches([0.1, 0.4, 0.35, 0.8], [0, 0, 1, 1])


def test_all_one_tie_group():
    _assert_matches([0.5] * 6, [0, 1, 0, 1, 0, 1])


def test_degenerate_single_class_is_nan():
    got, _ = _both_stats([0.1, 0.4, 0.35, 0.8], [1, 1, 1, 1])
    auroc, ap = auroc_ap_from_stats(got)
    assert np.isnan(float(auroc)) and float(ap) == pytest.approx(1.0)
    _assert_matches([0.1, 0.4, 0.35, 0.8], [1, 1, 1, 1])
    _assert_matches([0.1, 0.4, 0.35, 0.8], [0, 0, 0, 0])


def test_signed_zeros_share_a_key():
    _assert_matches([0.0, -0.0, 0.0, -0.0], [1, 0, 1, 0])


@pytest.mark.parametrize("n", [1, 7, 100, 5000, 33000])
def test_tie_heavy_random(n):
    rng = np.random.default_rng(n)
    _assert_matches(np.round(rng.standard_normal(n), 1), rng.integers(0, 2, n))


def test_masked_elements_are_inert():
    rng = np.random.default_rng(3)
    n = 20000
    preds = np.round(rng.standard_normal(n), 1)
    rel = rng.integers(0, 2, n)
    mask = rng.random(n) < 0.7
    _assert_matches(preds, rel, mask)
    # masked-off entries must not influence the result, whatever their scores;
    # they only add zero terms at other positions of the same f64 sum
    garbage = preds.copy()
    garbage[~mask] = 1e30
    clean, _ = _both_stats(preds, rel, mask)
    dirty, _ = _both_stats(garbage, rel, mask)
    assert torch.equal(clean[2:], dirty[2:])
    assert abs(float(auroc_ap_from_stats(clean)[0]) - float(auroc_ap_from_stats(dirty)[0])) < 1e-7


def test_one_group_spanning_blocks():
    # 33k equal scores cross the 32768-element Pallas block boundary
    rng = np.random.default_rng(5)
    _assert_matches(np.zeros(33000), rng.integers(0, 2, 33000))


def test_exact_block_size_no_padding():
    rng = np.random.default_rng(6)
    _assert_matches(np.round(rng.standard_normal(32768), 2), rng.integers(0, 2, 32768))


@pytest.mark.parametrize("n, distinct", [(1000, 0), (3000, 5)])
def test_offsets_match_the_pallas_kernel(n, distinct):
    """The sample-sort extension: off_p/off_n shift the AP precision ratio
    and leave the area local, exactly as in the Pallas kernel."""
    rng = np.random.RandomState(13 + n)
    p = rng.rand(n).astype(np.float32)
    if distinct:
        p = (np.floor(p * distinct) / distinct).astype(np.float32)  # tie storm
    rel = (rng.rand(n) < 0.4).astype(np.float32)
    for off_p, off_n in [(0, 0), (1234, 777), (10_000_000, 3)]:
        got, want = _both_stats(p, rel, offsets=[off_p, off_n])
        assert np.isclose(float(got[0]), float(want[0]), rtol=1e-6), (off_p, got, want)
        assert np.isclose(float(got[1]), float(want[1]), rtol=1e-5), (off_p, got, want)
        assert got[2].item() == want[2] and got[3].item() == want[3]


def test_offsets_as_tensor_or_pair_agree():
    key_s, pay_s = _sorted_stream([0.2, 0.2, 0.7, 0.1], [1, 0, 1, 0])
    key_t, pay_t = torch.from_numpy(key_s), torch.from_numpy(pay_s)
    a = tie_group_reduce(key_t, pay_t, offsets=(5.0, 2.0))
    b = tie_group_reduce(key_t, pay_t, offsets=torch.tensor([5.0, 2.0]))
    assert torch.equal(a, b)


def test_int32_keys_give_the_uint32_result():
    """Only key equality is read, so the sign-flipped int32 form the co-sort
    produces and the uint32 form give the same stats."""
    rng = np.random.default_rng(9)
    key_s, pay_s = _sorted_stream(np.round(rng.random(3000), 2), rng.integers(0, 2, 3000))
    u = torch.from_numpy(key_s)
    i = (u.view(torch.int32) ^ -(2**31)).contiguous()
    assert torch.equal(tie_group_reduce(u, torch.from_numpy(pay_s)), tie_group_reduce(i, torch.from_numpy(pay_s)))


def test_empty_stream_is_all_zero():
    empty = tie_group_reduce(torch.zeros(0, dtype=torch.uint32), torch.zeros(0))
    assert torch.equal(empty, torch.zeros(4))


def test_counts_stay_exact_past_2_pow_24():
    """The count hazard: an f32 cumulant sticks at 2^24. The reference counts
    in int32, so a class of 2^24 + 3 members is counted exactly."""
    n = 2**24 + 3
    key = torch.zeros(n, dtype=torch.int32)
    key[n // 2:] = 1  # two tie groups
    payload = torch.full((n,), 3.0)
    payload[:5] = 2.0
    stats = tie_group_reduce_reference(key, payload)
    assert int(stats[2].item()) == n - 5 and int(stats[3].item()) == 5


# ---- the weighted scan (weights_s=) ---------------------------------------------
# The plain weighted version against the Pallas kernel's weighted body in
# interpret mode. JAX carries f32 sums; the port float64, so area and AP sum
# agree to 1e-5 relative, and class totals exactly where the weights are
# integers.

W_TOL = 1e-5


def _weighted_sorted(preds, rel, w):
    key_s, pay_s, w_s = lax.sort(
        (jax_descending_key(jnp.asarray(preds, jnp.float32)), jnp.asarray(rel, jnp.float32) + 2.0,
         jnp.asarray(w, jnp.float32)),
        num_keys=1, is_stable=False,
    )
    return np.array(key_s), np.array(pay_s), np.array(w_s)


def _both_weighted(preds, rel, w, offsets=(0.0, 0.0)):
    key_s, pay_s, w_s = _weighted_sorted(preds, rel, w)
    want = np.asarray(jax_tie_group_reduce(
        jnp.asarray(key_s), jnp.asarray(pay_s), offsets=jnp.asarray(offsets, jnp.float32),
        weights_s=jnp.asarray(w_s), interpret=True,
    ))
    got = tie_group_reduce(torch.from_numpy(key_s), torch.from_numpy(pay_s), offsets, torch.from_numpy(w_s))
    return got.numpy(), want


def _assert_weighted(got, want, exact_totals=False):
    assert got.dtype == np.float32 and got.shape == (4,)
    np.testing.assert_allclose(got[:2], want[:2], rtol=W_TOL, atol=0.0)
    if exact_totals:
        np.testing.assert_array_equal(got[2:], want[2:])
    else:
        np.testing.assert_allclose(got[2:], want[2:], rtol=W_TOL, atol=0.0)


@pytest.mark.parametrize("n", [1, 7, 32767, 32768, 32769, 100003])
def test_weighted_scan_matches_the_pallas_kernel(n):
    rng = np.random.default_rng(100 + n)
    preds = np.round(rng.random(n), 2)  # tie-heavy
    rel = (rng.random(n) < preds).astype(np.float32)
    w = rng.lognormal(size=n).astype(np.float32)
    _assert_weighted(*_both_weighted(preds, rel, w))


def test_weighted_scan_integer_weights_give_exact_totals():
    rng = np.random.default_rng(2)
    n = 40000
    preds = np.round(rng.standard_normal(n), 1)
    rel = rng.integers(0, 2, n)
    _assert_weighted(*_both_weighted(preds, rel, rng.integers(0, 5, n).astype(np.float32)), exact_totals=True)


def test_weighted_scan_zero_weights_are_inert():
    """Weight-0 elements equal masked elements of the unweighted scan,
    whatever their scores."""
    rng = np.random.default_rng(4)
    n = 5000
    preds = np.round(rng.random(n), 2)
    rel = rng.integers(0, 2, n)
    keep = (rng.random(n) < 0.6).astype(np.float32)
    got, want = _both_weighted(preds, rel, keep)
    _assert_weighted(got, want, exact_totals=True)
    masked, _ = _both_stats(preds, rel, keep)
    np.testing.assert_allclose(got, masked.numpy(), rtol=1e-6, atol=0.0)
    garbage = np.where(keep > 0, preds, 1e30)
    np.testing.assert_allclose(_both_weighted(garbage, rel, keep)[0], got, rtol=1e-6, atol=0.0)


def test_weighted_scan_unit_weights_equal_the_unweighted_scan():
    rng = np.random.default_rng(7)
    n = 33000  # spans Pallas blocks and the port's tiles
    preds = np.round(rng.random(n) * 20) / 20
    rel = (rng.random(n) < 0.4).astype(np.float32)
    got, _ = _both_weighted(preds, rel, np.ones(n, np.float32))
    unweighted, _ = _both_stats(preds, rel)
    np.testing.assert_allclose(got, unweighted.numpy(), rtol=1e-6, atol=0.0)
    np.testing.assert_array_equal(got[2:], unweighted.numpy()[2:])


@pytest.mark.parametrize("offsets", [(37.5, 52.25), (1234.0, 777.0)])
def test_weighted_offsets_shift_only_the_ap_ratio(offsets):
    rng = np.random.default_rng(11)
    n = 2048
    preds = np.round(rng.random(n) * 10) / 10
    rel = (rng.random(n) < 0.5).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    got, want = _both_weighted(preds, rel, w, offsets)
    _assert_weighted(got, want)
    plain, _ = _both_weighted(preds, rel, w)
    assert got[0] == plain[0] and np.array_equal(got[2:], plain[2:])  # the area stays local
    assert got[1] != plain[1]


def test_weighted_tiny_totals_are_not_degenerate():
    """Weights of 1e-20 per side: the product of the totals underflows f32.
    The factor-wise degeneracy test still gives a number, and the float64
    factor-by-factor normalization gives the AUROC of the float64 oracle,
    0.75 (to 1e-5: the f32 area, ~3e-40, is subnormal); JAX's kernel floor
    does not, a deliberate difference."""
    got, want = _both_weighted([0.9, 0.1, 0.6, 0.3], [1, 0, 0, 1], np.full(4, 1e-20, np.float32))
    # the area, ~1e-40, is below f32's normal range: JAX's f32 sum flushes it
    # to 0 where the port's f64 sum keeps a subnormal
    assert abs(got[0]) < np.finfo(np.float32).tiny and abs(want[0]) < np.finfo(np.float32).tiny
    np.testing.assert_allclose(got[1:], want[1:], rtol=W_TOL, atol=0.0)
    (pa, pp), (ja, jp) = _scores(torch.from_numpy(got), want)
    assert abs(pa - 0.75) < 1e-5 and not np.isnan(ja)
    assert abs(pp - jp) < 1e-6
    # at 1e-16 the area is normal in f32, and the value is 0.75 to 1e-6
    got16, _ = _both_weighted([0.9, 0.1, 0.6, 0.3], [1, 0, 0, 1], np.full(4, 1e-16, np.float32))
    assert abs(float(auroc_ap_from_stats(torch.from_numpy(got16))[0]) - 0.75) < 1e-6
    for w_pos, w_neg in ((0.0, 1e-20), (1e-20, 0.0)):
        assert np.isnan(float(auroc_ap_from_stats(torch.tensor([0.0, 0.0, w_pos, w_neg]))[0]))
