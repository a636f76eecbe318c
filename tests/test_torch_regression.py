"""The port's regression pack against the JAX package, on the CPU.

Every case of ``tests/regression/*.py`` is mirrored: the same seeded numpy
inputs go through the JAX package (its CPU path) and the port with
``device="cpu"``, batch by batch through each module's ``forward`` and then
``compute()``, and through each functional form:

* ``MeanSquaredError``, ``MeanAbsoluteError``, ``MeanSquaredLogError`` and
  ``mean_relative_error`` on one- and five-target inputs;
* ``R2Score`` under ``adjusted`` × ``multioutput`` with its warnings;
* ``ExplainedVariance`` under ``multioutput``, its zero-division branches;
* ``PSNR`` in both state modes (``dim``), its bases and reductions, and the
  ``data_range=None`` running min/max seeded at 0.0;
* ``SSIM``'s mean and ``reduction="none"`` maps, in the banded form and the
  convolution form;
* bfloat16 and float16 inputs through ``promote_accumulator``;
* every error and warning text, in JAX's order;
* a 5-metric collection sharing one pass per batch, equal to the unshared
  values; ``state_from_jax`` of a JAX regression epoch; a 2-process gloo
  world of PSNR's min/max states and SSIM's list states.

Tolerances: states (sums and counts) and the sum-ratio values (MSE, MAE,
MSLE, relative error, PSNR) within 1e-6 relative (float32 sums in another
order); R2 and explained variance within 1e-5 absolute (a float32
difference of moment sums, ``Σy² − (Σy)²/n``, cancels: on a 32-row batch the
two packages' sums, added in other orders, move the score by up to 6e-6);
SSIM within 1e-5.
"""
import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.functional as jf
import metrics_tpu_torch as tm
import metrics_tpu_torch.functional as tf
from metrics_tpu_torch.functional.regression import sufficient_stats
from metrics_tpu_torch.interop import state_from_jax
from metrics_tpu_torch.utilities.data import promote_accumulator
from tests.torch_workers import regression_world, run_world

# the modules themselves: each package names its function ``ssim`` alike
ssim_module = importlib.import_module("metrics_tpu_torch.functional.regression.ssim")
jax_ssim_module = importlib.import_module("metrics_tpu.functional.regression.ssim")

CPU = "cpu"
SUM_TOL = 1e-6  # relative: float32 sums of the same terms in another order
MOMENT_TOL = 1e-5  # absolute: R2 / EV, a float32 difference of moment sums
SSIM_TOL = 1e-5
NUM_BATCHES, BATCH_SIZE, NUM_TARGETS = 10, 32, 5

_rs = np.random.RandomState(42)
SINGLE = (_rs.rand(NUM_BATCHES, BATCH_SIZE).astype(np.float32), _rs.rand(NUM_BATCHES, BATCH_SIZE).astype(np.float32))
MULTI = (
    _rs.rand(NUM_BATCHES, BATCH_SIZE, NUM_TARGETS).astype(np.float32),
    _rs.rand(NUM_BATCHES, BATCH_SIZE, NUM_TARGETS).astype(np.float32),
)
# tests/regression/test_psnr.py's images: small integers, three class mixes
PSNR_INPUTS = [
    (
        _rs.randint(n_pred, size=(NUM_BATCHES, BATCH_SIZE, 32, 32)).astype(np.float32),
        _rs.randint(n_target, size=(NUM_BATCHES, BATCH_SIZE, 32, 32)).astype(np.float32),
    )
    for n_pred, n_target in [(10, 10), (5, 10), (10, 5)]
]
# tests/regression/test_ssim.py's images: (size, channels, target = preds · coef), 4 batches of 4
SSIM_INPUTS = []
for _size, _channel, _coef in [(12, 3, 0.9), (13, 1, 0.8), (14, 1, 0.7), (15, 3, 0.6)]:
    _p = _rs.rand(4, 4, _channel, _size, _size).astype(np.float32)
    SSIM_INPUTS.append((_p, (_p * _coef).astype(np.float32)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x, dtype=np.float64)


def _close(ours, ref, rtol=SUM_TOL, atol=0.0):
    got, want = _np(ours), _np(ref)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _outcome(fn, *args, **kwargs):
    """``("ok", value)``, or ``("error", type name, message)``, with the
    warnings' texts in order."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            value = ("ok", fn(*args, **kwargs))
        except Exception as err:  # compared with the other package's outcome
            value = ("error", type(err).__name__, str(err))
    return value, [str(w.message) for w in caught]


def _assert_same_errors(ours, ref):
    (o, o_warn), (r, r_warn) = ours, ref
    assert o_warn == r_warn
    if o[0] == "error" or r[0] == "error":
        assert o == r
    else:
        assert o[0] == r[0] == "ok"


def _run_both(jax_make, torch_make, preds, target, tol):
    """Forward every batch through a JAX module and the port's; each step
    value and the epoch value must agree."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours, ref = torch_make(), jax_make()
    for p, t in zip(preds, target):
        _close(ours(_t(p), _t(t)), ref(jnp.asarray(p), jnp.asarray(t)), **tol)
    _close(ours.compute(), ref.compute(), **tol)
    return ours, ref


def _functional_both(jax_fn, torch_fn, preds, target, tol, **kwargs):
    for p, t in zip(preds, target):
        _close(torch_fn(_t(p), _t(t), **kwargs), jax_fn(jnp.asarray(p), jnp.asarray(t), **kwargs), **tol)


SUM_RATIO = {"rtol": SUM_TOL}
MOMENTS = {"rtol": 0.0, "atol": MOMENT_TOL}
SSIM_CMP = {"rtol": 0.0, "atol": SSIM_TOL}

# ---- mean errors (tests/regression/test_mean_error.py) ----------------------

MEAN_ERRORS = [
    ("MeanSquaredError", "mean_squared_error", "sum_squared_error"),
    ("MeanAbsoluteError", "mean_absolute_error", "sum_abs_error"),
    ("MeanSquaredLogError", "mean_squared_log_error", "sum_squared_log_error"),
]


@pytest.mark.parametrize("inputs", [SINGLE, MULTI], ids=["single", "multi"])
@pytest.mark.parametrize("cls, fn, state", MEAN_ERRORS, ids=[c for c, _, _ in MEAN_ERRORS])
def test_mean_error_module(inputs, cls, fn, state):
    ours, ref = _run_both(getattr(jm, cls), lambda: getattr(tm, cls)(device=CPU), *inputs, SUM_RATIO)
    _close(getattr(ours, state), getattr(ref, state))
    assert ours.total.dtype == torch.float32 and float(ours.total) == float(ref.total) == inputs[0].size


@pytest.mark.parametrize("inputs", [SINGLE, MULTI], ids=["single", "multi"])
@pytest.mark.parametrize("fn", [f for _, f, _ in MEAN_ERRORS] + ["mean_relative_error"])
def test_mean_error_functional(inputs, fn):
    _functional_both(getattr(jf, fn), getattr(tf, fn), *inputs, SUM_RATIO)


def test_mean_relative_error_zero_target_divides_by_one():
    p = np.array([0.5, 2.0, -1.0, 3.0], np.float32)
    t = np.array([0.0, 1.0, 0.0, 2.0], np.float32)
    got = tf.mean_relative_error(_t(p), _t(t))
    _close(got, jf.mean_relative_error(jnp.asarray(p), jnp.asarray(t)))
    _close(got, np.mean(np.abs((p - t) / np.where(t == 0, 1.0, t))))


# ---- R2 (tests/regression/test_r2score.py) ----------------------------------


@pytest.mark.parametrize("adjusted", [0, 5, 10])
@pytest.mark.parametrize("multioutput", ["raw_values", "uniform_average", "variance_weighted"])
@pytest.mark.parametrize("inputs, num_outputs", [(SINGLE, 1), (MULTI, NUM_TARGETS)], ids=["single", "multi"])
def test_r2score(adjusted, multioutput, inputs, num_outputs):
    args = dict(adjusted=adjusted, multioutput=multioutput, num_outputs=num_outputs)
    ours, ref = _run_both(lambda: jm.R2Score(**args), lambda: tm.R2Score(**args, device=CPU), *inputs, MOMENTS)
    for state in ("sum_squared_error", "sum_error", "residual", "total"):
        _close(getattr(ours, state), getattr(ref, state))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _functional_both(jf.r2score, tf.r2score, *inputs, MOMENTS, adjusted=adjusted, multioutput=multioutput)


@pytest.mark.parametrize("adjusted, n", [(3, 4), (4, 4), (1, 4), (2, 3)])
def test_r2score_adjusted_warnings(adjusted, n):
    p, t = SINGLE[0][0][:n], SINGLE[1][0][:n]
    ours = _outcome(tf.r2score, _t(p), _t(t), adjusted=adjusted)
    ref = _outcome(jf.r2score, jnp.asarray(p), jnp.asarray(t), adjusted=adjusted)
    _assert_same_errors(ours, ref)
    _close(ours[0][1], ref[0][1], **MOMENTS)


@pytest.mark.parametrize("call", [
    lambda pkg, arr: pkg.r2score(arr(np.zeros(100, np.float32)), arr(np.zeros(50, np.float32))),
    lambda pkg, arr: pkg.r2score(arr(np.zeros((10, 10, 10), np.float32)), arr(np.zeros((10, 10, 10), np.float32))),
    lambda pkg, arr: pkg.r2score(arr(np.zeros(1, np.float32)), arr(np.zeros(1, np.float32))),
    lambda pkg, arr: pkg.r2score(arr(np.ones(4, np.float32)), arr(np.arange(4, dtype=np.float32)), multioutput="x"),
    lambda pkg, arr: pkg.r2score(arr(np.ones(4, np.float32)), arr(np.arange(4, dtype=np.float32)), adjusted=-1),
    lambda pkg, arr: pkg.r2score(arr(np.ones(4, np.float32)), arr(np.arange(4, dtype=np.float32)), adjusted=1.5),
    # an invalid multioutput is reported before an invalid adjusted
    lambda pkg, arr: pkg.r2score(arr(np.ones(4, np.float32)), arr(np.arange(4, dtype=np.float32)), -1, "x"),
], ids=["shape", "multidim", "too-few", "multioutput", "adjusted<0", "adjusted-float", "order"])
def test_r2score_errors(call):
    _assert_same_errors(_outcome(call, tf, _t), _outcome(call, jf, jnp.asarray))


@pytest.mark.parametrize("kwargs", [{"adjusted": -1}, {"multioutput": "x"}, {"adjusted": -1, "multioutput": "x"}])
def test_r2score_module_argument_errors(kwargs):
    _assert_same_errors(_outcome(tm.R2Score, device=CPU, **kwargs), _outcome(jm.R2Score, **kwargs))


@pytest.mark.parametrize("cls", ["R2Score", "ExplainedVariance", "MeanSquaredError", "MeanAbsoluteError",
                                 "MeanSquaredLogError"])
@pytest.mark.parametrize("shapes", [((100,), (50,)), ((10, 10, 10), (10, 10, 10)), ((1,), (1,))],
                         ids=["shape", "multidim", "one-sample"])
def test_module_input_errors(cls, shapes):
    ps, ts = shapes
    ours = _outcome(lambda: tm.__dict__[cls](device=CPU)(torch.zeros(ps), torch.zeros(ts)))
    ref = _outcome(lambda: jm.__dict__[cls]()(jnp.zeros(ps), jnp.zeros(ts)))
    _assert_same_errors(ours, ref)


# ---- explained variance (tests/regression/test_explained_variance.py) --------


@pytest.mark.parametrize("multioutput", ["raw_values", "uniform_average", "variance_weighted"])
@pytest.mark.parametrize("inputs", [SINGLE, MULTI], ids=["single", "multi"])
def test_explained_variance(multioutput, inputs):
    ours, ref = _run_both(lambda: jm.ExplainedVariance(multioutput=multioutput),
                          lambda: tm.ExplainedVariance(multioutput=multioutput, device=CPU), *inputs, MOMENTS)
    for state in ("sum_error", "sum_squared_error", "sum_target", "sum_squared_target", "n_obs"):
        _close(getattr(ours, state), getattr(ref, state))
    _functional_both(jf.explained_variance, tf.explained_variance, *inputs, MOMENTS, multioutput=multioutput)


@pytest.mark.parametrize("multioutput", ["raw_values", "uniform_average", "variance_weighted"])
def test_explained_variance_zero_division_branches(multioutput):
    # columns: perfect fit of a varying target (num = 0, den > 0), a constant
    # target missed by a constant (num = 0, den = 0), a constant target
    # missed by a varying prediction (num > 0, den = 0), an ordinary column
    t = np.array([[1.0, 2.0, 2.0, 0.5], [2.0, 2.0, 2.0, 1.5], [4.0, 2.0, 2.0, 2.0]], np.float32)
    p = np.array([[1.0, 3.0, 1.0, 0.7], [2.0, 3.0, 2.5, 1.1], [4.0, 3.0, 3.0, 2.4]], np.float32)
    ours = tf.explained_variance(_t(p), _t(t), multioutput=multioutput)
    ref = jf.explained_variance(jnp.asarray(p), jnp.asarray(t), multioutput=multioutput)
    _close(ours, ref, **MOMENTS)
    if multioutput == "raw_values":
        np.testing.assert_array_equal(_np(ours)[:3], [1.0, 1.0, 0.0])


def test_explained_variance_argument_and_input_errors():
    _assert_same_errors(_outcome(tm.ExplainedVariance, multioutput="x", device=CPU),
                        _outcome(jm.ExplainedVariance, multioutput="x"))
    p, t = np.ones(4, np.float32), np.arange(4, dtype=np.float32)
    _assert_same_errors(_outcome(tf.explained_variance, _t(p), _t(t), multioutput="x"),
                        _outcome(jf.explained_variance, jnp.asarray(p), jnp.asarray(t), multioutput="x"))


def test_explained_variance_image_inputs_keep_per_position_moments():
    """>2-D inputs skip the shared pass: their dim-0 moments stay per position."""
    p, t = PSNR_INPUTS[0][0][:2, :4, :6, :6], PSNR_INPUTS[0][1][:2, :4, :6, :6]
    coll = tm.MetricCollection([tm.ExplainedVariance(multioutput="raw_values", device=CPU)])
    ref = jm.ExplainedVariance(multioutput="raw_values")
    for b in range(2):
        coll.update(_t(p[b]), _t(t[b]))
        ref.update(jnp.asarray(p[b]), jnp.asarray(t[b]))
    assert coll["ExplainedVariance"].sum_target.shape == (6, 6)
    _close(coll.compute()["ExplainedVariance"], ref.compute(), **MOMENTS)


# ---- PSNR (tests/regression/test_psnr.py) ------------------------------------

PSNR_CASES = [
    (0, 10, "elementwise_mean", None),
    (1, 10, "elementwise_mean", None),
    (2, 5, "elementwise_mean", None),
    (2, 5, "elementwise_mean", 1),
    (2, 5, "elementwise_mean", (1, 2)),
    (2, 5, "sum", (1, 2)),
]


@pytest.mark.parametrize("base", [10.0, 2.718281828459045])
@pytest.mark.parametrize("case, data_range, reduction, dim", PSNR_CASES)
def test_psnr(base, case, data_range, reduction, dim):
    preds, target = PSNR_INPUTS[case]
    args = dict(data_range=data_range, base=base, reduction=reduction, dim=dim)
    ours, ref = _run_both(lambda: jm.PSNR(**args), lambda: tm.PSNR(**args, device=CPU), preds, target, SUM_RATIO)
    if dim is None:
        _close(ours.sum_squared_error, ref.sum_squared_error)
        assert float(ours.total) == float(ref.total)
    else:
        assert len(ours.sum_squared_error) == len(ref.sum_squared_error) == NUM_BATCHES
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _functional_both(jf.psnr, tf.psnr, preds, target, SUM_RATIO, **args)


@pytest.mark.parametrize("case", [0, 1, 2])
def test_psnr_data_range_from_the_data(case):
    preds, target = PSNR_INPUTS[case]
    ours, ref = _run_both(jm.PSNR, lambda: tm.PSNR(device=CPU), preds[:4], target[:4], SUM_RATIO)
    _close(ours.min_target, ref.min_target)
    _close(ours.max_target, ref.max_target)
    _functional_both(jf.psnr, tf.psnr, preds[:4], target[:4], SUM_RATIO)


def test_psnr_min_max_are_seeded_at_zero():
    """The running min/max start at 0.0, not ±inf: an all-positive target
    series keeps ``min_target == 0`` (the JAX package's quirk, kept)."""
    rs = np.random.RandomState(7)
    target = (2.0 + rs.rand(3, 8, 8)).astype(np.float32)
    preds = (target + 0.1 * rs.randn(3, 8, 8)).astype(np.float32)
    ours, ref = _run_both(jm.PSNR, lambda: tm.PSNR(device=CPU), preds, target, SUM_RATIO)
    assert float(ours.min_target) == float(ref.min_target) == 0.0
    _close(ours.max_target, target.max())


@pytest.mark.parametrize("reduction", ["none", "sum"])
def test_psnr_reduction_warning_for_dim_none(reduction):
    match = f"The `reduction={reduction}` will not have any effect when `dim` is None."
    with pytest.warns(UserWarning, match=match):
        tm.PSNR(reduction=reduction, dim=None, device=CPU)
    with pytest.warns(UserWarning, match=match):
        tf.psnr(torch.ones(10), torch.ones(10), reduction=reduction, dim=None)
    _assert_same_errors(_outcome(tf.psnr, torch.ones(10), torch.zeros(10), reduction=reduction),
                        _outcome(jf.psnr, jnp.ones(10), jnp.zeros(10), reduction=reduction))


def test_psnr_missing_data_range():
    _assert_same_errors(_outcome(tm.PSNR, data_range=None, dim=0, device=CPU), _outcome(jm.PSNR, data_range=None, dim=0))
    _assert_same_errors(_outcome(tf.psnr, torch.ones(10), torch.zeros(10), data_range=None, dim=0),
                        _outcome(jf.psnr, jnp.ones(10), jnp.zeros(10), data_range=None, dim=0))


# ---- SSIM (tests/regression/test_ssim.py) ------------------------------------


def _ssim_oracle(preds, target, data_range=1.0, kernel_size=(11, 11), sigma=(1.5, 1.5), k1=0.01, k2=0.03):
    """float64 Gaussian-weighted SSIM over VALID windows (the JAX test's oracle)."""
    from scipy.signal import convolve2d

    preds, target = np.asarray(preds, np.float64), np.asarray(target, np.float64)

    def gauss(k, s):
        g = np.exp(-((np.arange((1 - k) / 2, (1 + k) / 2, 1.0) / s) ** 2) / 2)
        return g / g.sum()

    kernel = np.outer(gauss(kernel_size[0], sigma[0]), gauss(kernel_size[1], sigma[1]))
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    vals = []
    for b in range(preds.shape[0]):
        for c in range(preds.shape[1]):
            p, t = preds[b, c], target[b, c]
            mu_p, mu_t = (convolve2d(x, kernel, mode="valid") for x in (p, t))
            e_pp, e_tt, e_pt = (convolve2d(x, kernel, mode="valid") for x in (p * p, t * t, p * t))
            vals.append(((2 * mu_p * mu_t + c1) * (2 * (e_pt - mu_p * mu_t) + c2))
                        / ((mu_p**2 + mu_t**2 + c1) * (e_pp - mu_p**2 + e_tt - mu_t**2 + c2)))
    return np.mean(vals)


@pytest.mark.parametrize("case", range(len(SSIM_INPUTS)))
def test_ssim(case):
    preds, target = SSIM_INPUTS[case]
    ours, ref = _run_both(lambda: jm.SSIM(data_range=1.0), lambda: tm.SSIM(data_range=1.0, device=CPU),
                          preds, target, SSIM_CMP)
    assert len(ours.y) == len(ref.y) == len(preds)
    _close(ours.compute(), _ssim_oracle(preds.reshape(-1, *preds.shape[2:]), target.reshape(-1, *target.shape[2:])),
           **SSIM_CMP)
    _functional_both(jf.ssim, tf.ssim, preds, target, SSIM_CMP, data_range=1.0)


@pytest.mark.parametrize("data_range", [1.0, None])
def test_ssim_reduction_none_maps(data_range):
    preds, target = SSIM_INPUTS[0]
    ours = tf.ssim(_t(preds[0]), _t(target[0]), reduction="none", data_range=data_range)
    ref = jf.ssim(jnp.asarray(preds[0]), jnp.asarray(target[0]), reduction="none", data_range=data_range)
    assert ours.shape == (4, 3, 2, 2)
    _close(ours, ref, **SSIM_CMP)
    _close(tf.ssim(_t(preds[0]), _t(target[0]), reduction="sum", data_range=data_range),
           jf.ssim(jnp.asarray(preds[0]), jnp.asarray(target[0]), reduction="sum", data_range=data_range),
           rtol=SSIM_TOL)


@pytest.mark.parametrize("kernel_size, sigma", [((11, 11), (1.5, 1.5)), ((7, 5), (1.0, 2.0))])
def test_ssim_both_blur_forms(monkeypatch, kernel_size, sigma):
    """A 20 x 24 image takes the banded form; with the split lowered to 8 in
    the port it takes the convolution form. Both equal JAX's banded form and,
    with JAX's split lowered alike, JAX's convolution form."""
    rs = np.random.RandomState(3)
    preds = rs.rand(3, 2, 20, 24).astype(np.float32)
    target = np.clip(0.8 * preds + 0.2 * rs.rand(3, 2, 20, 24), 0, 1).astype(np.float32)
    args = dict(kernel_size=kernel_size, sigma=sigma, reduction="none")
    banded = tf.ssim(_t(preds), _t(target), **args)
    jax_banded = jf.ssim(jnp.asarray(preds), jnp.asarray(target), **args)
    monkeypatch.setattr(ssim_module, "_MATMUL_BLUR_MAX_DIM", 8)
    conv = tf.ssim(_t(preds), _t(target), **args)
    monkeypatch.setattr(jax_ssim_module, "_MATMUL_BLUR_MAX_DIM", 8)
    jax_conv = jf.ssim(jnp.asarray(preds), jnp.asarray(target), **args)
    for ours in (banded, conv):
        for ref in (jax_banded, jax_conv):
            _close(ours, ref, **SSIM_CMP)
    data_range = float(max(np.ptp(preds), np.ptp(target)))
    _close(torch.mean(conv), _ssim_oracle(preds, target, data_range, kernel_size, sigma), **SSIM_CMP)


def test_ssim_leaves_the_callers_precision_flags_as_they_were():
    before = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("high")
    try:
        preds, target = SSIM_INPUTS[0]
        tf.ssim(_t(preds[0]), _t(target[0]))
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cudnn.allow_tf32 == before[1]
    finally:
        torch.set_float32_matmul_precision(before[0])


def test_ssim_blur_matrix_is_cached_per_shape():
    a = ssim_module._blur_matrix(20, 11, 1.5, torch.float32, torch.device(CPU))
    assert ssim_module._blur_matrix(20, 11, 1.5, torch.float32, torch.device(CPU)) is a
    assert a.shape == (10, 20)
    np.testing.assert_allclose(_np(a.sum(1)), 1.0, rtol=1e-6)


SSIM_BAD = [
    ([1, 16, 16], [1, 16, 16], [11, 11], [1.5, 1.5]),
    ([1, 1, 16, 16], [1, 1, 16, 16], [11, 11], [1.5]),
    ([1, 1, 16, 16], [1, 1, 16, 16], [11], [1.5, 1.5]),
    ([1, 1, 16, 16], [1, 1, 16, 16], [11], [1.5]),
    ([1, 1, 16, 16], [1, 1, 16, 16], [11, 0], [1.5, 1.5]),
    ([1, 1, 16, 16], [1, 1, 16, 16], [11, 10], [1.5, 1.5]),
    ([1, 1, 16, 16], [1, 1, 16, 16], [11, -11], [1.5, 1.5]),
    ([1, 1, 16, 16], [1, 1, 16, 16], [11, 11], [1.5, 0]),
    ([1, 1, 16, 16], [1, 1, 16, 16], [11, 0], [1.5, -1.5]),
    ([1, 1, 16, 16], [1, 1, 15, 16], [11, 11], [1.5, 1.5]),
]


@pytest.mark.parametrize("pred, target, kernel, sigma", SSIM_BAD)
def test_ssim_invalid_inputs(pred, target, kernel, sigma):
    ours = _outcome(tf.ssim, torch.zeros(pred), torch.zeros(target), kernel, sigma)
    ref = _outcome(jf.ssim, jnp.zeros(pred), jnp.zeros(target), kernel, sigma)
    assert ours[0][0] == "error"
    _assert_same_errors(ours, ref)


def test_ssim_different_dtypes():
    ours = _outcome(tf.ssim, torch.zeros((1, 1, 16, 16)), torch.zeros((1, 1, 16, 16), dtype=torch.bfloat16))
    ref = _outcome(jf.ssim, jnp.zeros((1, 1, 16, 16)), jnp.zeros((1, 1, 16, 16), jnp.bfloat16))
    assert ours[0][1] == "TypeError"
    _assert_same_errors(ours, ref)


def test_ssim_module_warns_as_jax_does():
    _assert_same_errors(_outcome(tm.SSIM, device=CPU), _outcome(jm.SSIM))


# ---- half-precision inputs (run_precision_test_cpu) ---------------------------

HALF_CASES = [
    ("MeanSquaredError", "mean_squared_error", {}, SINGLE),
    ("MeanAbsoluteError", "mean_absolute_error", {}, MULTI),
    ("MeanSquaredLogError", "mean_squared_log_error", {}, SINGLE),
    ("R2Score", "r2score", {"num_outputs": NUM_TARGETS}, MULTI),
    ("ExplainedVariance", "explained_variance", {}, SINGLE),
    ("PSNR", "psnr", {"data_range": 10}, PSNR_INPUTS[0]),
    ("PSNR", "psnr", {"data_range": 5, "dim": (1, 2)}, PSNR_INPUTS[2]),
]


@pytest.mark.parametrize("half", ["bfloat16", "float16"])
@pytest.mark.parametrize("cls, fn, args, inputs", HALF_CASES, ids=[f"{c}-{i}" for i, (c, *_) in enumerate(HALF_CASES)])
def test_half_precision_inputs_accumulate_in_float32(half, cls, fn, args, inputs):
    """The half-precision batch is promoted to float32 before any sum: the
    port equals JAX's value on the same half inputs, and both return float32."""
    p, t = inputs[0][0], inputs[1][0]
    tp, tt = _t(p).to(getattr(torch, half)), _t(t).to(getattr(torch, half))
    jp, jt = jnp.asarray(p).astype(half), jnp.asarray(t).astype(half)
    fn_args = {k: v for k, v in args.items() if k != "num_outputs"}
    ours, ref = tf.__dict__[fn](tp, tt, **fn_args), jf.__dict__[fn](jp, jt, **fn_args)
    assert ours.dtype == torch.float32
    tol = MOMENTS if cls in ("R2Score", "ExplainedVariance") else SUM_RATIO
    _close(ours, ref, **tol)
    _close(tm.__dict__[cls](**args, device=CPU)(tp, tt), jm.__dict__[cls](**args)(jp, jt), **tol)


def test_promote_accumulator():
    x16, xb, x64, xi = (torch.ones(2, dtype=d) for d in (torch.float16, torch.bfloat16, torch.float64, torch.int32))
    assert [t.dtype for t in promote_accumulator(x16, xb, x64, xi)] == [torch.float32, torch.float32,
                                                                       torch.float64, torch.int32]
    assert promote_accumulator(x16).dtype == torch.float32


# ---- the shared pass in a collection -----------------------------------------


def _regression_collection(pkg, **kw):
    return pkg.MetricCollection([pkg.MeanSquaredError(**kw), pkg.MeanAbsoluteError(**kw), pkg.R2Score(**kw),
                                 pkg.PSNR(**kw), pkg.ExplainedVariance(**kw)])


@pytest.mark.parametrize("mode", ["forward", "update"])
def test_collection_shares_one_pass_per_batch(monkeypatch, mode):
    calls = []
    compute_stats = sufficient_stats._compute_stats
    monkeypatch.setattr(sufficient_stats, "_compute_stats", lambda p, t: calls.append(1) or compute_stats(p, t))
    rs = np.random.RandomState(11)
    target = (rs.randn(4, 1000) * 3 + 1).astype(np.float32)
    preds = (target + rs.randn(4, 1000)).astype(np.float32)
    shared = _regression_collection(tm, device=CPU)
    ref = _regression_collection(jm)
    alone = {name: type(m)(device=CPU) for name, m in shared.items()}
    for b in range(4):
        p, t = _t(preds[b]), _t(target[b])
        if mode == "forward":
            step = shared(p, t)
            ref_step = ref(jnp.asarray(preds[b]), jnp.asarray(target[b]))
            for name, m in alone.items():
                tol = MOMENTS if name in ("R2Score", "ExplainedVariance") else SUM_RATIO
                _close(step[name], m(p, t), **tol)
                _close(step[name], ref_step[name], **tol)
        else:
            shared.update(p, t)
            ref.update(jnp.asarray(preds[b]), jnp.asarray(target[b]))
            for m in alone.values():
                m.update(p, t)
    assert len(calls) == 4  # one pass per batch, not five
    got, want = shared.compute(), ref.compute()
    for name, m in alone.items():
        tol = MOMENTS if name in ("R2Score", "ExplainedVariance") else SUM_RATIO
        _close(got[name], m.compute(), **tol)
        _close(got[name], want[name], **tol)
    # outside a collection each metric reads the batch itself
    calls.clear()
    tm.MeanSquaredError(device=CPU).update(_t(preds[0]), _t(target[0]))
    with sufficient_stats.regression_family_sharing():
        tm.MeanSquaredError(device=CPU).update(_t(preds[0]), _t(target[0]))  # no memo scope: no sharing
    assert calls == []


def test_shared_stats_are_none_outside_both_scopes():
    p, t = torch.rand(8, 2), torch.rand(8, 2)
    assert sufficient_stats.regression_sufficient_stats(p, t) is None
    from metrics_tpu_torch.utilities.checks import shared_canonicalization

    with shared_canonicalization():
        assert sufficient_stats.regression_sufficient_stats(p, t) is None
        with sufficient_stats.regression_family_sharing():
            stats = sufficient_stats.regression_sufficient_stats(p, t)
            assert sufficient_stats.regression_sufficient_stats(p, t) is stats
            assert stats["sum_sq_diff"].shape == (2,)
            image = sufficient_stats.regression_sufficient_stats(torch.rand(2, 3, 4), torch.rand(2, 3, 4))
            assert image["sum_sq_diff"].shape == ()


def test_shared_pass_with_half_inputs_equals_the_unshared_values():
    rs = np.random.RandomState(5)
    t = _t(rs.rand(64).astype(np.float32)).to(torch.bfloat16)
    p = _t(rs.rand(64).astype(np.float32)).to(torch.bfloat16)
    got = _regression_collection(tm, device=CPU)(p, t)
    for name, value in got.items():
        alone = getattr(tm, name)(device=CPU)(p, t)
        assert value.dtype == torch.float32
        _close(value, alone, **(MOMENTS if name in ("R2Score", "ExplainedVariance") else SUM_RATIO))


# ---- state_from_jax ------------------------------------------------------------


def test_state_from_jax_carries_a_regression_epoch():
    def make(pkg, **kw):
        return pkg.MetricCollection({
            "mse": pkg.MeanSquaredError(**kw), "mae": pkg.MeanAbsoluteError(**kw),
            "msle": pkg.MeanSquaredLogError(**kw), "r2": pkg.R2Score(num_outputs=NUM_TARGETS, **kw),
            "ev": pkg.ExplainedVariance(multioutput="raw_values", **kw),
        })

    jax_coll = make(jm)
    for b in range(3):
        jax_coll.update(jnp.asarray(MULTI[0][b]), jnp.asarray(MULTI[1][b]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        images = {"psnr": (jm.PSNR(), tm.PSNR(device=CPU)),
                  "psnr_dim": (jm.PSNR(data_range=5, dim=(1, 2)), tm.PSNR(data_range=5, dim=(1, 2), device=CPU)),
                  "ssim": (jm.SSIM(data_range=1.0), tm.SSIM(data_range=1.0, device=CPU))}
    for name, (ref, _) in images.items():
        src = SSIM_INPUTS[0] if name == "ssim" else PSNR_INPUTS[1]
        for b in range(3):
            ref.update(jnp.asarray(src[0][b]), jnp.asarray(src[1][b]))
    ours = make(tm, device=CPU)
    jax_coll.persistent(True)
    state = {k: [np.asarray(v) for v in vals] if isinstance(vals, list) else np.asarray(vals)
             for k, vals in jax_coll.state_dict().items()}
    ours.load_state_dict(state_from_jax(state), strict=True)
    got, want = ours.compute(), jax_coll.compute()
    for name in want:
        _close(got[name], want[name])
    for name, (ref, port) in images.items():
        ref.persistent(True)
        state = {k: [np.asarray(v) for v in vals] if isinstance(vals, list) else np.asarray(vals)
                 for k, vals in ref.state_dict().items()}
        port.load_state_dict(state_from_jax(state), strict=True)
        if name == "psnr":
            assert float(port.min_target) == float(ref.min_target) and float(port.max_target) == float(ref.max_target)
        if name != "psnr":
            assert len(port.sum_squared_error if name == "psnr_dim" else port.y) == 3
        _close(port.compute(), ref.compute(), **(SSIM_CMP if name == "ssim" else SUM_RATIO))


# ---- across processes ------------------------------------------------------------


def test_two_process_psnr_min_max_and_ssim_lists_equal_one_process():
    rs = np.random.RandomState(17)
    batches = []
    for b in range(4):
        target = (rs.rand(2, 3, 16, 16) * (b + 1) - b).astype(np.float32)  # each batch its own range
        batches.append((np.clip(target + 0.05 * rs.randn(*target.shape), -4, 4).astype(np.float32), target))
    payload = {"batches": batches}
    world = run_world(2, regression_world, payload)
    one = regression_world(0, 1, torch.device(CPU), payload)
    for rank in range(2):
        for name, value in one.items():
            tol = SSIM_CMP if name == "ssim" else {"rtol": SUM_TOL}
            _close(world[rank][name], value, **tol)
    assert one["psnr_min"] == min(float(t.min()) for _, t in batches)
