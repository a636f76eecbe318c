"""The port's precision policy against the JAX package, on the CPU.

* The classification pack in half inputs: the 16 cases of
  ``tests/classification/test_half_precision.py`` (same metrics, arguments
  and numpy batches), in bfloat16 and float16, through the module's
  ``forward`` and the functional form. The port's value equals JAX's on the
  same half inputs within 1e-6 (integer counts exactly, and in the same
  dtype), and its own float32 value within that case's JAX tolerance
  (``atol`` as listed there, ``rtol`` 2e-2). One deliberate difference:
  ``hinge`` promotes half scores to float32 before it sums the margins,
  where JAX sums them in the half dtype (a float16 sum overflows past
  65,504); there the port equals its float32 hinge of the half-rounded
  scores within 1e-6, and JAX's value within one rounding to the half
  dtype.
* The shorthands ``bfloat16()``, ``float16()``, ``half()`` and ``float()`` on
  ``Metric``, ``MetricCollection``, ``CompositionalMetric`` and
  ``BootStrapper``: each equals the matching ``astype`` call state for state,
  ``half()`` is bfloat16 as in the JAX package (not ``nn.Module.half()``'s
  float16), and integer counters keep their dtype.
* ``BootStrapper``: the port casts its replicas (they are its states), the
  JAX package leaves them float32 (its wrapper has no states of its own).
* An armed MetricSan sees no violation from the shorthands.

* ``scripts/torch_precision.py`` (the card's phase 4t): its cases equal
  JAX's and the regression file's, its oracle equals scikit-learn's, and
  its four legs pass on the CPU at a small size.

The sharded cases (``test_bf16_preds_buffer_quantizes_scores``,
``test_astype_preserves_sharding_mid_accumulation``) are in
``tests/test_torch_sharded.py``; JAX's states carried across by
``state_from_jax`` in ``tests/test_torch_metric.py``.
"""
import importlib
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import average_precision_score, roc_auc_score

import metrics_tpu as jm
import metrics_tpu.functional as jf
import metrics_tpu_torch as tm
import metrics_tpu_torch.functional as tf
from metrics_tpu_torch.analysis import san_scope
from metrics_tpu_torch.analysis.sanitizer import disable_san
from metrics_tpu_torch.metric import Metric
from tests.classification.test_half_precision import CASES
from tests.helpers.testers import NUM_CLASSES

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import torch_precision as precision  # noqa: E402

jax_boot = importlib.import_module("metrics_tpu.wrappers.bootstrapping")
port_boot = importlib.import_module("metrics_tpu_torch.wrappers.bootstrapping")

CPU = "cpu"
JAX_TOL = 1e-6  # the port against JAX on the same half inputs
HALF_RTOL = 2e-2  # against float32: JAX's rtol (tests/helpers/testers.py::_assert_half_support)
HALVES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float16": (torch.float16, jnp.float16)}
HALF_EPS = {"bfloat16": 2.0**-8, "float16": 2.0**-11}  # one rounding of a result to the half dtype
SHORTHANDS = {"bfloat16": torch.bfloat16, "float16": torch.float16, "half": torch.bfloat16, "float": torch.float32}


def _leaves(result):
    """A result's tensors, flattened, as ``(float64 array, dtype name)``."""
    if isinstance(result, (list, tuple)):
        return [leaf for item in result for leaf in _leaves(item)]
    if isinstance(result, torch.Tensor):
        return [(result.detach().double().numpy(), str(result.dtype).replace("torch.", ""))]
    array = jnp.asarray(result)
    return [(np.asarray(array.astype(jnp.float64) if array.dtype != jnp.bool_ else array, np.float64),
             str(array.dtype))]


def _agree(ours, ref, atol, rtol, what):
    got, want = _leaves(ours), _leaves(ref)
    assert len(got) == len(want), what
    for (g, gd), (w, wd) in zip(got, want):
        assert g.shape == w.shape, (what, g.shape, w.shape)
        if "int" in gd or "int" in wd:
            assert gd == wd and np.array_equal(g, w), (what, gd, wd, g, w)
        else:
            np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=what)


@pytest.mark.parametrize("path", ["module", "functional"])
@pytest.mark.parametrize("half", list(HALVES))
@pytest.mark.parametrize("jax_cls, jax_fn, args, inputs, atol", [pytest.param(*c[1:], id=c[0]) for c in CASES])
def test_classification_half_inputs_match_jax(jax_cls, jax_fn, args, inputs, atol, half, path):
    """JAX's half-precision value check, through both packages: the port's
    value on half inputs equals JAX's within 1e-6 (counts exactly, dtypes
    alike), and its own float32 value within the case's tolerance."""
    torch_half, jax_half = HALVES[half]
    preds, target = inputs[0][0], np.asarray(inputs[1][0])
    tp, tt = torch.from_numpy(preds).to(torch_half), torch.from_numpy(target)
    jp, jt = jnp.asarray(preds).astype(jax_half), jnp.asarray(target)
    port_fn = getattr(tf, jax_fn.__name__)
    if path == "module":
        ours = getattr(tm, jax_cls.__name__)(**args, device=CPU)(tp, tt)
        ref = jax_cls(**args)(jp, jt)
    else:
        ours, ref = port_fn(tp, tt, **args), jax_fn(jp, jt, **args)
    if jax_fn.__name__ == "hinge":
        # the port promotes half scores before summing the margins; JAX sums
        # them in the half dtype, so its value is the port's, rounded to it
        _agree(ours, port_fn(tp.float(), tt, **args), JAX_TOL, 0.0, f"{path} against the rounded scores in float32")
        _agree(ours, ref, 0.0, HALF_EPS[half], f"{path} against JAX")
    else:
        _agree(ours, ref, JAX_TOL, 0.0, f"{path} against JAX")
    _agree(ours, port_fn(torch.from_numpy(preds), tt, **args), atol, HALF_RTOL, f"{path} against float32")


def test_hinge_half_margins_sum_in_float32_unlike_jax():
    """Past 65,504 summed margin (about 57,000 rows here) a float16 sum
    overflows: the JAX package's hinge returns inf or NaN there, the port's
    the float32 hinge of the float16-rounded scores."""
    rng = np.random.RandomState(5)
    p = rng.rand(70_000, 4).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    t = rng.randint(4, size=70_000)
    ref = jf.hinge(jnp.asarray(p).astype(jnp.float16), jnp.asarray(t))
    module_ref = jm.Hinge()(jnp.asarray(p).astype(jnp.float16), jnp.asarray(t))
    assert not np.isfinite(float(ref)) and not np.isfinite(float(module_ref))
    half = torch.from_numpy(p).to(torch.float16)
    want = tf.hinge(half.float(), torch.from_numpy(t))
    for got in (tf.hinge(half, torch.from_numpy(t)), tm.Hinge(device=CPU)(half, torch.from_numpy(t))):
        assert got.dtype == torch.float32 and abs(float(got) - float(want)) <= JAX_TOL


def _state_dtypes(metric: Metric) -> dict:
    return {k: [v.dtype for v in getattr(metric, k)] if isinstance(getattr(metric, k), list)
            else getattr(metric, k).dtype for k in metric._defaults}


def _states_equal(a: Metric, b: Metric) -> None:
    assert _state_dtypes(a) == _state_dtypes(b)
    for k in a._defaults:
        x, y = getattr(a, k), getattr(b, k)
        for u, v in zip(x if isinstance(x, list) else [x], y if isinstance(y, list) else [y]):
            assert torch.equal(u, v), k


def test_half_and_float16_shortcuts():
    """``half()`` maps to bfloat16 as in the JAX package; ``float16()`` gives
    IEEE half; ``float()`` float32. The same sequence on JAX's metric gives
    the same dtypes."""
    ours, ref = tm.MeanSquaredError(device=CPU), jm.MeanSquaredError()
    for shorthand, want in (("half", torch.bfloat16), ("float16", torch.float16), ("float", torch.float32)):
        assert getattr(ours, shorthand)() is ours and getattr(ref, shorthand)() is ref
        assert ours.sum_squared_error.dtype == want
        assert str(ref.sum_squared_error.dtype) == str(want).replace("torch.", "")


def _fed(make):
    """A metric or collection after two seeded batches (states mid-epoch)."""
    rng = np.random.default_rng(3)
    obj = make()
    for _ in range(2):
        p = torch.from_numpy(rng.random(64).astype(np.float32))
        obj.update(p, torch.from_numpy((rng.random(64) < p.numpy()).astype(np.int64)))
    return obj


_MEMBERS = {
    "MeanSquaredError": lambda: tm.MeanSquaredError(device=CPU),
    "StatScores": lambda: tm.StatScores(device=CPU),
    "BinnedAUROC": lambda: tm.BinnedAUROC(num_bins=16, device=CPU),
    "AUROC": lambda: tm.AUROC(pos_label=1, device=CPU),
    "Accuracy": lambda: tm.Accuracy(device=CPU),
}


@pytest.mark.parametrize("shorthand", list(SHORTHANDS))
@pytest.mark.parametrize("member", list(_MEMBERS))
def test_metric_shorthand_equals_astype_state_for_state(member, shorthand):
    """Each shorthand returns the metric itself and leaves exactly the states
    ``astype`` leaves, mid-epoch; integer counters keep their dtype."""
    a, b = _fed(_MEMBERS[member]), _fed(_MEMBERS[member])
    before = _state_dtypes(a)
    assert getattr(a, shorthand)() is a
    b.astype(SHORTHANDS[shorthand])
    _states_equal(a, b)
    after = _state_dtypes(a)
    for k, was in before.items():
        now = after[k]
        for w, n in zip(was if isinstance(was, list) else [was], now if isinstance(now, list) else [now]):
            assert n == (SHORTHANDS[shorthand] if w.is_floating_point else w), (k, w, n)
    assert a.compute() is not None


@pytest.mark.parametrize("shorthand", list(SHORTHANDS))
def test_collection_shorthand_equals_astype_state_for_state(shorthand):
    def make():
        return tm.MetricCollection([_MEMBERS[name]() for name in ("Accuracy", "BinnedAUROC", "StatScores")])

    a, b = _fed(make), _fed(make)
    assert getattr(a, shorthand)() is a
    b.astype(SHORTHANDS[shorthand])
    for name in a.keys():
        _states_equal(a[name], b[name])
    assert a["StatScores"].tp.dtype == torch.int32


def test_collection_astype():
    """Port of JAX's ``test_collection_astype``: every float state of a
    collection's member becomes bfloat16 under ``bfloat16()``."""
    col = tm.MetricCollection([tm.Accuracy(device=CPU), tm.BinnedAUROC(num_bins=16, device=CPU)])
    col.bfloat16()
    binned = col["BinnedAUROC"]
    floats = [getattr(binned, k) for k in binned._defaults if getattr(binned, k).is_floating_point()]
    assert floats and all(v.dtype == torch.bfloat16 for v in floats)


@pytest.mark.parametrize("shorthand", list(SHORTHANDS))
def test_compositional_shorthand_reaches_both_operands(shorthand):
    """``CompositionalMetric`` gets the shorthands through its own
    ``astype``: both operands are cast, and the value follows JAX's
    composite cast the same way."""
    comp = tm.MeanSquaredError(device=CPU) + tm.MeanAbsoluteError(device=CPU)
    ref = jm.MeanSquaredError() + jm.MeanAbsoluteError()
    assert getattr(comp, shorthand)() is comp
    getattr(ref, shorthand)()
    want = SHORTHANDS[shorthand]
    assert comp.metric_a.sum_squared_error.dtype == comp.metric_b.sum_abs_error.dtype == want
    assert str(ref.metric_a.sum_squared_error.dtype) == str(want).replace("torch.", "")
    x = np.linspace(0.0, 2.0, 16, dtype=np.float32)  # bf16 and fp16 hold these exactly
    comp.update(torch.from_numpy(x), torch.from_numpy(x[::-1].copy()))
    ref.update(jnp.asarray(x), jnp.asarray(x[::-1].copy()))
    _agree(comp.compute(), ref.compute(), JAX_TOL, 0.0, "composite value")


@pytest.mark.parametrize("shorthand", ["bfloat16", "half"])
def test_bootstrapper_casts_its_replicas_unlike_jax(monkeypatch, shorthand):
    """The port's ``BootStrapper`` keeps its replicas as states, so a
    shorthand casts them; JAX's wrapper has no states of its own, and its
    ``Metric.astype`` casts only ``_defaults``, so its replicas stay float32.
    On the same resamplings of inputs bf16 holds exactly (totals below 256),
    the two ``compute()`` agree within bf16 rounding."""
    n, replicas = 64, 5
    rng = np.random.RandomState(11)
    indices = [rng.randint(0, n, size=n) for _ in range(replicas)]
    jax_queue, port_queue = list(indices), list(indices)
    monkeypatch.setattr(jax_boot, "_bootstrap_sampler",
                        lambda size, sampling_strategy="poisson": jnp.asarray(jax_queue.pop(0).astype(np.int32)))
    monkeypatch.setattr(port_boot, "_bootstrap_sampler",
                        lambda size, sampling_strategy="poisson", num_samples=1, generator=None, device=None:
                        [torch.from_numpy(port_queue.pop(0)) for _ in range(num_samples)])
    kwargs = dict(num_bootstraps=replicas, raw=True, sampling_strategy="multinomial")
    pb = tm.BootStrapper(tm.MeanSquaredError(device=CPU), **kwargs)
    jb = jax_boot.BootStrapper(jm.MeanSquaredError(), **kwargs)
    assert getattr(pb, shorthand)() is pb and getattr(jb, shorthand)() is jb
    assert {m.sum_squared_error.dtype for m in pb.metrics} == {torch.bfloat16}
    assert {m.total.dtype for m in pb.metrics} == {torch.bfloat16}
    assert {str(m.sum_squared_error.dtype) for m in jb.metrics} == {"float32"}
    assert {str(m.total.dtype) for m in jb.metrics} == {"float32"}
    p = (rng.randint(0, 17, size=n) / 8).astype(np.float32)
    t = (rng.randint(0, 17, size=n) / 8).astype(np.float32)
    pb.update(torch.from_numpy(p), torch.from_numpy(t))
    jb.update(jnp.asarray(p), jnp.asarray(t))
    assert not jax_queue and not port_queue
    got, want = pb.compute(), jb.compute()
    assert sorted(got) == sorted(want) == ["mean", "raw", "std"]
    for k in want:
        _agree(got[k], want[k], 0.0, 2.0**-8, f"bootstrap {k}")


@pytest.fixture
def _disarmed():
    yield
    disable_san()
    assert "__setattr__" not in Metric.__dict__


def test_shorthands_under_an_armed_metricsan_report_nothing(_disarmed):
    """The shorthands go through ``astype``, a sanctioned lifecycle method:
    an armed MetricSan reports no state written outside it."""
    with san_scope() as san:
        m = _fed(_MEMBERS["MeanSquaredError"])
        m.half()
        col = _fed(lambda: tm.MetricCollection([tm.Accuracy(device=CPU), tm.BinnedAUROC(num_bins=16, device=CPU)]))
        col.half()
        comp = tm.MeanSquaredError(device=CPU) * 2
        comp.half().float16().float()
        for obj in (m, col):
            obj.float16().bfloat16().float()
            obj.compute()
    assert san.violations == []
    assert m.sum_squared_error.dtype == torch.float32


# ---- scripts/torch_precision.py (phase 4t's legs) on the CPU ------------------------------


def test_precision_script_cases_mirror_jax_and_the_regression_file():
    """The script's 16 cases are JAX's (ids, metrics, arguments, input kind,
    tolerance) and its 7 regression cases the regression file's."""
    from tests.classification.test_half_precision import _BIN
    from tests.test_torch_regression import HALF_CASES

    mine = precision.cases(NUM_CLASSES)
    assert [c[0] for c in mine] == [c[0] for c in CASES]
    for (name, cls, fn, args, kind, atol), (_, jax_cls, jax_fn, jax_args, inputs, jax_atol) in zip(mine, CASES):
        assert (cls, fn, args, atol) == (jax_cls.__name__, jax_fn.__name__, jax_args, jax_atol), name
        assert kind == ("binary" if inputs is _BIN else "multiclass"), name
    assert [c[:3] for c in precision.REG_CASES] == [c[:3] for c in HALF_CASES]


@pytest.mark.parametrize("half", list(HALVES))
def test_half_oracle_matches_sklearn(half):
    """The histogram oracle of half-rounded scores equals scikit-learn's
    AUROC and AP of the same scores, one stream and one-vs-rest."""
    rng = np.random.default_rng(17)
    scores = torch.from_numpy(rng.random(5000, dtype=np.float32)).to(HALVES[half][0])
    target = rng.integers(0, 2, 5000)
    rounded = scores.float().numpy()
    auroc, ap = precision.half_oracle(precision.half_bits(scores), target)
    assert abs(auroc - roc_auc_score(target, rounded)) < 1e-12
    assert abs(ap - average_precision_score(target, rounded)) < 1e-12
    rows = torch.from_numpy(rng.random((3000, 6), dtype=np.float32)).to(HALVES[half][0])
    labels = rng.integers(0, 6, 3000)
    aurocs, aps = precision.half_oracle(precision.half_bits(rows), labels)
    for c in range(6):
        assert abs(aurocs[c] - roc_auc_score(labels == c, rows[:, c].float().numpy())) < 1e-12
        assert abs(aps[c] - average_precision_score(labels == c, rows[:, c].float().numpy())) < 1e-12
    with pytest.raises(ValueError, match="non-negative"):
        precision.half_bits(-scores)


def test_tie_profile_of_sorted_streams():
    keys = torch.tensor([1, 1, 1, 2, 3, 3], dtype=torch.int32)
    assert precision._tie_profile(keys) == (3, 3, 3)
    rows = torch.tensor([[0, 0, 0, 0, 5, 6], [1, 2, 3, 4, 5, 6]], dtype=torch.int32)
    assert precision._tie_profile(rows) == (3, 6, 4)


def test_precision_script_legs_on_the_cpu():
    """Every leg at a small size: no failed check, no launch, the engine's
    two builds; with the oracle's tolerance made impossible, the AUROC and
    AP checks fail and the run says so."""
    inputs = precision.make_inputs(0.01)
    lines = []
    result = precision.run(torch.device("cpu"), inputs, emit=lines.append)
    assert result["ok"], result["failures"]
    assert lines[0] == "PLATFORM cpu" and lines[-1] == "DONE"
    assert sum(line.startswith("CASE ") for line in lines) == 64
    assert sum(line.startswith("REG ") for line in lines) == 28
    assert sorted(result["legs"]) == ["a", "b", "c", "d"] and not any(result["launches"].values())
    assert result["legs"]["d"]["builds"] == 2 and result["legs"]["d"]["state_dtypes"]["BinnedAUROC.hist_pos"] == "float32"
    assert result["legs"]["c"]["buffer_bytes"] * 2 == result["legs"]["c"]["float32_buffer_bytes"]
    strict = precision.ORACLE_TOL
    try:
        precision.ORACLE_TOL = -1.0
        failed = precision.run(torch.device("cpu"), inputs, emit=lambda line: None)
    finally:
        precision.ORACLE_TOL = strict
    assert not failed["ok"] and any("float64 oracle" in f for f in failed["failures"])
