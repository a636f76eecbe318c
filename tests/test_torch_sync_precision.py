"""The port's ``sync_precision=`` knob against the JAX package's, on the CPU.

The cases of ``tests/bases/test_sync_precision.py`` are mirrored, with the
cohort's two sync cases of ``tests/bases/test_cohort.py``
(``test_cohort_sync_exact_bit_identical_across_ranks``,
``test_cohort_sync_int8_residuals_within_bound``): the registration rules,
the residual companion's life (reset, ``astype``, ``state_dict``), the host
sync path in threaded virtual worlds of 2 (the port's
``tests/torch_virtual.py`` beside JAX's ``tests/helpers/testers.py``, on the
same seeded numpy inputs), the ``dist_sync_on_step`` recurrence on both
forward paths, the collection knob and the step engine's precision-keyed
signatures.

Tolerances: the synced values, local states and committed residuals of the
quantized tiers are held BIT-equal to JAX's (the same codec bits, merged in
rank order in f32 on both sides); the exact tier is bit-equal to the plain
sum; the documented bounds (``docs/performance.md:291-296``) are asserted
too: int8 within ``world * absmax/254``, bf16 within ``world * absmax/2^8``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu_torch as tm
from metrics_tpu.metric import Metric as JaxMetric
from metrics_tpu.utilities.distributed import gather_all_tensors as jax_gather
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.parallel import quantize as q
from metrics_tpu_torch.utilities.data import dim_zero_sum
from metrics_tpu_torch.utilities.distributed import gather_all_tensors
from tests.helpers.testers import run_virtual_ddp as jax_run_virtual_ddp
from tests.torch_virtual import run_virtual_ddp

CPU = "cpu"
_RNG = np.random.RandomState(7)


class Hist(Metric):
    """One sum-reduced histogram: the heavy-state families' stand-in."""

    def __init__(self, precision="exact", bins=512, **kwargs):
        super().__init__(device=CPU, **kwargs)
        self.add_state("hist", default=torch.zeros(bins), dist_reduce_fx="sum", sync_precision=precision)

    def update(self, x):
        self.hist = self.hist + x

    def compute(self):
        return self.hist


class JaxHist(JaxMetric):
    def __init__(self, precision="exact", bins=512, **kwargs):
        super().__init__(**kwargs)
        self.add_state("hist", default=jnp.zeros((bins,)), dist_reduce_fx="sum", sync_precision=precision)

    def update(self, x):
        self.hist = self.hist + x

    def compute(self):
        return self.hist


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ----------------------------------------------------------------------
# registration / eligibility
# ----------------------------------------------------------------------
def test_add_state_rejects_unknown_precision():
    m = Hist()
    with pytest.raises(ValueError, match="sync_precision"):
        m.add_state("bad", default=torch.zeros(4), dist_reduce_fx="sum", sync_precision="fp4")


def test_add_state_rejects_list_and_non_sum_states():
    m = Hist()
    with pytest.raises(ValueError, match="always sync exact"):
        m.add_state("cat", default=[], dist_reduce_fx="cat", sync_precision="int8")
    with pytest.raises(ValueError, match="always sync exact"):
        m.add_state("mx", default=torch.zeros(()), dist_reduce_fx="max", sync_precision="bf16")


def test_residual_companion_registered_and_reset():
    m = Hist("int8")
    assert m.sync_precisions() == {"hist": "int8"}
    assert m._reductions["hist__qres"] is dim_zero_sum
    assert m.hist__qres.dtype == torch.float32 and m.hist__qres.device.type == "cpu"
    m.update(torch.ones(512))
    m.hist__qres = torch.full((512,), 0.5)
    m.reset()
    assert float(m.hist.abs().max()) == 0.0
    assert float(m.hist__qres.abs().max()) == 0.0


def test_astype_keeps_residual_f32():
    m = Hist("int8", bins=16).astype(torch.bfloat16)
    assert m.hist.dtype == torch.bfloat16
    assert m.hist__qres.dtype == torch.float32
    assert m._defaults["hist__qres"].dtype == torch.float32


def test_set_sync_precision_defaults_to_eligible_states_only():
    roc = tm.ROC(device=CPU)
    assert roc.set_sync_precision("int8") == jm.ROC().set_sync_precision("int8") == {}
    cm = tm.ConfusionMatrix(num_classes=4, device=CPU)
    applied = cm.set_sync_precision("int8")
    assert applied and all(p == "int8" for p in applied.values())
    assert applied == jm.ConfusionMatrix(num_classes=4).set_sync_precision("int8")


@pytest.mark.parametrize(
    "name,port,jax_factory",
    [
        ("accuracy", lambda: tm.Accuracy(device=CPU), jm.Accuracy),
        ("stat_scores", lambda: tm.StatScores(num_classes=3, reduce="macro", device=CPU),
         lambda: jm.StatScores(num_classes=3, reduce="macro")),
        ("binned_auroc", lambda: tm.BinnedAUROC(num_bins=8, device=CPU), lambda: jm.BinnedAUROC(num_bins=8)),
        ("mse", lambda: tm.MeanSquaredError(device=CPU), jm.MeanSquaredError),
        ("psnr", lambda: tm.PSNR(device=CPU), jm.PSNR),
        ("r2", lambda: tm.R2Score(device=CPU), jm.R2Score),
    ],
)
def test_eligible_states_equal_jax_across_families(name, port, jax_factory):
    """Which states tier up (sum-reduced tensors) and which stay exact
    (lists, min/max/mean) is JAX's choice, family by family."""
    p, j = port(), jax_factory()
    assert p.set_sync_precision("bf16") == j.set_sync_precision("bf16")
    assert sorted(p._sync_residual_names()) == sorted(j._sync_residual_names())
    assert p.set_sync_precision("exact") == j.set_sync_precision("exact") == {}


def test_set_sync_precision_explicit_ineligible_state_raises():
    roc = tm.ROC(device=CPU)
    with pytest.raises((KeyError, ValueError)):
        roc.set_sync_precision("int8", states=["preds"])
    m = Hist("int8")
    with pytest.raises(KeyError):
        m.set_sync_precision("bf16", states=["hist__qres"])


def test_revert_to_exact_deregisters_residual():
    m = Hist("int8")
    assert "hist__qres" in m._defaults
    m.set_sync_precision("exact")
    assert m.sync_precisions() == {}
    assert "hist__qres" not in m._defaults and not hasattr(m, "hist__qres")
    m.set_sync_precision("bf16")
    assert m.sync_precisions() == {"hist": "bf16"}


def test_switching_tiers_keeps_the_residual():
    m = Hist("int8", bins=8)
    m.hist__qres = torch.full((8,), 0.25)
    assert m.set_sync_precision("bf16") == {"hist": "bf16"}
    assert torch.equal(m.hist__qres, torch.full((8,), 0.25))


def test_state_dict_roundtrip_carries_residual():
    m = Hist("int8", bins=32)
    m.update(torch.from_numpy(_RNG.rand(32).astype(np.float32)))
    m.hist__qres = torch.full((32,), 0.25)
    m.persistent(True)
    saved = m.state_dict()
    assert "hist__qres" in saved
    m2 = Hist("int8", bins=32)
    m2.persistent(True)
    m2.load_state_dict(saved, strict=True)
    assert torch.equal(m2.hist__qres, m.hist__qres)


def test_jax_state_dict_with_residual_loads_into_the_port():
    """A JAX metric's checkpoint, residual included, loads through
    ``state_from_jax`` and syncs to the same bits."""
    from metrics_tpu_torch.interop import state_from_jax

    x = (_RNG.rand(64) * 3).astype(np.float32)
    j = JaxHist("int8", bins=64)
    j.dist_sync_fn = jax_gather
    j.update(jnp.asarray(x))
    j.compute()
    j.persistent(True)
    m = Hist("int8", bins=64)
    m.persistent(True)
    m.load_state_dict(state_from_jax(j.state_dict()), strict=True)
    np.testing.assert_array_equal(_np(m.hist__qres), np.asarray(j.hist__qres))
    m.dist_sync_fn = gather_all_tensors
    j._computed = None
    np.testing.assert_array_equal(_np(m.compute()), np.asarray(j.compute()))


# ----------------------------------------------------------------------
# the host sync path in virtual worlds of 2
# ----------------------------------------------------------------------
def _ddp_sync(precision, data):
    results, jax_results = {}, {}

    def worker(rank, world):
        m = Hist(precision, bins=data.shape[1])
        m.dist_sync_fn = gather_all_tensors
        m.update(torch.from_numpy(data[rank]))
        out = _np(m.compute())
        results[rank] = (out, _np(m.hist), _np(getattr(m, "hist__qres", torch.zeros(1))))

    def jax_worker(rank, world):
        m = JaxHist(precision, bins=data.shape[1])
        m.dist_sync_fn = jax_gather
        m.update(jnp.asarray(data[rank]))
        out = np.asarray(m.compute())
        jax_results[rank] = (out, np.asarray(m.hist), np.asarray(getattr(m, "hist__qres", np.zeros(1))))

    run_virtual_ddp(2, worker)
    jax_run_virtual_ddp(2, jax_worker)
    return results, jax_results


@pytest.mark.parametrize("precision", ["int8", "bf16"])
def test_quantized_ddp_sync_close_to_exact_rank_agreeing_and_equal_to_jax(precision):
    data = (_RNG.rand(2, 512) * 5).astype(np.float32)
    exact = data[0] + data[1]
    results, jax_results = _ddp_sync(precision, data)
    out0, local0, res0 = results[0]
    np.testing.assert_array_equal(out0, results[1][0])
    bound = 2 * np.abs(data).max() / (254.0 if precision == "int8" else 2.0**8)
    assert np.abs(out0 - exact).max() <= bound + 1e-6
    np.testing.assert_array_equal(local0, data[0])  # accumulation unsynced and unquantized
    assert np.abs(res0).max() > 0  # the committed residual survives the restore
    for rank in (0, 1):
        for got, want in zip(results[rank], jax_results[rank]):
            np.testing.assert_array_equal(got, want)


def test_exact_default_is_bit_identical():
    data = (_RNG.rand(2, 128) * 3).astype(np.float32)
    results, jax_results = _ddp_sync("exact", data)
    out0, _, res0 = results[0]
    np.testing.assert_array_equal(out0, (torch.from_numpy(data[0]) + torch.from_numpy(data[1])).numpy())
    np.testing.assert_array_equal(out0, jax_results[0][0])
    assert np.abs(res0).max() == 0.0


def test_repeated_syncs_do_not_drift_and_equal_jax():
    data = (_RNG.rand(2, 256) * 4).astype(np.float32)
    errs, outs, jax_outs = {}, {}, {}

    def worker(rank, world):
        m = Hist("int8", bins=256)
        m.dist_sync_fn = gather_all_tensors
        batch = torch.from_numpy(data[rank])
        per_sync = []
        for step in range(1, 9):
            m.update(batch)
            out = _np(m.compute())
            per_sync.append(np.abs(out - (data[0] + data[1]) * step).max())
            outs.setdefault(rank, []).append(out)
        errs[rank] = per_sync

    def jax_worker(rank, world):
        m = JaxHist("int8", bins=256)
        m.dist_sync_fn = jax_gather
        for _ in range(1, 9):
            m.update(jnp.asarray(data[rank]))
            jax_outs.setdefault(rank, []).append(np.asarray(m.compute()))

    run_virtual_ddp(2, worker)
    jax_run_virtual_ddp(2, jax_worker)
    single_sync_bound = 2 * np.abs(data).max() * 8 / 254.0 + 1e-6
    assert max(errs[0]) <= 4 * single_sync_bound
    for rank in (0, 1):
        for got, want in zip(outs[rank], jax_outs[rank]):
            np.testing.assert_array_equal(got, want)


def test_sync_telemetry_counts_the_wire_bytes_like_jax():
    """``sync.payload_bytes`` is the f32 state, ``sync.wire_bytes`` the int8
    codes and scales (512 + 16 bytes): the same counters as JAX's."""
    import metrics_tpu.observability as jobs
    import metrics_tpu_torch.observability as obs

    x = (_RNG.rand(512) * 2).astype(np.float32)
    m, j = Hist("int8"), JaxHist("int8")
    m.dist_sync_fn, j.dist_sync_fn = gather_all_tensors, jax_gather
    m.update(torch.from_numpy(x))
    j.update(jnp.asarray(x))
    try:
        with obs.telemetry_scope() as tel, jobs.telemetry_scope() as jtel:
            m.compute()
            j.compute()
        keys = ("sync.calls", "sync.payload_bytes", "sync.wire_bytes")
        assert {k: tel.counters[k] for k in keys} == {k: jtel.counters[k] for k in keys}
        assert tel.counters["sync.wire_bytes"] == 512 + 4 * 4
        event = [e for e in tel.events if e["kind"] == "sync"][-1]
        jevent = [e for e in jtel.events if e["kind"] == "sync"][-1]
        assert {k: event[k] for k in ("payload_bytes", "wire_bytes", "quantized_states")} == {
            k: jevent[k] for k in ("payload_bytes", "wire_bytes", "quantized_states")}
    finally:
        for pkg in (obs, jobs):
            pkg.disable()
            pkg.get().reset()


# ----------------------------------------------------------------------
# collection knob + step engine signature identity
# ----------------------------------------------------------------------
def test_collection_knob_applies_to_eligible_members_only():
    col = tm.MetricCollection({"cm": tm.ConfusionMatrix(num_classes=3, device=CPU), "roc": tm.ROC(device=CPU)},
                              sync_precision="int8")
    jcol = jm.MetricCollection({"cm": jm.ConfusionMatrix(num_classes=3), "roc": jm.ROC()}, sync_precision="int8")
    per_member = col.sync_precisions()
    assert per_member["roc"] == {}
    assert per_member["cm"] and all(p == "int8" for p in per_member["cm"].values())
    assert per_member == jcol.sync_precisions()
    assert col.set_sync_precision("exact") == {"cm": {}, "roc": {}}


def _cls(n=64, c=4):
    probs = _RNG.rand(n, c).astype(np.float32)
    return torch.from_numpy(probs), torch.from_numpy(_RNG.randint(c, size=n))


def test_engine_cache_keys_on_precision_flip():
    probs, target = _cls()
    col = tm.MetricCollection({"acc": tm.Accuracy(device=CPU), "cm": tm.ConfusionMatrix(num_classes=4, device=CPU)},
                              compiled=True)
    col.forward(probs, target)
    engine = col._engine
    base = engine.trace_count
    col.forward(probs, target)
    assert engine.trace_count == base

    col.set_sync_precision("int8")
    col.forward(probs, target)
    assert engine.trace_count == base + 1  # tier flip: a new build

    col.set_sync_precision("bf16")
    col.forward(probs, target)
    assert engine.trace_count == base + 2  # same states, another tier: another build

    col.set_sync_precision("exact")
    col.forward(probs, target)
    assert engine.trace_count == base + 2  # back to the first signature: its build is reused


def test_compiled_results_identical_across_precision_flip_without_sync():
    probs, target = _cls()
    exact_col = tm.MetricCollection({"cm": tm.ConfusionMatrix(num_classes=4, device=CPU)}, compiled=True)
    q_col = tm.MetricCollection({"cm": tm.ConfusionMatrix(num_classes=4, device=CPU)}, compiled=True,
                                sync_precision="int8")
    a = exact_col.forward(probs, target)
    b = q_col.forward(probs, target)
    assert torch.equal(a["cm"], b["cm"])
    assert torch.equal(exact_col["cm"].confmat, q_col["cm"].confmat)
    # the engine's (accumulated, batch) fold leaves the residual at zero
    q_col.forward(probs, target)
    res = q_col["cm"].confmat__qres
    assert res.dtype == torch.float32 and float(res.abs().max()) == 0.0


# ----------------------------------------------------------------------
# dist_sync_on_step: the residual rides the SYNC stream, not accumulation
# ----------------------------------------------------------------------
class StepHist(Metric):
    def __init__(self, fused=False):
        super().__init__(dist_sync_on_step=True, device=CPU)
        if fused:
            self._fused_forward = True
        self.add_state("hist", default=torch.zeros(256), dist_reduce_fx="sum", sync_precision="int8")
        self.dist_sync_fn = gather_all_tensors  # force the host sync path

    def update(self, x):
        self.hist = self.hist + x

    def compute(self):
        return self.hist


class JaxStepHist(JaxMetric):
    def __init__(self, fused=False):
        super().__init__(dist_sync_on_step=True)
        if fused:
            self._fused_forward = True
        self.add_state("hist", default=jnp.zeros((256,)), dist_reduce_fx="sum", sync_precision="int8")
        self.dist_sync_fn = jax_gather

    def update(self, x):
        self.hist = self.hist + x

    def compute(self):
        return self.hist


@pytest.mark.parametrize("fused", [False, True], ids=["classic", "fused"])
def test_step_sync_error_feedback_advances_across_forwards(fused):
    bn = (_RNG.rand(256) * 5).astype(np.float32)
    batch = torch.from_numpy(bn)
    m, j = StepHist(fused=fused), JaxStepHist(fused=fused)
    m(batch)
    j(jnp.asarray(bn))
    r1 = m.hist__qres.clone()
    assert float(r1.abs().max()) > 0
    _, want_r2 = q.compensate_and_quantize(batch, r1, "int8")
    m(batch)
    j(jnp.asarray(bn))
    assert torch.equal(m.hist__qres, want_r2)
    for _ in range(6):
        m(batch)
        j(jnp.asarray(bn))
    step = (float(batch.abs().max()) + float(r1.abs().max())) / 127.0
    assert float(m.hist__qres.abs().max()) <= step + 1e-6
    np.testing.assert_allclose(_np(m.hist), bn * 8, rtol=1e-6)
    # every step's recurrence and the accumulation are JAX's bits
    np.testing.assert_array_equal(_np(m.hist__qres), np.asarray(j.hist__qres))
    np.testing.assert_array_equal(_np(m.hist), np.asarray(j.hist))


def test_fused_merge_does_not_sum_residuals_into_accumulation():
    batch = torch.from_numpy((_RNG.rand(256) * 3).astype(np.float32))
    m = StepHist(fused=True)
    m(batch)
    r1 = m.hist__qres.clone()
    m(batch)
    r2 = m.hist__qres.clone()
    _, want_r2 = q.compensate_and_quantize(batch, r1, "int8")
    assert torch.equal(r2, want_r2)
    assert not torch.equal(r2, r1 + want_r2)


def test_forward_without_sync_leaves_the_residual_alone():
    """A forward whose step does not sync must hand back the residual it
    found (seeded into the batch pass, restored after), on both paths."""
    for fused in (False, True):
        m = Hist("int8", bins=16)
        m._fused_forward = fused
        m.hist__qres = torch.full((16,), 0.125)
        m(torch.ones(16))
        m(torch.ones(16))
        assert torch.equal(m.hist__qres, torch.full((16,), 0.125))
        assert torch.equal(m.hist, torch.full((16,), 2.0))


# ----------------------------------------------------------------------
# the cohort's sync (tests/bases/test_cohort.py)
# ----------------------------------------------------------------------
def _grid(rng, shape):
    return (rng.randint(0, 256, size=shape) / 256.0).astype(np.float32)


def test_cohort_sync_exact_bit_identical_across_ranks():
    results = {}

    def worker(rank, world):
        rng = np.random.RandomState(20 + rank)
        p, t = torch.from_numpy(_grid(rng, (2, 16))), torch.from_numpy(_grid(rng, (2, 16)))
        cohort = tm.MetricCohort(tm.MetricCollection([tm.MeanSquaredError(device=CPU)]), tenants=2)
        cohort(p, t)
        synced = _np(cohort.compute()["MeanSquaredError"])
        oracle = []
        for i in range(2):
            col = tm.MetricCollection([tm.MeanSquaredError(device=CPU)])
            col(p[i], t[i])
            oracle.append(_np(col.compute()["MeanSquaredError"]))
        results[rank] = (synced, np.asarray(oracle))
        cohort(p, t)

    run_virtual_ddp(2, worker)
    for rank in (0, 1):
        synced, oracle = results[rank]
        np.testing.assert_array_equal(synced, oracle)
    np.testing.assert_array_equal(results[0][0], results[1][0])


def _cohort_int8_world(port: bool, grid: bool = False):
    results = {}

    def worker(rank, world):
        rng = np.random.RandomState(30 + rank)
        if port:
            cohort = tm.MetricCohort(tm.MetricCollection([tm.MeanSquaredError(device=CPU)], sync_precision="int8"),
                                     tenants=2)
            exact = tm.MetricCohort(tm.MetricCollection([tm.MeanSquaredError(device=CPU)]), tenants=2)
        else:
            cohort = jm.MetricCohort(jm.MetricCollection([jm.MeanSquaredError()], sync_precision="int8"), tenants=2)
            exact = jm.MetricCohort(jm.MetricCollection([jm.MeanSquaredError()]), tenants=2)
        for _ in range(3):
            if grid:
                pn, tn = _grid(rng, (2, 16)), _grid(rng, (2, 16))
            else:
                pn, tn = rng.rand(2, 16).astype(np.float32), rng.rand(2, 16).astype(np.float32)
            p, t = (torch.from_numpy(pn), torch.from_numpy(tn)) if port else (jnp.asarray(pn), jnp.asarray(tn))
            cohort(p, t)
            exact(p, t)
            results.setdefault(rank, []).append(
                (_np(cohort.compute()["MeanSquaredError"]), _np(exact.compute()["MeanSquaredError"])))
        res = cohort._states["MeanSquaredError"]["sum_squared_error__qres"]
        results[f"res{rank}"] = (_np(res), int(res.shape[0]), str(res.dtype), cohort.capacity)

    (run_virtual_ddp if port else jax_run_virtual_ddp)(2, worker)
    return results


def test_cohort_sync_int8_residuals_within_bound_and_equal_to_jax():
    results = _cohort_int8_world(port=True)
    jax_results = _cohort_int8_world(port=False)
    for rank in (0, 1):
        for qv, e in results[rank]:
            np.testing.assert_allclose(qv, e, atol=1e-2)
        res, rows, dtype, capacity = results[f"res{rank}"]
        assert rows == capacity and dtype == "torch.float32" and np.abs(res).max() > 0
    np.testing.assert_array_equal(results[0][0][0], results[1][0][0])
    # on grid rows (exact per-tenant sums in both packages) the quantized
    # stacks' residuals are JAX's bits and the values within 1e-6
    results = _cohort_int8_world(port=True, grid=True)
    jax_results = _cohort_int8_world(port=False, grid=True)
    for rank in (0, 1):
        np.testing.assert_array_equal(results[f"res{rank}"][0], jax_results[f"res{rank}"][0])
        for (qv, _), (jq_v, _) in zip(results[rank], jax_results[rank]):
            np.testing.assert_allclose(qv, jq_v, rtol=1e-6)
