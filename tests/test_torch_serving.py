"""The port's ``serving/`` against the JAX package's, on the CPU.

Every case of ``tests/bases/test_serving.py`` is mirrored but two: the
``FINGERPRINTS.json`` case audits jaxprs (``analysis/``, not ported), and
``test_healthz_reports_degraded_on_slo_breach`` needs the exporter (the rest
of ``observability/``, not ported): its ``healthz_payload()`` part is held
directly. With them, the two admission cases of
``tests/analysis/test_serving_concurrency.py``, run against the port's own
admission checks (``analysis/concurrency.py``) with test-only twins of the JAX package's
``DoubleBufferAliaser`` and ``HostReadOfDonated``
(``metrics_tpu/analysis/fixtures.py``), and parity scenarios that run both
packages on the same seeded numpy batches: values, admission verdicts,
``serving.*`` counters, SLO verdicts, ingest accounting and the background
writer's envelopes.

One deliberate difference shapes the cases: the port runs the first batch,
and every batch whose step signature is not built yet, on the caller thread
(a build's warm-up turns on a process-global sync debug mode on the card).
So where a JAX case needs the worker thread for its first batch, the port's
case stages one warm batch first, and says so.

Tolerance: the port's async path is bit-equal to its own blocking path;
counts and stats equal JAX's exactly; float values within 1e-5 of JAX's.
Every wait has a bound.
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.observability as jobs
import metrics_tpu_torch as tm
import metrics_tpu_torch.observability as obs
from metrics_tpu.serving import AsyncServingEngine as JaxAsyncServingEngine
from metrics_tpu.serving import IngestQueue as JaxIngestQueue
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.serving import (
    AsyncServingEngine,
    BackgroundCheckpointer,
    IngestQueue,
    ServingAdmissionError,
    ServingSLO,
)
from metrics_tpu_torch.analysis import concurrency as _admission

CPU = "cpu"
WAIT_S = 30.0


@pytest.fixture(autouse=True)
def _clean_telemetry():
    from metrics_tpu.serving import slo as jslo
    from metrics_tpu_torch.serving import slo as tslo

    def clean():
        for pkg in (jobs, obs):
            pkg.disable()
            pkg.get().reset()
            pkg.disable_flight()
            pkg.disable_tracing()
            pkg.get_tracer().reset()
        # a breaching SLO kept alive by a test frame must not reach a later test
        jslo._ACTIVE.clear()
        tslo._ACTIVE.clear()

    clean()
    yield
    clean()


@pytest.fixture(autouse=True)
def _bounded_drains(monkeypatch):
    """Every barrier of both packages' pipelines has a bound, the implicit
    ones too (``compute()``, ``close()``, an enrolled target's
    ``compute()``): a hang in a worker fails its test instead of running out
    the suite's clock."""
    for cls in (AsyncServingEngine, JaxAsyncServingEngine):
        real = cls.drain
        monkeypatch.setattr(cls, "drain", lambda self, timeout_s=WAIT_S, _real=real: _real(self, timeout_s))


# ----------------------------------------------------------------------
# inputs and factories: the same seeded numpy batches for both packages
# ----------------------------------------------------------------------
def _cls_batches(n=5, seed=0, rows=96):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        p = rng.rand(rows, 4).astype(np.float32)
        p /= p.sum(1, keepdims=True)
        out.append((p, rng.randint(4, size=rows).astype(np.int32)))
    return out


def _reg_batches(n=5, seed=1, rows=96):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rng.rand(rows).astype(np.float32)
        out.append((t + rng.randn(rows).astype(np.float32) * 0.1, t))
    return out


def _t(batch):
    return tuple(torch.from_numpy(np.asarray(a)) for a in batch)


def _j(batch):
    return tuple(jnp.asarray(a) for a in batch)


def _cls_col(**kw):
    return tm.MetricCollection(
        [
            tm.Accuracy(device=CPU),
            tm.Precision(num_classes=4, average="macro", device=CPU),
            tm.Recall(num_classes=4, average="macro", device=CPU),
            tm.F1(num_classes=4, average="macro", device=CPU),
        ],
        compiled=True,
        **kw,
    )


def _jax_cls_col(**kw):
    return jm.MetricCollection(
        [
            jm.Accuracy(),
            jm.Precision(num_classes=4, average="macro"),
            jm.Recall(num_classes=4, average="macro"),
            jm.F1(num_classes=4, average="macro"),
        ],
        compiled=True,
        **kw,
    )


def _reg_col(**kw):
    return tm.MetricCollection(
        [tm.MeanSquaredError(device=CPU), tm.MeanAbsoluteError(device=CPU), tm.R2Score(device=CPU)],
        compiled=True,
        **kw,
    )


def _jax_reg_col(**kw):
    return jm.MetricCollection([jm.MeanSquaredError(), jm.MeanAbsoluteError(), jm.R2Score()], compiled=True, **kw)


def _assert_collections_bitwise(a, b):
    for key in a.keys():
        for sname in a[key]._defaults:
            assert torch.equal(getattr(a[key], sname), getattr(b[key], sname)), f"state {key}.{sname}"


def _assert_close_to_jax(port_values, jax_values):
    assert set(port_values) == set(jax_values)
    for k in jax_values:
        np.testing.assert_allclose(
            np.asarray(port_values[k], dtype=np.float64), np.asarray(jax_values[k], dtype=np.float64),
            rtol=1e-5, atol=1e-6, err_msg=k,
        )


def _serve_jax(col, batches):
    pipe = JaxAsyncServingEngine(col)
    for b in batches:
        pipe.forward(*_j(b))
    values = pipe.compute()
    stats = dict(pipe.stats)
    pipe.close()
    return values, stats


# test-only twins of the JAX package's double-buffer hazard fixtures
class DoubleBufferAliaser(Metric):
    """``reset()`` reseeds the state from a tensor held since construction:
    every generation after a reset starts on the same tensor."""

    _fused_forward = True

    def __init__(self):
        super().__init__(device=CPU)
        self._pool = torch.zeros(())
        self.add_state("acc", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x):
        self.acc = self.acc + torch.sum(x)

    def compute(self):
        return self.acc

    def reset(self):
        super().reset()
        self.acc = self._pool  # the alias


class HostReadOfDonated(Metric):
    """``compute`` stashes the live state in a plain attribute."""

    _fused_forward = True

    def __init__(self):
        super().__init__(device=CPU)
        self.add_state("acc", default=torch.zeros(()), dist_reduce_fx="sum")
        self._last_value = None

    def update(self, x):
        self.acc = self.acc + torch.sum(x)

    def compute(self):
        self._last_value = self.acc  # the escape
        return self.acc


# ----------------------------------------------------------------------
# 1. async == blocking, bitwise; and the JAX package's values
# ----------------------------------------------------------------------
@pytest.mark.parametrize(
    "make_col,make_jax,batches",
    [(_cls_col, _jax_cls_col, _cls_batches()), (_reg_col, _jax_reg_col, _reg_batches())],
    ids=["classification4", "regression3"],
)
def test_async_collection_bit_identical_to_blocking(make_col, make_jax, batches):
    blocking = make_col()
    for b in batches:
        blocking(*_t(b))
    e_blocking = blocking.compute()

    served = make_col()
    pipe = AsyncServingEngine(served)
    assert pipe.is_async, pipe.refusal_reason
    for b in batches:
        assert pipe.forward(*_t(b)) is None  # the async path returns no value
    e_async = pipe.compute()
    for k in e_blocking:
        assert torch.equal(e_blocking[k], e_async[k]), k
    _assert_collections_bitwise(blocking, served)
    assert pipe.stats["dispatches"] == len(batches)
    assert pipe.stats["errors"] == 0
    assert pipe.stats["inline_steps"] == 1  # the first batch, on the caller
    stats = dict(pipe.stats)
    pipe.close()

    jax_values, jax_stats = _serve_jax(make_jax(), batches)
    _assert_close_to_jax(e_async, jax_values)
    assert {k: stats[k] for k in jax_stats} == jax_stats


def _cohort_batches():
    rng = np.random.RandomState(2)
    out = []
    for _ in range(4):
        p = rng.rand(3, 32, 4).astype(np.float32)
        p /= p.sum(-1, keepdims=True)
        out.append((p, rng.randint(4, size=(3, 32)).astype(np.int32)))
    return out


def test_async_cohort_bit_identical_to_blocking():
    batches = _cohort_batches()

    def cohort():
        return tm.MetricCohort(
            tm.MetricCollection([tm.Accuracy(device=CPU), tm.Precision(num_classes=4, average="macro", device=CPU)]),
            tenants=3,
        )

    blocking = cohort()
    for b in batches:
        blocking(*_t(b))
    e_blocking = blocking.compute()

    served = cohort()
    pipe = AsyncServingEngine(served)
    assert pipe.is_async, pipe.refusal_reason
    for b in batches:
        pipe.forward(*_t(b))
    e_async = served.compute()  # the cohort's own compute drains first
    for k in e_blocking:
        assert torch.equal(e_blocking[k], e_async[k]), k
    for name in blocking._states:
        for sname, v in blocking._states[name].items():
            assert torch.equal(v, served._states[name][sname]), f"stacked {name}.{sname}"
    pipe.close()

    jcohort = jm.MetricCohort(
        jm.MetricCollection([jm.Accuracy(), jm.Precision(num_classes=4, average="macro")]), tenants=3
    )
    jpipe = JaxAsyncServingEngine(jcohort)
    for b in batches:
        jpipe.forward(*_j(b))
    _assert_close_to_jax(e_async, jcohort.compute())
    jpipe.close()


def test_async_int8_sync_tier_bit_identical_to_blocking():
    """The quantized tier composes: the residual companions ride the async
    path as they ride the blocking one."""
    batches = _reg_batches(n=4, seed=3)
    blocking = _reg_col(sync_precision="int8")
    for b in batches:
        blocking(*_t(b))
    e_blocking = blocking.compute()

    served = _reg_col(sync_precision="int8")
    pipe = AsyncServingEngine(served)
    assert pipe.is_async, pipe.refusal_reason
    for b in batches:
        pipe.forward(*_t(b))
    e_async = pipe.compute()
    for k in e_blocking:
        assert torch.equal(e_blocking[k], e_async[k]), k
    _assert_collections_bitwise(blocking, served)  # the __qres residuals too
    assert [s for m in served.values() for s in m._sync_residual_names()]
    pipe.close()
    jax_values, _ = _serve_jax(_jax_reg_col(sync_precision="int8"), batches)
    _assert_close_to_jax(e_async, jax_values)


def test_async_single_metric_uses_its_own_engine():
    batches = _cls_batches(n=4, seed=21)
    blocking = tm.Accuracy(device=CPU)
    for b in batches:
        blocking(*_t(b))
    served = tm.Accuracy(device=CPU)
    pipe = AsyncServingEngine(served)
    assert pipe.is_async and pipe._engine is not None
    for b in batches:
        pipe.forward(*_t(b))
    assert torch.equal(pipe.compute(), blocking.compute())
    assert pipe.stats["dispatches"] == 4 and pipe._engine.trace_count == 1
    pipe.close()


def test_unbuilt_signature_runs_on_the_caller_after_the_worker_drains():
    """A batch whose signature the engine has not built never reaches the
    worker: it waits for the worker to go idle and runs on the caller
    thread. The values stay the blocking path's bits."""
    long_b = _cls_batches(n=3, seed=22, rows=96)
    short_b = _cls_batches(n=2, seed=23, rows=40)
    order = [long_b[0], long_b[1], short_b[0], long_b[2], short_b[1]]
    blocking = _cls_col()
    for b in order:
        blocking(*_t(b))
    served = _cls_col()
    pipe = AsyncServingEngine(served)
    threads = []
    real = pipe._dispatch

    def spy(args, kwargs):
        threads.append(threading.current_thread() is threading.main_thread())
        return real(args, kwargs)

    pipe._dispatch = spy
    for b in order:
        pipe.forward(*_t(b))
    pipe.drain(timeout_s=WAIT_S)
    # first batch and first 40-row batch on the caller; the rest on the worker
    assert threads == [True, False, True, False, False]
    assert pipe.stats["inline_steps"] == 2 and pipe.stats["dispatches"] == 5
    assert served._engine.trace_count == 2
    _assert_collections_bitwise(blocking, served)
    pipe.close()


def _small_cohort():
    return tm.MetricCohort(
        tm.MetricCollection([tm.Accuracy(device=CPU), tm.Precision(num_classes=4, average="macro", device=CPU)]),
        tenants=3,
    )


@pytest.mark.parametrize("kind", ["collection", "cohort"])
def test_forward_returns_while_the_worker_holds_a_step(kind):
    """The serve loop's built-signature lookup takes no engine lock: a batch
    staged while the worker sits inside a step (the engine's lock held)
    returns at once instead of waiting for that step."""
    if kind == "collection":
        make, batches = _cls_col, [_t(b) for b in _cls_batches(n=4, seed=24)]
    else:
        make, batches = _small_cohort, [_t(b) for b in _cohort_batches()]
    blocking = make()
    for b in batches:
        blocking(*b)
    served = make()
    pipe = AsyncServingEngine(served)
    pipe.forward(*batches[0])  # built on the caller
    engine = served._engine
    inside, release = threading.Event(), threading.Event()
    real_run = engine._run

    def held(*args, **kwargs):
        if threading.current_thread() is pipe._worker:
            inside.set()
            release.wait(WAIT_S)
        return real_run(*args, **kwargs)

    engine._run = held
    pipe.forward(*batches[1])
    assert inside.wait(WAIT_S) and engine._lock.locked()
    staged = threading.Event()
    stager = threading.Thread(target=lambda: (pipe.forward(*batches[2]), staged.set()), daemon=True)
    stager.start()
    returned = staged.wait(5.0)
    held_meanwhile = engine._lock.locked() and not release.is_set()
    release.set()
    stager.join(WAIT_S)
    assert returned and held_meanwhile, "forward() waited for the worker's step"
    pipe.forward(*batches[3])
    got = pipe.compute()
    for k, v in blocking.compute().items():
        assert torch.equal(got[k], v), k
    assert pipe.stats["dispatches"] == 4 and pipe.stats["inline_steps"] == 1
    pipe.close()


# ----------------------------------------------------------------------
# 2. admission
# ----------------------------------------------------------------------
def test_admission_refuses_double_buffer_hazard_classes():
    from metrics_tpu.analysis import fixtures as jfix

    for cls, jcls in ((DoubleBufferAliaser, jfix.DoubleBufferAliaser), (HostReadOfDonated, jfix.HostReadOfDonated)):
        pipe = AsyncServingEngine(cls())
        assert not pipe.is_async
        assert "MTA009" in pipe.refusal_reason
        # the blocking path still serves, and returns values
        v = pipe.forward(torch.ones(4))
        assert v is not None and float(v) == 4.0
        assert pipe.stats["blocking_steps"] == 1
        with pytest.raises(ServingAdmissionError):
            AsyncServingEngine(cls(), strict=True)
        jpipe = JaxAsyncServingEngine(jcls())
        assert not jpipe.is_async and "MTA009" in jpipe.refusal_reason
        # the same flavor, method and attribute as the JAX package's verdict
        flavor = pipe.refusal_reason.split("(")[1].split(" line")[0]
        assert flavor == jpipe.refusal_reason.split("(")[1].split(" line")[0]


def test_admission_refusal_counts_demotion_telemetry():
    from metrics_tpu.analysis.fixtures import DoubleBufferAliaser as JaxAliaser

    with obs.telemetry_scope():
        AsyncServingEngine(DoubleBufferAliaser())
        port = obs.get().counters.get("serving.demotions", 0)
    with jobs.telemetry_scope():
        JaxAsyncServingEngine(JaxAliaser())
        jax_count = jobs.get().counters.get("serving.demotions", 0)
    assert port == jax_count == 1


def test_admission_refuses_engine_ineligible_members():
    pipe = AsyncServingEngine(tm.PrecisionRecallCurve(device=CPU))  # a list state: eager only
    assert not pipe.is_async
    assert "engine-eligible" in pipe.refusal_reason
    north_star = tm.MetricCollection([tm.Accuracy(device=CPU), tm.AUROC(pos_label=1, device=CPU)])
    pipe = AsyncServingEngine(north_star)
    assert not pipe.is_async and "'AUROC' is not engine-eligible" in pipe.refusal_reason
    rng = np.random.RandomState(24)
    p, t = rng.rand(64).astype(np.float32), rng.randint(2, size=64).astype(np.int32)
    reference = tm.MetricCollection([tm.Accuracy(device=CPU), tm.AUROC(pos_label=1, device=CPU)])
    reference(*_t((p, t)))
    out = pipe.forward(*_t((p, t)))
    assert set(out) == {"Accuracy", "AUROC"}
    for k, v in reference.compute().items():
        assert torch.equal(pipe.compute()[k], v)
    pipe.close()


# the families both packages' admission judges (the JAX package's registry
# names), each built with the same arguments
ADMISSION_FAMILIES = [
    ("Accuracy", {}),
    ("Precision", {"num_classes": 4, "average": "macro"}),
    ("Recall", {"num_classes": 4, "average": "macro"}),
    ("F1", {"num_classes": 4, "average": "macro"}),
    ("FBeta", {"num_classes": 4, "beta": 0.5}),
    ("StatScores", {"num_classes": 4, "reduce": "macro"}),
    ("HammingDistance", {}),
    ("ConfusionMatrix", {"num_classes": 4}),
    ("CohenKappa", {"num_classes": 4}),
    ("MatthewsCorrcoef", {"num_classes": 4}),
    ("IoU", {"num_classes": 4}),
    ("Hinge", {}),
    ("MeanSquaredError", {}),
    ("MeanAbsoluteError", {}),
    ("MeanSquaredLogError", {}),
    ("R2Score", {}),
    ("ExplainedVariance", {}),
    ("PSNR", {}),
    ("SSIM", {}),
    ("AUROC", {"pos_label": 1}),
    ("AveragePrecision", {"pos_label": 1}),
    ("ROC", {"pos_label": 1}),
    ("PrecisionRecallCurve", {"pos_label": 1}),
    ("BinnedAUROC", {"num_bins": 16}),
    ("BinnedAveragePrecision", {"num_bins": 16}),
    ("RetrievalMAP", {}),
    ("RetrievalMRR", {}),
]


@pytest.mark.parametrize("family,kwargs", ADMISSION_FAMILIES, ids=[f for f, _ in ADMISSION_FAMILIES])
def test_admission_verdict_equals_jax(family, kwargs):
    """Admitted or refused, and for what kind of reason, as the JAX
    package's admission decides for the same family."""
    from metrics_tpu.serving.async_engine import _admission_refusal as jax_refusal
    from metrics_tpu_torch.serving.async_engine import _admission_refusal

    port = _admission_refusal(getattr(tm, family)(device=CPU, **kwargs))
    ref = jax_refusal(getattr(jm, family)(**kwargs))
    assert (port is None) == (ref is None), (port, ref)
    if ref is not None:
        assert ref.split(":")[0] == port.split(":")[0]


def test_admission_is_the_prover_verdict():
    """The enrollment refusal and the AST checks agree: the hazard twins
    refused, clean families admitted, and the first-dispatch check on the
    real tensors of an admitted family's first step is hazard-free."""
    from metrics_tpu_torch.serving.async_engine import _admission_refusal

    assert _admission_refusal(tm.Accuracy(device=CPU)) is None
    assert _admission_refusal(tm.MetricCollection([tm.Accuracy(device=CPU)], compiled=True)) is None
    for cls in (DoubleBufferAliaser, HostReadOfDonated):
        reason = _admission_refusal(cls())
        assert reason is not None and "MTA009" in reason
    assert _admission._host_reference_hazards(DoubleBufferAliaser, {"acc"}) == [
        ("host_cached_seed", "reset", "acc", 20)
    ]
    assert _admission._host_reference_hazards(HostReadOfDonated, {"acc"})[0][:3] == (
        "state_ref_escape", "compute", "_last_value"
    )

    metric = tm.Accuracy(device=CPU)
    engine = tm.CompiledStepEngine(metric, observe=False)
    rng = np.random.RandomState(0)
    p = torch.from_numpy(rng.rand(16, 4).astype(np.float32))
    t = torch.from_numpy(rng.randint(4, size=16))
    value = engine(p, t)
    states = [(s, getattr(metric, s)) for s in metric._defaults]
    defaults = {_admission._storage(d) for d in metric._defaults.values()} - {None}
    assert _admission.first_dispatch_hazards(states, _admission.engine_owned(engine), defaults, value) == []


def test_first_dispatch_check_reports_the_four_hazard_kinds():
    a, b, d = torch.ones(3), torch.ones(3), torch.zeros(2)
    buf = torch.ones(4)
    states = [("m.a", a), ("m.b", a[:2]), ("m.c", d), ("m.e", buf), ("m.f", b)]
    hazards = _admission.first_dispatch_hazards(states, {_admission._storage(buf)}, {_admission._storage(d)}, b)
    assert [h["kind"] for h in hazards] == [
        "duplicate_state_output", "const_state_output", "donated_passthrough", "cross_generation_alias"
    ]
    assert hazards[0]["shares"] == "m.a" and hazards[-1]["state"] == "m.f"


def test_first_dispatch_hazard_demotes_before_any_batch_is_queued():
    """A refusal by the first-dispatch check moves the pipeline to the
    blocking path with its first batch already folded in."""
    batches = _cls_batches(n=3, seed=25)
    served = _cls_col()
    pipe = AsyncServingEngine(served)
    real = _admission.first_dispatch_hazards
    _admission.first_dispatch_hazards = lambda *a: [{"kind": "donated_passthrough", "position": 0}]
    try:
        with obs.telemetry_scope():
            pipe.forward(*_t(batches[0]))
            assert obs.get().counters.get("serving.demotions") == 1
    finally:
        _admission.first_dispatch_hazards = real
    assert not pipe.is_async and "first-dispatch" in pipe.refusal_reason
    assert pipe._worker is None
    for b in batches[1:]:
        assert pipe.forward(*_t(b)) is not None  # blocking: values returned
    reference = _cls_col()
    for b in batches:
        reference(*_t(b))
    _assert_collections_bitwise(reference, served)
    pipe.close()


def test_writeback_stays_generation_monotonic_with_the_counter():
    assert _admission.writeback_generation_monotonic() is True


# ----------------------------------------------------------------------
# 3. barriers
# ----------------------------------------------------------------------
def test_compute_on_enrolled_collection_drains_staged_batches_first():
    batches = _cls_batches(n=6, seed=4)
    reference = _cls_col()
    for b in batches:
        reference(*_t(b))
    e_ref = reference.compute()

    served = _cls_col()
    pipe = AsyncServingEngine(served)
    for b in batches:
        pipe.forward(*_t(b))
    e = served.compute()  # no explicit drain: compute() is the barrier
    for k in e_ref:
        assert torch.equal(e_ref[k], e[k]), k
    assert pipe.stats["dispatches"] == len(batches)
    pipe.close()


def test_compute_on_enrolled_metric_drains_first():
    batches = _reg_batches(n=4, seed=26)
    served = tm.MeanSquaredError(device=CPU)
    pipe = AsyncServingEngine(served)
    for b in batches:
        pipe.forward(*_t(b))
    reference = tm.MeanSquaredError(device=CPU)
    for b in batches:
        reference(*_t(b))
    assert torch.equal(served.compute(), reference.compute())  # Metric._wrap_compute drains
    pipe.close()
    assert served._serving_pipeline is None


def test_drain_surfaces_bad_batch_error_once_and_keeps_state():
    good = _cls_batches(n=2, seed=5)
    served = _cls_col()
    pipe = AsyncServingEngine(served)
    for b in good:
        pipe.forward(*_t(b))
    pipe.drain(timeout_s=WAIT_S)
    bad_p, bad_t = _t(good[0])[0], _t(good[1])[1][:-7]  # mismatched rows
    pipe.forward(bad_p, bad_t)
    with pytest.raises(Exception):
        pipe.drain(timeout_s=WAIT_S)
    assert pipe.stats["errors"] == 1
    pipe.drain(timeout_s=WAIT_S)  # consumed: the barrier is clean now

    reference = _cls_col()
    for b in good:
        reference(*_t(b))
    _assert_collections_bitwise(reference, served)
    pipe.forward(*_t(good[0]))  # still serving
    pipe.drain(timeout_s=WAIT_S)
    assert pipe.stats["dispatches"] == len(good) + 1
    pipe.close()


def test_first_batch_error_is_parked_for_the_barrier():
    """The caller-thread first batch keeps the worker's contract: its
    failure surfaces at the barrier, and the next batch is the first
    dispatch again."""
    good = _cls_batches(n=2, seed=27)
    served = _cls_col()
    pipe = AsyncServingEngine(served)
    assert pipe.forward(_t(good[0])[0], _t(good[1])[1][:-7]) is None
    with pytest.raises(Exception):
        pipe.drain(timeout_s=WAIT_S)
    assert pipe._worker is None and not pipe._proof_done
    for b in good:
        pipe.forward(*_t(b))
    reference = _cls_col()
    for b in good:
        reference(*_t(b))
    pipe.drain(timeout_s=WAIT_S)
    _assert_collections_bitwise(reference, served)
    pipe.close()


def test_drain_times_out_instead_of_hanging():
    batches = _cls_batches(n=2, seed=28)
    pipe = AsyncServingEngine(_cls_col())
    pipe.forward(*_t(batches[0]))
    gate = threading.Event()
    real = pipe._dispatch
    pipe._dispatch = lambda args, kwargs: (gate.wait(WAIT_S), real(args, kwargs))[1]
    pipe.forward(*_t(batches[1]))
    with pytest.raises(TimeoutError):
        pipe.drain(timeout_s=0.05)
    gate.set()
    pipe.drain(timeout_s=WAIT_S)
    pipe.close()


def test_close_unenrolls_and_the_target_serves_blocking():
    batches = _cls_batches(n=2, seed=29)
    served = _cls_col()
    pipe = AsyncServingEngine(served)
    pipe.forward(*_t(batches[0]))
    pipe.close()
    pipe.close()  # idempotent
    assert served._serving_pipeline is None and pipe._worker is None
    with pytest.raises(RuntimeError, match="closed"):
        pipe.forward(*_t(batches[1]))
    assert served(*_t(batches[1])) is not None
    import pickle

    pipe2 = AsyncServingEngine(served)
    clone = pickle.loads(pickle.dumps(served))  # the enrollment is not pickled
    assert clone._serving_pipeline is None
    pipe2.close()


# ----------------------------------------------------------------------
# 4. a collection never enrolled
# ----------------------------------------------------------------------
def test_never_enrolled_collection_is_untouched_by_serving():
    """A collection never enrolled, even beside a live pipeline, runs
    bit-equal, builds the signature it always built (no serving token) and
    makes no ``serving.*`` counter move."""
    batches = _cls_batches(n=3, seed=6)
    control = _cls_col()
    v_control = [control(*_t(b)) for b in batches]
    e_control = control.compute()

    with obs.telemetry_scope():
        other = _cls_col()
        pipe = AsyncServingEngine(other)  # the live pipeline elsewhere
        pipe.forward(*_t(batches[0]))
        bystander = _cls_col()
        v_by = [bystander(*_t(b)) for b in batches]
        e_by = bystander.compute()
        pipe.close()
        serving_counters = {k: v for k, v in obs.get().counters.items() if k.startswith("serving.")}

    for va, vb in zip(v_control, v_by):
        for k in va:
            assert torch.equal(va[k], vb[k])
    for k in e_control:
        assert torch.equal(e_control[k], e_by[k])
    assert bystander._serving_pipeline is None
    (signature,) = list(bystander._engine._compiled)
    assert list(control._engine._compiled) == [signature]
    names, precisions, guard_token, _states, _structure, _leaves = signature
    assert guard_token is None
    assert set(serving_counters) <= {"serving.dispatches", "serving.barriers"}


# ----------------------------------------------------------------------
# 5. spans, latencies, SLOs
# ----------------------------------------------------------------------
@pytest.fixture()
def _tracing():
    from metrics_tpu_torch.observability import trace as trace_mod

    obs.enable_tracing(max_spans=trace_mod._DEFAULT_MAX_SPANS)
    obs.get_tracer().reset()
    yield obs.get_tracer()
    obs.disable_tracing()
    obs.get_tracer().reset()


def test_async_step_attribution_uses_the_batch_generation(_tracing):
    """Each batch's generation is allocated at admission and pinned by the
    worker: a batch staged as generation N carries N on every span."""
    from metrics_tpu_torch.observability import trace as trace_mod

    pipe = AsyncServingEngine(_cls_col())
    batches = _cls_batches(n=3, seed=8)
    pipe.forward(*_t(batches[0]))  # warm: the first dispatch and the build
    pipe.drain(timeout_s=WAIT_S)

    gate = threading.Event()
    real_dispatch = pipe._dispatch

    def slow_dispatch(args, kwargs):
        gate.wait(timeout=WAIT_S)
        return real_dispatch(args, kwargs)

    pipe._dispatch = slow_dispatch
    tracer = _tracing
    tracer.reset()
    before = trace_mod.current_step()
    pipe.forward(*_t(batches[1]))
    pipe.forward(*_t(batches[2]))
    assert [s["step"] for s in tracer.spans if s["name"] == "serving.stage"] == [before + 1, before + 2]
    gate.set()
    pipe.drain(timeout_s=WAIT_S)
    for name in ("serving.queue_wait", "serving.dispatch", "engine.dispatch"):
        assert sorted(s["step"] for s in tracer.spans if s["name"] == name) == [before + 1, before + 2], name
    pipe.close()


def test_serving_latency_histograms_and_queue_age_gauge():
    batches = _cls_batches(n=4, seed=9)
    with obs.telemetry_scope():
        pipe = AsyncServingEngine(_cls_col())
        for b in batches:
            pipe.forward(*_t(b))
        pipe.drain(timeout_s=WAIT_S)
        hists = obs.get().snapshot()["histograms"]
        for leg in ("serving.latency.queue_wait_ms", "serving.latency.dispatch_ms", "serving.latency.e2e_ms"):
            assert hists[leg]["count"] == len(batches), leg
        assert hists["serving.latency.e2e_ms"]["sum"] >= hists["serving.latency.dispatch_ms"]["sum"]
        gauges = obs.get().gauges
        assert "serving.queue.age_ms" in gauges and "serving.queue.depth" in gauges
        pipe.close()


def test_blocking_demoted_pipeline_keeps_the_latency_surface():
    with obs.telemetry_scope():
        pipe = AsyncServingEngine(DoubleBufferAliaser())
        pipe.forward(torch.ones(4))
        hists = obs.get().snapshot()["histograms"]
        assert hists["serving.latency.e2e_ms"]["count"] == 1
        assert hists["serving.latency.dispatch_ms"]["count"] == 1
        assert "serving.latency.queue_wait_ms" not in hists  # no queue leg


def _counter_scenario(pkg, make_col, batches, to_arrays):
    """The same serving scenario in either package: the counters it moves."""
    from importlib import import_module

    serving = import_module(f"{pkg}.serving")
    o = import_module(f"{pkg}.observability")
    with o.telemetry_scope():
        pipe = serving.AsyncServingEngine(make_col())
        for b in batches:
            pipe.forward(*to_arrays(b))
        pipe.drain()
        pipe.compute()
        pipe.close()
        counters = {k: v for k, v in o.get().counters.items() if k.startswith("serving.")}
        hists = {k: v["count"] for k, v in o.get().snapshot()["histograms"].items() if k.startswith("serving.")}
    return counters, hists


def test_serving_counters_equal_jax():
    batches = _cls_batches(n=4, seed=30)
    port = _counter_scenario("metrics_tpu_torch", _cls_col, batches, _t)
    ref = _counter_scenario("metrics_tpu", _jax_cls_col, batches, _j)
    assert port == ref


def test_serving_slo_burn_gauges_breach_and_one_dump_per_excursion(tmp_path):
    batches = _cls_batches(n=6, seed=10)
    with obs.telemetry_scope(), obs.flight_scope(tmp_path / "dumps") as rec:
        slo = ServingSLO(e2e_p99_ms=1e-6, sustain=2)  # unmeetable
        pipe = AsyncServingEngine(_cls_col(), slo=slo)
        for b in batches:
            pipe.forward(*_t(b))
        pipe.drain(timeout_s=WAIT_S)
        assert slo.breaching
        assert obs.get().gauges["serving.slo.e2e_burn"] > 1.0
        assert obs.get().counters["serving.slo.breaches"] == 1
        assert len([p for p in rec.dump_paths if "serving_slo_breach" in p]) == 1
        slo.e2e_p99_ms = 1e9  # recovery re-arms
        slo.evaluate()
        assert not slo.breaching
        slo.e2e_p99_ms = 1e-6
        for b in batches[:3]:
            pipe.forward(*_t(b))
        pipe.drain(timeout_s=WAIT_S)
        assert len([p for p in rec.dump_paths if "serving_slo_breach" in p]) == 2
        pipe.close()


def test_slo_verdicts_and_dumps_equal_jax(tmp_path):
    from metrics_tpu.serving import ServingSLO as JaxServingSLO

    batches = _cls_batches(n=4, seed=31)
    out = {}
    for pkg, o, slo_cls, pipe_cls, make, conv in (
        ("port", obs, ServingSLO, AsyncServingEngine, _cls_col, _t),
        ("jax", jobs, JaxServingSLO, JaxAsyncServingEngine, _jax_cls_col, _j),
    ):
        with o.telemetry_scope(), o.flight_scope(tmp_path / pkg) as rec:
            slo = slo_cls(e2e_p99_ms=1e-6, max_queue_age_ms=1e9, sustain=3, name="parity")
            pipe = pipe_cls(make(), slo=slo)
            for b in batches:
                pipe.forward(*conv(b))
            pipe.drain()
            snap = slo.snapshot()
            out[pkg] = (
                snap["name"], snap["targets"], snap["breaching"], sorted(snap["burns"]),
                o.get().counters.get("serving.slo.breaches"),
                len([p for p in rec.dump_paths if "serving_slo_breach" in p]),
            )
            pipe.close()
    assert out["port"] == out["jax"]


def test_slo_queue_age_breaches_with_a_wedged_worker(tmp_path):
    batches = _cls_batches(n=4, seed=14)
    with obs.telemetry_scope(), obs.flight_scope(tmp_path / "dumps") as rec:
        slo = ServingSLO(max_queue_age_ms=1e-6, sustain=1)
        pipe = AsyncServingEngine(_cls_col(), depth=1, slo=slo)
        pipe.forward(*_t(batches[0]))  # warm
        pipe.drain(timeout_s=WAIT_S)

        gate = threading.Event()
        real_dispatch = pipe._dispatch

        def wedged(args, kwargs):
            gate.wait(timeout=WAIT_S)
            return real_dispatch(args, kwargs)

        pipe._dispatch = wedged
        pipe.forward(*_t(batches[1]))  # the worker takes it and wedges
        time.sleep(0.05)
        pipe.forward(*_t(batches[2]))  # fills the depth-1 queue
        blocked = threading.Thread(target=pipe.forward, args=_t(batches[3]))
        blocked.start()
        deadline = time.time() + 10
        while not slo.breaching and time.time() < deadline:
            time.sleep(0.01)
        assert slo.breaching, "a wedged worker never breached the queue-age SLO"
        assert obs.get().gauges["serving.slo.queue_age_burn"] > 1.0
        gate.set()
        blocked.join(timeout=WAIT_S)
        assert not blocked.is_alive()
        pipe.drain(timeout_s=WAIT_S)
        deadline = time.time() + 10
        while not any("serving_slo_breach" in p for p in rec.dump_paths) and time.time() < deadline:
            time.sleep(0.01)
        assert any("serving_slo_breach" in p for p in rec.dump_paths)
        pipe.close()


def test_serving_slo_quiet_when_telemetry_off(tmp_path):
    slo = ServingSLO(e2e_p99_ms=1e-6, max_queue_age_ms=1e-6, sustain=1)
    with obs.flight_scope(tmp_path / "dumps") as rec:
        pipe = AsyncServingEngine(_cls_col(), slo=slo)
        for b in _cls_batches(n=2, seed=11):
            pipe.forward(*_t(b))
        pipe.drain(timeout_s=WAIT_S)
        pipe.close()
    assert slo.evaluate() is None
    assert not slo.breaching
    assert rec.dump_paths == []


def test_slo_validates_targets():
    with pytest.raises(ValueError, match="at least one target"):
        ServingSLO()
    with pytest.raises(ValueError, match="e2e_p99_ms must be > 0"):
        ServingSLO(e2e_p99_ms=0)
    assert ServingSLO(max_queue_age_ms=5, sustain=0).sustain == 1


def test_healthz_payload_reports_the_breach():
    """The ``serving_slo`` object of the JAX package's degraded /healthz
    case (its HTTP part needs the exporter, not ported), held directly."""
    from metrics_tpu_torch.serving.slo import active_slos, healthz_payload

    assert healthz_payload() is None  # byte-stable without any SLO
    with obs.telemetry_scope():
        slo = ServingSLO(e2e_p99_ms=1e-6, sustain=1, name="pytest-slo")
        calm = ServingSLO(max_queue_age_ms=1e9, name="a-calm-slo")
        pipe = AsyncServingEngine(_cls_col(), slo=slo)
        for b in _cls_batches(n=2, seed=12):
            pipe.forward(*_t(b))
        pipe.drain(timeout_s=WAIT_S)
        calm.evaluate()
        assert slo.breaching
        payload = healthz_payload()
        assert payload["breaching"]
        assert [s.name for s in active_slos()] == ["a-calm-slo", "pytest-slo"]
        verdicts = {s["name"]: s for s in payload["slos"]}
        assert verdicts["pytest-slo"]["breaching"] and verdicts["pytest-slo"]["burns"]["e2e"] > 1.0
        assert not verdicts["a-calm-slo"]["breaching"]
        pipe.close()


def test_batch_followable_admission_to_checkpoint_commit(tmp_path, _tracing):
    """One submission's batch id links the ingest chunk, the wave, the
    staged entry, the dispatch on the worker and the background commit on
    the writer: one Perfetto flow across three threads. The port's case
    sends one warm wave first, so that the traced wave is served by the
    worker (a first batch runs on the caller thread)."""
    from metrics_tpu_torch.reliability.journal import CheckpointJournal
    from metrics_tpu_torch.serving.bgcheckpoint import snapshot_pairs

    cohort = tm.MetricCohort(tm.Accuracy(device=CPU), tenants=2)
    pipe = AsyncServingEngine(cohort)
    q = IngestQueue(pipe, rows_per_step=4, max_buffered_rows=1024)
    rng = np.random.RandomState(13)
    ids = np.tile(np.arange(2), 4)
    p = rng.rand(8).astype(np.float32)
    q.submit(ids, p, (p > 0.5).astype(np.int32))  # the warm wave
    pipe.drain(timeout_s=WAIT_S)
    _tracing.reset()
    # the threads each stage ran on (a span's tid is the thread's native id)
    threads = {"submit": threading.get_native_id()}
    real_dispatch = pipe._dispatch

    def spy_dispatch(args, kwargs):
        threads["dispatch"] = threading.get_native_id()
        return real_dispatch(args, kwargs)

    pipe._dispatch = spy_dispatch
    q.submit(ids, p, (p > 0.5).astype(np.int32))
    pipe.drain(timeout_s=WAIT_S)
    flow = pipe.last_flow
    assert flow is not None and len(flow) == 1
    bg = BackgroundCheckpointer(CheckpointJournal(tmp_path / "journal"))
    real_commit = bg._commit_job

    def spy_commit(job):
        threads["commit"] = threading.get_native_id()
        return real_commit(job)

    bg._commit_job = spy_commit
    descriptor = bg.submit(snapshot_pairs(cohort), "MetricCohort", cursor=1, flow=flow)
    assert descriptor == {"pending": True, "cursor": 1, "note": None, "flow": list(flow)}
    bg.drain()
    bg.close()

    fid = flow[0]
    by_name = {}
    for s in _tracing.spans:
        if fid in (s.get("flow") or ()):
            by_name.setdefault(s["name"], []).append(s)
    for name in ("ingest.submit", "ingest.wave", "serving.stage", "serving.queue_wait", "serving.dispatch",
                 "checkpoint.commit"):
        assert name in by_name, (name, sorted(by_name))
    assert len(set(threads.values())) == 3
    assert {s["tid"] for s in by_name["serving.dispatch"]} == {threads["dispatch"]}
    assert {s["tid"] for s in by_name["checkpoint.commit"]} == {threads["commit"]}
    phs = [e["ph"] for e in _tracing.to_perfetto()["traceEvents"]
           if e.get("cat") == "flow" and e["args"].get("batch") == fid]
    assert phs[0] == "s" and phs[-1] == "f" and len(phs) >= 3
    pipe.close()


def test_dispatch_generation_advances_monotonically():
    col = _cls_col()
    gens = []
    for b in _cls_batches(n=3, seed=7):
        col(*_t(b))
        gens.append(col._engine.dispatch_generation)
    assert gens == [1, 2, 3]


# ----------------------------------------------------------------------
# 6. ingest against the JAX package's
# ----------------------------------------------------------------------
def _ingest_stream(tenants, rows, seed):
    rng = np.random.RandomState(seed)
    ids = np.tile(np.arange(tenants, dtype=np.int32), rows)
    rng.shuffle(ids)
    p = rng.rand(ids.size).astype(np.float32)
    return ids, p, (rng.rand(ids.size) > 0.5).astype(np.int32)


@pytest.mark.parametrize("behind_pipeline", [False, True], ids=["cohort", "pipeline"])
def test_ingest_equals_jax_and_direct_route_rows(behind_pipeline):
    tenants, rows_per_step = 4, 8
    subs = [_ingest_stream(tenants, n, seed) for n, seed in ((8, 40), (16, 41), (24, 42), (4, 43), (12, 44))]

    def run(pkg_tm, make_pipe, queue_cls, conv):
        cohort = pkg_tm.MetricCohort(pkg_tm.Accuracy(**conv["kw"]), tenants=tenants)
        pipe = make_pipe(cohort) if behind_pipeline else None
        q = queue_cls(pipe or cohort, rows_per_step=rows_per_step, coalesce_max=4)
        left = [q.submit(*s) for s in subs]
        q.flush()
        values = (pipe or cohort).compute()
        if pipe is not None:
            pipe.close()
        return np.asarray(values), dict(q.stats), q.buffered_rows, left

    port = run(tm, AsyncServingEngine, IngestQueue, {"kw": {"device": CPU}})
    ref = run(jm, JaxAsyncServingEngine, JaxIngestQueue, {"kw": {}})
    np.testing.assert_allclose(port[0], ref[0], rtol=1e-5)
    assert port[1:] == ref[1:]

    # the same rows as direct route_rows forwards: bit-equal
    direct = tm.MetricCohort(tm.Accuracy(device=CPU), tenants=tenants)
    q = IngestQueue(direct, rows_per_step=rows_per_step, coalesce_max=1)
    for s in subs:
        q.submit(*s)
    assert torch.equal(direct.compute(), torch.from_numpy(port[0]))


def test_ingest_redelivery_and_drain_tenant_equal_jax():
    out = {}
    for name, pkg, queue_cls, kw in (("port", tm, IngestQueue, {"device": CPU}), ("jax", jm, JaxIngestQueue, {})):
        cohort = pkg.MetricCohort(pkg.Accuracy(**kw), tenants=2)
        q = queue_cls(cohort, rows_per_step=4, redelivery_window=2, coalesce_max=1)
        rng = np.random.RandomState(45)
        for _ in range(3):
            ids = np.tile(np.arange(2, dtype=np.int32), 4)
            p = rng.rand(8).astype(np.float32)
            q.submit(ids, p, (p > 0.5).astype(np.int32))
        seq = q.last_wave_seq
        depth = q.ack_watermark(seq - 1)
        sink = []
        rows = q.redeliver(submit=lambda t, *a: sink.append((t.tolist(), [x.tolist() for x in a])))
        q.submit(np.zeros(3, dtype=np.int32), np.ones(3, np.float32), np.ones(3, np.int32))
        drained = q.drain_tenant(0)
        out[name] = (seq, depth, rows, sink, [d.tolist() for d in drained], q.drain_tenant(1), dict(q.stats),
                     np.asarray(cohort.compute()).tolist())
    assert out["port"][:7] == out["jax"][:7]
    np.testing.assert_allclose(out["port"][7], out["jax"][7], rtol=1e-6)


def test_ingest_validates_inputs():
    cohort = tm.MetricCohort(tm.Accuracy(device=CPU), tenants=2)
    with pytest.raises(ValueError, match="policy"):
        IngestQueue(cohort, rows_per_step=4, policy="drop")
    with pytest.raises(ValueError, match="rows_per_step"):
        IngestQueue(cohort, rows_per_step=0)
    with pytest.raises(ValueError, match="max_buffered_rows"):
        IngestQueue(cohort, rows_per_step=8, max_buffered_rows=4)
    with pytest.raises(TypeError, match="MetricCohort"):
        IngestQueue(tm.Accuracy(device=CPU), rows_per_step=4)
    q = IngestQueue(cohort, rows_per_step=4)
    with pytest.raises(ValueError, match="at least one row array"):
        q.submit(np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="rank-1"):
        q.submit(np.zeros((2, 2), np.int32), np.zeros((2, 2)))
    with pytest.raises(ValueError, match="leading dim"):
        q.submit(np.zeros(2, np.int32), np.zeros(3))
    q.submit(np.zeros(2, np.int32), np.zeros(2, np.float32), np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="carries 1 arrays"):
        q.submit(np.zeros(2, np.int32), np.zeros(2, np.float32))


# ----------------------------------------------------------------------
# 7. the background writer
# ----------------------------------------------------------------------
def test_background_envelope_equals_the_synchronous_one_and_jax(tmp_path):
    from metrics_tpu.reliability.checkpoint import save_envelope as jax_save_envelope
    from metrics_tpu.serving.bgcheckpoint import BackgroundCheckpointer as JaxBackgroundCheckpointer
    from metrics_tpu.serving.bgcheckpoint import snapshot_pairs as jax_snapshot_pairs
    from metrics_tpu.reliability.journal import CheckpointJournal as JaxJournal
    from metrics_tpu_torch.reliability.checkpoint import read_envelope, save_envelope
    from metrics_tpu_torch.reliability.journal import CheckpointJournal
    from metrics_tpu_torch.serving.bgcheckpoint import snapshot_pairs

    batches = _cls_batches(n=3, seed=46)
    col, jcol = _cls_col(), _jax_cls_col()
    for b in batches:
        col(*_t(b))
        jcol(*_j(b))
    sync = save_envelope(col)
    bg = BackgroundCheckpointer(CheckpointJournal(tmp_path / "port"))
    bg.submit(snapshot_pairs(col), type(col).__name__, cursor=2)
    bg.drain()
    bg.close()
    (record,) = bg._journal.records()
    written = read_envelope(bg._journal._gen_path(record["generation"]))
    assert written["checksum"] == sync["checksum"] and written["spec"] == sync["spec"]

    jbg = JaxBackgroundCheckpointer(JaxJournal(tmp_path / "jax"))
    jbg.submit(jax_snapshot_pairs(jcol), type(jcol).__name__, cursor=2)
    jbg.drain()
    jbg.close()
    assert jax_save_envelope(jcol)["checksum"] == sync["checksum"]
    assert jbg.stats == bg.stats == {"commits": 1, "coalesced": 0, "errors": 0}


def test_snapshot_is_isolated_from_later_steps():
    from metrics_tpu_torch.serving.bgcheckpoint import snapshot_pairs

    batches = _cls_batches(n=2, seed=47)
    col = _cls_col()
    col(*_t(batches[0]))
    pairs = snapshot_pairs(col)
    before = {k: v.clone() for k, v in pairs if isinstance(v, torch.Tensor)}
    col(*_t(batches[1]))
    for k, v in pairs:
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, before[k]), k
            live = dict(col._named_states())[k]
            assert v.untyped_storage().data_ptr() != live.untyped_storage().data_ptr()


def test_background_writer_coalesces_and_commits_in_cursor_order(tmp_path):
    from metrics_tpu_torch.reliability.journal import CheckpointJournal
    from metrics_tpu_torch.serving.bgcheckpoint import snapshot_pairs

    col = _cls_col()
    col(*_t(_cls_batches(n=1, seed=48)[0]))
    bg = BackgroundCheckpointer(CheckpointJournal(tmp_path / "j"))
    gate = threading.Event()
    real = bg._commit_job

    def gated(job):
        gate.wait(WAIT_S)
        return real(job)

    bg._commit_job = gated
    with obs.telemetry_scope():
        bg.submit(snapshot_pairs(col), "MetricCollection", cursor=0)
        deadline = time.time() + 10
        while not bg._busy and time.time() < deadline:
            time.sleep(0.005)
        bg.submit(snapshot_pairs(col), "MetricCollection", cursor=1)
        bg.submit(snapshot_pairs(col), "MetricCollection", cursor=2)  # replaces cursor 1
        gate.set()
        bg.drain(timeout_s=WAIT_S)
        assert obs.get().counters["serving.checkpoint.coalesced"] == 1
        assert obs.get().counters["serving.checkpoint.commits"] == 2
        assert obs.get().snapshot()["histograms"]["serving.latency.checkpoint_commit_ms"]["count"] == 2
    assert [r["cursor"] for r in bg._journal.records()] == [0, 2]
    assert bg.stats == {"commits": 2, "coalesced": 1, "errors": 0}
    record = bg.commit_sync(snapshot_pairs(col), "MetricCollection", cursor=3, note="protective: test")
    assert record["cursor"] == 3 and bg.stats["commits"] == 3
    bg.close()
    with pytest.raises(RuntimeError, match="closed"):
        bg.submit(snapshot_pairs(col), "MetricCollection", cursor=4)


def test_concurrent_submitters_lose_no_row():
    """Eight submitter threads (more than this box's cores) feed one queue in
    front of a pipelined cohort, with the interpreter switching threads
    every microsecond: every admitted row lands in exactly one tenant's
    count."""
    import sys

    tenants, rows_per_step, threads, submits = 4, 8, 8, 12
    cohort = tm.MetricCohort(tm.Accuracy(device=CPU), tenants=tenants)
    pipe = AsyncServingEngine(cohort)
    q = IngestQueue(pipe, rows_per_step=rows_per_step, max_buffered_rows=1 << 16, coalesce_max=4)
    errors = []

    def submitter(seed):
        rng = np.random.RandomState(seed)
        try:
            for _ in range(submits):
                ids = np.tile(np.arange(tenants, dtype=np.int32), rows_per_step // 2)
                p = rng.rand(ids.size).astype(np.float32)
                q.submit(ids, p, (p > 0.5).astype(np.int32))
        except Exception as err:  # noqa: BLE001 - reported below
            errors.append(err)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=submitter, args=(50 + i,)) for i in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=WAIT_S)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    left = q.flush()
    pipe.drain(timeout_s=WAIT_S)
    rows = threads * submits * tenants * rows_per_step // 2
    assert q.stats["admitted_rows"] == rows and left == 0
    assert int(cohort._states["metric"]["total"].sum()) == rows
    assert pipe.stats["errors"] == 0
    pipe.close()
