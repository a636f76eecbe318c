"""The port's pass 5 (``metrics_tpu_torch/analysis/numerics.py``: interval
horizons MTA010, cancellation sites and the float64-measured budget MTA011,
the equivariance probe MTA012) against the JAX package's and the committed
``NUMERICS_BASELINE.json``, on the CPU.

The cases of ``tests/analysis/test_numerics.py`` are mirrored under their
own names. Interval values and horizons are exact, site counts exact,
equivariance verdicts bitwise, and measured budgets at or under the
committed ones. The JAX package's interval walker loses JAX 0.9's ``jit``
calls and its measured budget does not run on this JAX, so its horizons and
budgets are no oracles: the committed file is. Its ``pjit`` case becomes a
``torch.cond`` subgraph whose intervals are asserted directly, and
``dot_general`` becomes ``mm``. Left out: the refresh script's refusal
ladder (``scripts/lint_metrics.py`` is not ported) and the
``docs/performance.md`` table check (a document of the JAX package).
"""
import math
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu_torch as M
import metrics_tpu_torch.observability as obs
from metrics_tpu_torch.analysis import audit_metric, audit_registry
from metrics_tpu_torch.analysis import fixtures as fx
from metrics_tpu_torch.analysis import numerics as num
from metrics_tpu_torch.analysis.numerics import (
    DEFAULT_FLEET_FLOOR_ROWS,
    DEFAULT_SERVING_ROWS_PER_STEP,
    Interval,
    check_numerics,
    committed_budget_ceiling,
    eval_jaxpr_intervals,
    load_numerics_baseline,
    measure_error_budget,
    state_horizons,
    tighten_baseline,
)
from metrics_tpu_torch.analysis.program import _fake_trace, registry_cases
from metrics_tpu_torch.metric import Metric

CPU = "cpu"
_NP_X = np.linspace(0.0, 1.0, 8).astype(np.float32)
_X = (torch.as_tensor(_NP_X),)


def _jx():
    import jax.numpy as jnp

    return (jnp.asarray(_NP_X),)


def _jnum():
    from metrics_tpu.analysis import numerics as jnum

    return jnum


@pytest.fixture(scope="module")
def registry_report():
    """The port's whole registry on the CPU, under a telemetry scope."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # config-edge warnings from factories
        with obs.telemetry_scope() as tel:
            report = audit_registry(quantized=True, cohort=True, device=CPU)
    return report, dict(tel.gauges), dict(tel.counters)


def _port_cases():
    return {name: (factory, args) for name, factory, args in registry_cases(CPU)}


def _jax_cases():
    from metrics_tpu.analysis.program import registry_cases as jax_registry_cases

    return {name: (factory, args) for name, factory, args in jax_registry_cases()}


# ---------------------------------------------------------------------------
# interval interpreter
# ---------------------------------------------------------------------------
def _ivs(fn, *in_ivs, args, unhandled=None):
    graph, _ = _fake_trace(fn, tuple(torch.zeros(a) for a in args))
    return eval_jaxpr_intervals(graph, list(in_ivs), unhandled)


def _jax_ivs(fn, *in_ivs, args):
    import jax
    import jax.numpy as jnp

    jnum = _jnum()
    closed = jax.make_jaxpr(fn)(*(jnp.zeros(a) for a in args))
    return [(iv.lo, iv.hi) for iv in jnum.eval_jaxpr_intervals(closed, [jnum.Interval(iv.lo, iv.hi) for iv in in_ivs])]


def test_interval_add_mul_sum():
    import jax.numpy as jnp

    out, = _ivs(lambda x: torch.sum(x * 2.0 + 1.0), Interval(0.0, 1.0), args=((8,),))
    assert (out.lo, out.hi) == (8.0, 24.0)  # 8 × (0·2 + 1), 8 × (1·2 + 1)
    assert _jax_ivs(lambda x: jnp.sum(x * 2.0 + 1.0), Interval(0.0, 1.0), args=((8,),)) == [(out.lo, out.hi)]


def test_interval_division_by_zero_spanning_interval_is_top():
    import jax.numpy as jnp

    out, = _ivs(lambda x, y: x / torch.sum(y), Interval(0.0, 1.0), Interval(-1.0, 1.0), args=((), (4,)))
    assert out.lo == -math.inf and out.hi == math.inf
    assert _jax_ivs(lambda x, y: x / jnp.sum(y), Interval(0.0, 1.0), Interval(-1.0, 1.0),
                    args=((), (4,))) == [(out.lo, out.hi)]


def test_interval_recurses_into_pjit():
    """The JAX case's nested call is a ``pjit``; the port's nested graph is
    a ``torch.cond`` branch. Each branch squares and sums 4 elements of
    [-2, 2]: [0, 16] (the even power tightens to >= 0), plus 1."""
    def fn(x):
        inner = torch.cond(x[0] > 100.0, lambda v: torch.sum(v * v), lambda v: torch.sum(v * v), (x,))
        return inner + 1.0

    out, = _ivs(fn, Interval(-2.0, 2.0), args=((4,),))
    assert (out.lo, out.hi) == (1.0, 17.0)


def test_interval_cond_takes_branch_union():
    import jax

    out, = _ivs(lambda x: torch.cond(x[0] > 0, lambda v: v * 2.0, lambda v: v - 10.0, (x,)),
                Interval(0.0, 1.0), args=((3,),))
    assert (out.lo, out.hi) == (-10.0, 2.0)
    want = _jax_ivs(lambda x: jax.lax.cond(x[0] > 0, lambda v: v * 2.0, lambda v: v - 10.0, x),
                    Interval(0.0, 1.0), args=((3,),))
    assert want == [(out.lo, out.hi)]


def test_interval_dot_general_scales_by_contraction():
    """``dot_general`` is ``mm`` (and ``dot`` for two vectors) here: the
    product interval times the contracted length."""
    out, = _ivs(lambda a, b: a @ b, Interval(0.0, 1.0), Interval(0.0, 1.0), args=((1, 5), (5, 1)))
    assert (out.lo, out.hi) == (0.0, 5.0)
    vec, = _ivs(lambda a, b: a @ b, Interval(0.0, 1.0), Interval(0.0, 1.0), args=((5,), (5,)))
    assert (vec.lo, vec.hi) == (0.0, 5.0)
    assert _jax_ivs(lambda a, b: a @ b, Interval(0.0, 1.0), Interval(0.0, 1.0), args=((5,), (5,))) == [(0.0, 5.0)]


def test_inverted_interval_construction_swaps_not_collapses():
    iv = Interval(5.0, 3.0)
    assert (iv.lo, iv.hi) == (3.0, 5.0)
    jiv = _jnum().Interval(5.0, 3.0)
    assert (jiv.lo, jiv.hi) == (iv.lo, iv.hi)


def test_clamp_of_disjoint_interval_maps_bounds_through():
    """clamp is monotone in x: an operand entirely below the clamp range
    yields the range's floor exactly, not an inverted intersection."""
    import jax

    for x_iv, want in ((Interval(-5.0, -4.0), (0.0, 0.0)), (Interval(-1.0, 0.5), (0.0, 0.5))):
        out, = _ivs(lambda x: torch.clamp(x, 0.0, 1.0), x_iv, args=((3,),))
        assert (out.lo, out.hi) == want
        assert _jax_ivs(lambda x: jax.lax.clamp(0.0, x, 1.0), x_iv, args=((3,),)) == [want]


def test_min_horizon_rows_helper_handles_empty_and_none():
    from metrics_tpu_torch.analysis.numerics import min_horizon_rows

    evidence = {
        "A": {"horizons": {"s": {"rows": 10.0}, "t": {"rows": None}}},
        "B": None,
        "C": {"horizons": {"u": {"rows": 3.0}}},
    }
    assert min_horizon_rows({}) is None
    assert min_horizon_rows(None) is None
    assert min_horizon_rows(evidence) == _jnum().min_horizon_rows(evidence) == 3.0


def test_unknown_primitive_is_top_not_crash():
    """An op without a rule gives ``TOP`` and is named in ``unhandled``
    (the JAX case's ``while`` loop; ``while_loop`` does not trace over fake
    tensors here, so an op the port has no rule for stands in)."""
    unhandled = set()
    out, = _ivs(lambda x: torch.special.erf(x) + 1.0, Interval(0.0, 1.0), args=((2,),), unhandled=unhandled)
    assert out.lo == -math.inf and out.hi == math.inf
    assert unhandled == {"aten.erf.default"}


def test_in_place_write_rebinds_the_written_interval():
    """The graphs are not functionalized: an ``index_add_`` through a view
    of a ``zeros`` buffer, read through the buffer afterwards, carries the
    written interval (32 ones into one of 20 slots: [0, 32]; a sum of 4
    rows: [0, 128]), not the buffer's default [0, 0]."""
    def fn(idx):
        counts = torch.zeros((4, 5), dtype=torch.int32)
        counts.view(-1).index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
        return counts.sum(0), counts

    graph, _ = _fake_trace(fn, (torch.zeros(32, dtype=torch.int64),))
    summed, counts = eval_jaxpr_intervals(graph, [Interval(0.0, 19.0)])
    assert (counts.lo, counts.hi) == (0.0, 32.0)
    assert (summed.lo, summed.hi) == (0.0, 128.0)


def test_label_bincount_and_its_operators_count_like_scatter_add():
    """The stat-score count (``label_bincount``: an ``index_add_`` into a
    ``zeros`` buffer) and the custom operators the cohort traces give
    scatter-add's bound: each count in [0, labels]. Past 2^20 labels the
    count writes into a view of 512 copies and sums them: the in-place
    write reaches the sum, and the interval is 512 copies' sound, loose
    bound."""
    from metrics_tpu_torch.ops.histogram import _COPIES, label_bincount

    for n, hi in ((32, 32.0), (1 << 20, float(_COPIES << 20))):
        graph, _ = _fake_trace(lambda idx: label_bincount(idx, 4), (torch.zeros(n, dtype=torch.int64),))
        out, = eval_jaxpr_intervals(graph, [Interval(0.0, 3.0)])
        assert (out.lo, out.hi) == (0.0, hi), n
    graph, _ = _fake_trace(lambda idx: torch.ops.metrics_tpu_torch.label_counts(idx, 4, None),
                           (torch.zeros(32, dtype=torch.int64),))
    out, = eval_jaxpr_intervals(graph, [Interval(0.0, 3.0)])
    assert (out.lo, out.hi) == (0.0, 32.0)
    graph, _ = _fake_trace(lambda idx, adds: torch.ops.metrics_tpu_torch.bucket_sums(idx, adds, 16),
                           (torch.zeros(32, dtype=torch.int64), torch.zeros(32)))
    out, = eval_jaxpr_intervals(graph, [Interval(0.0, 15.0), Interval(0.0, 0.5)])
    assert (out.lo, out.hi) == (0.0, 16.0)


# ---------------------------------------------------------------------------
# horizons
# ---------------------------------------------------------------------------
def _horizon(h):
    return {k: (v.get("kind"), v.get("rows")) for k, v in h.items() if not k.startswith("__")}


def test_int32_row_counter_horizon_is_two_to_31():
    h = state_horizons(fx.Int32RowCounter(device=CPU), _X, {})
    rows = h["rows"]
    assert rows["kind"] == "int-overflow"
    assert rows["rows"] == 2.0 ** 31 - 1  # the lifted row count is a point: [8, 8] per 8 rows
    assert rows["rows"] < DEFAULT_FLEET_FLOOR_ROWS
    # the f32 companion absorbs only after 2^24 serving steps
    assert h["acc"]["kind"] == "float-ulp-absorption"
    assert h["acc"]["rows"] == 2.0 ** 24 * DEFAULT_SERVING_ROWS_PER_STEP
    assert "__approximated__" not in h
    assert _horizon(h) == _horizon(_jnum().state_horizons(_jfx().Int32RowCounter(), _jx(), {}))


def _jfx():
    from metrics_tpu.analysis import fixtures as jfx

    return jfx


def _promoted_args(kind, rng, n=16):
    if kind == "reg":
        return rng.rand(n).astype(np.float32), rng.rand(n).astype(np.float32)
    if kind == "binary":
        return rng.rand(n).astype(np.float32), rng.randint(2, size=n)
    if kind == "hinge":
        return rng.randn(n).astype(np.float32), rng.randint(2, size=n)
    p = rng.rand(n, 4).astype(np.float32)
    return p / p.sum(1, keepdims=True), rng.randint(4, size=n)


@pytest.mark.parametrize("family,args", [
    ("Accuracy", None),
    ("HammingDistance", "binary"),
    ("Hinge", "hinge"),
    ("MeanSquaredError", "reg"),
    ("MeanAbsoluteError", "reg"),
    ("MeanSquaredLogError", "reg"),
    ("PSNR", "reg"),
    ("R2Score", "reg"),
], ids=["Accuracy", "Hamming", "Hinge", "MSE", "MAE", "MSLE", "PSNR", "R2"])
def test_promoted_counters_horizon_before_after(family, args):
    """Every promoted row counter is f32 (horizon 2^44 rows at the declared
    serving batch — above the fleet floor) where its int32 before-twin,
    ``Int32RowCounter``, saturates at 2^31 rows — below it. The horizons
    equal the JAX package's on the same seeded batch."""
    import jax.numpy as jnp

    import metrics_tpu as J

    np_args = _promoted_args(args, np.random.RandomState(0))
    kw = {"data_range": 1.0} if family == "PSNR" else {}
    m = getattr(M, family)(device=CPU, **kw)
    total = m._defaults["total"]
    assert total.is_floating_point(), "promoted counter regressed to int"
    h = state_horizons(m, tuple(torch.as_tensor(a) for a in np_args), {})
    assert h["total"]["kind"] == "float-ulp-absorption"
    assert h["total"]["rows"] >= DEFAULT_FLEET_FLOOR_ROWS
    before = state_horizons(fx.Int32RowCounter(device=CPU), _X, {})["rows"]["rows"]
    assert before < DEFAULT_FLEET_FLOOR_ROWS < h["total"]["rows"]
    ref = _jnum().state_horizons(getattr(J, family)(**kw), tuple(jnp.asarray(a) for a in np_args), {})
    assert _horizon(h) == _horizon(ref)


def test_suppressed_int32_families_record_subfloor_horizons():
    """StatScores/confmat families stay int32 by documented choice: the
    finding is suppressed (class-body allow with rationale) and the horizon
    is recorded in the committed baseline — and the port's own horizons
    equal it."""
    import jax.numpy as jnp

    import metrics_tpu as J

    base = load_numerics_baseline()
    assert base is not None
    cases = _port_cases()
    for fam, state in (("StatScores", "tp"), ("ConfusionMatrix", "confmat"),
                       ("MatthewsCorrcoef", "confmat"), ("CohenKappa", "confmat")):
        h = base[fam]["horizons"][state]
        assert h["kind"] == "int-overflow"
        assert h["rows"] < DEFAULT_FLEET_FLOOR_ROWS
        factory, args = cases[fam]
        got = state_horizons(factory(), args, {}, family=fam)[state]
        assert (got["kind"], got["rows"]) == (h["kind"], h["rows"]), fam
    preds, target = np.asarray([0.9, 0.1], np.float32), np.asarray([1, 0])
    r = audit_metric(M.StatScores(reduce="micro", device=CPU), (torch.as_tensor(preds), torch.as_tensor(target)))
    assert not [f for f in r.findings if f.rule == "MTA010"]
    assert any(f.rule == "MTA010" for f in r.suppressed)
    from metrics_tpu.analysis import audit_metric as jax_audit_metric

    ref = jax_audit_metric(J.StatScores(reduce="micro"), (jnp.asarray(preds), jnp.asarray(target)))
    assert {f.subject for f in r.suppressed if f.rule == "MTA010"} == {
        f.subject for f in ref.suppressed if f.rule == "MTA010"}


def test_macro_statscores_tn_horizon_is_shorter():
    """The interval pass is per-STATE: macro tn accumulates up to two
    counts per row, so its horizon is genuinely shorter than tp's — in the
    committed baseline and in the port's own derivation."""
    base = load_numerics_baseline()
    assert base["StatScores"]["horizons"]["tn"]["rows"] < base["StatScores"]["horizons"]["tp"]["rows"]
    factory, args = _port_cases()["Precision"]  # macro, 4 classes
    h = state_horizons(factory(), args, {}, family="Precision")
    assert h["tn"]["rows"] == base["Precision"]["horizons"]["tn"]["rows"] < h["tp"]["rows"]


# ---------------------------------------------------------------------------
# cancellation: structure + measured budget
# ---------------------------------------------------------------------------
def test_cancelling_variance_structural_site_and_blown_budget():
    r = audit_metric(fx.CancellingVariance(device=CPU), _X)
    assert {f.rule for f in r.findings} == {"MTA011"}
    ev = r.evidence["numerics"]["cancellation"]
    assert ev["sites"], "the E[x²]−E[x]² subtraction must be structurally visible"
    assert len(ev["sites"]) == len(_jnum().cancellation_sites(_jfx().CancellingVariance()))
    assert ev["budget"] == 1.0  # capped: all significant digits lost
    assert ev["float64"] is True


def test_in_tree_sufficient_stats_families_carry_measured_budgets(registry_report):
    """R2Score/ExplainedVariance deliberately risk the cancellation shape:
    the audit sees it (sites, as many as the JAX package's) and measures a
    budget. ExplainedVariance's is at its committed 1.0; R2Score's blows its
    committed 2^-19 and its class-body allow routes that to ``suppressed``."""
    report = registry_report[0]
    cases = _jax_cases()
    for fam in ("R2Score", "ExplainedVariance"):
        ev = report["families"][fam]["evidence"]["numerics"]
        assert ev["cancellation"]["sites"], fam
        assert len(ev["cancellation"]["sites"]) == len(_jnum().cancellation_sites(cases[fam][0]())), fam
        assert ev["cancellation"]["budget"] is not None
        assert ev["cancellation"]["float64"] is True
    base = load_numerics_baseline()
    assert base["ExplainedVariance"]["error_budget"] is not None
    assert report["families"]["ExplainedVariance"]["evidence"]["numerics"]["cancellation"]["budget"] <= 1.0
    r2 = report["families"]["R2Score"]
    assert [(f["rule"], f["subject"]) for f in r2["suppressed"]] == [("MTA011", "R2Score")]
    assert r2["evidence"]["numerics"]["cancellation"]["budget"] > base["R2Score"]["error_budget"]


def test_budget_gate_fires_on_conditioning_regression():
    """A worsened measured budget vs the committed entry is an MTA011
    finding even when the structure is unchanged."""
    m = fx.CancellingVariance(device=CPU)
    measured = measure_error_budget(m, _X)
    assert measured is not None and measured["budget"] > 0
    committed = {
        "CancellingVariance": {
            "states": ["count", "sum_x", "sum_x2"],
            "horizons": {},
            "error_budget": measured["budget"] / 8.0,
        }
    }
    findings, infos = [], []
    check_numerics(m, findings, infos, args=_X, baseline=committed)
    assert any(f.rule == "MTA011" for f in findings)


def test_budget_ceiling_is_deterministic_power_of_two():
    jnum = _jnum()
    assert committed_budget_ceiling(3e-8) == 2.0 ** math.ceil(math.log2(1.2e-7))
    assert committed_budget_ceiling(0.9) == 1.0  # capped
    assert committed_budget_ceiling(0.0) == 2.0 ** -24
    for x in (0.0, 1e-12, 3e-8, 4.77e-7, 1e-3, 0.3, 0.9, 5.0):
        assert committed_budget_ceiling(x) == jnum.committed_budget_ceiling(x), x


def test_fp64_oracle_isolates_computation_error():
    """A plain sum has no cancellation: its measured budget on the same
    adversarial probes stays at f32-epsilon scale, against an oracle that
    ran in float64."""
    measured = measure_error_budget(fx.SeamRegressor(device=CPU), _X)
    assert measured is not None
    assert measured["budget"] < 1e-5
    assert measured["float64"] is True and "skipped" not in measured


def test_adversarial_probes_are_the_jax_packages_bits():
    jcases = _jax_cases()
    for fam, (factory, args) in _port_cases().items():
        got = num._adversarial_probes(fam, args)
        want = _jnum()._adversarial_probes(fam, jcases[fam][1])
        assert [name for name, _ in got] == [name for name, _ in want] == ["shifted", "tiny"]
        for (_, a), (_, b) in zip(got, want):
            for x, y in zip(a, b):
                x, y = x.numpy(), np.asarray(y)
                assert np.array_equal(x, y) and (x.dtype == y.dtype or x.dtype.kind == y.dtype.kind == "i"), fam


class _Float32Pinned(Metric):
    """A sum whose compute pins float32: it has no float64 oracle."""

    _fused_forward = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("acc", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x):
        self.acc = self.acc + torch.sum(x)

    def compute(self):
        return self.acc.to(torch.float32)


def test_float64_leg_raises_when_a_leaf_stays_float32():
    """The oracle leg starts from float64 copies of the states and float64
    probes; a result leaf that stays float32 raises and is never reported
    as a budget (of 0). The audit records the family as unmeasured."""
    with pytest.raises(num.Float64OracleError, match="did not run in float64"):
        measure_error_budget(_Float32Pinned(device=CPU), _X)
    findings, infos = [], []
    ev = check_numerics(_Float32Pinned(device=CPU), findings, infos, args=_X, baseline={})
    assert ev["cancellation"]["budget"] is None and ev["cancellation"]["float64"] is False
    assert any("did not run in float64" in i for i in infos)
    assert findings == []


def test_float64_leg_really_runs_in_float64():
    """A 1-dim float32 state plus a 0-dim float64 sum stays float32 in
    PyTorch; the oracle leg's states are float64 copies, so every state and
    the value are float64."""
    class VectorSum(Metric):
        _fused_forward = True

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("acc", default=torch.zeros(3), dist_reduce_fx="sum")

        def update(self, x):
            self.acc = self.acc + torch.sum(x)

        def compute(self):
            return self.acc

    probe = (torch.as_tensor(_NP_X, dtype=torch.float64),)
    value = num._float64_leg(VectorSum(device=CPU), probe)
    assert value.dtype == torch.float64
    measured = measure_error_budget(VectorSum(device=CPU), _X)
    assert measured["float64"] is True and measured["budget"] < 1e-5


def test_a_non_finite_float32_result_loses_every_digit():
    """Where the f32 leg's result is not finite and the oracle's is, every
    digit is lost: the probe counts at the cap and is named (a cancellation
    that rounds to a zero divisor on one device and to garbage on another
    reads alike). Pairs non-finite on both sides compare nothing."""
    assert num._relative_error(torch.tensor([1.0, float("inf")]), torch.tensor([1.0, 2.0])) == math.inf
    assert num._relative_error(torch.tensor([float("nan")]), torch.tensor([float("nan")])) is None
    assert num._relative_error(torch.tensor([1.5, float("nan")]), torch.tensor([1.0, float("nan")])) == 0.5

    class OverflowsInFloat32(Metric):
        _fused_forward = True

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("acc", default=torch.zeros(()), dist_reduce_fx="sum")

        def update(self, x):
            self.acc = self.acc + torch.sum(x)

        def compute(self):
            return torch.exp(self.acc / 8e4)  # exp(100) on the shifted probe: inf in f32

    num.FAMILY_DOMAINS["OverflowsInFloat32"] = (num.UNBOUNDED,)
    try:
        measured = measure_error_budget(OverflowsInFloat32(device=CPU), _X)
    finally:
        del num.FAMILY_DOMAINS["OverflowsInFloat32"]
    assert measured["budget"] == 1.0
    assert "shifted" in measured["non_finite"] and measured["per_probe"]["shifted"] == 1.0


def test_probes_that_raise_are_named_as_skipped():
    class SmallOnly(Metric):
        _fused_forward = True

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("acc", default=torch.zeros(()), dist_reduce_fx="sum")

        def update(self, x):
            if float(torch.max(x)) > 1e3:
                raise ValueError("outside the domain")
            self.acc = self.acc + torch.sum(x)

        def compute(self):
            return self.acc

    num.FAMILY_DOMAINS["SmallOnly"] = (num.UNBOUNDED,)
    try:
        measured = measure_error_budget(SmallOnly(device=CPU), _X)
    finally:
        del num.FAMILY_DOMAINS["SmallOnly"]
    assert set(measured["per_probe"]) == {"tiny"}
    assert measured["skipped"] == {"shifted": "ValueError: outside the domain"}


# ---------------------------------------------------------------------------
# equivariance
# ---------------------------------------------------------------------------
DECLARED = ("AUROC", "AveragePrecision", "R2Score", "ExplainedVariance", "RetrievalMAP", "RetrievalMRR",
            "RetrievalPrecision", "RetrievalRecall", "MeanSquaredError", "MeanAbsoluteError")


@pytest.mark.parametrize("family", DECLARED)
def test_declared_invariant_families_are_bit_stable(family):
    """The 10 declared families of the registry are bit-stable at every
    probed scale, with the JAX package's verdict."""
    factory, args = _port_cases()[family]
    eq = num.equivariance_verdict(factory(), args, family=family)
    assert eq is not None and eq["checked"], family
    assert eq["bit_stable"], (family, eq)
    jfactory, jargs = _jax_cases()[family]
    assert eq == _jnum().equivariance_verdict(jfactory(), jargs, family=family)


def test_epsilon_threshold_fixture_fails_only_at_tiny_scale():
    r = audit_metric(fx.EpsilonThresholdAUROC(device=CPU), _X)
    assert {f.rule for f in r.findings} == {"MTA012"}
    eq = r.evidence["numerics"]["equivariance"]
    by_scale = {s["scale"]: s["bit_stable"] for s in eq["scales"]}
    assert by_scale[0.5] is True          # above the epsilon: invisible
    assert by_scale[2.0 ** -10] is False  # below it: the tie structure shifts
    ref = _jnum().equivariance_verdict(_jfx().EpsilonThresholdAUROC(), _jx())
    assert {s["scale"]: s["bit_stable"] for s in ref["scales"]} == by_scale


# ---------------------------------------------------------------------------
# the committed baseline: coverage + gate + merge semantics
# ---------------------------------------------------------------------------
def test_every_audited_entry_has_a_committed_baseline_entry(registry_report):
    """Every plain/@cohort/@int8/@bf16 entry the registry audits has a
    NUMERICS_BASELINE.json entry whose state inventory equals the port's,
    with horizons for every state and an error budget."""
    report = registry_report[0]
    base = load_numerics_baseline()
    assert base is not None
    missing = [fam for fam in report["families"] if fam not in base]
    assert missing == [], missing
    for fam, entry in report["families"].items():
        ev = entry["evidence"]["numerics"]
        fresh_states = sorted(k for k in ev["horizons"] if not k.startswith("__"))
        assert base[fam]["states"] == fresh_states, fam
        assert "error_budget" in base[fam], fam


def test_registry_numerics_is_clean(registry_report):
    """Pass 5 over all 89 entries: zero unsuppressed MTA010/MTA011/MTA012
    findings; no horizon regression among the suppressed; the gauges of the
    audit name the shortest horizon and no finding count."""
    report, gauges, counters = registry_report
    assert report["summary"]["families"] == 89
    live = [
        f for entry in report["families"].values()
        for f in entry["findings"]
        if f["rule"] in ("MTA010", "MTA011", "MTA012")
    ]
    assert live == [], live
    regressions = [f for entry in report["families"].values() for f in entry["suppressed"]
                   if "regression" in f["message"]]
    assert regressions == []
    assert gauges["analysis.numerics.horizon_min"] == num.min_horizon_rows(
        {fam: e["evidence"]["numerics"] for fam, e in report["families"].items()}) == 268435455.875
    assert "analysis.numerics.findings" not in counters


def test_horizon_regression_vs_baseline_is_gated():
    m = fx.Int32RowCounter(device=CPU)
    committed = {
        "Int32RowCounter": {
            "states": ["acc", "rows"],
            "horizons": {"rows": {"kind": "int-overflow", "rows": 2.0 ** 62}},
            "error_budget": 1.0,
        }
    }
    findings, infos = [], []
    check_numerics(m, findings, infos, args=_X, baseline=committed, floor_rows=1.0)  # floor disarmed
    msgs = [f for f in findings if f.rule == "MTA010"]
    assert msgs and "regression" in msgs[0].message


def test_changed_state_inventory_is_measured_not_gated():
    m = fx.Int32RowCounter(device=CPU)
    committed = {
        "Int32RowCounter": {
            "states": ["somebody_else"],
            "horizons": {"rows": {"kind": "int-overflow", "rows": 2.0 ** 62}},
            "error_budget": 1e-12,
        }
    }
    findings, infos = [], []
    check_numerics(m, findings, infos, args=_X, baseline=committed, floor_rows=1.0)
    assert findings == []
    assert any("measured, not gated" in i for i in infos)


def _entry(rows, budget, states=("s",)):
    return {
        "states": sorted(states),
        "horizons": {s: {"kind": "int-overflow", "rows": rows} for s in states},
        "error_budget": budget,
    }


def test_tighten_baseline_is_improvements_only():
    baseline = {"fixtures": ["CancellingVariance"], "entries": {
        "Fam": _entry(100.0, 0.25),
        "CancellingVariance": _entry(50.0, 2.0 ** -20),
        "Retired": _entry(1.0, 1.0),
    }}
    fresh = {
        "Fam": _entry(200.0, 0.5),  # horizon improved, budget worsened
        "CancellingVariance": _entry(9999.0, 1.0),  # fixtures never move
    }
    out, pruned = tighten_baseline(baseline, fresh)
    assert out["entries"]["Fam"]["horizons"]["s"]["rows"] == 200.0
    assert out["entries"]["Fam"]["error_budget"] == 0.25  # never grows
    assert out["entries"]["CancellingVariance"] == baseline["entries"]["CancellingVariance"]
    assert pruned == ["Retired"] and "Retired" not in out["entries"]
    assert (out, pruned) == _jnum().tighten_baseline(baseline, fresh)


def test_tighten_baseline_committed_unbounded_stays_unbounded():
    baseline = {"fixtures": [], "entries": {
        "Fam": {"states": ["s"], "horizons": {"s": {"kind": "static", "rows": None}},
                "error_budget": None},
    }}
    fresh = {"Fam": _entry(5.0, 0.5)}
    out, _ = tighten_baseline(baseline, fresh)
    assert out["entries"]["Fam"]["horizons"]["s"]["rows"] is None
    assert out == _jnum().tighten_baseline(baseline, fresh)[0]


def test_build_numerics_entry_round_trips_the_committed_entries(registry_report):
    """The entry a fresh evidence makes has the committed inventory and
    horizons (the error budget is the measurement's ceiling)."""
    report = registry_report[0]
    base = load_numerics_baseline()
    for fam in ("StatScores", "MeanSquaredError@int8", "AUROC"):
        entry = num.build_numerics_entry(report["families"][fam]["evidence"]["numerics"])
        assert entry["states"] == base[fam]["states"]
        assert entry["horizons"] == base[fam]["horizons"]


# ---------------------------------------------------------------------------
# suppression plumbing + watchdog hint
# ---------------------------------------------------------------------------
def test_stale_mta010_allow_is_flagged_mtl105():
    class CleanWithStaleNumericsAllow(Metric):
        # metrics-tpu: allow(MTA010) — STALE on purpose for this test
        _fused_forward = True

        def __init__(self):
            super().__init__(device=CPU)
            self.add_state("acc", default=torch.zeros(()), dist_reduce_fx="sum")

        def update(self, x):
            self.acc = self.acc + torch.sum(x)

        def compute(self):
            return self.acc

    r = audit_metric(CleanWithStaleNumericsAllow(), _X)
    assert {f.rule for f in r.findings} == {"MTL105"}
    assert "MTA010" in r.findings[0].message


def test_hint_for_watch_key_covers_numerics_rules():
    from metrics_tpu_torch.analysis.program import hint_for_watch_key

    audit_metric(fx.Int32RowCounter(device=CPU), _X)
    hint = hint_for_watch_key("Int32RowCounter")
    assert hint is not None and "MTA010" in hint and "overflow-horizon" in hint
