"""The port's program audit (pass 1, ``metrics_tpu_torch/analysis/
program.py``), the engine's abstract steps and the fake implementations of
the counting operators, on the CPU.

The pass-1 cases of ``tests/analysis/test_program.py`` are mirrored under
their own names. The walker cases trace their programs over fake tensors
of the card (``device="cuda"``; a fake tensor needs no card), where a
``.cpu()`` is a device→host transfer, and nest them in ``torch.cond`` and
``map`` bodies. The metric cases run on the CPU, where the audit traces the
CPU's program.
"""
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu_torch as M
from metrics_tpu_torch.analysis import audit_metric, hint_for_watch_key, iter_eqns
from metrics_tpu_torch.analysis import fixtures as fx
from metrics_tpu_torch.analysis.program import (
    _LAST_AUDIT,
    _callback_eqns,
    _duplicate_outvars,
    _trace_error_kind,
)
from metrics_tpu_torch.engine import LeafSpec, fake_trace

CPU = "cpu"
_X = (torch.linspace(0.0, 1.0, 8),)
# a fake tensor of the card: traces here, where no card is
_CARD = LeafSpec((4,), torch.float32, torch.device("cuda", 0))


def _cb(v):
    """A device→host round trip: ``.cpu()`` and back to ``v``'s device."""
    return v.sum().cpu().to(v.device)


def _map(fn, x):
    from torch._higher_order_ops.map import map as hop_map

    return hop_map(fn, x.reshape(2, 2))


# ---------------------------------------------------------------------------
# the walker: nested-graph recursion
# ---------------------------------------------------------------------------
def test_walker_finds_callback_inside_pjit():
    # a nested program that always runs: both branches of a cond hold it
    graph, _ = fake_trace(lambda x: torch.cond(x.sum() > 0, _cb, _cb, (x,)), (_CARD,))
    assert "aten._to_copy.default" in _callback_eqns(graph)


def test_walker_finds_callback_inside_scan():
    graph, _ = fake_trace(lambda x: _map(lambda row: row + _cb(row), x), (_CARD,))
    assert "aten._to_copy.default" in _callback_eqns(graph)


def test_walker_finds_callback_inside_cond_branch():
    graph, _ = fake_trace(lambda x: torch.cond(x.max() > 0, _cb, lambda v: v.sum(), (x,)), (_CARD,))
    assert "aten._to_copy.default" in _callback_eqns(graph)


def test_walker_finds_callback_three_levels_deep():
    def inner(v):
        return _map(lambda row: torch.cond(row.sum() > 1, _cb, lambda u: u.sum(), (row,)), v)

    graph, _ = fake_trace(lambda x: torch.cond(x.sum() > 0, inner, inner, (x,)), (_CARD,))
    assert "aten._to_copy.default" in _callback_eqns(graph)


def test_walker_clean_program_has_no_callbacks():
    graph, _ = fake_trace(lambda x: torch.sum(x) * 2, (_CARD,))
    assert _callback_eqns(graph) == []
    assert len(list(iter_eqns(graph))) >= 2


def test_walker_cpu_program_copies_are_no_transfer():
    """On a program whose device is the CPU a ``.cpu()`` moves nothing: the
    callback kind binds on the card."""
    graph, _ = fake_trace(_cb, (torch.ones(4),))
    assert _callback_eqns(graph) == []


def test_duplicate_outvars_detects_aliasing():
    graph, _ = fake_trace(lambda x: (torch.sum(x),) * 2, (torch.ones(4),))
    dups = _duplicate_outvars(graph)
    assert len(dups) == 1 and dups[0][0] == 2

    clean, _ = fake_trace(lambda x: (torch.sum(x), torch.max(x)), (torch.ones(4),))
    assert _duplicate_outvars(clean) == []


def test_duplicate_outvars_follows_views_and_in_place_writes():
    """PyTorch's second form: an output that is a view of another output,
    or an in-place write into it, shares its storage."""
    view, _ = fake_trace(lambda x: (x * 2, (x * 2).view(-1)), (torch.ones(4),))
    assert _duplicate_outvars(view) == []  # two products: two buffers

    def shared(x):
        y = x * 2
        return y, y.view(2, 2), y[0]

    graph, _ = fake_trace(shared, (torch.ones(4),))
    assert _duplicate_outvars(graph) == [(3, [0, 1, 2])]

    def in_place(x):
        y = x * 2
        return y, y.add_(1)

    graph, _ = fake_trace(in_place, (torch.ones(4),))
    assert _duplicate_outvars(graph) == [(2, [0, 1])]


class _ViewAlias(M.Metric):
    """MTA003's PyTorch-only form: one state a view of another."""

    _fused_forward = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("sums", default=torch.zeros((2,)), dist_reduce_fx="sum")
        self.add_state("first", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x):
        self.sums = self.sums + torch.stack([x.sum(), (x * x).sum()])
        self.first = self.sums[0]  # the alias: a view into `sums`

    def compute(self):
        return self.first


def test_state_that_views_another_state_is_flagged():
    result = audit_metric(_ViewAlias(device=CPU), _X)
    assert {(f.rule, f.subject) for f in result.findings} == {("MTA003", "_ViewAlias.update")}


@pytest.mark.parametrize(
    "fn, kind",
    [
        (lambda x: x + float(x.sum()), "host-sync"),
        (lambda x: x + x.sum().item(), "host-sync"),
        (lambda x: torch.as_tensor(x.sum().numpy()), "host-sync"),
        (lambda x: x[x > 0.5], "host-sync"),
        (lambda x: x.reshape(3, 3), "trace-failure"),
    ],
    ids=["float", "item", "numpy", "boolean-mask", "shape-error"],
)
def test_trace_errors_are_classified(fn, kind):
    with pytest.raises(Exception) as info:
        fake_trace(fn, (torch.ones(4),))
    assert _trace_error_kind(info.value) == kind


# ---------------------------------------------------------------------------
# the counting operators under fake tensors (the repair this pass needed)
# ---------------------------------------------------------------------------
def _label_counts_call(indices, weights):
    from metrics_tpu_torch.ops.histogram import _label_counts

    return _label_counts(indices, 5, weights)


def _bucket_sums_call(indices, adds):
    from metrics_tpu_torch.ops.histogram import _bucket_sums

    return _bucket_sums(indices, adds, 7)


@pytest.mark.parametrize("op", [_label_counts_call, _bucket_sums_call], ids=["label_counts", "bucket_sums"])
@pytest.mark.parametrize("batched", [False, True], ids=["alone", "vmap"])
def test_counting_operators_trace_over_fake_tensors(op, batched):
    rng = np.random.RandomState(3)
    idx = torch.as_tensor(rng.randint(0, 5, size=(3, 6)))
    second = torch.as_tensor(rng.rand(3, 6) > 0.3) if op is _label_counts_call else torch.ones(3, 6, dtype=torch.float64)
    fn = torch.func.vmap(op) if batched else op
    call = (idx, second) if batched else (idx[0], second[0])
    real = fn(*call)
    graph, spec = fake_trace(fn, call)
    assert (spec.shape, spec.dtype, spec.device) == (tuple(real.shape), real.dtype, real.device)
    assert _callback_eqns(graph) == []


# ---------------------------------------------------------------------------
# the engine hook
# ---------------------------------------------------------------------------
def test_abstract_step_traces_without_dispatch():
    m = M.MeanSquaredError(device=CPU)
    engine = M.CompiledStepEngine(m)
    graph, out_shapes, n_donated = engine.abstract_step(*(_X[0], _X[0]))
    assert n_donated == 2  # sum_squared_error + total
    assert engine.cache_info()["compiled_signatures"] == 0  # no build happened
    new_states, values = out_shapes
    assert set(new_states["metric"]) == {"sum_squared_error", "total"}
    # state is conserved abstractly: merged dtypes match the defaults
    assert new_states["metric"]["sum_squared_error"].dtype == torch.float32
    # and metric state is untouched by tracing
    assert int(m.total) == 0


def test_abstract_step_refuses_all_eager_engine():
    engine = M.CompiledStepEngine(M.AUROC(device=CPU))  # list states: eager-only
    with pytest.raises(ValueError, match="eager"):
        engine.abstract_step(_X[0], torch.ones(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="eager"):
        engine.abstract_cohort_step(_X[0], torch.ones(8, dtype=torch.int32))


@pytest.mark.parametrize("cohort", [False, True], ids=["step", "cohort_step"])
def test_abstract_steps_touch_nothing(cohort):
    """No signature cache, state, build counter, watchdog, cost ledger or
    telemetry event moves; states and inputs come back as fake leaves of
    the right shapes."""
    from metrics_tpu_torch import observability as obs
    from metrics_tpu_torch.observability import costledger

    rng = np.random.RandomState(5)
    m = M.BinnedAUROC(num_bins=16, device=CPU)
    preds = torch.as_tensor(rng.rand(8).astype(np.float32))
    target = torch.as_tensor(rng.randint(2, size=8))
    m(preds, target)  # a real step first: live states to snapshot
    before = {k: getattr(m, k).clone() for k in m._defaults}
    objects = {k: getattr(m, k) for k in m._defaults}
    engine = M.CompiledStepEngine(m)
    with obs.telemetry_scope() as tel, costledger.cost_ledger_scope() as ledger:
        if cohort:
            graph, out, n = engine.abstract_cohort_step(preds, target, capacity=4)
        else:
            graph, out, n = engine.abstract_step(preds, target)
        assert list(tel.events) == [] and tel.watchdog.snapshot()["keys"] == {}
        assert ledger.snapshot()["entries"] == []
    info = engine.cache_info()
    assert (info["compiled_signatures"], info["trace_count"], info["seen_signatures"]) == (0, 0, 0)
    assert engine.dispatch_generation == 0
    for k in m._defaults:
        assert getattr(m, k) is objects[k] and torch.equal(getattr(m, k), before[k])
    lead = (4,) if cohort else ()
    assert n == 2
    assert {k: (v.shape, v.dtype) for k, v in out[0]["metric"].items()} == {
        "hist_neg": (lead + (16,), torch.float32), "hist_pos": (lead + (16,), torch.float32)
    }


def test_abstract_cohort_step_stacks_states_and_inputs():
    engine = M.CompiledStepEngine(M.MeanSquaredError(device=CPU))
    graph, out, n = engine.abstract_cohort_step(_X[0], _X[0], capacity=4)
    placeholders = [p.meta["val"].shape for p in graph.graph.nodes if p.op == "placeholder"]
    assert placeholders == [(4,), (4,), (4, 8), (4, 8)]
    assert n == 2 and out[1]["metric"].shape == (4,)


# ---------------------------------------------------------------------------
# dtype-drift detection on real metrics
# ---------------------------------------------------------------------------
def test_bf16_cast_metric_with_f32_inputs_is_flagged():
    """bfloat16 states fed f32 batches silently promote back to f32 after
    one update — the precision policy evaporates AND every later step
    rebuilds. The auditor names it before the first dispatch."""
    m = M.MeanSquaredError(device=CPU).astype(torch.bfloat16)
    result = audit_metric(m, (_X[0], _X[0]))
    rules = {f.rule for f in result.findings}
    assert rules == {"MTA001"}


def test_bf16_inputs_with_f32_accumulators_is_clean():
    """The sound half-precision loop — bf16 batches into f32 sufficient
    stats (the `promote_accumulator` discipline) — stays clean."""
    m = M.MeanSquaredError(device=CPU)
    xb = _X[0].to(torch.bfloat16)
    result = audit_metric(m, (xb, xb))
    assert result.findings == []


def test_zero_dim_promotion_shows_as_dtype_drift():
    """PyTorch's 0-dim promotion (a 0-dim float64 state plus a 1-dim float32
    batch gives float32) is the drift MTA001 names; tensors carry no
    weak_type, so JAX's weak-type check has no counterpart."""

    class _F64Acc(M.Metric):
        _fused_forward = True

        def __init__(self):
            super().__init__(device=CPU)
            self.add_state("acc", default=torch.zeros((), dtype=torch.float64), dist_reduce_fx="sum")

        def update(self, x):
            self.acc = (self.acc + x).sum()

        def compute(self):
            return self.acc

    def drift(x):
        return [f.detail for f in audit_metric(_F64Acc(), (x,)).findings if f.rule == "MTA001"]

    assert drift(torch.ones(())) == []  # two 0-dim operands: float64 stays
    assert drift(torch.ones(4)) == [{"before": "float64", "after": "float32"}]


def test_audit_leaves_metric_usable():
    m = M.Accuracy(device=CPU)
    raw = np.random.RandomState(0).rand(16, 4).astype(np.float32)
    preds = torch.as_tensor(raw / raw.sum(1, keepdims=True))
    target = torch.as_tensor(np.random.RandomState(1).randint(4, size=16))
    audit_metric(m, (preds, target))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        value = m(preds, target)
    assert 0.0 <= float(value) <= 1.0
    assert int(m.total) == 16  # audit tracing never touched live state


# ---------------------------------------------------------------------------
# compiled-path rules bind only metrics that claim they can compile
# ---------------------------------------------------------------------------
class _EagerAlias(M.Metric):
    """No `_fused_forward`: never compiled — the aliased states are legal
    sharing, not a buffer hazard."""

    def __init__(self):
        super().__init__(device=CPU)
        self.add_state("a", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("b", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x):
        total = torch.sum(x)
        self.a = total
        self.b = total

    def compute(self):
        return self.a


class _EagerCallback(M.Metric):
    def __init__(self):
        super().__init__(device=CPU)
        self.add_state("acc", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x):
        self.acc = self.acc + torch.as_tensor(torch.sum(x).cpu().numpy())

    def compute(self):
        return self.acc


def test_engine_ineligible_metric_is_exempt_from_donation_aliasing():
    result = audit_metric(_EagerAlias(), _X)
    assert result.findings == []
    assert not result.engine_eligible


def test_engine_ineligible_callback_is_info_not_finding():
    result = audit_metric(_EagerCallback(), _X)
    assert result.findings == []
    assert any("eager-only by design" in i for i in result.infos)


def test_fused_variants_of_the_same_programs_still_flag():
    """Identical update programs with the fused-forward opt-in DO get the
    compiled-path rules (the fixture classes pin the full messages)."""
    alias = type("_FusedAlias", (_EagerAlias,), {"_fused_forward": True})
    cb = type("_FusedCallback", (_EagerCallback,), {"_fused_forward": True})
    assert {f.rule for f in audit_metric(alias(), _X).findings} == {"MTA003"}
    assert {f.rule for f in audit_metric(cb(), _X).findings} == {"MTA002"}


# ---------------------------------------------------------------------------
# watchdog cross-link
# ---------------------------------------------------------------------------
def test_hint_names_rule_for_engine_watch_key():
    audit_metric(fx.NarrowAccumulator(device=CPU), _X)
    hint = hint_for_watch_key("engine[NarrowAccumulator]")
    assert hint is not None and "MTA001" in hint and "narrow-accumulator" in hint


def test_single_metric_engine_watch_key_matches_audit_names():
    """A lone metric is keyed 'metric' inside the engine; its watch key
    must still carry the class name or the analyzer cross-link dies for
    the most common engine shape."""
    engine = M.CompiledStepEngine(fx.NarrowAccumulator(device=CPU))
    assert engine._watch_key == "engine[NarrowAccumulator]"
    audit_metric(fx.NarrowAccumulator(device=CPU), _X)
    assert hint_for_watch_key(engine._watch_key) is not None


def test_abstract_step_does_not_feed_the_watchdog():
    """Analysis-only traces must not count as churn: auditing in a
    telemetry session leaves the recompilation watchdog silent."""
    from metrics_tpu_torch import observability as obs

    with obs.telemetry_scope() as tel:
        for _ in range(tel.watchdog.trace_budget + 4):
            audit_metric(M.MeanSquaredError(device=CPU), (_X[0], _X[0]))
        assert tel.watchdog.retrace_count() == 0
        assert tel.watchdog.snapshot()["keys"] == {}


def test_audit_does_not_emit_eager_fallback_events():
    """The auditor's throwaway engines must not look like production
    demotions in the event log: auditing an eager member (AUROC) in a
    telemetry session leaves zero `eager_fallback` events."""
    from metrics_tpu_torch import observability as obs
    from metrics_tpu_torch.analysis import audit_collection

    binary = (torch.linspace(0.0, 1.0, 8), torch.ones(8, dtype=torch.int32))
    with obs.telemetry_scope() as tel:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            audit_metric(M.AUROC(device=CPU), binary)
            audit_collection(
                M.MetricCollection({"auroc": M.AUROC(device=CPU), "mse": M.MeanSquaredError(device=CPU)}),
                binary,
            )
        events = [e for e in tel.events if e.get("kind") == "eager_fallback"]
        assert events == []


def test_hint_resolves_custom_named_collection_members():
    """Collection engine watch keys are built from the collection's own
    keys; auditing the collection must register results under those names
    too, or renamed members ({'bad': ...} -> 'engine[bad]') never get an
    attribution."""
    from metrics_tpu_torch.analysis import audit_collection

    audit_collection(M.MetricCollection({"bad": fx.NarrowAccumulator(device=CPU)}), _X)
    hint = hint_for_watch_key("engine[bad]")
    assert hint is not None and "MTA001" in hint


def test_hint_none_for_clean_or_unknown_keys():
    audit_metric(M.Accuracy(device=CPU), (torch.ones((4, 2)), torch.ones(4, dtype=torch.int32)))
    assert hint_for_watch_key("engine[Accuracy]") is None
    assert hint_for_watch_key("engine[NeverAudited]") is None


def test_watchdog_warning_carries_the_hint():
    from metrics_tpu_torch.observability.watchdog import RecompilationWatchdog

    audit_metric(fx.NarrowAccumulator(device=CPU), _X)
    assert "NarrowAccumulator" in _LAST_AUDIT
    wd = RecompilationWatchdog()
    key = "engine[NarrowAccumulator,hint-test]"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        wd.note_compile(key, new_signature=False)
    messages = [str(w.message) for w in caught]
    assert any("MTA001" in m and "thrashing" in m for m in messages), messages


def test_hint_names_pass3_rules_for_watch_keys():
    """Watchdog attributions must cover the pass-3 rules: a metric whose
    last audit holds MTA005/006/007 findings gets a hint naming them
    (MTA001 still fronts when present — churn is what the watchdog
    measures)."""
    audit_metric(fx.ReplicaDependentCount(device=CPU), _X)
    hint = hint_for_watch_key("engine[ReplicaDependentCount]")
    assert hint is not None and "MTA005" in hint and "replica-inequivalence" in hint

    audit_metric(fx.ComputeMutatesState(device=CPU), _X)
    hint = hint_for_watch_key("engine[ComputeMutatesState]")
    assert hint is not None and "MTA006" in hint and "lifecycle-unsound" in hint

    audit_metric(fx.UntouchedStatePassthrough(device=CPU), _X)
    hint = hint_for_watch_key("engine[UntouchedStatePassthrough]")
    assert hint is not None and "MTA007" in hint and "donation-lifetime" in hint


def test_hint_names_pass4_rules_for_watch_keys():
    """Watchdog attributions cover the pass-4 rules: a family whose last
    audit holds MTA008 (seam regression) or MTA009 (double-buffer hazard)
    findings gets a hint naming them."""
    audit_metric(fx.SeamRegressor(device=CPU), _X)
    hint = hint_for_watch_key("engine[SeamRegressor]")
    assert hint is not None and "MTA008" in hint and "host-seam-regression" in hint

    audit_metric(fx.HostReadOfDonated(device=CPU), _X)
    hint = hint_for_watch_key("engine[HostReadOfDonated]")
    assert hint is not None and "MTA009" in hint and "double-buffer-unsafe" in hint

    audit_metric(fx.DoubleBufferAliaser(device=CPU), _X)
    hint = hint_for_watch_key("engine[DoubleBufferAliaser]")
    assert hint is not None and "MTA009" in hint


class _OneCleanState(M.Metric):
    """A clean one-state family: its seam budget matches the deliberately
    tight committed SeamRegressor baseline exactly, so a same-named audit
    of THIS class clears the pass-4 hint."""

    _fused_forward = True

    def __init__(self):
        super().__init__(device=CPU)
        self.add_state("acc", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x):
        self.acc = self.acc + torch.sum(x)

    def compute(self):
        return self.acc


@pytest.mark.parametrize("fixture", ["SeamRegressor", "HostReadOfDonated"], ids=["MTA008", "MTA009"])
def test_hint_name_keying_caveat_extends_to_pass4(fixture):
    """The name-keyed caveat, re-pinned for the pass-4 rules: a same-named
    clean class re-audited afterwards clears the hint (latest audit wins),
    and re-auditing the broken one re-arms it."""
    broken = getattr(fx, fixture)
    audit_metric(broken(device=CPU), _X)
    assert hint_for_watch_key(f"engine[{fixture}]") is not None

    clean = type(fixture, (_OneCleanState,), {})
    audit_metric(clean(), _X)
    assert hint_for_watch_key(f"engine[{fixture}]") is None

    audit_metric(broken(device=CPU), _X)
    assert hint_for_watch_key(f"engine[{fixture}]") is not None


@pytest.mark.parametrize("rule", ["MTA013", "MTA014"], ids=["MTA013", "MTA014"])
def test_hint_name_keying_caveat_extends_to_pass6(rule):
    """The name-keyed caveat, re-pinned for the pass-6 protocol rules: the
    explorer registers its findings under the driven class's bare name, so
    a watchdog key naming the coordinator/shard class hints the protocol
    violation — and a same-named clean class re-explored afterwards clears
    it (latest audit wins), exactly like the metric-audit rules."""
    from metrics_tpu_torch.analysis.protocol import explore_crash_consistency, explore_fencing
    from metrics_tpu_torch.fleet import FleetShard, MigrationCoordinator

    if rule == "MTA013":
        broken, base = fx.GcBeforeDurableCoordinator, MigrationCoordinator
        explore = lambda cls: explore_crash_consistency(  # noqa: E731
            coordinator_cls=cls, modes=("none",), device=CPU
        )
    else:
        broken, base = fx.UnfencedCheckpointShard, FleetShard
        explore = lambda cls: explore_fencing(  # noqa: E731
            shard_cls=cls, writes=("checkpoint",), points=("after_fence",), device=CPU
        )

    explore(broken)
    hint = hint_for_watch_key(broken.__name__)
    assert hint is not None and rule in hint

    clean = type(broken.__name__, (base,), {})
    explore(clean)
    assert hint_for_watch_key(broken.__name__) is None

    explore(broken)
    assert hint_for_watch_key(broken.__name__) is not None


def test_hint_name_keying_caveat_latest_audit_wins():
    """The documented caveat, pinned: the hint lookup is keyed by bare
    class name and reflects the MOST RECENT audit of any class with that
    name. A same-named clean class re-audited afterwards clears the hint;
    until that re-audit, a stale finding keeps hinting."""
    audit_metric(fx.ReplicaDependentCount(device=CPU), _X)
    assert hint_for_watch_key("engine[ReplicaDependentCount]") is not None

    clean = type("ReplicaDependentCount", (M.MeanSquaredError,), {})
    audit_metric(clean(device=CPU), (_X[0], _X[0]))
    assert hint_for_watch_key("engine[ReplicaDependentCount]") is None

    audit_metric(fx.ReplicaDependentCount(device=CPU), _X)
    assert hint_for_watch_key("engine[ReplicaDependentCount]") is not None
