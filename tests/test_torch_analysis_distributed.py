"""The port's distributed-equivalence prover and lifecycle/donation
analyzer (pass 3, ``metrics_tpu_torch/analysis/distributed.py``) and its
program fingerprints, on the CPU.

The pass-3 cases of ``tests/analysis/test_distributed.py`` that read no
registry report are mirrored here under their own names; the ones that
read it are in ``tests/test_torch_analysis_registry.py``, beside the
registry run they share. Two cases are the port's own: PyTorch's second
form of compute mutation (an in-place write that keeps the attribute bound
to the same tensor), and fingerprints that leave the device out.
"""
import warnings

import numpy as np
import torch

import metrics_tpu_torch as M
from metrics_tpu_torch.analysis import audit_metric, fingerprint_jaxpr
from metrics_tpu_torch.analysis import distributed as dist
from metrics_tpu_torch.analysis import fixtures as fx
from metrics_tpu_torch.engine import CompiledStepEngine, LeafSpec, _flatten, fake_trace

CPU = "cpu"
_X = (torch.linspace(0.0, 1.0, 8),)


# ---------------------------------------------------------------------------
# grid probes: the construction that makes bit-identity a fair demand
# ---------------------------------------------------------------------------
def test_grid_probe_floats_live_on_the_grid():
    raw = torch.as_tensor(np.random.RandomState(0).rand(32).astype(np.float32))
    (probe,) = dist.grid_probe_args((raw,))
    vals = probe.numpy().astype(np.float64) * 256.0
    assert np.array_equal(vals, np.round(vals))  # integer multiples of 1/256


def test_grid_probe_probability_rows_sum_to_exactly_one():
    rng = np.random.RandomState(1)
    probs = rng.rand(16, 4).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    tgt_in = torch.arange(16) % 4
    probe, tgt = dist.grid_probe_args((torch.as_tensor(probs), tgt_in))
    # rows are integer compositions of 256: the float32 row sum is EXACT
    assert np.array_equal(probe.numpy().sum(axis=1), np.ones(16, np.float32))
    assert tgt is tgt_in


def test_grid_probe_keeps_integer_leaves():
    ints = torch.arange(8)
    out = dist.grid_probe_args((ints,))
    assert out[0] is ints


# ---------------------------------------------------------------------------
# MTA005
# ---------------------------------------------------------------------------
class _Sum(M.Metric):
    def __init__(self, **kwargs):
        super().__init__(device=CPU, **kwargs)
        self.add_state("acc", default=torch.zeros((32,)), dist_reduce_fx="sum")

    def update(self, x):
        self.acc = self.acc + x

    def compute(self):
        return self.acc


def test_two_level_merge_matches_flat_bitwise_on_exact_sum():
    """Direct probe of the merge composite: 4 replicas, 2 slices, exact
    sum state — the two-level fold must be bit-identical to flat."""
    m = _Sum()
    rng = np.random.RandomState(9)
    per = [
        {"acc": torch.as_tensor((rng.randint(0, 1024, size=32) / 256.0).astype(np.float32))}
        for _ in range(4)
    ]
    flat, _ = dist._merge_replica_states(m, per)
    two, _ = dist._merge_replica_states_two_level(m, per, num_slices=2)
    assert torch.equal(flat["acc"], two["acc"])


def test_two_level_merge_int8_within_summed_bound():
    class _QSum(M.Metric):
        def __init__(self):
            super().__init__(device=CPU)
            self.add_state("acc", default=torch.zeros((256,)), dist_reduce_fx="sum", sync_precision="int8")

        def update(self, x):
            self.acc = self.acc + x

        def compute(self):
            return self.acc

    m = _QSum()
    rng = np.random.RandomState(10)
    per = [
        {"acc": torch.as_tensor(rng.rand(256).astype(np.float32) * 4), "acc__qres": torch.zeros((256,))}
        for _ in range(4)
    ]
    flat, flat_tols = dist._merge_replica_states(m, per)
    two, two_tols = dist._merge_replica_states_two_level(m, per, num_slices=2)
    err = float((flat["acc"] - two["acc"]).abs().max())
    assert err > 0.0  # different quantization points: genuinely lossy
    assert err <= flat_tols["acc"] + two_tols["acc"]


def test_quantized_variant_uses_different_engine_signature():
    """A precision flip is a different program: the engine signature must
    differ between the exact and int8 variants of the same metric."""
    base, tiered = M.BinnedAUROC(num_bins=16, device=CPU), M.BinnedAUROC(num_bins=16, device=CPU)
    tiered.set_sync_precision("int8")
    args = (torch.linspace(0.0, 1.0, 8), torch.ones(8, dtype=torch.int32))

    def signature(m):
        engine = CompiledStepEngine(m, observe=False)
        leaves = []
        structure = _flatten((args, {}), leaves)
        return engine._signature(("metric",), engine._current_states(("metric",)), leaves, structure)

    assert signature(base) != signature(tiered)


def test_replica_dependent_count_flags_split_inequivalence():
    result = audit_metric(fx.ReplicaDependentCount(device=CPU), _X)
    assert {f.rule for f in result.findings} == {"MTA005"}
    msgs = " | ".join(f.message for f in result.findings)
    assert "diverges" in msgs
    # evidence still recorded for the report
    assert result.distributed is not None


def test_order_sensitive_merge_flags_order_dependence():
    """A merge that reads the replica axis by INDEX (weighting rank 0
    double) is commutatively broken in a way only realistic per-replica
    states expose — the permutation leg of MTA005 catches it."""

    def rank_weighted(stacked):
        w = torch.cat([torch.full((1,), 2.0), torch.ones((stacked.shape[0] - 1,))])
        return torch.tensordot(w, stacked, dims=1)

    class OrderSensitive(M.Metric):
        _fused_forward = False  # eager: isolate the MTA005-order probe

        def __init__(self):
            super().__init__(device=CPU)
            self.add_state("acc", default=torch.zeros(()), dist_reduce_fx=rank_weighted)

        def update(self, x):
            self.acc = self.acc + torch.sum(x)

        def compute(self):
            return self.acc

    findings, infos = [], []
    dist.check_replica_equivalence(OrderSensitive(), _X, {}, findings, infos)
    kinds = {f.detail.get("kind") for f in findings if f.rule == "MTA005"}
    assert findings and all(f.rule == "MTA005" for f in findings)
    assert "order" in kinds or any("diverges" in f.message for f in findings)


# ---------------------------------------------------------------------------
# MTA006 — lifecycle
# ---------------------------------------------------------------------------
def test_reset_identity_probe_accepts_sum_min_max_identities():
    assert dist._reduction_identity_violation(dist.dim_zero_sum, torch.zeros((4,)), torch.ones((4,))) is None
    assert dist._reduction_identity_violation(
        dist.dim_zero_min, torch.full((4,), float("inf")), torch.ones((4,))
    ) is None
    assert dist._reduction_identity_violation(
        dist.dim_zero_max, torch.full((4,), float("-inf")), torch.ones((4,))
    ) is None


def test_reset_identity_probe_rejects_non_identity():
    note = dist._reduction_identity_violation(dist.dim_zero_sum, torch.ones(()), torch.tensor(3.0))
    assert note is not None and "identity" in note


def test_compute_mutation_caught_concrete_and_abstract():
    result = audit_metric(fx.ComputeMutatesState(device=CPU), _X)
    findings = [f for f in result.findings if f.rule == "MTA006"]
    assert len(findings) == 1
    assert findings[0].detail["concrete"] is True


def test_bitwise_invisible_mutation_caught_abstractly():
    """`self.x = self.x + 0` survives the concrete value check (the value
    is unchanged) but the trace-time identity check sees the rewrite."""

    class SneakyMutation(M.Metric):
        _fused_forward = True

        def __init__(self):
            super().__init__(device=CPU)
            self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + torch.sum(x)

        def compute(self):
            self.total = self.total + 0.0  # bitwise no-op, still a write
            return self.total

    findings, infos = [], []
    dist.check_lifecycle(SneakyMutation(), _X, {}, findings, infos)
    muts = [f for f in findings if "mutates" in f.message]
    assert len(muts) == 1
    assert muts[0].detail["abstract"] is True


class _InPlaceCompute(M.Metric):
    """PyTorch's second form of compute mutation: an in-place write keeps
    the attribute bound to the same tensor (JAX arrays cannot be written
    in place)."""

    _fused_forward = True

    def __init__(self):
        super().__init__(device=CPU)
        self.add_state("acc", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x):
        self.acc = self.acc + torch.sum(x)

    def compute(self):
        self.acc.add_(0)  # bitwise no-op, a write all the same
        return self.acc


def test_in_place_compute_mutation_caught_by_versions():
    findings, infos = [], []
    dist.check_lifecycle(_InPlaceCompute(), _X, {}, findings, infos)
    muts = [f for f in findings if "mutates" in f.message]
    assert [(f.subject, f.detail) for f in muts] == [
        ("_InPlaceCompute.acc", {"concrete": True, "abstract": True})
    ]
    # the audit reports it, and the cached probe state stayed as it was
    result = audit_metric(_InPlaceCompute(), _X)
    assert {(f.rule, f.subject) for f in result.findings} == {("MTA006", "_InPlaceCompute.acc")}


def test_residual_coherence_on_real_tier_is_clean():
    m = M.MeanSquaredError(device=CPU)
    m.set_sync_precision("int8")
    findings, infos = [], []
    dist.check_lifecycle(m, (_X[0], _X[0]), {}, findings, infos)
    assert findings == []


def test_orphan_residual_flags():
    result = audit_metric(fx.OrphanResidual(device=CPU), _X)
    assert {f.rule for f in result.findings} == {"MTA006"}
    assert any("orphan" in f.message for f in result.findings)


def test_residual_persistence_mismatch_flags():
    m = M.MeanSquaredError(device=CPU)
    m.set_sync_precision("int8")
    m._persistent["sum_squared_error__qres"] = True  # the mismatch
    findings, infos = [], []
    dist.check_lifecycle(m, (_X[0], _X[0]), {}, findings, infos)
    assert any("persistence" in f.message for f in findings)


# ---------------------------------------------------------------------------
# MTA007 — donation lifetime
# ---------------------------------------------------------------------------
def test_untouched_state_passthrough_flags():
    result = audit_metric(fx.UntouchedStatePassthrough(device=CPU), _X)
    assert [f.rule for f in result.findings] == ["MTA007"]
    assert "version" in result.findings[0].subject


def test_passthrough_exempts_eager_metrics():
    """An eager metric has no engine buffers: the same untouched state is
    legal there."""
    eager = type("EagerUntouched", (fx.UntouchedStatePassthrough,), {"_fused_forward": False})
    result = audit_metric(eager(device=CPU), _X)
    assert result.findings == []


def test_donated_passthrough_positions_on_synthetic_program():
    s, x = LeafSpec((3,), torch.float32, torch.device(CPU)), torch.ones(3)
    graph, _ = fake_trace(lambda s, x: (s, x + 1.0), (s, x))
    assert dist._donated_passthrough_positions(graph, 1) == [0]
    clean, _ = fake_trace(lambda s, x: (s + x, x + 1.0), (s, x))
    assert dist._donated_passthrough_positions(clean, 1) == []
    # PyTorch's in-place form hands the input's storage back too
    in_place, _ = fake_trace(lambda s, x: (s.add_(x), x + 1.0), (s, x))
    assert dist._donated_passthrough_positions(in_place, 1) == [0]


def test_unowned_loader_flags_and_delegating_loader_does_not():
    assert any(
        f.rule == "MTA007" and "load_state_dict" in f.subject
        for f in audit_metric(fx.UnownedLoader(device=CPU), _X).findings
    )

    class DelegatingLoader(fx.UnownedLoader):
        def load_state_dict(self, state_dict, prefix="", strict=False, _warn_on_zero_match=True):
            super().load_state_dict(state_dict, prefix=prefix, strict=strict)

    # delegation bottoms out in the fixture's unsafe loader, but the
    # override ITSELF delegates — only the defining class is charged
    assert dist._unsafe_load_override(DelegatingLoader) is None
    assert dist._unsafe_load_override(fx.UnownedLoader) is fx.UnownedLoader
    assert dist._unsafe_load_override(M.MeanSquaredError) is None


# ---------------------------------------------------------------------------
# program fingerprints (drift sentinel)
# ---------------------------------------------------------------------------
def test_fingerprints_deterministic_across_audits():
    a = audit_metric(M.MeanSquaredError(device=CPU), (_X[0], _X[0]), fingerprint=True)
    b = audit_metric(M.MeanSquaredError(device=CPU), (_X[0], _X[0]), fingerprint=True)
    assert a.fingerprints == b.fingerprints
    assert a.fingerprints["update"] and a.fingerprints["step"]


def test_fingerprints_change_when_the_program_changes():
    f32 = audit_metric(M.MeanSquaredError(device=CPU), (_X[0], _X[0]), fingerprint=True)
    xb = _X[0].to(torch.bfloat16)
    bf16 = audit_metric(M.MeanSquaredError(device=CPU), (xb, xb), fingerprint=True)
    assert f32.fingerprints["update"] != bf16.fingerprints["update"]


def test_fingerprint_digest_reflects_shapes_and_dtypes():
    def digest(x):
        return fingerprint_jaxpr(fake_trace(lambda v: v + 1.0, (x,))[0])

    assert digest(torch.zeros(4)) != digest(torch.zeros(8))
    assert digest(torch.zeros(4)) != digest(torch.zeros(4, dtype=torch.float64))
    assert digest(torch.zeros(4)) == digest(torch.zeros(4))


def test_fingerprint_digest_leaves_the_device_out():
    """The card's program and the CPU's digest alike: a fake trace on the
    card (no card needed) against the same trace on the CPU."""

    def program(x):
        y = torch.flip(x, (0,)) * 2.0
        return torch.cumsum(y, 0), y.sum().to(torch.float64)

    card = LeafSpec((4, 4), torch.float32, torch.device("cuda", 0))
    cpu = LeafSpec((4, 4), torch.float32, torch.device(CPU))
    assert fingerprint_jaxpr(fake_trace(program, (card,))[0]) == fingerprint_jaxpr(fake_trace(program, (cpu,))[0])


def test_identity_probe_is_two_sided():
    """A zero-seeded `max` passes against positive states and only fails
    on negative ones — the probe must check both sides of the default."""
    note = dist._reduction_identity_violation(dist.dim_zero_max, torch.zeros(()), torch.tensor(3.0))
    assert note is not None  # the sign-flipped leg catches it


def test_psnr_running_range_quirk_is_suppressed_not_silent():
    """PSNR(data_range=None) seeds its running min/max trackers with 0.0
    to match the reference — a documented parity quirk, routed to the
    suppressed bucket with the rationale at the registration site."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        x = torch.linspace(0.1, 1.0, 8)
        result = audit_metric(M.PSNR(device=CPU), (x, x))
    assert result.findings == []
    assert {(f.rule, f.subject) for f in result.suppressed} == {
        ("MTA006", "PSNR.min_target"), ("MTA006", "PSNR.max_target"),
    }


def test_fingerprint_digest_reflects_static_params():
    """Two programs with identical ops and shapes but different static
    arguments (a flip of another axis of a square tensor) must digest
    differently — argument-only drift is exactly the silent semantic
    change the sentinel exists to catch."""
    x = torch.zeros((4, 4))
    a = fake_trace(lambda v: torch.flip(v, (0,)), (x,))[0]
    b = fake_trace(lambda v: torch.flip(v, (1,)), (x,))[0]
    assert fingerprint_jaxpr(a) != fingerprint_jaxpr(b)


def test_variant_audit_does_not_flag_base_suppressions_stale():
    """A class allow earning its keep on the base audit (MTA001 fires and
    is suppressed there) must not read as a stale MTL105 on the
    sync_precision variant audits, which deliberately never run MTA001."""
    from metrics_tpu_torch.analysis.program import _audit_quantized_variant

    class SuppressedQuantizable(fx.SuppressedNarrowAccumulator):
        pass

    base = audit_metric(SuppressedQuantizable(device=CPU), _X)
    assert base.findings == []  # the allow is used (inherited class-body)
    variant = SuppressedQuantizable(device=CPU)
    assert variant.set_sync_precision("int8")
    result = _audit_quantized_variant(variant, _X)
    assert [f.rule for f in result.findings] == [], [str(f) for f in result.findings]
