"""The port's registry audit and metric fixtures (passes 1 and 3) against
the JAX package's, on the CPU.

One module-scoped fixture per package runs its whole registry once
(``audit_registry(quantized=True, fingerprints=True)``, the port's with
``device="cpu"``): 29 families with their ``@cohort``, ``@int8`` and
``@bf16`` variants. The two reports must have the same families, the same
eligibility, the same findings and suppressions of MTA001–MTA009, MTA012
and MTL105, the same MTA005 evidence, and pass 5's sites and equivariance
verdicts (horizons and budgets against ``NUMERICS_BASELINE.json``). The registry cases of
``tests/analysis/test_distributed.py`` are mirrored here under their own
names, on the port's report. Beside them: each of the 15 metric fixtures
against its JAX twin, the grid probes and the merged replica states against
the JAX package's, and the engine's abstract steps against JAX's shapes.
"""
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu_torch as M
from metrics_tpu_torch.analysis import audit_metric, audit_registry
from metrics_tpu_torch.analysis import distributed as dist
from metrics_tpu_torch.analysis import fixtures as fx
from metrics_tpu_torch.analysis.program import registry_cases

CPU = "cpu"
#: the rules whose findings both packages' audits give alike (pass 5's
#: MTA010 and MTA011 are compared by subject below: the JAX package's walker
#: adds a spurious horizon regression beside each floor finding, and its
#: measured budget does not run)
COMPARED = {"MTA001", "MTA002", "MTA003", "MTA004", "MTA005", "MTA006", "MTA007", "MTA008", "MTA009", "MTA012",
            "MTL105"}
#: families whose exact tier sums transcendental terms (log1p): the 8-ulp allowance
ULP_FAMILIES = {"MeanSquaredLogError"}

FIXTURES = [
    "NarrowAccumulator", "SuppressedNarrowAccumulator", "CallbackInJit", "HostSyncUpdate", "DonatedAlias",
    "NonCommutativeMerge", "MeanWithoutCount", "UnscaledInt8Psum", "ReplicaDependentCount", "NonIdentityReset",
    "ComputeMutatesState", "OrphanResidual", "UntouchedStatePassthrough", "UnownedLoader", "StaleSuppression",
]


@pytest.fixture(scope="module")
def registry_report():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # config-edge warnings from factories
        return audit_registry(quantized=True, fingerprints=True, device=CPU)


@pytest.fixture(scope="module")
def jax_report():
    from metrics_tpu.analysis import audit_registry as jax_audit_registry

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jax_audit_registry(quantized=True, fingerprints=True)


def _rule_set(entries, bucket):
    return sorted((f["rule"], f["subject"]) for f in entries[bucket] if f["rule"] in COMPARED)


# ---------------------------------------------------------------------------
# the registry against the JAX package's
# ---------------------------------------------------------------------------
def test_registry_families_and_eligibility_equal_jax(registry_report, jax_report):
    port, ref = registry_report["families"], jax_report["families"]
    assert sorted(port) == sorted(ref)
    assert registry_report["summary"]["families"] == jax_report["summary"]["families"] == 89
    for fam in ref:
        assert port[fam]["engine_eligible"] == ref[fam]["engine_eligible"], fam


def test_registry_findings_and_suppressions_equal_jax(registry_report, jax_report):
    assert registry_report["summary"]["findings"] == jax_report["summary"]["findings"] == 0
    for fam, ref in jax_report["families"].items():
        port = registry_report["families"][fam]
        assert _rule_set(port, "findings") == _rule_set(ref, "findings"), fam
        assert _rule_set(port, "suppressed") == _rule_set(ref, "suppressed"), fam
        # MTA010: the same suppressed subjects (the JAX package's floor
        # findings, each with a spurious regression twin from its walker)
        subjects = [{f["subject"] for f in e["suppressed"] if f["rule"] == "MTA010"} for e in (port, ref)]
        assert subjects[0] == subjects[1], fam


def test_registry_equivalence_evidence_equals_jax(registry_report, jax_report):
    """MTA005's replica counts and bit-identity verdicts are the JAX
    package's. One deliberate difference: the JAX package's two-level
    merge of ``MeanSquaredLogError`` differs from its flat one within the
    8-ulp allowance, where the port's sums the same rows bit for bit."""
    for fam, ref in jax_report["families"].items():
        a, b = ref["distributed"], registry_report["families"][fam]["distributed"]
        assert (a is None) == (b is None), fam
        if a is None:
            continue
        for key in ("replicas", "on_grid", "bit_identical", "quantized_states"):
            assert b[key] == a[key], (fam, key, a[key], b[key])
        assert ("topology" in a) == ("topology" in b), fam
        if "topology" in a:
            ta, tb = a["topology"], b["topology"]
            assert (tb["replicas"], tb["num_slices"]) == (ta["replicas"], ta["num_slices"]), fam
            if fam in ULP_FAMILIES and tb["bit_identical"] and not ta["bit_identical"]:
                assert ta["max_state_err"] < 1e-6, (fam, ta)
            else:
                assert tb["bit_identical"] == ta["bit_identical"], (fam, ta, tb)


def test_registry_report_is_clean_and_names_no_unported_evidence(registry_report):
    """Clean, with pass 4's evidence on exactly the engine-eligible entries
    and pass 5's ``numerics`` on every entry, as the JAX package's. The
    suppressed findings are the int32 families' 96 MTA010 floor findings
    (24 per kind) and R2Score's 4 MTA011 budget findings (its class-body
    allow: the committed 2^-19 budget is below what R2's formula measures
    against a float64 oracle)."""
    assert registry_report["schema"] == "metrics_tpu.analysis_report"
    assert registry_report["summary"] == {"families": 89, "findings": 0, "suppressed": 100}
    assert registry_report["host_seam_sites"]
    kinds = {}
    for fam, entry in registry_report["families"].items():
        if entry["engine_eligible"]:
            assert set(entry["evidence"]) == {"host_seam", "double_buffer", "numerics"}, fam
        else:
            assert set(entry["evidence"]) == {"numerics"}, fam
        for f in entry["suppressed"]:
            key = (f["rule"], fam.split("@")[1] if "@" in fam else "base")
            kinds[key] = kinds.get(key, 0) + 1
            if f["rule"] == "MTA010":
                assert "below the fleet floor" in f["message"], (fam, f)
            else:
                assert (f["rule"], f["subject"]) == ("MTA011", "R2Score"), (fam, f)
    assert kinds == {**{("MTA010", k): 24 for k in ("base", "cohort", "int8", "bf16")},
                     **{("MTA011", k): 1 for k in ("base", "cohort", "int8", "bf16")}}


def test_registry_numerics_equal_jax_and_the_committed_baseline(registry_report, jax_report):
    """Pass 5 of every entry against its two oracles. The JAX package's live
    report gives the cancellation sites and the equivariance verdicts (its
    interval walker loses JAX 0.9's ``jit`` calls and its measured budget
    cannot run, so its horizons and budgets are not oracles);
    ``NUMERICS_BASELINE.json`` gives the horizons (kind, and rows equal as
    floats) and the budgets. Every measured budget is at or under the
    committed one, except R2Score's (suppressed, see above); a family whose
    compute pins float32 has no float64 oracle and no budget."""
    from metrics_tpu_torch.analysis.numerics import load_numerics_baseline

    base = load_numerics_baseline()
    measured = 0
    for fam, entry in registry_report["families"].items():
        ev = entry["evidence"]["numerics"]
        ref = jax_report["families"][fam]["evidence"]["numerics"]
        sites, jsites = ev["cancellation"]["sites"], ref["cancellation"]["sites"]
        assert (sites is None) == (jsites is None), fam
        assert sites is None or len(sites) == len(jsites), (fam, sites, jsites)
        assert ev["equivariance"] == ref["equivariance"], fam
        committed = base[fam]
        horizons = {k: v for k, v in ev["horizons"].items() if not k.startswith("__")}
        assert "__approximated__" not in ev["horizons"], (fam, ev["horizons"]["__approximated__"])
        assert sorted(horizons) == committed["states"], fam
        for state, want in committed["horizons"].items():
            got = horizons[state]
            assert (got["kind"], got["rows"]) == (want["kind"], want["rows"]), (fam, state, got, want)
        budget = ev["cancellation"]["budget"]
        if budget is None:
            assert ev["cancellation"]["float64"] is False, (fam, ev["cancellation"])
            continue
        assert ev["cancellation"]["float64"] is True and not ev["cancellation"].get("skipped"), fam
        measured += 1
        if fam.split("@")[0] != "R2Score":
            assert budget <= committed["error_budget"], (fam, budget, committed["error_budget"])
    # 11 root families measure (10 engine-eligible, 4 kinds each, and AUC);
    # the other 18 pin float32 for their result (casts to float32, the
    # tie-scan kernel's float32 output)
    assert measured == 41


# ---------------------------------------------------------------------------
# the registry cases of tests/analysis/test_distributed.py, on the port
# ---------------------------------------------------------------------------
def test_registry_equivalence_verified_at_all_replica_counts(registry_report):
    """Every engine-eligible family is proven equivalent at R ∈ {1, 2, 4}
    with zero findings (the summary gate pins zero findings overall; this
    pins that MTA005 actually RAN everywhere it binds)."""
    checked = 0
    for fam, entry in registry_report["families"].items():
        if "@" in fam or not entry["engine_eligible"]:
            continue
        ev = entry["distributed"]
        assert ev is not None, f"{fam}: equivalence never probed"
        assert ev["replicas"] == [1, 2, 4], (fam, ev)
        checked += 1
    assert checked >= 15  # the engine-eligible majority of the registry


def test_registry_exact_tier_is_bit_identical_modulo_log_terms(registry_report):
    """Exact-tier equivalence is BIT-identical on grid probes for every
    family except those accumulating transcendental per-element terms
    (log1p sums re-associate at the last ulp — the documented ≤8-ulp
    allowance)."""
    for fam, entry in registry_report["families"].items():
        if "@" in fam or not entry["engine_eligible"]:
            continue
        ev = entry["distributed"]
        assert ev["on_grid"], f"{fam}: grid probe rejected, fell back to raw args"
        if fam not in ULP_FAMILIES:
            assert ev["bit_identical"], (fam, ev)
            assert ev["max_state_err"] == 0.0, (fam, ev)


def test_registry_topology_equivalence_proved(registry_report):
    """Every engine-eligible family's two-level (2-slice) hierarchical
    merge is proven against the flat path on the same per-replica states —
    bit-identical on the exact tier, with zero findings registry-wide."""
    checked = 0
    for fam, entry in registry_report["families"].items():
        if "@" in fam or not entry["engine_eligible"]:
            continue
        topo = entry["distributed"].get("topology")
        assert topo is not None, f"{fam}: topology equivalence never probed"
        assert topo["replicas"] == 4 and topo["num_slices"] == 2, (fam, topo)
        if fam not in ULP_FAMILIES:
            assert topo["bit_identical"], (fam, topo)
            assert topo["max_state_err"] == 0.0, (fam, topo)
        checked += 1
    assert checked >= 15


def test_quantized_variant_topology_within_per_level_bounds(registry_report):
    """Quantized variants carry the topology leg too: the hierarchical
    merge (exact level 0, registered tier at level 1) stays within the
    SUMMED per-level documented bounds of the flat merge."""
    for fam, entry in registry_report["families"].items():
        if "@" not in fam or fam.split("@")[1] == "cohort":
            continue
        topo = entry["distributed"].get("topology")
        assert topo is not None, fam
        assert entry["findings"] == [], (fam, entry["findings"])
        # the leg genuinely exercised the lossy path: bit-identity is off
        assert not topo["bit_identical"], (fam, topo)


def test_quantized_variants_audited_and_within_bounds(registry_report):
    """The sync_precision=int8/bf16 variants of eligible families are
    audited as separate programs (engine signatures key on the precision
    map) and their R-replica equivalence holds within the documented
    tier bounds — quantizing through the real codec."""
    variants = {
        f: e for f, e in registry_report["families"].items() if "@" in f and f.split("@")[1] != "cohort"
    }
    assert len(variants) >= 20  # both tiers across the eligible families
    assert {f.split("@")[1] for f in variants} == {"int8", "bf16"}
    for fam, entry in variants.items():
        assert entry["findings"] == [], (fam, entry["findings"])
        ev = entry["distributed"]
        assert ev is not None and ev["quantized_states"], fam
        assert ev["replicas"] == [1, 2, 4], (fam, ev)
    # the binned histogram tier sits far inside its documented 1e-3 value bound
    assert variants["BinnedAUROC@int8"]["distributed"]["max_value_err"] <= 1e-3


def test_engine_step_program_has_no_donated_passthrough(registry_report):
    """The real engine merge gives every state a fresh buffer — pinned so
    a later 'optimization' that passes an input buffer through gets
    caught by the gate."""
    for fam, entry in registry_report["families"].items():
        assert not any(f["rule"] == "MTA007" for f in entry["findings"] + entry["suppressed"]), fam


def test_registry_report_carries_fingerprints(registry_report):
    prints = registry_report["fingerprints"]
    base = {f for f in registry_report["families"] if "@" not in f}
    cohort = {f for f in registry_report["families"] if f.endswith("@cohort")}
    assert set(prints) == base | cohort
    mse = prints["MeanSquaredError"]
    assert mse["update"] and mse["step"]
    # eager-only families have no step program to digest
    assert prints["AUROC"]["step"] is None
    # the cohort variant digests the VMAPPED step — a different program
    assert prints["MeanSquaredError@cohort"]["cohort_step"]
    assert prints["MeanSquaredError@cohort"]["cohort_step"] != mse["step"]


def test_registry_fingerprints_repeat_in_a_second_audit(registry_report):
    """The same family audited again digests to the report's fingerprints."""
    cases = {name: (factory, args) for name, factory, args in registry_cases(CPU)}
    for name in ("MeanSquaredError", "Precision", "BinnedAUROC", "AUROC"):
        factory, args = cases[name]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            again = audit_metric(factory(), args, fingerprint=True).fingerprints
        assert again == registry_report["fingerprints"][name], name


def test_cuda_without_a_card_raises():
    """The registry audit runs on the card unless the caller asks for the
    CPU: asking for the card on a machine without one raises before
    anything is built."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card tests cover device='cuda'")
    for device in ("cuda", None):
        with pytest.raises(RuntimeError, match="none is available"):
            audit_registry(device=device)
        with pytest.raises(RuntimeError, match="none is available"):
            registry_cases(device)


# ---------------------------------------------------------------------------
# the metric fixtures against their JAX twins
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_findings_equal_jax(name):
    import jax.numpy as jnp

    from metrics_tpu.analysis import audit_metric as jax_audit_metric
    from metrics_tpu.analysis import fixtures as jfx

    x = np.linspace(0.0, 1.0, 8).astype(np.float32)
    ref = jax_audit_metric(getattr(jfx, name)(), (jnp.asarray(x),))
    port = audit_metric(getattr(fx, name)(device=CPU), (torch.as_tensor(x),))

    def key(result):
        return {(f.rule, f.subject, f.suppressed) for f in result.findings + result.suppressed if f.rule in COMPARED}

    assert key(port) == key(ref)
    assert key(port)  # every fixture trips its rule
    assert port.engine_eligible == ref.engine_eligible


# ---------------------------------------------------------------------------
# probes, merged states and abstract steps against the JAX package's
# ---------------------------------------------------------------------------
def _jax_cases():
    from metrics_tpu.analysis.program import registry_cases as jax_registry_cases

    return {name: (factory, args) for name, factory, args in jax_registry_cases()}


def _port_cases():
    return {name: (factory, args) for name, factory, args in registry_cases(CPU)}


def test_grid_probe_args_equal_jax():
    from metrics_tpu.analysis import distributed as jdist

    ref, port = _jax_cases(), _port_cases()
    for name in ("Accuracy", "BinnedAUROC", "MeanSquaredError", "Hinge", "AUC", "RetrievalMAP"):
        for a, b in zip(jdist.grid_probe_args(ref[name][1]), dist.grid_probe_args(port[name][1])):
            a, b = np.asarray(a), b.numpy()
            # the float leaves are the JAX package's bits; integer leaves pass
            # through (int32 there, with x64 off; int64 here)
            assert np.array_equal(a, b) and (a.dtype == b.dtype or a.dtype.kind == b.dtype.kind == "i"), name


def _pick(tree):
    return {k: np.asarray(v, dtype=np.float64) if not hasattr(v, "numpy") else v.numpy().astype(np.float64)
            for k, v in tree.items()}


@pytest.mark.parametrize("tier", ["exact", "int8", "bf16"])
@pytest.mark.parametrize("name", ["Accuracy", "StatScores", "ConfusionMatrix", "BinnedAUROC", "MeanSquaredError",
                                  "R2Score", "Hinge"])
def test_merged_replica_states_equal_jax(name, tier):
    """Per-replica updates merged by each package's composite, at R ∈ {1, 2,
    4}: bit-equal on the exact tier, within the stated bound on int8 and
    bf16."""
    from metrics_tpu.analysis import distributed as jdist

    (jfactory, jargs), (factory, args) = _jax_cases()[name], _port_cases()[name]
    ref, port = jfactory(), factory()
    if tier != "exact":
        if not ref.set_sync_precision(tier):
            pytest.skip(f"{name} has no state the {tier} tier takes")
        assert port.set_sync_precision(tier)
    jprobe, probe = jdist.grid_probe_args(jargs), dist.grid_probe_args(args)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for replicas in (1, 2, 4):
            jshards, shards = jdist._shard_args(jprobe, {}, replicas), dist._shard_args(probe, {}, replicas)
            jmerged, _ = jdist._merge_replica_states(ref, [jdist._states_after_update(ref, a, k) for a, k in jshards])
            merged, tols = dist._merge_replica_states(port, [dist._states_after_update(port, a, k) for a, k in shards])
            jm, pm = _pick(jmerged), _pick(merged)
            assert sorted(jm) == sorted(pm)
            for s in jm:
                if tols.get(s, 0.0) == 0.0:
                    assert np.array_equal(jm[s], pm[s]), (name, tier, replicas, s)
                else:
                    assert np.abs(jm[s] - pm[s]).max() <= tols[s], (name, tier, replicas, s)


@pytest.mark.parametrize("name", ["MeanSquaredError", "Accuracy", "BinnedAUROC"])
def test_abstract_step_shapes_equal_jax(name):
    import metrics_tpu as J

    (jfactory, jargs), (factory, args) = _jax_cases()[name], _port_cases()[name]
    _, jshapes, jn = J.CompiledStepEngine(jfactory()).abstract_step(*jargs)
    _, shapes, n = M.CompiledStepEngine(factory()).abstract_step(*args)
    _, jcohort, _ = J.CompiledStepEngine(jfactory()).abstract_cohort_step(*jargs, capacity=4)
    _, cohort, _ = M.CompiledStepEngine(factory()).abstract_cohort_step(*args, capacity=4)
    assert n == jn
    for want, got in ((jshapes[0]["metric"], shapes[0]["metric"]), (jcohort[0]["metric"], cohort[0]["metric"])):
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} == {
            k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in got.items()
        }
