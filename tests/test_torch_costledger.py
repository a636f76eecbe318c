"""The port's compiled-program cost ledger against the JAX package's, on the CPU.

Every case of ``tests/bases/test_costledger.py`` is mirrored on
``metrics_tpu_torch.observability.costledger`` under the same name: the
``engine.compile.*`` counters, the ``engine.compile_ms`` histogram and the
``engine.programs.*`` gauges ride the telemetry switch; the armed ledger
keeps one entry per program; the exposition renders one family set per
program; flight dumps carry the ledger; and nothing of it perturbs a
result. Two differences are by design (ROADMAP Queue 3 item 4): an entry's
key is a digest of the program's definition and call shapes, not a jaxpr
fingerprint, and ``flops`` / ``bytes_accessed`` are None (there is no XLA
cost model), as JAX records them when its analysis fails. Parity cases run
the same sequences of signatures through both packages and compare the
cold and warm counts, the entries' shapes and the gauges exactly.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.observability as jobs
import metrics_tpu_torch as tm
import metrics_tpu_torch.observability as obs
from metrics_tpu.engine import CompiledStepEngine as JaxCompiledStepEngine
from metrics_tpu.observability import costledger as jcl
from metrics_tpu_torch.engine import CompiledStepEngine
from metrics_tpu_torch.observability import costledger as cl

CPU = "cpu"


@pytest.fixture(autouse=True)
def _pristine():
    def reset():
        for pkg, ledger in ((obs, cl), (jobs, jcl)):
            pkg.disable()
            pkg.get().reset()
            ledger.disable_cost_ledger()
            ledger.get_ledger().reset()

    reset()
    yield
    reset()


def _np_batch(rows=32, seed=0):
    rng = np.random.RandomState(seed)
    p = rng.rand(rows, 4).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    return p, rng.randint(4, size=rows)


def _batch(rows=32, seed=0):
    return tuple(torch.from_numpy(a) for a in _np_batch(rows, seed))


# ----------------------------------------------------------------------
# 1. the cheap tier: counters/histogram/gauges with telemetry alone
# ----------------------------------------------------------------------
def test_cold_compiles_count_and_fill_the_compile_histogram():
    with obs.telemetry_scope() as tel:
        col = tm.MetricCollection([tm.Accuracy(device=CPU)], compiled=True)
        p, t = _batch()
        col(p, t)  # one new signature: cold
        col(p, t)  # cache hit: no build at all
        assert tel.counters.get("engine.compile.cold") == 1
        assert "engine.compile.warm" not in tel.counters
        assert tel.snapshot()["histograms"]["engine.compile_ms"]["count"] == 1
        assert tel.gauges["engine.programs.cold"] == 1
        assert tel.gauges["engine.programs.warm"] == 0


def test_lru_thrash_recompiles_classify_warm():
    """cache_size=1 and two alternating signatures: the third step rebuilds
    a signature this engine built before, a warm build."""
    engine = CompiledStepEngine(tm.Accuracy(device=CPU), cache_size=1)
    a = _batch(rows=16, seed=1)
    b = _batch(rows=24, seed=2)
    with obs.telemetry_scope() as tel:
        engine.step(*a)  # cold
        engine.step(*b)  # cold (evicts a)
        engine.step(*a)  # warm: seen before, evicted since
        assert tel.counters["engine.compile.cold"] == 2
        assert tel.counters["engine.compile.warm"] == 1
        assert tel.gauges["engine.programs.warm"] == 1
        assert tel.snapshot()["histograms"]["engine.compile_ms"]["count"] == 3


def test_disarmed_ledger_records_no_entries_and_disabled_telemetry_nothing():
    col = tm.MetricCollection([tm.Accuracy(device=CPU)], compiled=True)
    p, t = _batch(seed=3)
    col(p, t)
    assert obs.get().counters == {}
    assert cl.get_ledger().entries() == []


# ----------------------------------------------------------------------
# 2. the armed ledger
# ----------------------------------------------------------------------
def test_armed_ledger_records_fingerprint_wall_time_and_cost():
    with obs.cost_ledger_scope() as ledger:
        col = tm.MetricCollection([tm.Accuracy(device=CPU)], compiled=True)
        p, t = _batch(seed=4)
        col(p, t)
        col(p, t)  # cache hit: no new entry
        entries = ledger.entries()
        assert len(entries) == 1
        (e,) = entries
        assert e["kind"] == "step" and e["compiles"] == 1 and e["cold_compiles"] == 1
        assert e["engine"] == "engine[Accuracy]"
        # a 16-hex digest, as JAX's fingerprint_jaxpr gives
        assert len(e["fingerprint"]) == 16
        int(e["fingerprint"], 16)
        assert e["last_compile_ms"] > 0
        # no cost model on the port: None, as JAX records a failed analysis
        assert e["flops"] is None and e["bytes_accessed"] is None
        assert e["signatures"] == 1


def test_same_program_from_two_engines_folds_into_one_entry():
    with obs.cost_ledger_scope() as ledger:
        p, t = _batch(seed=5)
        tm.MetricCollection([tm.Accuracy(device=CPU)], compiled=True)(p, t)
        tm.MetricCollection([tm.Accuracy(device=CPU)], compiled=True)(p, t)
        entries = ledger.entries()
        assert len(entries) == 1  # one definition and call => one entry
        assert entries[0]["compiles"] == 2
        # cold both times: each engine's signature set is new
        assert entries[0]["cold_compiles"] == 2


def test_cohort_programs_enter_the_ledger_as_cohort_kind():
    with obs.cost_ledger_scope() as ledger:
        cohort = tm.MetricCohort(tm.MeanSquaredError(device=CPU), tenants=2)
        x = torch.from_numpy(np.random.RandomState(6).rand(2, 16).astype(np.float32))
        cohort(x, x)
        (e,) = ledger.entries()
        assert e["kind"] == "cohort_step"
        assert e["engine"].endswith("@cohort")


def test_report_and_json_shapes():
    with obs.cost_ledger_scope() as ledger:
        p, t = _batch(seed=7)
        tm.MetricCollection([tm.Accuracy(device=CPU)], compiled=True)(p, t)
        text = ledger.report()
        assert "cost ledger" in text and "engine[Accuracy]" in text
        snap = json.loads(ledger.to_json())
        assert snap["format"] == "metrics_tpu.cost_ledger"
        assert snap["programs"] == 1 and snap["cold_compiles"] == 1
    # empty + disarmed report stays valid
    cl.get_ledger().reset()
    assert "no compiles recorded" in cl.get_ledger().report()


def test_exposition_renders_per_program_families_when_entries_exist():
    with obs.telemetry_scope(), cl.cost_ledger_scope():
        p, t = _batch(seed=8)
        tm.MetricCollection([tm.Accuracy(device=CPU)], compiled=True)(p, t)
        text = obs.render_exposition()
        assert "metrics_tpu_engine_program_compiles" in text
        assert "metrics_tpu_engine_program_cold_compiles" in text
        assert "metrics_tpu_engine_program_compile_ms" in text
        # no cost model: the flops / bytes families render only for an
        # entry that has them (JAX's analysis resolves on its CPU backend)
        assert "metrics_tpu_engine_program_flops" not in text
        obs.parse_prometheus_text(text)  # structurally valid
    # no entries -> no per-program families (the registry's
    # engine.programs.* gauges are separate and may remain)
    cl.get_ledger().reset()
    assert "metrics_tpu_engine_program_compiles" not in obs.render_exposition()


def test_flight_dumps_attach_the_ledger_when_armed(tmp_path):
    with obs.flight_scope(tmp_path / "dumps") as rec:
        with cl.cost_ledger_scope():
            p, t = _batch(seed=9)
            tm.MetricCollection([tm.Accuracy(device=CPU)], compiled=True)(p, t)
            path = rec.dump("drill")
            with open(path) as f:
                dump = json.load(f)
            assert dump["cost_ledger"], "armed ledger must ride the dump"
            (row,) = dump["cost_ledger"].values()
            assert row["engine"] == "engine[Accuracy]" and row["compiles"] == 1
        # disarmed: the field stays present (schema) but null
        path = rec.dump("drill-off")
        with open(path) as f:
            assert json.load(f)["cost_ledger"] is None


def test_ledger_never_perturbs_results_or_program_identity():
    """Bit-identical results, the same signature count and builds with the
    ledger armed."""
    p, t = _batch(seed=10)
    plain = tm.MetricCollection([tm.Accuracy(device=CPU)], compiled=True)
    v_plain = plain(p, t)["Accuracy"]
    info_plain = plain._engine.cache_info()

    with cl.cost_ledger_scope():
        armed = tm.MetricCollection([tm.Accuracy(device=CPU)], compiled=True)
        v_armed = armed(p, t)["Accuracy"]
        info_armed = armed._engine.cache_info()
    assert torch.equal(v_plain, v_armed)
    assert info_plain["compiled_signatures"] == info_armed["compiled_signatures"]
    assert info_plain["trace_count"] == info_armed["trace_count"]


# ----------------------------------------------------------------------
# 3. the port's own: what the digest keys on
# ----------------------------------------------------------------------
def test_entry_key_follows_the_definition_and_the_call_not_the_engine():
    """Another configuration or another batch shape is another program;
    the same ones through a single-metric engine and a cohort are not the
    same kind; a recording failure degrades to an ``unanalyzable:`` key."""
    with obs.cost_ledger_scope() as ledger:
        p, t = _batch(rows=32, seed=11)
        for average in ("macro", "micro", "macro"):
            tm.MetricCollection([tm.Precision(num_classes=4, average=average, device=CPU)], compiled=True)(p, t)
        keys = {e["fingerprint"]: e["compiles"] for e in ledger.entries()}
        assert sorted(keys.values()) == [1, 2]
        tm.MetricCollection([tm.Precision(num_classes=4, average="macro", device=CPU)], compiled=True)(*_batch(24))
        assert len(ledger.entries()) == 3
        key = ledger.record("engine[x]", "step", ("sig",), 0.001, True, lambda: 1 / 0, ())
        assert key == "unanalyzable:ZeroDivisionError"
        assert ledger.record("engine[x]", "step", ("sig",), 0.001, False, lambda: {}, None) == (
            "unanalyzable:ValueError")


def test_shape_tree_keeps_structure_and_drops_data():
    tree = {"s": {"a": torch.zeros(3, 2, dtype=torch.int32)}, "args": (torch.ones(5), 7, "x"), "k": [None]}
    spec = cl.shape_tree(tree)
    assert spec == {"s": {"a": cl.TensorSpec((3, 2), torch.int32)},
                    "args": (cl.TensorSpec((5,), torch.float32), 7, "x"), "k": [None]}
    assert cl.fingerprint("d", spec) == cl.fingerprint("d", cl.shape_tree(tree))
    assert cl.fingerprint("d", spec) != cl.fingerprint("d", cl.shape_tree({**tree, "k": [1]}))


# ----------------------------------------------------------------------
# 4. parity: the same signatures through both packages
# ----------------------------------------------------------------------
def _entry_shapes(ledger):
    return sorted((e["engine"], e["kind"], e["compiles"], e["cold_compiles"], e["warm_compiles"], e["signatures"])
                  for e in ledger.entries())


@pytest.mark.parametrize("cache_size", [1, 2, 16])
def test_same_signature_sequence_gives_jax_cold_and_warm_counts(cache_size):
    """An engine of each package fed the same row counts (LRU thrash at
    small caches): equal cold / warm counters, gauges, histogram counts and
    ledger entries (by engine, kind, builds, cold, warm, signatures)."""
    rows = (16, 24, 16, 32, 24, 16, 48, 32)
    batches = [_np_batch(r, seed=i) for i, r in enumerate(rows)]
    out = []
    for pkg, o, ledger_mod, engine_cls, conv, kw in (
        (jm, jobs, jcl, JaxCompiledStepEngine, jnp.asarray, {}),
        (tm, obs, cl, CompiledStepEngine, torch.from_numpy, {"device": CPU}),
    ):
        with o.telemetry_scope() as tel, ledger_mod.cost_ledger_scope() as ledger:
            engine = engine_cls({"acc": pkg.Accuracy(**kw), "f1": pkg.F1(num_classes=4, average="macro", **kw)},
                                cache_size=cache_size)
            for p, t in batches:
                engine.step(conv(p), conv(t))
            snap = tel.snapshot()
            out.append({
                "counters": {k: v for k, v in snap["counters"].items() if k.startswith("engine.compile")},
                "gauges": {k: v for k, v in snap["gauges"].items() if k.startswith("engine.programs")},
                "builds": snap["histograms"]["engine.compile_ms"]["count"],
                "entries": _entry_shapes(ledger),
                "ledger": {k: v for k, v in ledger.snapshot().items() if k != "entries"},
            })
    jax_side, port_side = out
    assert port_side == jax_side
    assert port_side["counters"]["engine.compile.cold"] == len(set(rows))


def test_cohort_signature_sequence_gives_jax_counts():
    """A cohort growing across capacity buckets with health on: each bucket
    is a cold cohort build in both packages, the same entries."""
    rng = np.random.RandomState(12)
    out = []
    for pkg, o, ledger_mod, conv, kw in ((jm, jobs, jcl, jnp.asarray, {}), (tm, obs, cl, torch.from_numpy,
                                                                            {"device": CPU})):
        with o.telemetry_scope() as tel, ledger_mod.cost_ledger_scope() as ledger:
            cohort = pkg.MetricCohort(pkg.MeanSquaredError(**kw), tenants=2)
            for tenants in (2, 2, 3, 5, 5):
                while len(cohort) < tenants:
                    cohort.add_tenant()
                x = rng.rand(tenants, 8).astype(np.float32)
                cohort(conv(x), conv(x))
            snap = tel.snapshot()
            out.append(({k: v for k, v in snap["counters"].items() if k.startswith("engine.compile")},
                        _entry_shapes(ledger)))
    assert out[1] == out[0]
    assert out[1][0] == {"engine.compile.cold": 3}
