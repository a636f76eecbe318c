"""The port's multi-tenant cohort against the JAX package's, on the CPU.

The cases of ``tests/bases/test_cohort.py`` and
``tests/bases/test_cohort_health.py`` are mirrored. The same seeded numpy
inputs go through the JAX package's ``MetricCohort``, the port's
``MetricCohort`` (on the CPU the engine runs its vmapped step function
directly: the plain version of the card's CUDA graph) and the port's own
independent collections:

* the port's cohort is bit-identical to independent collections, step
  values and states, over six families (classification, confusion matrix,
  binned AUROC, Hamming distance, hinge, the regression pack), and agrees
  with JAX's cohort; add/remove mid-stream; the slot table without
  persistent states; nested inputs in partial buckets; the ``state_dict``
  capacity resize; the capacity buckets and the ramp's builds; steady state
  with a single build; ``route_rows``; ineligible members; input-shape
  validation; ``as_cohort``; ``from_collections`` and unstacking; a
  single-metric template; ``reset`` keeping membership; exact sync across
  gloo worlds of 2 and 4;
* health: off bit-identical; the toggle a cache entry, not a rebuild; the
  rows / updates / last-step accounting; a new tenant starting fresh; slot
  reuse; capacity growth; nonfinite counts per slot; reserved names; health
  tensors that are never the engine's; a restore starting a fresh window;
* the count primitives' batching rule: one ``index_add`` for every tenant
  (the profile of a vmapped classification step counts as many at
  capacity 2 as at 1,024), and counts equal to the per-tenant counts;
* a JAX cohort's ``state_dict()`` loaded through ``state_from_jax``.

Tolerances: float inputs are grid-valued (multiples of 1/256, as the JAX
test bed makes them), so every float sum is exact in any order: against the
port's own collections states and values are bit-equal, except the
regression values, within JAX's 8-ulp allowance (chains of products of
exact sums); against JAX's cohort counts are exact and floats within 1e-5
(float32 formulas of the two packages, as in the earlier slices).

The JAX cases that wait for the ports they need: the envelope round trip
and the guard rollback (``reliability/``), the 64-tenant scrape (the
exporter), the trace merges and the sync spans (the observability core).
The int8 sync case came with the sync tiers and is in
``tests/test_torch_sync_precision.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import metrics_tpu as jm
import metrics_tpu_torch as tm
from metrics_tpu.cohort import bucket_capacity as jax_bucket_capacity
from metrics_tpu.cohort import route_rows as jax_route_rows
from metrics_tpu_torch.cohort import bucket_capacity, route_rows
from metrics_tpu_torch.interop import state_from_jax
from metrics_tpu_torch.ops.histogram import label_bincount, score_histograms
from tests.torch_workers import cohort_sync_world, run_world

CPU = "cpu"
C = 4
JAX_TOL = 1e-5
# the regression values' allowance (tests/bases/test_cohort.py:143)
VALUE_ULPS = {"regression": 8}


def _grid(rng, shape, lo=0, hi=256):
    return (rng.randint(lo, hi, size=shape) / 256.0).astype(np.float32)


def _cls_batches(n, b, seed=0):
    # probability rows are integer multinomials / 256: they sum to exactly 1
    rng = np.random.RandomState(seed)
    probs = (rng.multinomial(256, [1.0 / C] * C, size=(n, b)) / 256.0).astype(np.float32)
    return probs, rng.randint(C, size=(n, b))


def _bin_batches(n, b, seed=0):
    rng = np.random.RandomState(seed)
    return _grid(rng, (n, b)), rng.randint(2, size=(n, b))


def _reg_batches(n, b, seed=0):
    rng = np.random.RandomState(seed)
    return _grid(rng, (n, b)), _grid(rng, (n, b))


def _hinge_batches(n, b, seed=0):
    rng = np.random.RandomState(seed)
    return _grid(rng, (n, b), lo=-512, hi=512), rng.randint(2, size=(n, b))


def _kw(pkg):
    return {"device": CPU} if pkg is tm else {}


def _classification(pkg):
    kw = _kw(pkg)
    return pkg.MetricCollection([pkg.Accuracy(**kw), pkg.Precision(num_classes=C, average="macro", **kw),
                                 pkg.Recall(num_classes=C, average="macro", **kw),
                                 pkg.F1(num_classes=C, average="macro", **kw)])


def _regression(pkg):
    kw = _kw(pkg)
    return pkg.MetricCollection([pkg.MeanSquaredError(**kw), pkg.MeanAbsoluteError(**kw), pkg.R2Score(**kw),
                                 pkg.PSNR(**kw), pkg.ExplainedVariance(**kw)])


FAMILIES = {
    "classification": (_classification, _cls_batches),
    "confusion-matrix": (lambda pkg: pkg.MetricCollection([pkg.ConfusionMatrix(num_classes=C, **_kw(pkg))]),
                         _cls_batches),
    "binned-auroc": (lambda pkg: pkg.MetricCollection([pkg.BinnedAUROC(num_bins=16, **_kw(pkg))]), _bin_batches),
    "hamming": (lambda pkg: pkg.MetricCollection([pkg.HammingDistance(**_kw(pkg))]), _bin_batches),
    "hinge": (lambda pkg: pkg.MetricCollection([pkg.Hinge(**_kw(pkg))]), _hinge_batches),
    "regression": (_regression, _reg_batches),
}


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(got, want, msg="", ulps=0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, f"{msg}: shape {got.shape} vs {want.shape}"
    if ulps and np.issubdtype(got.dtype, np.floating):
        tol = ulps * np.spacing(np.maximum(np.abs(got), np.abs(want)).astype(got.dtype))
        assert np.all(np.abs(got.astype(np.float64) - want.astype(np.float64)) <= tol), f"{msg}: {got} vs {want}"
    else:
        np.testing.assert_array_equal(got, want, err_msg=msg)


def _near_jax(got, want, msg=""):
    got, want = _np(got), np.asarray(want)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=JAX_TOL, atol=JAX_TOL, err_msg=msg)
    else:
        np.testing.assert_array_equal(got, want, err_msg=msg)


def _assert_parity(cohort, independents, step_values=None, ulps=0):
    """The cohort's states bit-identical to the independent collections
    (``independents[i]`` is the i-th live tenant's), its ``compute()`` and
    step values bit-identical up to ``ulps``."""
    comp = cohort.compute()
    slots = cohort.tenant_ids()
    assert len(slots) == len(independents)
    for i, col in enumerate(independents):
        ref = col.compute()
        for key in ref:
            _equal(comp[key][i], ref[key], f"compute: tenant {i}, {key}", ulps)
        for key, m in col.items():
            for sname in m._defaults:
                _equal(cohort._states[key][sname][slots[i]], getattr(m, sname),
                       f"state: tenant {i} (slot {slots[i]}), {key}.{sname}")
    if step_values is not None:
        values, refs = step_values
        for i, ref in enumerate(refs):
            for key in ref:
                _equal(values[key][i], ref[key], f"step value: tenant {i}, {key}", ulps)


def _assert_matches_jax(port, jax_cohort):
    """States and ``compute()`` of the port's cohort against JAX's."""
    for key, states in jax_cohort._states.items():
        for sname, v in states.items():
            _near_jax(port._states[key][sname], v, f"state {key}.{sname}")
    got, want = port.compute(), jax_cohort.compute()
    for key in want:
        _near_jax(got[key], want[key], f"compute {key}")


# ---- bit identity, membership, checkpoints ---------------------------------------


@pytest.mark.parametrize("family", list(FAMILIES))
def test_cohort_bit_identical_to_independent_collections_and_to_jax(family):
    template, batches = FAMILIES[family]
    n, b = 3, 32
    ulps = VALUE_ULPS.get(family, 0)
    cohort = tm.MetricCohort(template(tm), tenants=n)
    jax_cohort = jm.MetricCohort(template(jm), tenants=n)
    independents = [template(tm) for _ in range(n)]
    for step in range(3):
        p, t = batches(n, b, seed=step)
        values = cohort(*_t(p, t))
        jax_values = jax_cohort(*_j(p, t))
        refs = [col(*_t(p[i], t[i])) for i, col in enumerate(independents)]
        _assert_parity(cohort, independents, step_values=(values, refs), ulps=ulps)
        for key in jax_values:
            _near_jax(values[key], jax_values[key], f"step {step} value {key}")
    _assert_matches_jax(cohort, jax_cohort)
    assert cohort.cache_info()["trace_count"] == 1


@pytest.mark.parametrize("family", ["classification", "regression"])
def test_cohort_add_remove_mid_stream(family):
    template, batches = FAMILIES[family]
    ulps = VALUE_ULPS.get(family, 0)
    cohort = tm.MetricCohort(template(tm), tenants=2)
    jax_cohort = jm.MetricCohort(template(jm), tenants=2)
    independents = [template(tm) for _ in range(2)]

    def step(n, seed):
        p, t = batches(n, 32, seed=seed)
        cohort(*_t(p, t))
        jax_cohort(*_j(p, t))
        for i, col in enumerate(independents):
            col(*_t(p[i], t[i]))

    step(2, 0)
    # a third tenant mid-stream grows capacity 2 -> 4
    cohort.add_tenant()
    jax_cohort.add_tenant()
    independents.append(template(tm))
    step(3, 1)
    _assert_parity(cohort, independents, ulps=ulps)
    # evict the middle tenant: survivors keep accumulating, slot order holds
    evicted = cohort.remove_tenant(1, return_state=True)
    jax_cohort.remove_tenant(1)
    ref_evicted = independents.pop(1)
    for key in ref_evicted.keys():
        _equal(evicted[key].compute(), ref_evicted[key].compute(), f"evicted tenant {key}")
    assert cohort.tenant_ids() == (0, 2) == jax_cohort.tenant_ids()
    step(2, 2)
    _assert_parity(cohort, independents, ulps=ulps)
    # slot reuse: a re-admitted tenant starts from the defaults
    assert cohort.add_tenant() == 1 == jax_cohort.add_tenant()
    independents.insert(1, template(tm))
    step(3, 3)
    _assert_parity(cohort, independents, ulps=ulps)
    _assert_matches_jax(cohort, jax_cohort)


def test_cohort_slot_table_round_trips_without_persistent_states():
    cohort = tm.MetricCohort(tm.MetricCollection([tm.MeanSquaredError(device=CPU)]), tenants=3)
    cohort.remove_tenant(1)
    sd = cohort.state_dict()
    assert set(sd) == {"__cohort_slots__"} and sd["__cohort_slots__"].dtype == torch.int8
    fresh = tm.MetricCohort(tm.MetricCollection([tm.MeanSquaredError(device=CPU)]), tenants=3)
    fresh.load_state_dict(sd)
    assert fresh.tenant_ids() == (0, 2)


def test_cohort_routes_nested_inputs_in_partial_buckets():
    # 3 live tenants in a capacity-4 bucket: nested tensor leaves are padded
    # as top-level ones are (the vmap in_dims reach them)
    class DictUpdate(tm.MeanSquaredError):
        def update(self, batch):
            super().update(batch["p"], batch["t"])

    cohort = tm.MetricCohort(DictUpdate(device=CPU), tenants=3)
    p, t = _t(*_reg_batches(3, 8, seed=0))
    values = cohort({"p": p, "t": t})
    assert values.shape == (3,) and cohort.capacity == 4
    oracle = [DictUpdate(device=CPU) for _ in range(3)]
    for i, m in enumerate(oracle):
        m({"p": p[i], "t": t[i]})
    _equal(cohort.compute(), torch.stack([m.compute() for m in oracle]), "nested inputs")


def test_cohort_state_dict_capacity_resize():
    small = tm.MetricCohort(tm.MetricCollection([tm.MeanSquaredError(device=CPU)]), tenants=2)
    small(*_t(*_reg_batches(2, 16, seed=0)))
    grown = tm.MetricCohort(tm.MetricCollection([tm.MeanSquaredError(device=CPU)]), tenants=5)
    grown.load_state_dict(dict(small._named_states()))
    assert grown.capacity == small.capacity == 2 and len(grown) == 2
    _equal(grown.compute()["MeanSquaredError"], small.compute()["MeanSquaredError"], "resized")


def test_bucket_capacity_bounds_ramp_builds():
    buckets = {bucket_capacity(n) for n in range(1, 10_001)}
    assert len(buckets) <= 14 and max(buckets) == 16_384
    for n in range(0, 300):
        cap = bucket_capacity(n)
        assert cap >= n and (cap & (cap - 1)) == 0 and cap == jax_bucket_capacity(n)
    with pytest.raises(ValueError, match="tenant count must be >= 0"):
        bucket_capacity(-1)


def test_cohort_ramp_builds_once_per_bucket():
    cohort = tm.MetricCohort(tm.MetricCollection([tm.Accuracy(device=CPU)]), tenants=1)
    n = 1
    while n <= 70:
        cohort(*_t(*_cls_batches(n, 8, seed=n)))
        for _ in range(min(9, 71 - n)):
            cohort.add_tenant()
            n += 1
    # buckets crossed: 2, 4, 8, 16, 32, 64, 128
    assert cohort.cache_info()["trace_count"] <= 7 and len(cohort) == 71


def test_cohort_steady_state_single_build():
    cohort = tm.MetricCohort(tm.MetricCollection([tm.MeanSquaredError(device=CPU)]), tenants=4)
    for step in range(5):
        cohort(*_t(*_reg_batches(4, 16, seed=step)))
    info = cohort.cache_info()
    assert info["trace_count"] == 1 and info["compiled_signatures"] == 1


def test_route_rows_groups_tagged_stream():
    rng = np.random.RandomState(3)
    ids = np.repeat(np.arange(3), 4)[rng.permutation(12)]
    rows = np.arange(12, dtype=np.float32) * 10
    routed = route_rows(torch.from_numpy(ids), torch.from_numpy(rows), num_tenants=3)
    assert routed.shape == (3, 4)
    for tenant in range(3):
        np.testing.assert_array_equal(np.sort(routed[tenant].numpy()), np.sort(rows[ids == tenant]))
    # arrival order kept within a tenant (stable sort), as JAX's
    np.testing.assert_array_equal(routed[0].numpy(), rows[np.flatnonzero(ids == 0)])
    np.testing.assert_array_equal(routed.numpy(), np.asarray(jax_route_rows(jnp.asarray(ids), jnp.asarray(rows),
                                                                            num_tenants=3)))
    with pytest.raises(ValueError, match="!= uniform"):
        route_rows(torch.tensor([0, 0, 1, 0]), torch.zeros(4), num_tenants=2)
    with pytest.raises(ValueError, match="do not split evenly"):
        route_rows(torch.tensor([0, 0, 1]), torch.zeros(3), num_tenants=2)


def test_route_rows_feeds_cohort_identically():
    n, b = 3, 8
    p, t = _cls_batches(n, b, seed=5)
    ids = torch.from_numpy(np.repeat(np.arange(n), b))
    rp, rt = route_rows(ids, *_t(p.reshape(n * b, C), t.reshape(n * b)), num_tenants=n)
    direct = tm.MetricCohort(tm.MetricCollection([tm.Accuracy(device=CPU)]), tenants=n)
    routed = tm.MetricCohort(tm.MetricCollection([tm.Accuracy(device=CPU)]), tenants=n)
    direct(*_t(p, t))
    routed(rp, rt)
    _equal(routed.compute()["Accuracy"], direct.compute()["Accuracy"], "routed")


def test_route_rows_skips_the_count_check_while_the_engine_builds():
    from metrics_tpu_torch.utilities.data import tracing

    with tracing():  # unequal rows per tenant: not checked, as under JAX's jit
        routed = route_rows(torch.tensor([0, 0, 0, 1]), torch.arange(4.0), num_tenants=2)
    assert routed.shape == (2, 2)


def test_cohort_rejects_engine_ineligible_members():
    with pytest.raises(ValueError, match="engine-eligible") as err:
        tm.MetricCohort(tm.MetricCollection([tm.AUROC(device=CPU)]), tenants=2)
    # the engine's own reason, as JAX's cohort names it
    assert "does not opt into fused one-update forward" in str(err.value)
    with pytest.raises(ValueError, match="engine-eligible"):
        jm.MetricCohort(jm.MetricCollection([jm.AUROC()]), tenants=2)


def test_cohort_input_shape_validation():
    cohort = tm.MetricCohort(tm.MetricCollection([tm.MeanSquaredError(device=CPU)]), tenants=3)
    with pytest.raises(ValueError, match="leading dim"):
        cohort(torch.zeros(5, 8), torch.zeros(5, 8))
    with pytest.raises(ValueError, match="tenants must be >= 1"):
        tm.MetricCohort(tm.MeanSquaredError(device=CPU), tenants=0)


def test_as_cohort_adopts_collection_state():
    col = tm.MetricCollection([tm.MeanSquaredError(device=CPU)])
    p, t = _t(*_reg_batches(1, 16, seed=0))
    col(p[0], t[0])
    cohort = col.as_cohort(tenants=3)
    _equal(cohort.compute(tenant=0)["MeanSquaredError"], col.compute()["MeanSquaredError"], "tenant 0")
    assert len(cohort) == 3
    _equal(cohort.compute(tenant=1)["MeanSquaredError"], torch.tensor(float("nan")), "tenant 1 at defaults")
    col(p[0], t[0])  # the original keeps working


def test_from_collections_and_unstack_round_trip():
    cols = [tm.MetricCollection([tm.MeanSquaredError(device=CPU)]) for _ in range(3)]
    p, t = _t(*_reg_batches(3, 16, seed=1))
    for i, c in enumerate(cols):
        c(p[i], t[i])
    cohort = tm.MetricCohort.from_collections(cols)
    for i, c in enumerate(cols):
        _equal(cohort.compute(tenant=i)["MeanSquaredError"], c.compute()["MeanSquaredError"], f"tenant {i}")
        back = cohort.tenant_collection(i)
        _equal(back.compute()["MeanSquaredError"], c.compute()["MeanSquaredError"], f"unstacked {i}")
    with pytest.raises(ValueError, match="structure mismatch"):
        cohort.add_tenant(state=tm.MetricCollection([tm.MeanAbsoluteError(device=CPU)]))


def test_cohort_single_metric_template_returns_bare_values():
    cohort = tm.MetricCohort(tm.Accuracy(device=CPU), tenants=2)
    jax_cohort = jm.MetricCohort(jm.Accuracy(), tenants=2)
    p, t = _cls_batches(2, 16, seed=0)
    values = cohort(*_t(p, t))
    _near_jax(values, jax_cohort(*_j(p, t)), "step")
    assert values.shape == (2,) and cohort.compute().shape == (2,)
    assert cohort.compute(tenant=1).shape == ()
    assert isinstance(cohort.tenant_collection(0), tm.Accuracy)


def test_cohort_reset_keeps_membership():
    cohort = tm.MetricCohort(tm.MetricCollection([tm.MeanSquaredError(device=CPU)]), tenants=3)
    cohort(*_t(*_reg_batches(3, 16, seed=0)))
    cohort.remove_tenant(2)
    cohort.reset()
    assert cohort.tenant_ids() == (0, 1)
    _equal(cohort._states["MeanSquaredError"]["sum_squared_error"], torch.zeros(cohort.capacity), "reset")


def test_cohort_state_dict_is_not_changed_by_membership_changes():
    cohort = tm.MetricCohort(tm.MetricCollection([tm.MeanSquaredError(device=CPU)]), tenants=3)
    cohort(*_t(*_reg_batches(3, 16, seed=0)))
    saved = {k: v.clone() for k, v in cohort._named_states()}
    held = dict(cohort._named_states())
    cohort.remove_tenant(1)
    cohort.add_tenant()
    for k, v in held.items():
        _equal(v, saved[k], k)


def test_cohort_pickles_and_deep_copies_without_its_programs():
    import copy
    import pickle

    cohort = tm.MetricCohort(_classification(tm), tenants=3)
    cohort(*_t(*_cls_batches(3, 16, seed=0)))
    batch = _t(*_cls_batches(3, 16, seed=1))
    for make_copy in (lambda c: pickle.loads(pickle.dumps(c)), copy.deepcopy):
        clone = make_copy(cohort)
        assert clone.cache_info()["trace_count"] == 0 and clone.tenant_ids() == cohort.tenant_ids()
        got = clone(*batch)
        for key, v in cohort(*batch).items():
            _equal(got[key], v, key)
        for (key, v), (_, w) in zip(clone._named_states(), cohort._named_states()):
            _equal(v, w, key)
    assert "MetricCohort(tenants=3, capacity=4" in repr(cohort)


def test_jax_cohort_state_dict_loads_through_state_from_jax():
    """A JAX cohort's stacked states and slot table (``_named_states``, and
    ``state_dict`` with persistent states) load into the port's cohort and
    compute the same values; both keep accumulating alike."""
    jax_cohort = jm.MetricCohort(_classification(jm), tenants=3)
    jax_cohort(*_j(*_cls_batches(3, 32, seed=0)))
    jax_cohort.remove_tenant(1)
    jax_cohort.persistent(True)
    for blob in (dict(jax_cohort._named_states()), jax_cohort.state_dict()):
        port = tm.MetricCohort(_classification(tm), tenants=1)
        port.load_state_dict(state_from_jax({k: np.asarray(v) for k, v in blob.items()}))
        assert port.tenant_ids() == jax_cohort.tenant_ids() and port.capacity == jax_cohort.capacity
        _assert_matches_jax(port, jax_cohort)
    p, t = _cls_batches(2, 32, seed=1)
    port(*_t(p, t))
    jax_cohort(*_j(p, t))
    _assert_matches_jax(port, jax_cohort)


@pytest.mark.parametrize("world", [2, 4])
def test_cohort_sync_exact_bit_identical_across_ranks(world):
    """One gather per stacked state in a gloo world: every rank's synced
    values equal the per-tenant oracle (each tenant's collection synced
    alone) bit for bit, and the sync leaves the local states local."""
    ranks = run_world(world, cohort_sync_world, {"seed": 20})
    for rank, out in ranks.items():
        np.testing.assert_array_equal(out["synced"], out["oracle"], err_msg=f"rank {rank}")
        np.testing.assert_array_equal(out["synced"], ranks[0]["synced"], err_msg=f"rank {rank}")
        np.testing.assert_array_equal(out["state_after"][:2], out["local_twice"], err_msg=f"rank {rank}")


# ---- the count primitives under vmap ------------------------------------------------


def _vmapped_classification_step_profile(capacity):
    from torch.profiler import profile

    cohort = tm.MetricCohort(_classification(tm), tenants=capacity)
    batch = _t(*_cls_batches(capacity, 64, seed=1))
    cohort(*batch)
    with profile() as prof:
        cohort(*batch)
    return {e.key: e.count for e in prof.key_averages()}


def test_vmapped_classification_step_counts_every_tenant_in_one_index_add():
    """The CPU twin of the card's equal-kernels gate: the cohort step's
    ``aten::index_add`` calls (and all its ATen calls) do not grow with the
    tenants; functorch's own rule for ``index_add`` loops over them."""
    small, large = _vmapped_classification_step_profile(2), _vmapped_classification_step_profile(1024)
    adds = {k: v for k, v in small.items() if k.startswith("aten::index_add")}
    assert adds and adds == {k: v for k, v in large.items() if k.startswith("aten::index_add")}
    aten = lambda ev: sum(v for k, v in ev.items() if k.startswith("aten::"))  # noqa: E731
    assert aten(small) == aten(large)


@pytest.mark.parametrize("rows", [50, 65_536], ids=["one-buffer", "spread"])
def test_label_bincount_batching_rule_equals_per_tenant_counts(rows):
    """Negatives clamp to 0 and labels past the length drop, per tenant;
    with weights; 17 x 65,536 labels take the spread form on the flat count."""
    rng = np.random.RandomState(7)
    idx = torch.from_numpy(rng.randint(-2, 8, size=(17, rows)))
    weights = torch.from_numpy(rng.rand(17, rows) < 0.5)
    got = torch.func.vmap(lambda i, w: label_bincount(i, 5, w))(idx, weights)
    assert torch.equal(got, torch.stack([label_bincount(idx[k], 5, weights[k]) for k in range(17)]))
    got = torch.func.vmap(lambda i: label_bincount(i, 6))(idx)
    assert torch.equal(got, torch.stack([label_bincount(idx[k], 6) for k in range(17)]))
    # weights shared by every tenant (not batched)
    got = torch.func.vmap(lambda i: label_bincount(i, 5, weights[0]))(idx)
    assert torch.equal(got, torch.stack([label_bincount(idx[k], 5, weights[0]) for k in range(17)]))


@pytest.mark.parametrize("columns", [0, 3])
def test_score_histograms_batching_rule_equals_per_tenant_histograms(columns):
    rng = np.random.RandomState(8)
    shape = (6, 40) if not columns else (6, 40, columns)
    preds = torch.from_numpy(rng.rand(*shape).astype(np.float32))
    rel = torch.from_numpy(rng.rand(*shape) < 0.5)
    weights = torch.from_numpy(_grid(rng, (6, 40)))
    for w in (None, weights):
        if w is None:
            got = torch.func.vmap(lambda p, r: score_histograms(p, r, 8))(preds, rel)
        else:
            got = torch.func.vmap(lambda p, r, x: score_histograms(p, r, 8, x))(preds, rel, w)
        for k in range(6):
            want = score_histograms(preds[k], rel[k], 8, None if w is None else w[k])
            assert torch.equal(got[0][k], want[0]) and torch.equal(got[1][k], want[1])


# ---- health --------------------------------------------------------------------


def _batch(tenants, rows=16, seed=0):
    return _reg_batches(tenants, rows, seed)


def _mse_cohorts(tenants, health=True):
    return (tm.MetricCohort(tm.MeanSquaredError(device=CPU), tenants=tenants, track_health=health),
            jm.MetricCohort(jm.MeanSquaredError(), tenants=tenants, track_health=health))


def _health_equal(port, jax_cohort, keys=("rows_seen", "updates", "last_step", "staleness", "nonfinite")):
    got, want = port.health(), jax_cohort.health()
    assert got["step"] == want["step"] and got["tenants"] == want["tenants"]
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return got


def test_health_off_is_the_default_and_bit_identical():
    preds, target = _t(*_batch(4))
    off = tm.MetricCohort(tm.MeanSquaredError(device=CPU), tenants=4)
    assert off._track_health is None
    v_off = off(preds, target)
    assert off.health() is None and off._health is None
    on = tm.MetricCohort(tm.MeanSquaredError(device=CPU), tenants=4, track_health=True)
    v_on = on(preds, target)
    assert on.health() is not None
    assert torch.equal(v_off, v_on)
    for sname, v in off._states["metric"].items():
        assert torch.equal(v, on._states["metric"][sname]), sname


def test_health_toggle_is_a_cache_entry_not_a_rebuild():
    preds, target = _t(*_batch(4))
    cohort = tm.MetricCohort(tm.MeanSquaredError(device=CPU), tenants=4)
    for health, builds in ((False, 1), (True, 2), (False, 2), (True, 2)):
        cohort._track_health = health
        cohort(preds, target)
        assert cohort._engine.trace_count == builds
    assert cohort.health()["updates"].tolist() == [2, 2, 2, 2]


def test_rows_updates_laststep_accounting():
    port, jax_cohort = _mse_cohorts(4)
    for _ in range(3):
        port(*_t(*_batch(4)))
        jax_cohort(*_j(*_batch(4)))
    h = _health_equal(port, jax_cohort)
    assert h["step"] == 3
    assert h["rows_seen"].tolist() == [48] * 4 and h["updates"].tolist() == [3] * 4
    assert h["last_step"].tolist() == [3] * 4 and h["staleness"].tolist() == [0] * 4
    assert h["nonfinite"].tolist() == [0] * 4


def test_new_tenant_starts_fresh_and_never_active_reads_stale():
    port, jax_cohort = _mse_cohorts(2)
    for _ in range(2):
        port(*_t(*_batch(2)))
        jax_cohort(*_j(*_batch(2)))
    assert port.add_tenant() == jax_cohort.add_tenant() == 2
    h = _health_equal(port, jax_cohort)
    i = h["tenants"].index(2)
    assert h["updates"][i] == 0 and h["last_step"][i] == -1 and h["staleness"][i] == 2
    port(*_t(*_batch(3, seed=1)))
    jax_cohort(*_j(*_batch(3, seed=1)))
    h = _health_equal(port, jax_cohort)
    assert h["updates"][i] == 1 and h["staleness"][i] == 0


def test_slot_reuse_resets_health():
    port, jax_cohort = _mse_cohorts(3)
    port(*_t(*_batch(3)))
    jax_cohort(*_j(*_batch(3)))
    port.remove_tenant(1)
    jax_cohort.remove_tenant(1)
    assert port.add_tenant() == 1 == jax_cohort.add_tenant()
    port(*_t(*_batch(3, seed=2)))
    jax_cohort(*_j(*_batch(3, seed=2)))
    h = _health_equal(port, jax_cohort)
    assert h["updates"][1] == 1 and h["rows_seen"][1] == 16  # not the evicted tenant's


def test_capacity_growth_preserves_health():
    port, jax_cohort = _mse_cohorts(2)
    port(*_t(*_batch(2)))
    jax_cohort(*_j(*_batch(2)))
    for _ in range(3):  # grow 2 -> 8
        port.add_tenant()
        jax_cohort.add_tenant()
    assert port.capacity == 8
    h = _health_equal(port, jax_cohort)
    assert h["updates"].tolist() == [1, 1, 0, 0, 0]
    port.add_tenants(3)
    jax_cohort.add_tenants(3)
    port(*_t(*_batch(8, seed=3)))
    jax_cohort(*_j(*_batch(8, seed=3)))
    assert _health_equal(port, jax_cohort)["updates"].tolist() == [2, 2, 1, 1, 1, 1, 1, 1]


def test_nonfinite_state_is_counted_per_slot():
    """A tenant fed NaN rows holds a nonfinite state from then on: its slot,
    and only its slot, counts every step that leaves it so (JAX counts the
    same without a guard)."""
    port, jax_cohort = _mse_cohorts(4)
    preds, target = _batch(4)
    poison = preds.copy()
    poison[2] = np.nan
    for p in (preds, poison, preds):
        port(*_t(p, target))
        jax_cohort(*_j(p, target))
    h = _health_equal(port, jax_cohort)
    assert h["nonfinite"].tolist() == [0, 0, 2, 0]


def test_reserved_member_names_are_rejected():
    for name in ("__cohort_health__", "__cohort_slots__"):
        with pytest.raises(ValueError, match="reserved"):
            tm.MetricCohort({name: tm.MeanSquaredError(device=CPU)})


def test_health_tensors_are_never_the_engines():
    preds, target = _t(*_batch(2))
    cohort = tm.MetricCohort(tm.MeanSquaredError(device=CPU), tenants=2, track_health=True)
    cohort(preds, target)
    before = dict(cohort._health)
    kept = {k: v.clone() for k, v in before.items()}
    cohort(preds, target)
    buffers = {id(b) for b in cohort._engine._state_buffers.values()}
    for k, v in before.items():  # the accumulators handed in are left as they were
        assert torch.equal(v, kept[k]) and cohort._health[k] is not v, k
        assert id(cohort._health[k]) not in buffers


def test_any_restore_starts_a_fresh_health_window():
    source = tm.MetricCohort(tm.MeanSquaredError(device=CPU), tenants=4, track_health=True)
    preds, target = _t(*_batch(4))
    source(preds, target)
    blob = source.state_dict()
    cohort = tm.MetricCohort(tm.MeanSquaredError(device=CPU), tenants=4, track_health=True)
    cohort(preds, target)
    cohort(preds, target)
    assert cohort.health()["step"] == 2
    cohort.load_state_dict(blob)  # same capacity
    assert cohort._health is None and cohort._steps == 0 and cohort.health() is None
    cohort(preds, target)
    h = cohort.health()
    assert h["step"] == 1 and h["updates"].tolist() == [1, 1, 1, 1]


# ---- failure and results ----------------------------------------------------------


class _HostRead(tm.MeanSquaredError):
    """Reads a batch value to the host in its update, which no batched step
    (and no CUDA graph) can hold."""

    def update(self, preds, target):
        float(preds.sum())
        super().update(preds, target)


def test_a_failed_build_raises_drops_the_program_and_demotes_nothing():
    cohort = tm.MetricCohort(tm.MetricCollection({"mse": _HostRead(device=CPU)}), tenants=2)
    before = {k: v.clone() for k, v in cohort._named_states()}
    batch = _t(*_reg_batches(2, 8, seed=0))
    for attempt in (1, 2):  # no eager fallback: each call builds anew and raises
        with pytest.raises(RuntimeError):
            cohort(*batch)
        assert cohort._engine.trace_count == attempt and cohort.cache_info()["compiled_signatures"] == 0
    assert cohort._engine.eager_fallbacks == {} and cohort._steps == 0
    for k, v in cohort._named_states():
        _equal(v, before[k], k)


def test_compute_result_outlives_later_steps_and_reset():
    """``ConfusionMatrix(normalize=None).compute()`` returns its state: the
    matrices read after one step keep their counts through later steps and
    ``reset()``."""
    cohort = tm.MetricCohort(tm.ConfusionMatrix(num_classes=C, device=CPU), tenants=3)
    cohort(*_t(*_cls_batches(3, 32, seed=0)))
    first = cohort.compute()
    kept = first.clone()
    cohort(*_t(*_cls_batches(3, 32, seed=1)))
    cohort.reset()
    assert torch.equal(first, kept) and int(kept.sum()) == 3 * 32
