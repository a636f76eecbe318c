"""The port's two-level hierarchical sync against the JAX package's, on the CPU.

The cases of ``tests/parallel/test_hierarchy.py`` and of
``tests/reliability/test_hierarchy_chaos.py`` are mirrored. Two-level worlds
are threads (``tests/torch_virtual.py``: a ``VirtualTwoLevelGroup`` whose
level-0 gathers rendezvous per slice and whose level-1 exchange rendezvous
the slice leaders, beside JAX's own in ``tests/helpers/testers.py``); the
chaos drills run in one process over ``faultinject.simulated_pods``, where
the remote peers mirror this process's contributions, so every healthy or
degraded expectation is exact arithmetic. The gloo world of 4 (2 × 2 over
``over_flat`` and over ``new_group`` slices) is in
``tests/test_torch_distributed.py``.

Tolerances: grid-valued rows (multiples of 1/256) make every float sum exact
in any order, so the exact two-level sync is held BIT-equal to the flat one
and to JAX's; the int8 tier is held bit-equal to JAX's two-level result and
its committed residuals, and within the documented bound
(``num_slices * slice-partial absmax / 254``) of the exact sum; a rank's
mean state (its own package's division) is within 1e-6. Counters equal
JAX's but for the keys that carry the metric's class name.

The JAX cases that wait for ``EvalSession`` (ROADMAP Queue 1 item 4):
``test_pod_dropout_mid_session_resumes_exactly_once_with_quorum``,
``test_pod_dropout_resume_degrades_without_a_sync_policy``,
``test_slice_local_skew_resume_does_not_deadlock_over_flat`` and
``test_healthy_session_resume_records_full_quorum``.
"""
import glob
import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.observability as jobs
import metrics_tpu_torch.observability as obs
from metrics_tpu import Metric as JaxMetric
from metrics_tpu import reliability as jrel
from metrics_tpu.parallel import hierarchy as jhier
from metrics_tpu.parallel.backend import set_sync_backend as jax_set_sync_backend
from metrics_tpu.reliability import faultinject as jfi
from metrics_tpu.utilities.distributed import gather_all_tensors as jax_gather
from metrics_tpu_torch import reliability
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.parallel.backend import get_sync_backend, set_sync_backend
from metrics_tpu_torch.parallel.hierarchy import (
    HierarchicalSyncBackend,
    SyncTopology,
    last_quorum,
    reset_quorum,
    two_level_fold,
)
from metrics_tpu_torch.reliability import SyncPolicy
from metrics_tpu_torch.reliability import faultinject as fi
from metrics_tpu_torch.utilities.data import dim_zero_cat, dim_zero_max, dim_zero_mean, dim_zero_min, dim_zero_sum
from metrics_tpu_torch.utilities.distributed import gather_all_tensors
from tests.helpers.testers import run_virtual_hierarchy as jax_run_virtual_hierarchy
from tests.torch_virtual import VirtualDDPGroup, VirtualTwoLevelGroup, run_virtual_ddp, run_virtual_hierarchy

CPU = "cpu"
_X = (np.random.RandomState(0xA5).randint(0, 512, size=300) / 256.0).astype(np.float32)


@pytest.fixture(autouse=True)
def _clean_backend_quorum_and_recorders():
    def clean():
        reset_quorum()
        jhier.reset_quorum()
        set_sync_backend(None)
        jax_set_sync_backend(None)
        for pkg in (jobs, obs):
            pkg.disable()
            pkg.get().reset()
            pkg.disable_flight()

    clean()
    yield
    clean()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _quorum_fields(q):
    d = q.as_dict()
    return {k: v for k, v in d.items() if k != "wall_time"}


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------
def test_topology_regular_layout():
    topo = SyncTopology.regular(2, 4)
    assert topo.world_size == 8
    assert topo.num_slices == 2 and topo.slice_size == 4
    assert topo.slices == ((0, 1, 2, 3), (4, 5, 6, 7))
    assert topo.slice_of(5) == 1 and topo.local_index(5) == 1
    assert topo.leaders() == (0, 4)
    assert topo.is_leader(4) and not topo.is_leader(6)
    assert repr(topo) == repr(jhier.SyncTopology.regular(2, 4))


def test_topology_rejects_bad_partitions():
    with pytest.raises(ValueError, match="equal-sized"):
        SyncTopology([[0, 1, 2], [3]])
    with pytest.raises(ValueError, match="partition"):
        SyncTopology([[0, 1], [1, 2]])
    with pytest.raises(ValueError, match="partition"):
        SyncTopology([[0, 1], [3, 4]])
    with pytest.raises(ValueError, match="non-empty"):
        SyncTopology([])
    with pytest.raises(ValueError, match=">= 1"):
        SyncTopology.regular(0, 2)


def test_topology_noncontiguous_slices_allowed():
    topo = SyncTopology([[0, 2], [1, 3]])
    assert topo.slice_of(2) == 0 and topo.slice_of(1) == 1
    assert topo.leaders() == (0, 1)


def test_fold_classification():
    assert two_level_fold(dim_zero_sum) == "sum"
    assert two_level_fold(dim_zero_max) == "max"
    assert two_level_fold(dim_zero_min) == "min"
    assert two_level_fold(dim_zero_mean) is None
    assert two_level_fold(dim_zero_cat) is None
    assert two_level_fold(None) is None


def test_backend_validates_level_precisions():
    topo = SyncTopology.regular(2, 1)
    group = VirtualTwoLevelGroup(topo)
    with pytest.raises(ValueError, match="level precision"):
        HierarchicalSyncBackend(topo, group.level0, group.level1, level_precisions=("exact", "fp4"))
    with pytest.raises(ValueError, match="exactly two"):
        HierarchicalSyncBackend(topo, group.level0, group.level1, level_precisions=("exact",))


def test_rank_is_a_method_resolved_per_call():
    """The port's ``rank()`` form: an int, a callable (per thread in a
    virtual world), or the ``torch.distributed`` rank (0 without a group)."""
    topo = SyncTopology.regular(2, 2)
    group = VirtualTwoLevelGroup(topo)
    assert HierarchicalSyncBackend(topo, group.level0, group.level1, rank=3).rank() == 3
    assert HierarchicalSyncBackend(topo, group.level0, group.level1).rank() == 0
    seen = {}

    def worker(rank, topology):
        b = get_sync_backend()
        seen[rank] = (b.rank(), b.slice_id, b.level0.rank(), b.level1.rank())

    run_virtual_hierarchy(topo, worker)
    assert seen == {0: (0, 0, 0, 0), 1: (1, 0, 1, 0), 2: (2, 1, 0, 1), 3: (3, 1, 1, 1)}


# ---------------------------------------------------------------------------
# the virtual two-level world
# ---------------------------------------------------------------------------
class _Stats(Metric):
    """sum + max + mean states: a two-level fold pair plus one state that
    rides the composed flat path."""

    def __init__(self, precision="exact"):
        super().__init__(device=CPU)
        self.add_state("total", default=torch.zeros(96), dist_reduce_fx="sum", sync_precision=precision)
        self.add_state("peak", default=torch.zeros(()), dist_reduce_fx="max")
        self.add_state("level", default=torch.zeros(()), dist_reduce_fx="mean")

    def update(self, x):
        self.total = self.total + x
        self.peak = torch.maximum(self.peak, x.max())
        self.level = x.mean()

    def compute(self):
        return self.total


class _JaxStats(JaxMetric):
    def __init__(self, precision="exact"):
        super().__init__()
        self.add_state("total", default=jnp.zeros((96,)), dist_reduce_fx="sum", sync_precision=precision)
        self.add_state("peak", default=jnp.zeros(()), dist_reduce_fx="max")
        self.add_state("level", default=jnp.zeros(()), dist_reduce_fx="mean")

    def update(self, x):
        self.total = self.total + x
        self.peak = jnp.maximum(self.peak, x.max())
        self.level = x.mean()

    def compute(self):
        return self.total


def _rank_batch(rank: int) -> np.ndarray:
    rng = np.random.RandomState(100 + rank)
    return (rng.randint(0, 512, size=96) / 256.0).astype(np.float32)


def _assert_equal_to_jax(got, want, key):
    """Bit-equal, but for ``level``: each rank's ``x.mean()`` of 96 grid
    values is its own package's division (1 ulp apart); the sync then
    averages the same way in both."""
    if key == "level":
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=key)
    else:
        np.testing.assert_array_equal(got, want, err_msg=key)


def _stats_world(runner, topo_or_world, precision="exact", jax_side=False):
    out = {}

    def worker(rank, _):
        if jax_side:
            m = _JaxStats(precision)
            m.dist_sync_fn = jax_gather
            m.update(jnp.asarray(_rank_batch(rank)))
        else:
            m = _Stats(precision)
            m.dist_sync_fn = gather_all_tensors
            m.update(torch.from_numpy(_rank_batch(rank)))
        m._sync_dist()
        out[rank] = {k: _np(getattr(m, k)) for k in ("total", "peak", "level")}
        if precision != "exact":
            out[rank]["total__qres"] = _np(m.total__qres)

    runner(topo_or_world, worker)
    return out


def test_two_level_exact_bit_identical_to_flat_and_to_jax():
    flat = _stats_world(run_virtual_ddp, 4)
    hier = _stats_world(run_virtual_hierarchy, SyncTopology.regular(2, 2))
    jax_hier = _stats_world(jax_run_virtual_hierarchy, jhier.SyncTopology.regular(2, 2), jax_side=True)
    for rank in range(4):
        for key in ("total", "peak", "level"):
            np.testing.assert_array_equal(hier[rank][key], flat[rank][key], err_msg=f"rank {rank} state {key}")
            _assert_equal_to_jax(hier[rank][key], jax_hier[rank][key], key)
    q = last_quorum()
    assert q is not None and q.full and q.degraded_level is None
    assert _quorum_fields(q) == _quorum_fields(jhier.last_quorum())


def test_two_level_int8_within_documented_bound_and_equal_to_jax():
    results = _stats_world(run_virtual_hierarchy, SyncTopology.regular(2, 2), "int8")
    jax_results = _stats_world(jax_run_virtual_hierarchy, jhier.SyncTopology.regular(2, 2), "int8", jax_side=True)
    exact = sum(_rank_batch(r) for r in range(4))
    absmax = max(np.abs(_rank_batch(r)).max() for r in range(4))
    bound = 2 * (2 * absmax) / 254
    for rank in range(4):
        assert np.abs(results[rank]["total"] - exact).max() <= bound
        assert np.abs(results[rank]["total__qres"]).max() > 0
        for key in ("total", "peak", "level", "total__qres"):
            _assert_equal_to_jax(results[rank][key], jax_results[rank][key], key)
    np.testing.assert_array_equal(results[0]["total__qres"], results[1]["total__qres"])
    np.testing.assert_array_equal(results[2]["total__qres"], results[3]["total__qres"])


@pytest.mark.parametrize("levels", [("int8", "exact"), ("bf16", "int8"), ("exact", "exact")])
def test_per_level_precision_overrides_equal_jax(levels):
    """A level-0 override quantizes feedback-free; only level 1 consumes
    and commits the residual. Every level pairing equals JAX's bits."""
    out = {}

    def run(jax_side):
        res = {}

        def worker(rank, _):
            if jax_side:
                m = _JaxStats("int8")
                m.dist_sync_fn = jax_gather
                m.update(jnp.asarray(_rank_batch(rank)))
            else:
                m = _Stats("int8")
                m.dist_sync_fn = gather_all_tensors
                m.update(torch.from_numpy(_rank_batch(rank)))
            m._sync_dist()
            res[rank] = (_np(m.total), _np(m.total__qres))

        if jax_side:
            from tests.helpers.testers import VirtualTwoLevelGroup as JaxGroup, _RANK as JAX_RANK
            import threading

            group = JaxGroup(jhier.SyncTopology.regular(2, 2))
            group.level_precisions = tuple(levels)
            jax_set_sync_backend(group)
            errors = []

            def t(rank):
                JAX_RANK.rank = rank
                try:
                    worker(rank, None)
                except BaseException as err:  # noqa: BLE001
                    errors.append(err)
                    group.abort()

            threads = [threading.Thread(target=t, args=(r,)) for r in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            jax_set_sync_backend(None)
            assert not errors, errors
        else:
            run_virtual_hierarchy(SyncTopology.regular(2, 2), worker, level_precisions=levels)
        return res

    out, jax_out = run(False), run(True)
    for rank in range(4):
        np.testing.assert_array_equal(out[rank][0], jax_out[rank][0])
        np.testing.assert_array_equal(out[rank][1], jax_out[rank][1])
    if levels[1] == "exact":
        assert np.abs(out[0][1]).max() == 0.0  # no lossy level 1: nothing to commit


def test_composed_flat_gather_is_rank_ordered():
    seen = {}

    def worker(rank, topo):
        out = get_sync_backend().gather(torch.tensor(float(rank)))
        seen[rank] = [float(v) for v in out]

    run_virtual_hierarchy(SyncTopology([[0, 2], [1, 3]]), worker)
    for rank in range(4):
        assert seen[rank] == [0.0, 1.0, 2.0, 3.0]


def test_leader_exchange_is_sparse():
    widths = []

    def worker(rank, topo):
        backend = get_sync_backend()
        out = backend.gather_level1(torch.tensor(float(backend.slice_id)))
        widths.append(len(out))

    group = run_virtual_hierarchy(SyncTopology.regular(2, 2), worker)
    assert widths == [2, 2, 2, 2]
    assert group.level1.widths == [2, 2, 2, 2]


def test_over_flat_composition_matches_direct_transports():
    captured = {}

    def worker(rank, world):
        flat = get_sync_backend()
        hb = HierarchicalSyncBackend.over_flat(SyncTopology.regular(2, 2), flat)
        l0 = [float(v) for v in hb.gather_level0(torch.tensor(float(rank)))]
        l1 = [float(v) for v in hb.gather_level1(torch.tensor(float(rank)))]
        captured[rank] = (l0, l1, hb.rank(), hb.level0.rank(), hb.level1.rank())

    run_virtual_ddp(4, worker)
    assert captured[1][0] == [0.0, 1.0]
    assert captured[3][0] == [2.0, 3.0]
    for rank in range(4):
        assert captured[rank][1] == [0.0, 2.0]
        assert captured[rank][2:] == (rank, rank % 2, rank // 2)


def test_over_flat_rejects_world_mismatch():
    with pytest.raises(ValueError, match="world"):
        HierarchicalSyncBackend.over_flat(SyncTopology.regular(2, 4), VirtualDDPGroup(2))


def test_reduction_none_array_state_stays_stacked():
    class NoRed(Metric):
        def __init__(self):
            super().__init__(device=CPU)
            self.add_state("x", default=torch.zeros(3), dist_reduce_fx=None)

        def update(self, v):
            self.x = v

        def compute(self):
            return self.x

    out = {}

    def worker(rank, topo):
        m = NoRed()
        m.dist_sync_fn = gather_all_tensors
        m.update(torch.full((3,), float(rank)))
        m._sync_dist()
        out[rank] = _np(m.x)

    run_virtual_hierarchy(SyncTopology.regular(2, 2), worker)
    for rank in range(4):
        assert out[rank].shape == (4, 3)
        np.testing.assert_array_equal(out[rank][:, 0], [0.0, 1.0, 2.0, 3.0])


def test_list_state_rides_the_composed_path_in_rank_order():
    class Cat(Metric):
        def __init__(self):
            super().__init__(device=CPU)
            self.add_state("xs", default=[], dist_reduce_fx="cat")

        def update(self, v):
            self.xs.append(v)

        def compute(self):
            return self.xs

    out = {}

    def worker(rank, topo):
        m = Cat()
        m.dist_sync_fn = gather_all_tensors
        m.update(torch.full((2,), float(rank)))
        m.update(torch.full((1,), 10.0 + rank))
        m._sync_dist()
        out[rank] = _np(m.xs)

    run_virtual_hierarchy(SyncTopology.regular(2, 2), worker)
    want = np.array([0, 0, 1, 1, 2, 2, 3, 3, 10, 11, 12, 13], np.float32)
    for rank in range(4):
        np.testing.assert_array_equal(out[rank], want)


def test_backend_heartbeat_and_stream_follow_the_quorum():
    topo = SyncTopology.regular(2, 1)
    with fi.simulated_pods(2) as backend:
        assert backend.heartbeat() == (0, 1)
        assert float(backend.stream(torch.tensor(3.0), source=1)) == 3.0
        value, acks = backend.stream_acked(torch.tensor(5.0))
        assert float(value) == 5.0 and acks == 2
        m = _Stats()
        m.dist_sync_fn = gather_all_tensors
        m.update(torch.from_numpy(_rank_batch(0)))
        with fi.pod_dropout(1), reliability.sync_policy_scope(max_retries=0, degraded_ok=True):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                m.compute()
        assert backend.heartbeat() == (0,)
    assert topo.world_size == 2


# ---------------------------------------------------------------------------
# cohort over a hierarchical backend
# ---------------------------------------------------------------------------
def test_cohort_sync_routes_through_hierarchy():
    from metrics_tpu_torch import MeanSquaredError, MetricCohort

    rng = np.random.RandomState(3)
    p = torch.from_numpy((rng.randint(0, 256, size=(2, 16)) / 256.0).astype(np.float32))
    t = torch.from_numpy((rng.randint(0, 256, size=(2, 16)) / 256.0).astype(np.float32))
    with fi.simulated_pods(num_slices=2), obs.telemetry_scope() as tel:
        cohort = MetricCohort(MeanSquaredError(device=CPU), tenants=2)
        cohort(p, t)
        local_sse = cohort._states["metric"]["sum_squared_error"].clone()
        values = cohort.compute()
        np.testing.assert_allclose(_np(values), _np(((p - t) ** 2).mean(dim=1)), atol=1e-6)
        assert torch.equal(cohort._states["metric"]["sum_squared_error"], local_sse)
        assert tel.counters["cohort.sync_collectives"] == 2
        assert tel.counters["sync.level0.calls"] == tel.counters["sync.level1.calls"] == 1
    q = last_quorum()
    assert q is not None and q.full


def test_cohort_int8_hierarchical_commits_stacked_residuals_and_equals_jax():
    """A quantized cohort over simulated pods: the stacked state quantized at
    level 1 once for every tenant; its residual stack committed; values and
    residuals JAX's bits on grid rows; a dropped pod serves the slice scope
    and commits nothing."""
    import metrics_tpu as jm
    from metrics_tpu_torch import MeanSquaredError, MetricCohort, MetricCollection

    rng = np.random.RandomState(5)
    pn = (rng.randint(0, 256, size=(3, 32)) / 256.0).astype(np.float32)
    tn = (rng.randint(0, 256, size=(3, 32)) / 256.0).astype(np.float32)
    with fi.simulated_pods(2):
        cohort = MetricCohort(MetricCollection([MeanSquaredError(device=CPU)], sync_precision="int8"), tenants=3)
        cohort(torch.from_numpy(pn), torch.from_numpy(tn))
        got = _np(cohort.compute()["MeanSquaredError"])
        res = _np(cohort._states["MeanSquaredError"]["sum_squared_error__qres"])
    with jfi.simulated_pods(2):
        jc = jm.MetricCohort(jm.MetricCollection([jm.MeanSquaredError()], sync_precision="int8"), tenants=3)
        jc(jnp.asarray(pn), jnp.asarray(tn))
        want = np.asarray(jc.compute()["MeanSquaredError"])
        jres = np.asarray(jc._states["MeanSquaredError"]["sum_squared_error__qres"])
    np.testing.assert_array_equal(res, jres)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.abs(res).max() > 0
    with fi.simulated_pods(2):
        cohort = MetricCohort(MetricCollection([MeanSquaredError(device=CPU)], sync_precision="int8"), tenants=3)
        cohort(torch.from_numpy(pn), torch.from_numpy(tn))
        with fi.pod_dropout(1), reliability.sync_policy_scope(max_retries=0, degraded_ok=True):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                got = _np(cohort.compute()["MeanSquaredError"])
        assert float(cohort._states["MeanSquaredError"]["sum_squared_error__qres"].abs().max()) == 0.0
    np.testing.assert_allclose(got, ((pn - tn) ** 2).mean(1), atol=1e-6)


# ---------------------------------------------------------------------------
# chaos drills (tests/reliability/test_hierarchy_chaos.py)
# ---------------------------------------------------------------------------
class QHist(Metric):
    def __init__(self, precision="int8"):
        super().__init__(device=CPU)
        self.add_state("hist", default=torch.zeros(300), dist_reduce_fx="sum", sync_precision=precision)

    def update(self, x):
        self.hist = self.hist + x

    def compute(self):
        return self.hist


class JaxQHist(JaxMetric):
    def __init__(self, precision="int8"):
        super().__init__()
        self.add_state("hist", default=jnp.zeros((300,)), dist_reduce_fx="sum", sync_precision=precision)

    def update(self, x):
        self.hist = self.hist + x

    def compute(self):
        return self.hist


class MixedStats(Metric):
    """sum + max: degradation must move BOTH to slice scope, never one."""

    def __init__(self):
        super().__init__(device=CPU)
        self.add_state("total", default=torch.zeros(300), dist_reduce_fx="sum")
        self.add_state("peak", default=torch.zeros(()), dist_reduce_fx="max")

    def update(self, x):
        self.total = self.total + x
        self.peak = torch.maximum(self.peak, x.max())

    def compute(self):
        return self.total


def _filled(cls=QHist, *args):
    m = cls(*args)
    m.dist_sync_fn = gather_all_tensors
    m.update(torch.from_numpy(_X))
    return m


def _jax_filled(cls=JaxQHist, *args):
    m = cls(*args)
    m.dist_sync_fn = jax_gather
    m.update(jnp.asarray(_X))
    return m


def _dumps(directory):
    return sorted(glob.glob(os.path.join(os.fspath(directory), "flight-*.json")))


def test_flaky_level1_retries_then_succeeds_no_residual_double_apply():
    with fi.simulated_pods(2):
        clean = _filled()
        want = _np(clean.compute())
        want_res = _np(clean.hist__qres)
        assert np.abs(want_res).max() > 0
        m = _filled()
        with fi.flaky_level(level=1, fails=2) as flaky:
            with reliability.sync_policy_scope(max_retries=2, backoff_s=0.001) as pol:
                got = _np(m.compute())
        assert flaky.calls == 4  # two failures, then the codes and the scales
        assert pol.stats["retries"] == 2 and pol.stats["degraded"] == 0
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(_np(m.hist__qres), want_res)
    with jfi.simulated_pods(2):
        j = _jax_filled()
        np.testing.assert_array_equal(np.asarray(j.compute()), want)
        np.testing.assert_array_equal(np.asarray(j.hist__qres), want_res)
    q = last_quorum()
    assert q is not None and q.full


def test_flaky_level0_exhaustion_degrades_to_local_only():
    with fi.simulated_pods(num_slices=2, slice_size=2):
        m = _filled()
        local = _np(m.hist)
        with fi.flaky_level(level=0, fails=10**6):
            with reliability.sync_policy_scope(max_retries=1, backoff_s=0.001, degraded_ok=True) as pol:
                with warnings.catch_warnings(record=True):
                    warnings.simplefilter("always")
                    got = _np(m.compute())
        assert pol.stats["degraded"] == 1
        np.testing.assert_array_equal(got, local)
        assert float(m.hist__qres.abs().max()) == 0.0
    q = last_quorum()
    assert q.degraded_level == 0 and q.ranks_present == (0,)
    assert q.slices_present == () and q.dropped_pods == 2
    with jfi.simulated_pods(num_slices=2, slice_size=2):
        j = _jax_filled()
        with jfi.flaky_level(level=0, fails=10**6):
            with jrel.sync_policy_scope(max_retries=1, backoff_s=0.001, degraded_ok=True):
                with warnings.catch_warnings(record=True):
                    warnings.simplefilter("always")
                    j.compute()
    assert _quorum_fields(q) == _quorum_fields(jhier.last_quorum())


def test_level0_degradation_keeps_flat_degraded_contract():
    class NoRed(Metric):
        def __init__(self):
            super().__init__(device=CPU)
            self.add_state("x", default=torch.zeros(3), dist_reduce_fx=None)
            self.add_state("xs", default=[], dist_reduce_fx="cat")

        def update(self, v):
            self.x = v
            self.xs.append(v)

        def compute(self):
            return self.x

    with fi.simulated_pods(num_slices=2, slice_size=2):
        m = NoRed()
        m.dist_sync_fn = gather_all_tensors
        m.update(torch.arange(3.0))
        with fi.flaky_level(level=0, fails=10**6):
            with reliability.sync_policy_scope(max_retries=0, backoff_s=0.001, degraded_ok=True):
                with warnings.catch_warnings(record=True):
                    warnings.simplefilter("always")
                    m._sync_dist()
        assert tuple(m.x.shape) == (1, 3)
        assert not isinstance(m.xs, list)
        np.testing.assert_array_equal(_np(m.xs), np.arange(3.0))


def test_hung_level1_times_out_and_degrades_level0_exact(tmp_path):
    with fi.simulated_pods(2), obs.telemetry_scope(), obs.flight_scope(tmp_path):
        m = _filled()
        with fi.hung_level(level=1, delay_s=30.0):
            policy = SyncPolicy(
                max_retries=0, levels={1: SyncPolicy(max_retries=0, timeout_s=0.2, degraded_ok=True)}
            )
            with reliability.sync_policy_scope(policy):
                with warnings.catch_warnings(record=True):
                    warnings.simplefilter("always")
                    got = _np(m.compute())
        np.testing.assert_array_equal(got, _X)
        assert float(m.hist__qres.abs().max()) == 0.0
        counters = obs.get().snapshot()["counters"]
        assert counters.get("reliability.sync_level_degraded") == 1
        assert "reliability.degraded_syncs" not in counters
        assert policy.levels[1].stats["timeouts"] == 1
        assert len(_dumps(tmp_path)) == 1
        with open(_dumps(tmp_path)[0]) as f:
            dump = json.load(f)
        assert dump["reason"] == "sync_timeout"
        assert any(e["kind"] == "sync_level_degraded" for e in obs.get().events)
    q = last_quorum()
    assert q.degraded_level == 1 and q.slices_present == (0,) and q.dropped_pods == 1


def test_degradation_is_atomic_across_mixed_states():
    with fi.simulated_pods(2):
        m = _filled(MixedStats)
        with fi.pod_dropout(slice_id=1):
            with reliability.sync_policy_scope(max_retries=0, degraded_ok=True):
                with warnings.catch_warnings(record=True):
                    warnings.simplefilter("always")
                    total = _np(m.compute())
        np.testing.assert_array_equal(total, _X)
        assert float(m.peak) == float(_X.max())
        q = last_quorum()
        assert q.lost_slices == (1,) and q.slices_present == (0,)
        m2 = _filled(MixedStats)
        np.testing.assert_array_equal(_np(m2.compute()), 2 * _X)


def test_level1_failure_without_degraded_ok_raises():
    with fi.simulated_pods(2):
        m = _filled()
        with fi.pod_dropout(1), reliability.sync_policy_scope(max_retries=0):
            with pytest.raises(reliability.SyncFailedError, match="unreachable"):
                m.compute()
        assert float(m.hist__qres.abs().max()) == 0.0
        np.testing.assert_array_equal(_np(m.hist), _X)


def test_healthy_hierarchical_run_counters_equal_jax(tmp_path):
    with fi.simulated_pods(2), obs.telemetry_scope(), obs.flight_scope(tmp_path):
        m = _filled()
        with reliability.sync_policy_scope(max_retries=2, backoff_s=0.001):
            got = _np(m.compute())
        np.testing.assert_allclose(got, 2 * _X, atol=2 * np.abs(_X).max() / 127)
        snap = obs.get().snapshot()
        bad = {k: v for k, v in snap["counters"].items() if k.startswith("reliability.") and v}
        assert not bad, f"healthy hierarchical run moved failure counters: {bad}"
        assert snap["counters"]["sync.level0.calls"] == 1
        assert snap["counters"]["sync.level1.calls"] == 1
        assert snap["counters"]["sync.level0.wire_bytes"] > 0
        assert snap["counters"]["sync.level1.wire_bytes"] > 0
        assert "sync.level0.ms" in snap["histograms"] and "sync.level1.ms" in snap["histograms"]
        assert not _dumps(tmp_path)
    with jfi.simulated_pods(2), jobs.telemetry_scope():
        j = _jax_filled()
        with jrel.sync_policy_scope(max_retries=2, backoff_s=0.001):
            np.testing.assert_array_equal(np.asarray(j.compute()), got)
        jsnap = jobs.get().snapshot()
    # equal but for the metric's own name (QHist / JaxQHist)
    assert {k: v for k, v in snap["counters"].items() if not k.startswith("metric.")} == {
        k: v for k, v in jsnap["counters"].items() if not k.startswith("metric.")}
    assert sorted(k for k in snap["histograms"] if not k.startswith("metric.")) == sorted(
        k for k in jsnap["histograms"] if not k.startswith("metric."))
    q = last_quorum()
    assert q.full and q.dropped_pods == 0


def test_level1_wire_is_smaller_than_flat_equivalent():
    with fi.simulated_pods(2), obs.telemetry_scope():
        m = _filled()
        m.compute()
        counters = obs.get().snapshot()["counters"]
        assert counters["sync.level1.wire_bytes"] < counters["sync.payload_bytes"] / 3
        assert counters["sync.level1.wire_bytes"] == 3 * 128 + 3 * 4  # 3 padded blocks of codes + scales


def test_pod_dropout_rejects_unknown_slice_and_needs_a_hierarchy():
    with pytest.raises(RuntimeError, match="HierarchicalSyncBackend"):
        with fi.flaky_level(1):
            pass
    with fi.simulated_pods(2):
        with pytest.raises(ValueError, match="outside topology"):
            with fi.pod_dropout(5):
                pass
        with pytest.raises(ValueError, match="level"):
            with fi.hung_level(2):
                pass
