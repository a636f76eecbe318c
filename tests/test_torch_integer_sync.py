"""An exact sync of integer states keeps JAX's dtype.

``jnp.sum(x, axis=0)`` (x64 off) sums bool and int8 / int16 / int32 states to
int32 and unsigned ones to uint32; ``torch.sum`` would widen them to int64.
The port's ``dim_zero_sum`` returns JAX's dtypes, so an exact sync hands back
int32 counts, the two-level exact path sends int32 slice partials at level 1
(as many bytes as the payload), and a synced state's envelope spec says
``int32`` as JAX's does. A gloo world of 4 (one process a rank) syncs a
``ConfusionMatrix`` and a macro ``StatScores`` flat and over a 2 x 2
topology; the JAX package syncs the same per-rank batches in its threaded
virtual worlds (flat and two-level); every synced integer state must equal
JAX's in dtype and value on every rank.

Tolerance: none (integer counts).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
from metrics_tpu.parallel.hierarchy import SyncTopology as JaxSyncTopology
from metrics_tpu_torch.utilities.data import dim_zero_sum
from tests.helpers.testers import run_virtual_ddp as jax_run_virtual_ddp
from tests.helpers.testers import run_virtual_hierarchy as jax_run_virtual_hierarchy
from tests.torch_workers import int_sync_world, run_world

WORLD = 4
CLASSES = 5


@pytest.mark.parametrize(
    "dtype,want",
    [
        (torch.bool, torch.int32),
        (torch.int8, torch.int32),
        (torch.int16, torch.int32),
        (torch.int32, torch.int32),
        (torch.int64, torch.int64),
        (torch.uint8, torch.uint32),
        (torch.float32, torch.float32),
        (torch.float64, torch.float64),
        (torch.bfloat16, torch.bfloat16),
    ],
)
def test_dim_zero_sum_returns_jax_dtypes(dtype, want):
    x = torch.tensor([[1, 0, 3], [1, 1, 2]]).to(dtype)
    got = dim_zero_sum(x)
    assert got.dtype == want
    if dtype not in (torch.int64, torch.float64, torch.bfloat16):
        jx = jnp.asarray(x.to(torch.float32).numpy()).astype(str(dtype).replace("torch.", ""))
        assert str(got.dtype).replace("torch.", "") == str(jnp.sum(jx, axis=0).dtype)
    assert torch.equal(got.to(torch.float64), x.to(torch.float64).sum(0))


def test_int32_sum_wraps_past_two_to_the_31_as_jax_does():
    x = torch.tensor([[2**31 - 1], [5]], dtype=torch.int32)
    got = dim_zero_sum(x)
    want = np.asarray(jnp.sum(jnp.asarray(x.numpy()), axis=0))
    assert got.dtype == torch.int32 and got.tolist() == want.tolist() == [-(2**31) + 4]


def _batches(seed=3, rows=64):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(WORLD):
        probs = rng.rand(rows, CLASSES).astype(np.float32)
        out.append((probs / probs.sum(1, keepdims=True), rng.randint(CLASSES, size=rows).astype(np.int32)))
    return out


def _jax_synced(batches):
    """The JAX package's synced states, flat and two-level, as numpy."""
    out = {}

    def sync(rank, layout):
        probs, target = batches[rank]
        metrics = {
            "ConfusionMatrix": jm.ConfusionMatrix(num_classes=CLASSES),
            "StatScores": jm.StatScores(reduce="macro", num_classes=CLASSES),
        }
        for key, m in metrics.items():
            m.update(jnp.asarray(probs), jnp.asarray(target))
            m._sync_dist()
            if rank == 0:
                for sname in m._defaults:
                    out[(layout, key, sname)] = np.asarray(getattr(m, sname))

    jax_run_virtual_ddp(WORLD, lambda rank, world: sync(rank, "flat"))
    jax_run_virtual_hierarchy(JaxSyncTopology.regular(2, WORLD // 2), lambda rank, topo: sync(rank, "two_level"))
    return out


def test_gloo_exact_sync_of_integer_states_matches_jax_dtype_and_values():
    batches = _batches()
    ranks = run_world(WORLD, int_sync_world, {"batches": batches})
    want = _jax_synced(batches)
    assert want and all(v.dtype == np.int32 for v in want.values())
    for rank, out in ranks.items():
        for key, value in want.items():
            got = out[key]
            assert got.dtype == value.dtype, (rank, key, got.dtype, value.dtype)
            assert np.array_equal(got, value), (rank, key)
        # the two-level exact path sends int32 partials at level 1: as many
        # bytes as the payload (int64 partials would send twice as many)
        counters = out[("two_level", "counters")]
        assert counters["sync.level1.wire_bytes"] == counters["sync.payload_bytes"], (rank, counters)
