"""The port's quantized sync codecs and collectives against the JAX package's.

The cases of ``tests/parallel/test_quantize.py`` are mirrored: the codec
numerics, the wire format, error feedback, the quantized reduction, and the
collectives ``qsync_sum`` / ``qsync_state`` / ``sync_array``. JAX runs its
collectives inside ``shard_map`` programs over the 8-device CPU mesh; the
port's run eagerly over the sync backend, here a threaded virtual world of 8
(``tests/torch_virtual.py``); the gloo world of 4 is in
``tests/test_torch_distributed.py``.

Tolerances: codes, scales, bf16 payloads and residuals are held BIT-equal
to JAX on the same seeded inputs (``torch.round`` and ``jnp.round`` both
round half to even; both bf16 casts round to nearest even); so are the
quantized collective's results on grid-valued rows (multiples of 1/256,
whose per-device sums are exact in any order). The documented bounds
(``docs/performance.md:291-296``): int8 within ``absmax/254`` per element
per contribution, bf16 within ``|x|/2^8``. Counters equal JAX's exactly in
a world of one (JAX counts a program's collectives once, at its trace; the
port counts every executed collective, so a world of 8 threads in one
process counts 8 times).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import metrics_tpu.observability as jobs
import metrics_tpu_torch.observability as obs
from metrics_tpu.parallel import quantize as jq
from metrics_tpu.parallel.collective import qsync_sum as jax_qsync_sum
from metrics_tpu.parallel.collective import sync_array as jax_sync_array
from metrics_tpu.parallel.collective import sync_state as jax_sync_state
from metrics_tpu.utilities.jit import tpu_shard_map
from metrics_tpu_torch.parallel import quantize as q
from metrics_tpu_torch.parallel.collective import qsync_state, qsync_sum, sync_array, sync_state
from tests.torch_virtual import run_virtual_ddp

_RNG = np.random.RandomState(0xA11CE)
WORLD = 8


@pytest.fixture(autouse=True)
def _pristine_telemetry():
    for pkg in (jobs, obs):
        pkg.disable()
        pkg.get().reset()
    yield
    for pkg in (jobs, obs):
        pkg.disable()
        pkg.get().reset()


def _bits(x) -> np.ndarray:
    """A tensor's or array's raw bits (bf16 and f32 compared as integers)."""
    a = x.detach().cpu() if isinstance(x, torch.Tensor) else x
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _grid(shape, hi=512):
    return (_RNG.randint(0, hi, size=shape) / 256.0).astype(np.float32)


# ----------------------------------------------------------------------
# bit parity of the codecs with the JAX package
# ----------------------------------------------------------------------
CODEC_CASES = [
    ("vector_1000", (1000,), 10.0),
    ("hist_512", (512,), 1.0),
    ("scalar", (), 3.0),
    ("odd_7x13", (7, 13), 1e-3),
    ("confmat_33x33", (33, 33), 1e4),
    ("tiny", (300,), 1e-35),
    ("huge", (257,), 1e30),
    ("half_zero_blocks", (640,), 5.0),
    ("ties_at_half_steps", (384,), None),
]


def _codec_input(shape, scale):
    if scale is None:  # values exactly half a step apart: round-half-even decides
        x = (np.arange(int(np.prod(shape))) % 255 - 127).astype(np.float32) + 0.5
        x[::128] = 127.0  # each block's absmax fixes the scale at 1
        return x.reshape(shape)
    x = np.asarray(_RNG.randn(*shape) * scale, dtype=np.float32)
    if x.size >= 640:
        x.reshape(-1)[256:512] = 0.0  # two all-zero blocks: scale 1, no 0/0
    return x


@pytest.mark.parametrize("name,shape,scale", CODEC_CASES, ids=[c[0] for c in CODEC_CASES])
def test_int8_codes_and_scales_bit_equal_to_jax(name, shape, scale):
    x = _codec_input(shape, scale)
    jc, js = jq.quantize_block_scaled(jnp.asarray(x))
    tc, ts = q.quantize_block_scaled(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(_bits(ts), _bits(np.asarray(js)))
    back_j = jq.dequantize_block_scaled(jc, js, x.shape)
    back_t = q.dequantize_block_scaled(tc, ts, x.shape)
    np.testing.assert_array_equal(_bits(back_t), _bits(np.asarray(back_j)))


def test_subnormal_blocks_keep_their_values_where_xla_cpu_flushes_them():
    """A block whose values are subnormal (below 2^-126): the port divides
    by a subnormal scale and keeps the block within half a step, as IEEE
    arithmetic (and the card) does; XLA's CPU backend flushes subnormals to
    zero, so the JAX package syncs such a block as zeros. A deliberate
    difference, and the only codec input where the bits part."""
    x = np.asarray(_RNG.randn(300) * 1e-39, dtype=np.float32)
    codes, scales = q.quantize_block_scaled(torch.from_numpy(x))
    back = q.dequantize_block_scaled(codes, scales, x.shape).numpy()
    assert np.abs(codes.numpy()).max() == 127
    blocks = np.pad(x, (0, 84)).reshape(-1, q.DEFAULT_BLOCK_SIZE)
    bound = np.repeat(np.abs(blocks).max(axis=1) / 254.0, q.DEFAULT_BLOCK_SIZE)[:300]
    assert np.all(np.abs(back - x) <= bound + 2e-45)
    jc, _ = jq.quantize_block_scaled(jnp.asarray(x))
    assert not np.asarray(jc).any()


@pytest.mark.parametrize("name,shape,scale", CODEC_CASES, ids=[c[0] for c in CODEC_CASES])
def test_bf16_payload_bit_equal_to_jax(name, shape, scale):
    x = _codec_input(shape, scale)
    jp = jq.quantize_payload(jnp.asarray(x), "bf16")
    tp = q.quantize_payload(torch.from_numpy(x), "bf16")
    assert set(tp) == set(jp) == {"q"} and tp["q"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(tp["q"]), _bits(np.asarray(jp["q"])))
    np.testing.assert_array_equal(
        _bits(q.dequantize_payload(tp, x.shape)), _bits(np.asarray(jq.dequantize_payload(jp, x.shape)))
    )
    assert q.payload_wire_nbytes(tp) == jq.payload_wire_nbytes(jp)


@pytest.mark.parametrize("precision", ["int8", "bf16"])
@pytest.mark.parametrize("with_residual", [False, True], ids=["fresh", "residual"])
def test_compensate_and_quantize_bit_equal_to_jax(precision, with_residual):
    x = (_RNG.rand(700) * 7).astype(np.float32)
    r = (_RNG.randn(700) * 0.01).astype(np.float32) if with_residual else None
    jp, jr = jq.compensate_and_quantize(jnp.asarray(x), None if r is None else jnp.asarray(r), precision)
    tp, tr = q.compensate_and_quantize(torch.from_numpy(x), None if r is None else torch.from_numpy(r), precision)
    assert set(tp) == set(jp)
    for k in tp:
        np.testing.assert_array_equal(_bits(tp[k]), _bits(np.asarray(jp[k])))
    np.testing.assert_array_equal(_bits(tr), _bits(np.asarray(jr)))
    assert q.payload_wire_nbytes(tp) == jq.payload_wire_nbytes(jp)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("precision", ["int8", "bf16"])
def test_merge_dequantized_bit_equal_to_jax(dtype, precision):
    """Four ranks' payloads merged in rank order, integer states re-rounded
    (half to even) onto their lattice."""
    rows = [(_RNG.rand(300) * 100).astype(dtype) for _ in range(4)]
    jpay = [jq.quantize_payload(jnp.asarray(r), precision) for r in rows]
    tpay = [q.quantize_payload(torch.from_numpy(r), precision) for r in rows]
    jm = jq.merge_dequantized(jpay, (300,), jnp.dtype(dtype))
    tm = q.merge_dequantized(tpay, (300,), getattr(torch, dtype))
    assert str(tm.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(_bits(tm), _bits(np.asarray(jm)))


# ----------------------------------------------------------------------
# codec numerics (tests/parallel/test_quantize.py)
# ----------------------------------------------------------------------
def test_int8_roundtrip_error_within_half_step_per_block():
    x = torch.from_numpy(_RNG.randn(1000).astype(np.float32) * 10)
    codes, scales = q.quantize_block_scaled(x)
    back = q.dequantize_block_scaled(codes, scales, x.shape)
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    assert back.shape == x.shape
    blocks = np.pad(x.numpy(), (0, 24)).reshape(-1, q.DEFAULT_BLOCK_SIZE)
    bound = np.repeat(np.abs(blocks).max(axis=1) / 254.0, q.DEFAULT_BLOCK_SIZE)[:1000]
    assert np.all(np.abs((back - x).numpy()) <= bound + 1e-7)


def test_outlier_cost_is_confined_to_its_block():
    x = np.ones(4 * q.DEFAULT_BLOCK_SIZE, np.float32)
    x[0] = 1e4
    back = q.dequantize_block_scaled(*q.quantize_block_scaled(torch.from_numpy(x)), x.shape).numpy()
    assert np.abs(back[q.DEFAULT_BLOCK_SIZE:] - 1.0).max() <= 1.0 / 254.0 + 1e-7


def test_all_zero_block_roundtrips_exactly():
    x = torch.zeros(300)
    codes, scales = q.quantize_block_scaled(x)
    assert torch.all(scales == 1.0)
    assert torch.equal(q.dequantize_block_scaled(codes, scales, x.shape), torch.zeros(300))


def test_padding_dropped_on_dequantize():
    x = torch.from_numpy(_RNG.rand(7, 13).astype(np.float32))
    assert q.dequantize_payload(q.quantize_payload(x, "int8"), x.shape).shape == (7, 13)


def test_wire_bytes_int8_hits_compression_floor():
    x = torch.from_numpy(_RNG.rand(512).astype(np.float32))
    wire = q.payload_wire_nbytes(q.quantize_payload(x, "int8"))
    assert wire == 512 + 4 * 4
    assert x.numel() * 4 / wire >= 3.0


def test_wire_bytes_bf16_is_half():
    x = torch.from_numpy(_RNG.rand(512).astype(np.float32))
    assert q.payload_wire_nbytes(q.quantize_payload(x, "bf16")) == 512 * 2


def test_invalid_precision_rejected():
    x = torch.ones(8)
    with pytest.raises(ValueError, match="sync_precision"):
        q.quantize_payload(x, "fp8")
    with pytest.raises(ValueError, match="exact"):
        q.quantize_payload(x, "exact")
    with pytest.raises(ValueError, match="exact"):
        q.quantized_sum_reduction("exact")


def test_error_feedback_cancels_drift_over_repeated_syncs():
    """Syncing the same state many times, the time-averaged signed error of
    the reported values tends to zero, while residual-free quantization
    repeats the same biased error every round; every round's residual is
    JAX's, bit for bit."""
    xn = (_RNG.rand(640) * 3).astype(np.float32)
    x = torch.from_numpy(xn)
    naive_bias = (q.dequantize_payload(q.quantize_payload(x, "int8"), x.shape) - x).numpy()
    res, jres = torch.zeros_like(x), jnp.zeros(640, jnp.float32)
    reported = []
    for _ in range(32):
        payload, res = q.compensate_and_quantize(x, res, "int8")
        _, jres = jq.compensate_and_quantize(jnp.asarray(xn), jres, "int8")
        np.testing.assert_array_equal(_bits(res), _bits(np.asarray(jres)))
        reported.append(q.dequantize_payload(payload, x.shape).numpy())
    ef_bias = np.mean([r - xn for r in reported], axis=0)
    assert np.abs(ef_bias).max() < np.abs(naive_bias).max() / 4
    assert float(res.abs().max()) <= float(x.abs().max()) / 127.0 + 1e-6


def test_compensate_without_residual_returns_fresh_error():
    x = torch.from_numpy(_RNG.rand(64).astype(np.float32))
    payload, new_res = q.compensate_and_quantize(x, None, "int8")
    back = q.dequantize_payload(payload, x.shape)
    np.testing.assert_allclose(new_res.numpy(), (x - back).numpy(), atol=1e-7)


@pytest.mark.parametrize("precision", ["int8", "bf16"])
def test_quantized_sum_reduction_is_commutative_and_magnitude_preserving(precision):
    red = q.quantized_sum_reduction(precision)
    assert red.quantized_precision == precision and red.block_scaled
    assert red.__name__ == jq.quantized_sum_reduction(precision).__name__
    an = (_RNG.rand(2, 200) * 5).astype(np.float32)
    a = torch.from_numpy(an)
    fwd, rev = red(a).numpy(), red(a.flip(0)).numpy()
    np.testing.assert_array_equal(fwd, rev)
    np.testing.assert_array_equal(_bits(red(a)), _bits(np.asarray(jq.quantized_sum_reduction(precision)(jnp.asarray(an)))))
    bound = 2 * float(a.abs().max()) / (254.0 if precision == "int8" else 2.0**8)
    assert np.abs(fwd - (an[0] + an[1])).max() <= bound + 1e-6


# ----------------------------------------------------------------------
# the collectives in a virtual world of 8 against JAX's shard_map programs
#
# JAX's collective runs inside one XLA program that fuses the codec with the
# merge; that program's sum differs from JAX's own host-path codec (eager
# ``quantize_payload`` + ``merge_dequantized``, what ``Metric._sync_dist``
# runs) in the last bits. The port's collective equals the host path bit for
# bit, and the program within the documented bound.
# ----------------------------------------------------------------------
def _mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ("data",))


def _jax_qsync(x, precision, with_residual=False):
    def step(v):
        local = jnp.sum(v, axis=0)
        if with_residual:
            return jax_qsync_sum(local, precision, "data", residual=jnp.zeros_like(local))
        return jax_qsync_sum(local, precision, "data")

    prog = jax.jit(tpu_shard_map(step, mesh=_mesh(), in_specs=P("data"), out_specs=P(), check_vma=False))
    return jax.tree_util.tree_map(np.asarray, prog(jnp.asarray(x)))


def _jax_host_merge(x, precision, residual=None):
    """JAX's host-path codec on the per-device partials of ``x``: each rank's
    payload made eagerly and merged in rank order (``merge_dequantized``)."""
    parts = x.reshape(WORLD, -1, *x.shape[1:]).sum(1)
    payloads = [jq.quantize_payload(jnp.asarray(p), precision) for p in parts]
    return np.asarray(jq.merge_dequantized(payloads, parts.shape[1:], jnp.dtype(x.dtype)))


def _port_world(x, fn):
    """Run ``fn(local_partial)`` on every rank of a virtual world of 8, rank r
    holding the sum of its block of ``x``'s rows; returns {rank: result}."""
    per = x.shape[0] // WORLD
    out = {}

    def worker(rank, world):
        local = torch.from_numpy(x[rank * per:(rank + 1) * per]).sum(0)
        out[rank] = fn(local)

    run_virtual_ddp(WORLD, worker)
    return out


@pytest.mark.parametrize("precision", ["int8", "bf16"])
def test_qsync_sum_approximates_the_sum_and_equals_jax(precision):
    x = _RNG.rand(WORLD * 64, 512).astype(np.float32)
    ranks = _port_world(x, lambda local: qsync_sum(local, precision).numpy())
    exact = x.sum(axis=0)
    per_dev = np.abs(x).sum(axis=0).max() / (254.0 if precision == "int8" else 2.0**8)
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r], ranks[0])
    assert np.abs(ranks[0] - exact).max() <= WORLD * per_dev
    assert not np.array_equal(ranks[0], exact)
    # grid-valued rows: every per-device sum is exact, so the codes, the
    # rank-order merge and the result are the JAX host path's bits
    g = _grid((WORLD * 64, 512))
    port = _port_world(g, lambda local: qsync_sum(local, precision).numpy())[0]
    np.testing.assert_array_equal(_bits(port), _bits(_jax_host_merge(g, precision)))
    np.testing.assert_allclose(port, _jax_qsync(g, precision), rtol=0, atol=WORLD * per_dev)


def test_qsync_sum_exact_precision_is_the_plain_sum():
    x = _RNG.rand(WORLD * 8, 64).astype(np.float32)
    ranks = _port_world(x, lambda local: (qsync_sum(local, "exact").numpy(), sync_array(local, "sum").numpy()))
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r][0], ranks[r][1])
        np.testing.assert_array_equal(ranks[r][0], ranks[0][0])
    jax_ref = np.asarray(jax.jit(tpu_shard_map(
        lambda v: jax_sync_array(jnp.sum(v, axis=0), "sum", "data"),
        mesh=_mesh(), in_specs=P("data"), out_specs=P(), check_vma=False))(jnp.asarray(x)))
    np.testing.assert_allclose(ranks[0][0], jax_ref, rtol=1e-6)
    g = _grid((WORLD * 8, 64))
    ranks = _port_world(g, lambda local: qsync_sum(local, "exact").numpy())
    np.testing.assert_array_equal(ranks[0], g.sum(0))


def test_qsync_sum_integer_state_stays_integral_and_equals_jax():
    x = _RNG.randint(0, 50, size=(WORLD * 16, 128)).astype(np.int32)
    ranks = _port_world(x, lambda local: qsync_sum(local.to(torch.int32), "int8"))
    assert ranks[0].dtype == torch.int32
    np.testing.assert_array_equal(ranks[0].numpy(), _jax_host_merge(x, "int8"))
    assert _jax_qsync(x, "int8").dtype == np.int32


def test_qsync_sum_residual_threading_equals_jax():
    g = _grid((WORLD * 4, 256))
    ranks = _port_world(g, lambda local: qsync_sum(local, "int8", residual=torch.zeros_like(local)))
    synced, new_res = ranks[0]
    assert synced.shape == (256,) and new_res.shape == (256,)
    assert float(new_res.abs().max()) > 0
    np.testing.assert_array_equal(_bits(synced), _bits(_jax_host_merge(g, "int8")))
    _, j_res = jq.compensate_and_quantize(jnp.asarray(g[:4].sum(0)), jnp.zeros(256, jnp.float32), "int8")
    np.testing.assert_array_equal(_bits(new_res), _bits(np.asarray(j_res)))
    j_synced, _ = _jax_qsync(g, "int8", with_residual=True)
    bound = WORLD * float(np.abs(g.reshape(WORLD, 4, 256).sum(1)).max()) / 254.0
    np.testing.assert_allclose(synced.numpy(), j_synced, rtol=0, atol=bound)


def test_qsync_state_routes_precisions_per_state():
    x = _RNG.rand(WORLD * 8, 128).astype(np.float32)

    def fn(local):
        synced, residuals = qsync_state(
            {"hist": local, "count": torch.tensor(float(local.numel() * 8))},
            {"hist": "sum", "count": "sum"},
            {"hist": "int8"},
        )
        return synced["hist"], synced["count"], residuals["hist"]

    hist, count, res = _port_world(x, fn)[0]
    assert float(count) == x.shape[0] * x.shape[1]
    assert np.abs(hist.numpy() - x.sum(0)).max() < 0.5
    assert res.shape == (128,)


def test_qsync_state_rejects_non_sum_reduction_on_quantized_state():
    with pytest.raises(ValueError, match="requires a 'sum' reduction"):
        qsync_state({"v": torch.ones(4)}, {"v": "max"}, {"v": "int8"})


@pytest.mark.parametrize("reduction", ["sum", "mean", "min", "max", "cat", None])
def test_sync_array_reductions_equal_jax(reduction):
    """Every reduction spec on grid-valued rows (exact in any order): the
    world's result equals JAX's ``sync_array`` under ``shard_map``."""
    g = _grid((WORLD * 2, 24))

    def port(local):
        return sync_array(local, reduction).numpy()

    got = _port_world(g, port)
    out_specs = P() if reduction != "cat" else P()
    want = np.asarray(jax.jit(tpu_shard_map(
        lambda v: jax_sync_array(jnp.sum(v, axis=0), reduction, "data"),
        mesh=_mesh(), in_specs=P("data"), out_specs=out_specs, check_vma=False))(jnp.asarray(g)))
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r], want)


def test_sync_state_defaults_to_sum_and_maps_nested_values():
    g = _grid((WORLD, 6))

    def port(local):
        out = sync_state({"total": local, "pair": (local, local * 2)}, {"pair": "max"})
        return out["total"].numpy(), [v.numpy() for v in out["pair"]]

    got = _port_world(g, port)[3]
    np.testing.assert_array_equal(got[0], g.sum(0))
    np.testing.assert_array_equal(got[1][0], g.max(0))
    np.testing.assert_array_equal(got[1][1], 2 * g.max(0))
    with pytest.raises(ValueError, match="reduction"):
        sync_array(torch.ones(2), "median")


# ----------------------------------------------------------------------
# wire bytes against logical bytes: the counters equal JAX's in a world of one
# ----------------------------------------------------------------------
def _counters(tel):
    return {k: v for k, v in tel.counters.items() if k.startswith("collective.")}


def _one_device_program(step):
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    return jax.jit(tpu_shard_map(step, mesh=mesh, in_specs=P("data"), out_specs=P(), check_vma=False))


def test_wire_bytes_counted_separately_from_logical_bytes():
    x = _RNG.rand(1, 512).astype(np.float32)
    with jobs.telemetry_scope() as jtel:
        np.asarray(_one_device_program(lambda v: jax_qsync_sum(jnp.sum(v, axis=0), "int8", "data"))(jnp.asarray(x)))
    with obs.telemetry_scope() as tel:
        qsync_sum(torch.from_numpy(x).sum(0), "int8")
    c = tel.counters
    assert _counters(tel) == _counters(jtel)
    assert c["collective.qsum_int8"] == 1
    assert c["collective.payload_bytes"] == 512 * 4
    assert c["collective.wire_bytes"] == 512 + 4 * 4
    assert c["collective.payload_bytes"] / c["collective.wire_bytes"] >= 3.0
    assert tel.snapshot()["histograms"]["collective.wire_bytes"] == jtel.snapshot()["histograms"]["collective.wire_bytes"]


def test_exact_path_wire_equals_logical_and_keeps_old_key():
    with jobs.telemetry_scope() as jtel:
        np.asarray(_one_device_program(lambda v: jax_sync_array(jnp.sum(v, axis=0), "sum", "data"))(
            jnp.ones((1, 256), jnp.float32)))
    with obs.telemetry_scope() as tel:
        sync_array(torch.ones(256), "sum")
    assert _counters(tel) == _counters(jtel)
    assert tel.counters["collective.payload_bytes"] == 256 * 4
    assert tel.counters["collective.wire_bytes"] == tel.counters["collective.payload_bytes"]


def test_sync_state_counts_one_collective_per_state_like_jax():
    """``tests/bases/test_telemetry.py::test_collective_counters_record_at_trace_time``
    in a world of one: one ``collective.sum`` per state per sync. JAX counts
    it once per trace (its second call replays the program); the port counts
    every executed collective, so a second call counts again."""
    x = np.arange(16, dtype=np.float32)
    with jobs.telemetry_scope() as jtel:
        prog = _one_device_program(lambda v: jax_sync_state({"total": v}, {"total": "sum"}, "data")["total"])
        prog(jnp.asarray(x))
        prog(jnp.asarray(x))
    with obs.telemetry_scope() as tel:
        sync_state({"total": torch.from_numpy(x)}, {"total": "sum"})
        assert _counters(tel) == _counters(jtel)
        sync_state({"total": torch.from_numpy(x)}, {"total": "sum"})
        assert tel.counters["collective.sum"] == 2 * jtel.counters["collective.sum"] == 2
