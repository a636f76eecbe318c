"""The port's checkpoint envelope against the JAX package's, on the CPU.

Every case of ``tests/reliability/test_checkpoint_envelope.py`` and of
``tests/reliability/test_roundtrips.py`` is mirrored: the same seeded numpy
inputs fill the JAX metric and its port, and the port's envelope must behave
as JAX's does (typed rejections, strict spec checks, list, scalar and bf16
states through a file, atomic writes, torn files) and carry the same header:
format, schema version, metric type, completeness, spec and checksum string.
Beyond those, the two packages' envelopes cross both ways, through a file
and through ``envelope_to_bytes``, with strict validation: int32, float32,
bfloat16 and list ("cat") states and a session cursor; and a cohort's
envelope (its int8 slot table included) round-trips.

Integer inputs are fed as int32: the JAX package (x64 off) holds them so,
and the port keeps the dtype it is given, so a list state of int64 targets
would carry another spec (a strict load pins no list dtype, so such an
envelope still crosses).

Tolerance: none. States, checksums and cursors are bit-equal; the values
computed from loaded states equal those computed from the saved ones (the
same float32 operations on the same bits). Port values are compared with
JAX's within rtol 1e-5 where the two packages compute them (their own float
sums in other orders).
"""
import io
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as jm
import metrics_tpu.observability as jobs
import metrics_tpu_torch as tm
import metrics_tpu_torch.observability as obs
from metrics_tpu import reliability as jrel
from metrics_tpu.reliability import faultinject as jfi
from metrics_tpu_torch import reliability as rel
from metrics_tpu_torch.reliability import (
    CheckpointCorruptionError,
    CheckpointMismatchError,
    CheckpointSchemaError,
    load_envelope,
    read_envelope,
    save_envelope,
    write_envelope,
)
from metrics_tpu_torch.reliability import faultinject as fi
from metrics_tpu_torch.reliability.checkpoint import (
    ENVELOPE_FORMAT,
    SCHEMA_VERSION,
    envelope_from_bytes,
    envelope_to_bytes,
)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _pristine():
    def clean():
        for pkg in (jobs, obs):
            pkg.disable()
            pkg.get().reset()
            pkg.disable_flight()
        rel.uninstall_guard()
        jrel.uninstall_guard()

    clean()
    yield
    clean()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy() if x.dtype == torch.bfloat16 else x.detach().cpu().numpy()
    return np.asarray(x)


def _header(env):
    return {k: v for k, v in env.items() if k != "payload"}


def _cls(seed=0, n=48, c=4):
    rng = np.random.RandomState(seed)
    probs = rng.rand(n, c).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    return probs, rng.randint(c, size=n).astype(np.int32)


def _acc(seed=0):
    """A filled Accuracy of each package on the same batch: (port, jax)."""
    p, t = _cls(seed)
    m, j = tm.Accuracy(device=CPU), jm.Accuracy()
    m.update(torch.from_numpy(p), torch.from_numpy(t))
    j.update(jnp.asarray(p), jnp.asarray(t))
    return m, j


def test_envelope_structure_and_roundtrip():
    m, j = _acc()
    env, jenv = save_envelope(m), jrel.save_envelope(j)
    assert env["format"] == ENVELOPE_FORMAT == jenv["format"]
    assert env["schema_version"] == SCHEMA_VERSION == jenv["schema_version"]
    assert env["metric_type"] == "Accuracy" and env["complete"] is True
    assert set(env["spec"]) == set(env["payload"]) == {"correct", "total"}
    assert env["checksum"].startswith("crc32:")
    assert _header(env) == _header(jenv)  # same spec, same checksum
    m2 = tm.Accuracy(device=CPU)
    load_envelope(m2, env, strict=True)
    assert float(m2.compute()) == float(m.compute()) == pytest.approx(float(j.compute()), rel=1e-6)


def test_persistent_only_envelope_wraps_state_dict():
    m, _ = _acc()
    m.persistent(True)
    env = save_envelope(m, persistent_only=True)
    assert set(env["payload"]) == set(m.state_dict())
    m.persistent(False)
    env_empty = save_envelope(m, persistent_only=True)
    assert env_empty["payload"] == {} and env_empty["complete"] is False


@pytest.mark.parametrize(
    "mode,exc",
    [
        ("payload", CheckpointCorruptionError),
        ("checksum", CheckpointCorruptionError),
        ("schema", CheckpointSchemaError),
        ("truncate", CheckpointMismatchError),
    ],
)
def test_corrupted_envelopes_rejected_with_typed_errors(mode, exc):
    m, j = _acc()
    env = save_envelope(m)
    bad = fi.corrupt_envelope(env, mode)
    jbad = jfi.corrupt_envelope(jrel.save_envelope(j), mode)
    assert _header(bad) == _header(jbad)  # the same damage as JAX's injector
    with obs.telemetry_scope():
        with pytest.raises(exc):
            load_envelope(tm.Accuracy(device=CPU), bad, strict=True)
        assert obs.get().counters["reliability.checkpoint_rejects"] == 1
        assert any(e["kind"] == "checkpoint_reject" for e in obs.get().events)
    load_envelope(tm.Accuracy(device=CPU), env, strict=True)  # the original still loads


def test_rejection_leaves_state_untouched():
    donor = save_envelope(_acc(seed=1)[0])
    m = _acc(seed=2)[0]
    before = float(m.compute())
    with pytest.raises(CheckpointCorruptionError):
        load_envelope(m, fi.corrupt_envelope(donor, "payload"), strict=True)
    assert float(m.compute()) == before


def test_not_an_envelope_and_future_schema_rejected():
    with pytest.raises(CheckpointSchemaError, match="not a metrics_tpu"):
        load_envelope(tm.Accuracy(device=CPU), {"some": "dict"}, strict=True)
    env = save_envelope(_acc()[0])
    with pytest.raises(CheckpointSchemaError, match="schema_version"):
        load_envelope(tm.Accuracy(device=CPU), dict(env, schema_version=SCHEMA_VERSION + 1), strict=True)


def test_strict_rejects_differently_configured_metric():
    env = save_envelope(_acc()[0])
    with pytest.raises(CheckpointMismatchError, match="missing|unexpected"):
        load_envelope(tm.MeanSquaredError(device=CPU), env, strict=True)


def test_strict_rejects_shape_drift():
    rng = np.random.RandomState(0)
    p, t = rng.rand(64).astype(np.float32), rng.randint(2, size=64)
    m = tm.BinnedAUROC(num_bins=32, device=CPU)
    m.update(torch.from_numpy(p), torch.from_numpy(t))
    j = jm.BinnedAUROC(num_bins=32)
    j.update(jnp.asarray(p), jnp.asarray(t))
    env = save_envelope(m)
    assert _header(env) == _header(jrel.save_envelope(j))
    other = tm.BinnedAUROC(num_bins=16, device=CPU)
    with pytest.raises(CheckpointMismatchError, match="shape"):
        load_envelope(other, env, strict=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        load_envelope(other, env, strict=False)
    assert any("skipped" in str(w.message) for w in caught)


def test_nonstrict_loads_valid_intersection():
    m = _acc(seed=3)[0]
    env = fi.corrupt_envelope(save_envelope(m), "truncate")
    m2 = tm.Accuracy(device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        load_envelope(m2, env, strict=False)
    kept = sorted(env["payload"])
    assert kept
    for key in kept:
        assert torch.equal(getattr(m2, key), getattr(m, key))


def test_collection_envelope_roundtrip_with_list_states(tmp_path):
    rng = np.random.RandomState(4)
    p, t = rng.rand(64).astype(np.float32), rng.randint(2, size=64).astype(np.int32)
    col = tm.MetricCollection([tm.Accuracy(device=CPU), tm.AUROC(device=CPU)])
    col.update(torch.from_numpy(p), torch.from_numpy(t))
    jcol = jm.MetricCollection([jm.Accuracy(), jm.AUROC()])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcol.update(jnp.asarray(p), jnp.asarray(t))
    env = save_envelope(col)
    assert env["metric_type"] == "MetricCollection"
    assert any(k.startswith("AUROC.") for k in env["payload"])
    assert _header(env) == _header(jrel.save_envelope(jcol))
    path = tmp_path / "collection.npz"
    write_envelope(path, env)
    col2 = tm.MetricCollection([tm.Accuracy(device=CPU), tm.AUROC(device=CPU)])
    load_envelope(col2, read_envelope(path), strict=True)
    a, b = col.compute(), col2.compute()
    for k in a:
        assert float(a[k]) == float(b[k])


def test_file_roundtrip_preserves_bf16_and_scalars(tmp_path):
    rng = np.random.RandomState(5)
    p, t = rng.rand(64).astype(np.float32), rng.randint(2, size=64)
    m = tm.BinnedAUROC(num_bins=16, device=CPU)
    m.update(torch.from_numpy(p), torch.from_numpy(t))
    m.astype(torch.bfloat16)
    j = jm.BinnedAUROC(num_bins=16)
    j.update(jnp.asarray(p), jnp.asarray(t))
    j.astype(jnp.bfloat16)
    env = save_envelope(m)
    assert env["spec"]["hist_pos"]["dtype"] == "bfloat16"
    assert _header(env) == _header(jrel.save_envelope(j))
    path = tmp_path / "bf16.npz"
    write_envelope(path, env)
    m2 = tm.BinnedAUROC(num_bins=16, device=CPU).astype(torch.bfloat16)
    load_envelope(m2, read_envelope(path), strict=True)
    assert m2.hist_pos.dtype == torch.bfloat16
    assert float(m2.compute()) == float(m.compute())
    acc = _acc()[0]
    p2 = tmp_path / "acc.npz"
    write_envelope(p2, save_envelope(acc))
    assert read_envelope(p2)["spec"]["correct"]["shape"] == []


def test_envelope_is_isolated_from_later_updates(tmp_path):
    rng = np.random.RandomState(11)
    p, t = torch.from_numpy(rng.rand(32).astype(np.float32)), torch.from_numpy(rng.randint(2, size=32))
    m = tm.AUROC(device=CPU)
    m.update(p, t)
    env = save_envelope(m)
    want = float(m.compute())
    m.update(torch.flip(p, (0,)), t)  # appends to the live lists after the save
    m2 = tm.AUROC(device=CPU)
    load_envelope(m2, env, strict=True)
    assert len(m2.preds) == 1 and float(m2.compute()) == want
    path = tmp_path / "iso.npz"
    write_envelope(path, env)
    m3 = tm.AUROC(device=CPU)
    load_envelope(m3, read_envelope(path), strict=True)
    assert float(m3.compute()) == want


def test_empty_list_state_envelope_file_roundtrip(tmp_path):
    m = tm.AUROC(device=CPU)
    env = save_envelope(m)
    assert _header(env) == _header(jrel.save_envelope(jm.AUROC()))
    path = tmp_path / "fresh.npz"
    write_envelope(path, env)
    restored = read_envelope(path)
    assert restored["payload"]["preds"] == []
    m2 = tm.AUROC(device=CPU)
    load_envelope(m2, restored, strict=True)
    assert m2.preds == [] and m2.target == []


def test_collection_strict_load_tolerates_sibling_prefixes():
    p, t = _cls(9, n=16)
    col_a = tm.MetricCollection([tm.Accuracy(device=CPU)])
    col_b = tm.MetricCollection([tm.Accuracy(device=CPU)])
    for col in (col_a, col_b):
        col.update(torch.from_numpy(p), torch.from_numpy(t))
        col.persistent(True)
    shared = {}
    col_a.state_dict(shared, prefix="a.")
    col_b.state_dict(shared, prefix="b.")
    fresh = tm.MetricCollection([tm.Accuracy(device=CPU)])
    fresh.load_state_dict(shared, prefix="a.", strict=True)
    assert float(fresh.compute()["Accuracy"]) == float(col_a.compute()["Accuracy"])
    with pytest.raises(KeyError, match="no member"):
        fresh.load_state_dict({**shared, "a.Ghost.x": torch.tensor(0)}, prefix="a.", strict=True)


def test_file_corruption_detected(tmp_path):
    path = tmp_path / "ckpt.npz"
    write_envelope(path, save_envelope(_acc()[0]))
    blob = bytearray(path.read_bytes())
    blob[-20] ^= 0xFF
    path.write_bytes(bytes(blob))
    with pytest.raises((CheckpointCorruptionError, CheckpointSchemaError, Exception)):
        load_envelope(tm.Accuracy(device=CPU), read_envelope(path), strict=True)


def test_compositional_metric_envelope_roundtrip():
    (m1, j1), (m2, j2) = _acc(seed=6), _acc(seed=7)
    comp = m1 + m2
    env = save_envelope(comp)
    assert any(k.startswith("metric_a.") for k in env["payload"])
    assert _header(env) == _header(jrel.save_envelope(j1 + j2))
    comp2 = tm.Accuracy(device=CPU) + tm.Accuracy(device=CPU)
    load_envelope(comp2, env, strict=True)
    assert float(comp.compute()) == float(comp2.compute())


def test_load_state_dict_strict_and_zero_match_warn():
    m = _acc(seed=8)[0]
    m.persistent(True)
    sd = m.state_dict()
    fresh = tm.Accuracy(device=CPU)
    with pytest.raises(KeyError, match="missing"):
        fresh.load_state_dict(sd, prefix="typo.", strict=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fresh.load_state_dict(sd, prefix="typo.")
    assert any("matched" in str(w.message) for w in caught)
    col = tm.MetricCollection([tm.Accuracy(device=CPU)])
    with pytest.raises(KeyError, match="no member"):
        col.load_state_dict({"NotAMember.correct": torch.tensor(0)}, strict=True)


def test_write_envelope_is_atomic_on_crash(tmp_path, monkeypatch):
    path = tmp_path / "ckpt.npz"
    write_envelope(path, save_envelope(_acc(seed=1)[0]))
    before = path.read_bytes()
    real_savez = np.savez

    def dying_savez(f, **arrays):
        buf = io.BytesIO()
        real_savez(buf, **arrays)
        f.write(buf.getvalue()[: buf.tell() // 2])
        raise OSError("simulated crash mid-write")

    monkeypatch.setattr(np, "savez", dying_savez)
    with pytest.raises(OSError, match="mid-write"):
        write_envelope(path, save_envelope(_acc(seed=2)[0]))
    monkeypatch.undo()
    assert path.read_bytes() == before
    assert not (tmp_path / "ckpt.npz.tmp").exists()
    load_envelope(tm.Accuracy(device=CPU), read_envelope(path), strict=True)


def test_atomic_file_fresh_target_crash_leaves_nothing(tmp_path):
    path = tmp_path / "new.bin"
    with pytest.raises(RuntimeError):
        with rel.atomic_file(path) as f:
            f.write(b"partial")
            raise RuntimeError("boom")
    assert not path.exists() and not (tmp_path / "new.bin.tmp").exists()


def test_truncate_injector_against_a_real_file(tmp_path):
    path = tmp_path / "trunc.npz"
    write_envelope(path, fi.corrupt_envelope(save_envelope(_acc(seed=3)[0]), "truncate"))
    with pytest.raises(CheckpointMismatchError, match="missing keys"):
        load_envelope(tm.Accuracy(device=CPU), read_envelope(path), strict=True)


def test_torn_file_raises_typed_corruption_error(tmp_path):
    path = tmp_path / "torn.npz"
    write_envelope(path, save_envelope(_acc(seed=4)[0]))
    fi.torn_write(path, keep_fraction=0.4)
    with obs.telemetry_scope():
        with pytest.raises(CheckpointCorruptionError, match="unreadable|truncat"):
            read_envelope(path)
        assert obs.get().counters["reliability.checkpoint_rejects"] == 1
    with pytest.raises(ValueError, match="keep_fraction"):
        fi.torn_write(path, keep_fraction=1.5)


def test_missing_file_stays_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        read_envelope(tmp_path / "never_written.npz")


def test_loaded_states_are_device_owned(tmp_path):
    """States loaded from an envelope are copies the metric owns, never
    views of the decoded payload."""
    path = tmp_path / "ckpt.npz"
    m = tm.MeanSquaredError(device=CPU)
    x = torch.from_numpy(np.random.RandomState(0).rand(64).astype(np.float32))
    m.update(x, x * 0.5)
    write_envelope(path, save_envelope(m))
    env = read_envelope(path)
    fresh = tm.MeanSquaredError(device=CPU)
    load_envelope(fresh, env, strict=True)
    hosts = [v.ctypes.data for v in env["payload"].values() if isinstance(v, np.ndarray) and v.size]
    for sname in fresh._defaults:
        assert getattr(fresh, sname).data_ptr() not in hosts


# ----------------------------------------------------------------------
# the two packages' envelopes, both ways
# ----------------------------------------------------------------------
def _cross_pair(kind):
    """(port object, JAX object) holding the same state of ``kind``."""
    rng = np.random.RandomState(21)
    if kind == "int32":  # ConfusionMatrix: an int32 matrix
        p, t = _cls(21)
        m, j = tm.ConfusionMatrix(num_classes=4, device=CPU), jm.ConfusionMatrix(num_classes=4)
        m.update(torch.from_numpy(p), torch.from_numpy(t))
        j.update(jnp.asarray(p), jnp.asarray(t))
    elif kind in ("float32", "bfloat16"):
        p, t = rng.rand(64).astype(np.float32), rng.randint(2, size=64)
        m, j = tm.BinnedAUROC(num_bins=16, device=CPU), jm.BinnedAUROC(num_bins=16)
        m.update(torch.from_numpy(p), torch.from_numpy(t))
        j.update(jnp.asarray(p), jnp.asarray(t))
        if kind == "bfloat16":
            m.astype(torch.bfloat16)
            j.astype(jnp.bfloat16)
    elif kind == "list":
        m, j = tm.AUROC(device=CPU), jm.AUROC()
        for _ in range(2):
            p, t = rng.rand(32).astype(np.float32), rng.randint(2, size=32).astype(np.int32)
            m.update(torch.from_numpy(p), torch.from_numpy(t))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                j.update(jnp.asarray(p), jnp.asarray(t))
    else:  # "cursor": a session-enrolled collection (float32 and int32 counts)
        p, t = _cls(22)
        m = tm.MetricCollection([tm.Accuracy(device=CPU), tm.ConfusionMatrix(num_classes=4, device=CPU)])
        j = jm.MetricCollection([jm.Accuracy(), jm.ConfusionMatrix(num_classes=4)])
        m.update(torch.from_numpy(p), torch.from_numpy(t))
        j.update(jnp.asarray(p), jnp.asarray(t))
        m._session_cursor = j._session_cursor = 7
    return m, j


def _fresh(kind):
    return _cross_pair(kind) if kind == "cursor" else {
        "int32": lambda: (tm.ConfusionMatrix(num_classes=4, device=CPU), jm.ConfusionMatrix(num_classes=4)),
        "float32": lambda: (tm.BinnedAUROC(num_bins=16, device=CPU), jm.BinnedAUROC(num_bins=16)),
        "bfloat16": lambda: (tm.BinnedAUROC(num_bins=16, device=CPU).astype(torch.bfloat16),
                             jm.BinnedAUROC(num_bins=16).astype(jnp.bfloat16)),
        "list": lambda: (tm.AUROC(device=CPU), jm.AUROC()),
    }[kind]()


def _states(obj):
    return {k: ([_np(x) for x in v] if isinstance(v, list) else _np(v)) for k, v in obj._named_states()}


def _same_states(a, b):
    sa, sb = _states(a), _states(b)
    assert set(sa) == set(sb)
    for k in sa:
        va, vb = (sa[k], sb[k]) if isinstance(sa[k], list) else ([sa[k]], [sb[k]])
        assert len(va) == len(vb), k
        for x, y in zip(va, vb):
            assert np.asarray(x).dtype.name in (np.asarray(y).dtype.name, "float32"), k
            assert np.array_equal(np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)), k


@pytest.mark.parametrize("route", ["file", "bytes"])
@pytest.mark.parametrize("kind", ["int32", "float32", "bfloat16", "list", "cursor"])
def test_envelopes_cross_both_ways_with_equal_checksums(kind, route, tmp_path):
    m, j = _cross_pair(kind)
    env, jenv = save_envelope(m), jrel.save_envelope(j)
    assert _header(env) == _header(jenv), kind  # the same spec and checksum string

    def through(envelope, writer, reader, name):
        if route == "file":
            path = tmp_path / f"{name}.npz"
            writer[0](path, envelope)
            return reader[0](path)
        return reader[1](writer[1](envelope))

    port_io = ((write_envelope, envelope_to_bytes), (read_envelope, envelope_from_bytes))
    jax_io = (
        (jrel.write_envelope, jrel.checkpoint.envelope_to_bytes),
        (jrel.read_envelope, jrel.checkpoint.envelope_from_bytes),
    )
    # JAX -> port: written by JAX, read and strictly loaded by the port
    from_jax = through(jenv, jax_io[0], port_io[1], "from_jax")
    assert _header(from_jax) == _header(jenv)
    port_dst, _ = _fresh(kind)
    load_envelope(port_dst, from_jax, strict=True)
    _same_states(port_dst, m)
    # port -> JAX: written by the port, read and strictly loaded by JAX
    to_jax = through(env, port_io[0], jax_io[1], "to_jax")
    assert _header(to_jax) == _header(env)
    _, jax_dst = _fresh(kind)
    jrel.load_envelope(jax_dst, to_jax, strict=True)
    _same_states(jax_dst, j)
    if kind == "cursor":
        assert port_dst._session_cursor == jax_dst._session_cursor == 7
    if kind == "bfloat16":
        assert port_dst.hist_pos.dtype == torch.bfloat16 and jax_dst.hist_pos.dtype == jnp.bfloat16
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, want = port_dst.compute(), jax_dst.compute()
    if isinstance(got, dict):
        for k in got:
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k], dtype=np.float32), rtol=1e-5)
    else:
        np.testing.assert_allclose(_np(got), np.asarray(want, dtype=np.float32), rtol=1e-5)


def test_jax_in_memory_envelope_loads_into_the_port():
    """A JAX envelope dict (numpy payload, an ml_dtypes bfloat16 array
    included) loads strictly into the port without a file."""
    for kind in ("int32", "bfloat16", "list"):
        m, j = _cross_pair(kind)
        port_dst, _ = _fresh(kind)
        load_envelope(port_dst, jrel.save_envelope(j), strict=True)
        _same_states(port_dst, m)


def test_cohort_envelope_save_resume_round_trip(tmp_path):
    """A cohort's envelope carries its stacked states and its int8
    ``__cohort_slots__`` table under one checksum, equal to JAX's for the
    same cohort; strict-loading it (from a file) restores states and
    membership, so a resumed cohort computes the same values and keeps
    stepping like the original."""
    rng = np.random.RandomState(31)
    tenants = 3

    def batch():
        # multiples of 1/8: every float32 sum of their squares is exact, so
        # both packages' states agree bit for bit whatever their sum order
        return (rng.randint(0, 8, (tenants, 16)) / 8).astype(np.float32), (rng.randint(0, 8, (tenants, 16)) / 8).astype(
            np.float32
        )

    cohort = tm.MetricCohort(tm.MetricCollection([tm.MeanSquaredError(device=CPU), tm.MeanAbsoluteError(device=CPU)]),
                             tenants=tenants)
    jcohort = jm.MetricCohort(jm.MetricCollection([jm.MeanSquaredError(), jm.MeanAbsoluteError()]), tenants=tenants)
    for _ in range(2):
        p, t = batch()
        cohort(torch.from_numpy(p), torch.from_numpy(t))
        jcohort(jnp.asarray(p), jnp.asarray(t))
    cohort.remove_tenant(1)
    jcohort.remove_tenant(1)
    env, jenv = save_envelope(cohort), jrel.save_envelope(jcohort)
    assert env["spec"]["__cohort_slots__"] == {"kind": "array", "dtype": "int8", "shape": [4]}
    assert env["metric_type"] == "MetricCohort"
    assert _header(env) == _header(jenv)
    path = tmp_path / "cohort.npz"
    write_envelope(path, env)
    resumed = tm.MetricCohort(tm.MetricCollection([tm.MeanSquaredError(device=CPU), tm.MeanAbsoluteError(device=CPU)]),
                              tenants=tenants)
    load_envelope(resumed, read_envelope(path), strict=True)
    assert resumed.tenant_ids() == cohort.tenant_ids() == (0, 2)
    _same_states(resumed, cohort)
    p, t = batch()
    for c in (cohort, resumed):
        c(torch.from_numpy(p[[0, 2]]), torch.from_numpy(t[[0, 2]]))
    a, b = cohort.compute(), resumed.compute()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # the JAX cohort strictly loads the port's file too
    jresumed = jm.MetricCohort(jm.MetricCollection([jm.MeanSquaredError(), jm.MeanAbsoluteError()]), tenants=tenants)
    jrel.load_envelope(jresumed, jrel.read_envelope(path), strict=True)
    assert jresumed.tenant_ids() == (0, 2)


# ----------------------------------------------------------------------
# test_roundtrips.py: every family through state_dict and the envelope
# ----------------------------------------------------------------------
_RNG = np.random.RandomState(1234)
_N, _C = 48, 4
_PROBS = _RNG.rand(_N, _C).astype(np.float32)
_PROBS /= _PROBS.sum(1, keepdims=True)
_MC = (_PROBS, _RNG.randint(_C, size=_N))
_BIN = (_PROBS[:, 1].copy(), _RNG.randint(2, size=_N).astype(np.int32))
_REG = (_RNG.rand(_N).astype(np.float32), _RNG.rand(_N).astype(np.float32))
_RET = (_RNG.randint(6, size=_N).astype(np.int32), _RNG.rand(_N).astype(np.float32),
        _RNG.randint(2, size=_N).astype(np.int32))
_HINGE = (_RNG.randn(_N).astype(np.float32), _BIN[1])
_LIN = (np.linspace(0, 1, 16).astype(np.float32), np.linspace(0, 1, 16).astype(np.float32))

CASES = [
    ("Accuracy", {}, _MC),
    ("Precision", {"num_classes": _C, "average": "macro"}, _MC),
    ("Recall", {"num_classes": _C, "average": "macro"}, _MC),
    ("F1", {"num_classes": _C, "average": "macro"}, _MC),
    ("FBeta", {"num_classes": _C, "beta": 0.5, "average": "macro"}, _MC),
    ("StatScores", {"reduce": "micro"}, _MC),
    ("ConfusionMatrix", {"num_classes": _C}, _MC),
    ("IoU", {"num_classes": _C}, _MC),
    ("MatthewsCorrcoef", {"num_classes": _C}, _MC),
    ("CohenKappa", {"num_classes": _C}, _MC),
    ("HammingDistance", {}, _BIN),
    ("Hinge", {}, _HINGE),
    ("AUROC", {}, _BIN),
    ("AveragePrecision", {}, _BIN),
    ("PrecisionRecallCurve", {}, _BIN),
    ("ROC", {}, _BIN),
    ("AUC", {"reorder": True}, _LIN),
    ("BinnedAUROC", {"num_bins": 16}, _BIN),
    ("BinnedAveragePrecision", {"num_bins": 16}, _BIN),
    ("MeanSquaredError", {}, _REG),
    ("MeanAbsoluteError", {}, _REG),
    ("MeanSquaredLogError", {}, _REG),
    ("R2Score", {}, _REG),
    ("ExplainedVariance", {}, _REG),
    ("PSNR", {"data_range": 1.0}, _REG),
    ("RetrievalMAP", {}, _RET),
    ("RetrievalMRR", {}, _RET),
    ("RetrievalPrecision", {"k": 2}, _RET),
    ("RetrievalRecall", {"k": 2}, _RET),
]


def _filled(name, kwargs, args, times=2):
    m = getattr(tm, name)(device=CPU, **kwargs)
    for _ in range(times):
        m.update(*(torch.from_numpy(np.asarray(a)) for a in args))
    return m


def _values_equal(a, b, name):
    flat_a = a if isinstance(a, (tuple, list)) else [a]
    flat_b = b if isinstance(b, (tuple, list)) else [b]
    assert len(flat_a) == len(flat_b), name
    for x, y in zip(flat_a, flat_b):
        if isinstance(x, (tuple, list)):
            _values_equal(x, y, name)
        else:
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), name


@pytest.mark.parametrize("name,kwargs,args", CASES, ids=[c[0] for c in CASES])
def test_state_dict_roundtrip_every_family(name, kwargs, args):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = _filled(name, kwargs, args)
        m.persistent(True)
        saved = m.state_dict()
        assert saved, name
        m2 = getattr(tm, name)(device=CPU, **kwargs)
        m2.persistent(True)
        m2.load_state_dict(saved, strict=True)
        _values_equal(m.compute(), m2.compute(), name)


@pytest.mark.parametrize("name,kwargs,args", CASES, ids=[c[0] for c in CASES])
def test_envelope_roundtrip_every_family(name, kwargs, args, tmp_path):
    """Through an envelope in memory and through a file. The envelope's spec
    equals the JAX package's for the same updates, each package's checksum
    function gives the other's checksum string on the other's payload, and
    where the two packages' states are bit-equal (all but
    MeanSquaredLogError's ``log1p`` sums) so are the checksums; the JAX
    package strictly loads the port's file."""
    from metrics_tpu.reliability.checkpoint import _checksum as jax_checksum
    from metrics_tpu_torch.reliability.checkpoint import _checksum

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = _filled(name, kwargs, args)
        env = save_envelope(m)
        assert env["complete"], name
        j = getattr(jm, name)(**kwargs)
        for _ in range(2):
            j.update(*(jnp.asarray(a) for a in args))
        jenv = jrel.save_envelope(j)
        assert env["spec"] == jenv["spec"], name
        assert _checksum(jenv["payload"]) == jenv["checksum"] and jax_checksum(env["payload"]) == env["checksum"]
        if name != "MeanSquaredLogError":
            assert env["checksum"] == jenv["checksum"], name
        m2 = getattr(tm, name)(device=CPU, **kwargs)
        load_envelope(m2, env, strict=True)
        _values_equal(m.compute(), m2.compute(), name)
        path = tmp_path / f"{name}.npz"
        write_envelope(path, env)
        m3 = getattr(tm, name)(device=CPU, **kwargs)
        load_envelope(m3, read_envelope(path), strict=True)
        _values_equal(m.compute(), m3.compute(), name)
        jrel.load_envelope(getattr(jm, name)(**kwargs), jrel.read_envelope(path), strict=True)


def test_persistent_toggle_controls_state_dict():
    m = _filled("Accuracy", {}, _MC, times=1)
    assert m.state_dict() == {}
    m.persistent(True)
    assert set(m.state_dict()) == {"correct", "total"}
    m.persistent(False)
    assert m.state_dict() == {}


def test_bf16_cast_roundtrip_through_plain_and_envelope(tmp_path):
    m = _filled("BinnedAUROC", {"num_bins": 16}, _BIN, times=1)
    m.astype(torch.bfloat16)
    m.persistent(True)
    want = float(m.compute())
    m2 = tm.BinnedAUROC(num_bins=16, device=CPU).astype(torch.bfloat16)
    m2.load_state_dict(m.state_dict(), strict=True)
    assert float(m2.compute()) == want
    path = tmp_path / "bf16.npz"
    write_envelope(path, save_envelope(m))
    m3 = tm.BinnedAUROC(num_bins=16, device=CPU).astype(torch.bfloat16)
    load_envelope(m3, read_envelope(path), strict=True)
    assert m3.hist_pos.dtype == torch.bfloat16
    assert float(m3.compute()) == want


def test_collection_roundtrip_mixed_state_kinds(tmp_path):
    def build():
        return tm.MetricCollection(
            {"acc": tm.Accuracy(device=CPU), "cm": tm.ConfusionMatrix(num_classes=2, device=CPU),
             "auroc": tm.AUROC(device=CPU)}
        )

    col = build()
    col.update(*(torch.from_numpy(np.asarray(a)) for a in _BIN))
    col.persistent(True)
    saved = col.state_dict()
    assert any(k.startswith("auroc.") for k in saved)
    col2 = build()
    col2.load_state_dict(saved, strict=True)
    a, b = col.compute(), col2.compute()
    for k in a:
        _values_equal(a[k], b[k], k)
    path = tmp_path / "col.npz"
    write_envelope(path, save_envelope(col))
    col3 = build()
    load_envelope(col3, read_envelope(path), strict=True)
    c = col3.compute()
    for k in a:
        _values_equal(a[k], c[k], k)
    assert os.path.exists(path)
