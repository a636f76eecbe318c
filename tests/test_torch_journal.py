"""The port's ``CheckpointJournal`` against the JAX package's, on the CPU.

Every case of ``tests/reliability/test_journal.py`` is mirrored: commits
rotate and garbage-collect, the newest good generation loads, an empty
journal is a fresh start, a torn newest generation falls back with a typed
warning and a counter, every generation torn raises, a lost or unreadable
manifest degrades to a directory scan (the cursor recovered from the
envelope), stray files are collected. Beyond those, the two packages'
journals are one format: a journal the JAX package wrote resumes in the port
and the other way round, manifest and generations alike.

Tolerance: none (file names, manifest records, cursors and states are
compared exactly).
"""
import json
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
from metrics_tpu_torch.reliability import (
    CheckpointCorruptionError,
    CheckpointJournal,
    EvalSession,
    atomic_write_json,
    load_envelope,
    save_envelope,
)
from metrics_tpu_torch.reliability import faultinject as fi

CPU = "cpu"


@pytest.fixture(autouse=True)
def _pristine():
    def clean():
        for pkg in (jobs, obs):
            pkg.disable()
            pkg.get().reset()
            pkg.disable_flight()

    clean()
    yield
    clean()


def _filled(seed=0, jax_side=False):
    rng = np.random.RandomState(seed)
    x = rng.rand(32).astype(np.float32)
    if jax_side:
        m = jm.MeanSquaredError()
        m.update(jnp.asarray(x), jnp.asarray(x * 0.5))
        return m
    m = tm.MeanSquaredError(device=CPU)
    m.update(torch.from_numpy(x), torch.from_numpy(x * 0.5))
    return m


def _journal_with(tmp_path, n, keep_last=3):
    journal = CheckpointJournal(tmp_path / "j", keep_last=keep_last)
    for i in range(n):
        journal.commit(save_envelope(_filled(seed=i)), cursor=i)
    return journal


def test_commit_rotates_and_garbage_collects(tmp_path):
    journal = _journal_with(tmp_path, 5, keep_last=2)
    records = journal.records()
    assert [r["generation"] for r in records] == [4, 5]
    assert [r["cursor"] for r in records] == [3, 4]
    on_disk = sorted(f for f in os.listdir(journal.directory) if f.startswith("gen-"))
    assert on_disk == ["gen-00000004.npz", "gen-00000005.npz"]
    with open(journal.manifest_path) as f:
        manifest = json.load(f)
    assert manifest["format"] == "metrics_tpu.checkpoint_manifest"
    assert manifest["keep_last"] == 2
    # the JAX package reads the same records from the port's journal
    assert [r["generation"] for r in jrel.CheckpointJournal(journal.directory).records()] == [4, 5]


def test_load_latest_good_returns_newest(tmp_path):
    journal = _journal_with(tmp_path, 3)
    envelope, record, skipped = journal.load_latest_good()
    assert record["cursor"] == 2 and skipped == []
    target = _filled(seed=99)
    load_envelope(target, envelope, strict=True)
    assert torch.equal(target.sum_squared_error, _filled(seed=2).sum_squared_error)


def test_empty_journal_is_a_fresh_start_not_an_error(tmp_path):
    journal = CheckpointJournal(tmp_path / "empty")
    assert journal.load_latest_good() == (None, None, [])
    assert journal.records() == []


def test_torn_newest_generation_falls_back_with_typed_warning(tmp_path):
    journal = _journal_with(tmp_path, 3)
    fi.torn_write(journal._gen_path(3), keep_fraction=0.3)
    with obs.telemetry_scope(), pytest.warns(UserWarning, match="falling back"):
        envelope, record, skipped = journal.load_latest_good()
    assert record["cursor"] == 1
    assert len(skipped) == 1 and "CheckpointCorruptionError" in skipped[0]["error"]
    assert obs.get().counters["reliability.session_torn_write_fallbacks"] == 1
    load_envelope(_filled(seed=0), envelope, strict=True)


def test_every_generation_torn_raises_typed_error(tmp_path):
    journal = _journal_with(tmp_path, 2, keep_last=2)
    for gen in (1, 2):
        fi.torn_write(journal._gen_path(gen), keep_fraction=0.2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(CheckpointCorruptionError, match="none is loadable"):
            journal.load_latest_good()


def test_lost_manifest_recovers_from_directory_scan(tmp_path):
    m = tm.MeanSquaredError(device=CPU)
    session = EvalSession(m, tmp_path / "j", checkpoint_every=1)
    rng = np.random.RandomState(0)
    for i in range(3):
        x = torch.from_numpy(rng.rand(16).astype(np.float32))
        session.step(i, x, x * 0.5)
    os.remove(session.journal.manifest_path)
    journal = CheckpointJournal(tmp_path / "j")
    records = journal.records()
    assert [r["generation"] for r in records] and all(r["cursor"] is None for r in records)
    envelope, record, _ = journal.load_latest_good()
    assert record["cursor"] == 2


def test_unreadable_manifest_warns_and_scans(tmp_path):
    journal = _journal_with(tmp_path, 2)
    with open(journal.manifest_path, "w") as f:
        f.write("{ torn json")
    with pytest.warns(UserWarning, match="manifest"):
        records = journal.records()
    assert [r["generation"] for r in records] == [1, 2]


def test_crash_between_manifest_and_gc_leaves_valid_journal(tmp_path):
    journal = _journal_with(tmp_path, 4, keep_last=2)
    stray = journal._gen_path(1)
    with open(stray, "wb") as f:
        f.write(b"leftover")
    assert [r["generation"] for r in journal.records()] == [3, 4]
    journal.commit(save_envelope(_filled()), cursor=9)
    assert not os.path.exists(stray)


def test_keep_last_validation(tmp_path):
    with pytest.raises(ValueError, match="keep_last"):
        CheckpointJournal(tmp_path, keep_last=0)


def test_atomic_write_json_replaces_never_tears(tmp_path):
    path = tmp_path / "m.json"
    atomic_write_json(path, {"v": 1})
    with pytest.raises(TypeError):
        atomic_write_json(path, object())
    with open(path) as f:
        assert json.load(f) == {"v": 1}
    assert not os.path.exists(str(path) + ".tmp")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_journal_written_by_one_package_resumes_in_the_other(writer, tmp_path):
    """Generations, manifest and embedded cursor are one format: the other
    package's journal lists the same records, loads the newest generation
    strictly and recovers its cursor from the payload without a manifest."""
    d = tmp_path / "j"
    if writer == "jax":
        journal = jrel.CheckpointJournal(d, keep_last=2)
        for i in range(3):
            journal.commit(jrel.save_envelope(_filled(seed=i, jax_side=True)), cursor=i)
        reader, target = CheckpointJournal(d), _filled(seed=9)
        load = load_envelope
    else:
        journal = CheckpointJournal(d, keep_last=2)
        for i in range(3):
            journal.commit(save_envelope(_filled(seed=i)), cursor=i)
        reader, target = jrel.CheckpointJournal(d), _filled(seed=9, jax_side=True)
        load = jrel.load_envelope
    assert [(r["generation"], r["cursor"]) for r in reader.records()] == [(2, 1), (3, 2)]
    envelope, record, skipped = reader.load_latest_good()
    assert record["cursor"] == 2 and skipped == []
    load(target, envelope, strict=True)
    np.testing.assert_allclose(
        np.asarray(target.sum_squared_error), np.asarray(_filled(seed=2, jax_side=writer == "port").sum_squared_error),
        rtol=1e-6,
    )
    assert reader.cursors_on_disk() == [1, 2]
