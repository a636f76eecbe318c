"""Deliberately broken host code: negative tests proving each host-side
analyzer rule fires.

Port of the host fixtures of ``metrics_tpu/analysis/fixtures.py``. The
mirror of :mod:`metrics_tpu_torch.reliability.faultinject` for the static
analyzer: faultinject injects runtime faults to prove the *dynamic*
defenses catch them; these fixtures encode defects to prove the *static*
passes catch them before anything runs. Each fixture is surgical — it
violates exactly one rule and is otherwise clean, so the tests can pin
"this fixture trips this rule and nothing else". The fleet fixtures
subclass the port's own fleet classes and override the hooks those classes
name for the purpose (``MigrationCoordinator._commit_target``,
``FleetShard._check_fence``). The metric fixtures of the program-audit
passes come with those passes.

Never export these from the package root; they exist for the analyzer's
test bed and for documentation of what each rule means in code.
"""
import json
import os
import threading

from metrics_tpu_torch.fleet import FleetShard, MigrationCoordinator

__all__ = [
    "GcBeforeDurableCoordinator",
    "NonAtomicManifestWriter",
    "UnfencedCheckpointShard",
    "UnlockedSharedCounter",
]


class UnlockedSharedCounter:
    """MTL106 drill: a background worker and the owning thread both write
    ``value``; neither holds ``_lock``. The static lint flags both writes
    (suppressed inline here — the fixture must STAY broken to keep proving
    the rule; ``tests/test_torch_analysis_lint.py`` pins the unsuppressed
    source fires), and :func:`~metrics_tpu_torch.analysis.concurrency.
    thread_shared_model` lists ``value`` as shared across threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def spin(self, n: int = 3) -> None:
        """Run the worker to completion on a background thread."""
        worker = threading.Thread(target=self._worker, args=(n,), daemon=True)
        worker.start()
        worker.join()

    def _worker(self, n: int) -> None:
        for _ in range(n):
            # metrics-tpu: allow(MTL106) — deliberate: the broken fixture
            self.value = self.value + 1

    def bump(self) -> None:
        # metrics-tpu: allow(MTL106) — deliberate: the broken fixture
        self.value = self.value + 1


class GcBeforeDurableCoordinator(MigrationCoordinator):
    """MTA013: a migration coordinator that skips the phase-3 target
    commit — the source still GCs the tenant in ``pre_gc``, so the ONLY
    durable copy of the tenant's state is deleted before the target has
    written one. Every live object looks healthy (the in-memory handoff
    completed); the first reopen-from-disk loses the tenant. Exactly the
    bug class the crash-consistency explorer's base-case schedule
    (``migrate runs to completion`` → reopen → invariants) exists to
    catch — no kill required, the protocol itself is unsound."""

    def _commit_target(self, dst, txn):
        # the elided durability step: pre_gc's newest-generation guard
        # still passes off the SEED-era checkpoint, so nothing trips at
        # migration time — only the explorer's reopen sees the loss
        pass


class UnfencedCheckpointShard(FleetShard):
    """MTA014: a shard whose write path skips the epoch fence. After
    failover bumps the authority's epoch, this stale owner's checkpoint /
    wave / replication / migration writes sail through where a fenced
    shard dies with :class:`~metrics_tpu_torch.fleet.lease.StaleEpochError`
    — the fencing explorer observes the un-refused write (and, for the
    durable paths, changed bytes under a fenced epoch) at every
    interleaving point against promotion."""

    def _check_fence(self, what: str) -> None:
        # the missing fence: a real shard routes every write through
        # authority.check(lease) and re-raises typed
        pass


class NonAtomicManifestWriter:
    """MTL107: a manifest writer with both non-atomic patterns — a
    write-mode ``open()`` straight at a durable path (a kill mid-write
    leaves torn JSON where readers expect a manifest) and an
    ``os.rename`` with no ``os.fsync`` ordered before it (the NAME goes
    durable while the bytes sit in the page cache). The in-tree allows
    keep the repo gate green; the tests strip them and re-lint to pin
    that the unsuppressed source fires exactly MTL107."""

    def __init__(self, directory: str):
        self.directory = directory

    def write(self, records) -> str:
        path = os.path.join(self.directory, "MANIFEST.json")
        # metrics-tpu: allow(MTL107) — deliberate: the broken fixture
        with open(path, "w") as f:
            json.dump({"records": list(records)}, f, indent=1)
        return path

    def publish(self, tmp: str, path: str) -> None:
        # metrics-tpu: allow(MTL107) — deliberate: the broken fixture
        os.rename(tmp, path)
