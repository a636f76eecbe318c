"""Deliberately broken code: negative tests proving each analyzer rule
fires.

Port of ``metrics_tpu/analysis/fixtures.py``: the metric fixtures of the
program audit (pass 1) and of the distributed-equivalence and lifecycle
pass (pass 3), of the host-seam and double-buffer pass (pass 4), of the
numerics pass (pass 5), the positive control of the quantized merge probe,
and the host fixtures. The mirror of
:mod:`metrics_tpu_torch.reliability.faultinject` for the static analyzer:
faultinject injects runtime faults to prove the *dynamic* defenses catch
them; these fixtures encode defects to prove the *static* passes catch
them before anything runs. Each fixture is surgical — it violates exactly
one rule and is otherwise clean, so the tests can pin "this fixture trips
this rule and nothing else". The fleet fixtures subclass the port's own
fleet classes and override the hooks those classes name for the purpose
(``MigrationCoordinator._commit_target``, ``FleetShard._check_fence``). The
fixtures of the sanitizer come with it. ``SeamRegressor`` and
``CancellingVariance`` keep the JAX package's class names: the committed
``SEAM_BASELINE.json`` and ``NUMERICS_BASELINE.json`` gate them by those
names.

The metric fixtures take the :class:`~metrics_tpu_torch.Metric` base's
``device`` (the card by default; ``"cpu"`` on the CPU).

Never export these from the package root; they exist for the analyzer's
test bed and for documentation of what each rule means in code.
"""
import json
import os
import threading

import torch

from metrics_tpu_torch.fleet import FleetShard, MigrationCoordinator
from metrics_tpu_torch.metric import Metric

__all__ = [
    "BlockScaledQuantizedSync",
    "CallbackInJit",
    "CancellingVariance",
    "ComputeMutatesState",
    "DonatedAlias",
    "DoubleBufferAliaser",
    "EpsilonThresholdAUROC",
    "GcBeforeDurableCoordinator",
    "HostReadOfDonated",
    "HostSyncUpdate",
    "Int32RowCounter",
    "MeanWithoutCount",
    "NarrowAccumulator",
    "NonAtomicManifestWriter",
    "NonCommutativeMerge",
    "NonIdentityReset",
    "OrphanResidual",
    "ReplicaDependentCount",
    "SeamRegressor",
    "StaleSuppression",
    "SuppressedNarrowAccumulator",
    "UnfencedCheckpointShard",
    "UnlockedSharedCounter",
    "UnownedLoader",
    "UnscaledInt8Psum",
    "UntouchedStatePassthrough",
]


class NarrowAccumulator(Metric):
    """MTA001: a float16 accumulator fed float32 batches. One update
    promotes the state to f32 (signature churn: every later step
    rebuilds) and the declared accumulator is narrower than its input
    (precision loss)."""

    _fused_forward = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("acc", default=torch.zeros((), dtype=torch.float16), dist_reduce_fx="sum")

    def update(self, x: torch.Tensor) -> None:
        self.acc = self.acc + torch.sum(x)

    def compute(self) -> torch.Tensor:
        return self.acc


class SuppressedNarrowAccumulator(NarrowAccumulator):
    """The same defect with the rule suppressed — the suppression-syntax
    fixture."""

    # metrics-tpu: allow(MTA001) — deliberate: proves class-body
    # suppression routes findings to the `suppressed` bucket


class CallbackInJit(Metric):
    """MTA002: a host round trip in the update program — ``.cpu()``, numpy,
    and back to the device. It runs fine eagerly — and would serialize
    every compiled step on a device→host copy; the fake trace cannot read
    the value and says so."""

    _fused_forward = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("acc", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x: torch.Tensor) -> None:
        # metrics-tpu: allow(MTL101) — deliberate: the broken fixture
        total = torch.from_numpy(torch.sum(x).cpu().numpy())
        self.acc = self.acc + total.to(self.acc.device)

    def compute(self) -> torch.Tensor:
        return self.acc


class HostSyncUpdate(Metric):
    """MTA002 (concretization flavor): ``float()`` of a tensor in an
    engine-eligible update. The first compiled step's warm-up raises on the
    synchronizing read and demotes the metric to eager."""

    _fused_forward = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("acc", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x: torch.Tensor) -> None:
        self.acc = self.acc + float(torch.sum(x))  # metrics-tpu: allow(MTL101)

    def compute(self) -> torch.Tensor:
        return self.acc


class DonatedAlias(Metric):
    """MTA003: one tensor assigned to two states. The two outputs of the
    step share one buffer — two live states aliasing the same storage (the
    JAX package's double donation)."""

    _fused_forward = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("sum_a", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("sum_b", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x: torch.Tensor) -> None:
        total = torch.sum(x)
        self.sum_a = total
        self.sum_b = total  # the alias: the same tensor as sum_a

    def compute(self) -> torch.Tensor:
        return self.sum_a


class NonCommutativeMerge(Metric):
    """MTA004: a custom ``dist_reduce_fx`` whose fold is order-dependent —
    every replica layout merges to a different value."""

    @staticmethod
    def _subtract_reduce(stacked: torch.Tensor) -> torch.Tensor:
        return stacked[0] - stacked[1:].sum(dim=0)

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("acc", default=torch.zeros(()), dist_reduce_fx=self._subtract_reduce)

    def update(self, x: torch.Tensor) -> None:
        self.acc = self.acc + torch.sum(x)

    def compute(self) -> torch.Tensor:
        return self.acc


class MeanWithoutCount(Metric):
    """MTA004 (mean flavor): a 'mean'-reduced state with no paired
    sum-reduced count — mean-of-means is wrong whenever replicas see
    different batch counts."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("avg", default=torch.zeros(()), dist_reduce_fx="mean")

    def update(self, x: torch.Tensor) -> None:
        self.avg = torch.mean(x)

    def compute(self) -> torch.Tensor:
        return self.avg


def _unscaled_int8_psum(stacked: torch.Tensor) -> torch.Tensor:
    """The quantized-sync anti-pattern: per-rank contributions cast straight
    to int8 — no block scales — summed, and cast back. Fractional values
    truncate to 0 and anything past ±127 is lost; the 'compressed' merge
    destroys the magnitudes it claims to accumulate."""
    return stacked.to(torch.int8).sum(dim=0).to(torch.float32)


# the declaration that holds it to the quantized contract (MTA004 probes
# magnitude preservation on the dequantized result, not just commutativity)
_unscaled_int8_psum.quantized_precision = "int8"


class UnscaledInt8Psum(Metric):
    """MTA004 (quantized flavor): an int8 psum WITHOUT block scales. Still
    commutative — the classic probe alone would pass it — but not
    magnitude-preserving, which is the property that makes a quantized
    merge sound."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("acc", default=torch.zeros((8,)), dist_reduce_fx=_unscaled_int8_psum)

    def update(self, x: torch.Tensor) -> None:
        self.acc = self.acc + torch.reshape(x, self.acc.shape)

    def compute(self) -> torch.Tensor:
        return torch.sum(self.acc)


class ReplicaDependentCount(Metric):
    """MTA005: a sum-reduced state that counts *update calls*, not data.
    One replica over the whole batch counts 1; R replicas over shards
    count R — `compute(reduce(states_1..R)) != compute(update-on-concat)`
    the moment this runs data-parallel. The classic replica-dependence
    defect: state encodes the execution topology, not the stream."""

    _fused_forward = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("batches", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x: torch.Tensor) -> None:
        self.total = self.total + torch.sum(x)
        self.batches = self.batches + 1.0  # per-CALL, not per-sample

    def compute(self) -> torch.Tensor:
        return self.total / torch.clamp(self.batches, min=1.0)


class NonIdentityReset(Metric):
    """MTA006 (reset flavor): a sum-reduced state whose reset value is 1,
    not the reduction's identity 0. Every sync round folds the phantom 1
    of each freshly-reset (or idle) replica into the merged state.
    Deliberately eager-only: with an engine opt-in the same defect would
    *also* surface as MTA005 replica-inequivalence — which is the point
    of the reset-identity rule catching it earlier and cheaper."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("acc", default=torch.ones(()), dist_reduce_fx="sum")

    def update(self, x: torch.Tensor) -> None:
        self.acc = self.acc + torch.sum(x)

    def compute(self) -> torch.Tensor:
        return self.acc


class ComputeMutatesState(Metric):
    """MTA006 (purity flavor): ``compute`` writes a registered state.
    After one compute the accumulated count is doubled, so every
    compute-then-keep-accumulating loop (step-value logging mid-epoch)
    silently corrupts the epoch state. Caught by the concrete value
    check."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x: torch.Tensor) -> None:
        self.total = self.total + torch.sum(x)

    def compute(self) -> torch.Tensor:
        self.total = self.total * 2.0  # the mutation
        return self.total


class OrphanResidual(Metric):
    """MTA006 (residual flavor): a state named like an error-feedback
    companion (``*__qres``) with no ``sync_precision`` entry pairing it.
    The residual exemption from every sync/reduction rule only covers
    REGISTERED companions — an orphan is ordinary state wearing the
    exemption's name."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("hist", default=torch.zeros((8,)), dist_reduce_fx="sum")
        self.add_state("hist__qres", default=torch.zeros((8,)), dist_reduce_fx="sum")

    def update(self, x: torch.Tensor) -> None:
        self.hist = self.hist + torch.reshape(x, self.hist.shape)

    def compute(self) -> torch.Tensor:
        return torch.sum(self.hist)


class UntouchedStatePassthrough(Metric):
    """MTA007: an engine-eligible metric registering a state its update
    never writes. The step hands the SAME storage back every dispatch —
    the engine's buffer and the metric's attribute share it for a state
    that never changes, and two disjoint buffer generations are impossible.
    Configuration belongs in plain attributes, not in state."""

    _fused_forward = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("acc", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("version", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x: torch.Tensor) -> None:
        self.acc = self.acc + torch.sum(x)  # `version` never written

    def compute(self) -> torch.Tensor:
        return self.acc


class UnownedLoader(Metric):
    """MTA007 (load flavor): a ``load_state_dict`` override that imports
    checkpoint values without the ``_device_owned`` copy and without
    delegating to the library loader. The loaded states alias the caller's
    storage (a checkpoint's tensors, another metric's states)."""

    _fused_forward = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("acc", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x: torch.Tensor) -> None:
        self.acc = self.acc + torch.sum(x)

    def compute(self) -> torch.Tensor:
        return self.acc

    def load_state_dict(self, state_dict, prefix="", strict=False, _warn_on_zero_match=True):
        for key in self._defaults:
            if prefix + key in state_dict:
                setattr(self, key, torch.as_tensor(state_dict[prefix + key]))


class StaleSuppression(Metric):
    """MTL105: a class-body allow for a rule whose violation no longer
    exists (the program is clean). The unused-noqa analogue — the allow
    must be deleted, or the next REAL buffer alias here sails through
    pre-suppressed."""

    # metrics-tpu: allow(MTA003) — STALE on purpose: nothing here aliases

    _fused_forward = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("acc", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x: torch.Tensor) -> None:
        self.acc = self.acc + torch.sum(x)

    def compute(self) -> torch.Tensor:
        return self.acc


class SeamRegressor(Metric):
    """MTA008: a family whose host-seam budget regressed past its committed
    baseline. The entry for this class in ``SEAM_BASELINE.json`` budgets ONE
    host-synced state; the class registers THREE — every sync now pays three
    host collectives, every checkpoint three fetches. The program itself is
    sound (all states written, sum-reduced, fused), so only the seam gate
    fires: a crossing-count creep no other rule sees."""

    _fused_forward = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("hits", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("misses", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("weight", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x: torch.Tensor) -> None:
        self.hits = self.hits + torch.sum(x)
        self.misses = self.misses + torch.sum(1.0 - x)
        self.weight = self.weight + x.shape[0]

    def compute(self) -> torch.Tensor:
        return self.hits / torch.clamp(self.hits + self.misses, min=1.0)


class DoubleBufferAliaser(Metric):
    """MTA009 (generation-alias flavor): ``reset()`` reseeds the registered
    state from a tensor held on the instance since construction. Every
    generation after a reset starts on the same held tensor, so two state
    generations can never be disjoint. The single step graph is clean (the
    merge makes a new tensor), which is why the prover has an AST leg."""

    _fused_forward = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._pool = torch.zeros((), device=self.device)  # the held tensor
        self.add_state("acc", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x: torch.Tensor) -> None:
        self.acc = self.acc + torch.sum(x)

    def compute(self) -> torch.Tensor:
        return self.acc

    def reset(self) -> None:
        super().reset()
        self.acc = self._pool  # the alias: every generation shares _pool


class HostReadOfDonated(Metric):
    """MTA009 (host-read flavor): ``compute`` stashes the live state in a
    plain attribute — a host reference that outlives the compute. The next
    step replaces the state, and a later read of the stash (an exporter
    scrape, user code) reads a tensor a step in flight may write. The prover
    refuses the stash at the assignment."""

    _fused_forward = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("acc", default=torch.zeros(()), dist_reduce_fx="sum")
        self._last_value = None

    def update(self, x: torch.Tensor) -> None:
        self.acc = self.acc + torch.sum(x)

    def compute(self) -> torch.Tensor:
        self._last_value = self.acc  # the escape: a host ref to live state
        return self.acc


class Int32RowCounter(Metric):
    """MTA010: an int32 row counter. Sound in every per-step sense — the
    program is clean, the reduction is a sum, replicas agree — and it
    saturates after 2³¹ rows. The interval pass bounds its per-row increment
    at exactly 1 and derives a horizon far below the 2⁴⁰-row fleet floor."""

    _fused_forward = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("rows", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("acc", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x: torch.Tensor) -> None:
        self.rows = self.rows + torch.tensor(x.shape[0], dtype=torch.int32, device=x.device)
        self.acc = self.acc + torch.sum(x)

    def compute(self) -> torch.Tensor:
        return self.acc / torch.clamp_min(self.rows.to(torch.float32), 1.0)


class CancellingVariance(Metric):
    """MTA011: variance via E[x²]−E[x]² — the catastrophic-cancellation
    shape. Structurally detected (both subtraction operands descend from
    accumulated sums) AND measured: on mean-shifted probes the f32 result
    loses every significant digit against the float64 oracle, blowing the
    deliberately-tight budget committed for this class in
    ``NUMERICS_BASELINE.json`` — exactly how a conditioning regression in a
    real family would fail the gate."""

    _fused_forward = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("sum_x", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("sum_x2", default=torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("count", default=torch.zeros(()), dist_reduce_fx="sum")

    def update(self, x: torch.Tensor) -> None:
        self.sum_x = self.sum_x + torch.sum(x)
        self.sum_x2 = self.sum_x2 + torch.sum(x * x)
        self.count = self.count + x.shape[0]

    def compute(self) -> torch.Tensor:
        n = torch.clamp_min(self.count, 1.0)
        mean = self.sum_x / n
        return self.sum_x2 / n - mean * mean  # the cancellation


class EpsilonThresholdAUROC(Metric):
    """MTA012: a rank metric (declared scale-invariant in the pass-5
    equivariance table) hiding an ABSOLUTE epsilon: scores below 1e-3 are
    snapped to zero before ranking. At scale 1.0 every oracle test passes;
    rescale the same scores by 2⁻¹⁰ (exact in IEEE floats) and different
    scores cross the epsilon, the tie structure changes, and the result
    drifts — the metamorphic probe catches what no fixed-scale test can."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("scores", default=[], dist_reduce_fx=None)

    def update(self, x: torch.Tensor) -> None:
        self.scores.append(x)

    def compute(self) -> torch.Tensor:
        s = torch.cat([torch.reshape(v, (-1,)) for v in self.scores])
        # the median of an even count is the mean of the middle two
        target = (s > torch.quantile(s, 0.5)).to(torch.float32)
        s = torch.where(torch.abs(s) < 1e-3, 0.0, s)  # the hidden epsilon
        # pairwise Mann-Whitney AUROC (ties contribute 1/2): when the
        # epsilon collapses scores to ties, strict wins become halves and
        # the value drifts — exactly what the metamorphic probe measures
        wins = (s[:, None] > s[None, :]).to(torch.float32)
        ties = (s[:, None] == s[None, :]).to(torch.float32)
        pair = target[:, None] * (1.0 - target[None, :])
        n_pairs = torch.sum(pair)
        u = torch.sum(pair * (wins + 0.5 * ties))
        return u / torch.clamp_min(n_pairs, 1.0)


class BlockScaledQuantizedSync(Metric):
    """The POSITIVE control of the quantized MTA004 probe: a 64-bin 'sum'
    state on the int8 sync tier (block-scaled, with its error-feedback
    residual). Must audit clean — the probe runs on the dequantized
    composite and the residual companion is exempt from every reduction
    rule."""

    _fused_forward = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("hist", default=torch.zeros((64,)), dist_reduce_fx="sum", sync_precision="int8")

    def update(self, x: torch.Tensor) -> None:
        self.hist = self.hist + torch.zeros_like(self.hist) + torch.sum(x) / self.hist.shape[0]

    def compute(self) -> torch.Tensor:
        return torch.sum(self.hist)


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
