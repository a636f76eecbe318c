"""Rule catalog + finding model for the static metric-program auditor.

Port of ``metrics_tpu/analysis/rules.py``: the same rule ids, slugs,
owners, summaries and rationales, except MTL101 and MTL102, which speak of
PyTorch's idioms (host reads in a path a CUDA graph captures; graph capture
or compilation outside ``engine.py``). Each :class:`Rule` has a stable ID
used in three places:

* findings emitted by the analysis passes (the port's
  :mod:`metrics_tpu_torch.analysis.lint` walks the package's ASTs, and
  :mod:`metrics_tpu_torch.analysis.protocol` drives the fleet's protocol),
* suppression comments in source — ``# metrics-tpu: allow(MTA001)`` on the
  offending line (lint) or at class-body level in a metric class (program
  audit; state-scoped suppression uses the ``_analysis_allow`` mapping),
* the :class:`~metrics_tpu_torch.observability.RecompilationWatchdog`
  cross-link, which names the rule likely responsible when it fires.

``MTA*`` rules are **program-audit** rules: they reason about a metric's
step program. ``MTL*`` rules are **repo-invariant lint** rules: shallow,
syntactic, zero-false-positive properties of the source tree itself. A rule
whose pass the port does not hold yet keeps its entry; its ``owner`` names
the module that will hold it.
"""
import io
import re
import textwrap
import tokenize
from dataclasses import dataclass, field
from typing import Any, Dict, Set

__all__ = [
    "HOST_CALLBACKS",
    "Finding",
    "Rule",
    "RULES",
    "rule",
    "parse_allow_comments",
    "class_allowed_rules",
    "own_class_allowed_rules",
    "state_allowed_rules",
]

# calls whose function argument runs eagerly on the host by contract (a
# graph break under torch.compile): MTL101 exempts host ops inside that
# argument, as the JAX package's lint exempts a callback's body
HOST_CALLBACKS = ("torch.compiler.disable", "torch._dynamo.disable")

_ALLOW_RE = re.compile(r"#\s*metrics-tpu:\s*allow\(\s*([A-Z]{3}\d{3}(?:\s*,\s*[A-Z]{3}\d{3})*)\s*\)")


@dataclass(frozen=True)
class Rule:
    """One checkable contract: stable ID, the pass that owns it, and the
    failure mode it guards against."""

    id: str
    slug: str
    owner: str  # the pass: "program", "distributed", "concurrency", "numerics", "protocol" or "lint"
    summary: str
    rationale: str

    def to_dict(self) -> Dict[str, str]:
        return {
            "id": self.id,
            "slug": self.slug,
            "owner": self.owner,
            "summary": self.summary,
            "rationale": self.rationale,
        }


RULES: Dict[str, Rule] = {}


def rule(id: str, slug: str, owner: str, summary: str, rationale: str) -> Rule:
    r = Rule(id, slug, owner, summary, rationale)
    RULES[id] = r
    return r


# ---------------------------------------------------------------------------
# pass 1 — program audit (jaxpr)
# ---------------------------------------------------------------------------
MTA001 = rule(
    "MTA001",
    "narrow-accumulator",
    "program",
    "Accumulator state dtype drifts across an update, or is narrower than"
    " the floating input it accumulates.",
    "A state whose dtype changes after one update (silent promotion, or a"
    " weak-type flip) changes the step's input signature, so every"
    " subsequent step retraces/recompiles — churn the recompilation"
    " watchdog only sees after the fact. A floating accumulator narrower"
    " than its input (f16 sums of f32 batches) silently destroys precision"
    " the way bf16 moment sums do.",
)

MTA002 = rule(
    "MTA002",
    "host-sync-in-trace",
    "program",
    "Host synchronization inside a traced region: callback primitives in"
    " the jaxpr, or a concretization error (`.item()`/`float()`-shaped"
    " reads) while tracing a program that is supposed to compile.",
    "A `pure_callback`/`io_callback` in the step program serializes the"
    " donated dispatch the engine exists to keep async; a concretization"
    " failure means the metric silently demotes to eager on its first"
    " compiled step.",
)

MTA003 = rule(
    "MTA003",
    "donation-alias",
    "program",
    "One buffer aliased into more than one output of a donated step"
    " program (two states, or a state and the batch value, sharing one"
    " jaxpr output variable).",
    "The engine donates the state pytree to XLA. Two outputs backed by one"
    " donated buffer either fail dispatch (double-donation) or leave two"
    " live states sharing storage, so the next in-place step corrupts one"
    " through the other — the same class of bit-garbling the durable-"
    " session work fixed dynamically for checkpoint restores.",
)

MTA004 = rule(
    "MTA004",
    "unsound-reduction",
    "program",
    "A declared `dist_reduce_fx` that cannot soundly merge cross-replica"
    " state: a custom reduction that fails a commutativity probe, a 'mean'"
    " state with no paired count, a fused-forward state outside the"
    " mergeable set, a cat-state metric that an engine would compile, or a"
    " quantized merge that is not magnitude-preserving (an unscaled"
    " low-precision psum).",
    "Cross-replica sync all-gathers per-rank states and folds them with"
    " the declared reduction; `psum`-style folds assume commutative,"
    " weight-aware merges. An order-dependent reduction gives every rank"
    " layout a different answer; a bare mean-of-means is wrong whenever"
    " ranks see different batch counts; cat states must demote to eager"
    " rather than compile. Quantized sync tiers (sync_precision=) are"
    " probed through the quantize→dequantize composite: commutativity is"
    " checked on the DEQUANTIZED result within the tier's error bound, the"
    " merge must preserve magnitude (block scales, not bare int8 casts),"
    " and error-feedback residual companions (`<state>__qres`, local-only"
    " compensation state) are exempt from every reduction rule.",
)

MTA005 = rule(
    "MTA005",
    "replica-inequivalence",
    "distributed",
    "The N-replica sync-then-compute composite disagrees with compute on"
    " the concatenated batch: `compute(reduce(states_1..R)) !="
    " compute(update-on-concat)` on concrete probe batches (R ∈ {1, 2, 4})"
    " — exactly for the exact sync tier, beyond the documented error bound"
    " for the bf16/int8 tiers — or the merged state depends on replica"
    " ORDER (axis-index leakage, order-sensitive state).",
    "Every scale-out story (vmapped cohorts, hierarchical multi-pod sync,"
    " async dispatch) assumes data parallelism is semantically invisible:"
    " R replicas that each update on a shard and then sync must equal one"
    " replica that saw the whole batch. A metric violating it is silently"
    " wrong the moment it runs distributed — on EVERY step, not on a rare"
    " failure path. The exact tier is held to bit-identity (probe batches"
    " are grid-valued so float accumulation is exactly associative; a"
    " documented <=8-ulp re-association allowance covers transcendental"
    " per-element terms), the quantized tiers to their documented"
    " per-family bounds, quantizing through the real codec.",
)

MTA006 = rule(
    "MTA006",
    "lifecycle-unsound",
    "distributed",
    "A state's reset->update*->sync->compute->restore lifecycle is"
    " unsound: the reset default is not the identity of its"
    " `dist_reduce_fx` (a second sync round silently folds the non-zero"
    " reset back in), `compute` mutates registered state (before/after"
    " state fingerprints differ across a compute), or a `__qres` residual"
    " companion is incoherent (orphaned, non-zero default, or shape-"
    " mismatched against the state it compensates).",
    "Multi-round sync composes only because an idle or freshly-reset"
    " replica contributes the reduction's identity; a non-identity reset"
    " corrupts the merged state by exactly the reset value per extra"
    " round. A compute that mutates state turns every"
    " compute-then-keep-accumulating loop into silent double counting."
    " Error-feedback residuals are exempt from sync rules precisely"
    " because they are local-only zeros-reset compensation state — an"
    " incoherent residual voids that exemption.",
)

MTA007 = rule(
    "MTA007",
    "donation-lifetime",
    "distributed",
    "A donated-buffer lifetime hazard across the compiled step: a state"
    " buffer passes through the donated step program unchanged (the"
    " donated input IS an output), or a `load_state_dict` override imports"
    " checkpoint buffers into donation slots without the `_device_owned`"
    " copy.",
    "The engine donates the state pytree every dispatch. A pass-through"
    " state hands the donated input buffer back as the 'new' state, so"
    " host references (registered defaults, snapshots) silently die and"
    " the planned ping-pong double-buffering (two DISJOINT buffer"
    " generations in flight) is structurally impossible for that state."
    " Loaded-state buffers that skip `_device_owned` alias host storage"
    " XLA may reuse — observed historically as bit-garbled resumes and GC"
    " segfaults, fixed dynamically by the durable-session work and now"
    " refused statically.",
)

MTA008 = rule(
    "MTA008",
    "host-seam-regression",
    "concurrency",
    "A family's host-seam budget — the counted, phase-classified"
    " host<->device crossings of its serving loop (callbacks per dispatch,"
    " per-state host collectives per sync, device fetches per"
    " compute/checkpoint) — exceeds the committed per-family baseline"
    " (SEAM_BASELINE.json).",
    "The device-resident serving-loop work (in-program sync, async"
    " double-buffered dispatch, streamed checkpoints) is measured in host"
    " crossings removed. That only means something if the crossings are a"
    " number, not a hope: pass 4 derives each family's budget from the"
    " real traced step program plus the host-side call paths, and the"
    " committed baseline turns any regression — a new callback in a step"
    " program, a state that starts syncing through the host — into a CI"
    " finding. Folding a crossing in-program lowers the budget; the"
    " refreshed baseline then GATES the improvement against backsliding.",
)

MTA009 = rule(
    "MTA009",
    "double-buffer-unsafe",
    "concurrency",
    "The two-generation donation interleave is unsound for this family:"
    " a buffer of generation N aliases one generation N+1 donates (a"
    " state output that is a donated input, an executable-owned constant,"
    " or two outputs sharing storage), or host code keeps a reference"
    " that an in-flight donation kills (a method stashing a registered"
    " state into a plain attribute, or reseeding a state from a"
    " host-cached buffer).",
    "Ping-pong double-buffering — dispatch N+1 enqueued against buffer"
    " generation B while N is still in flight on generation A — is only"
    " safe when every dispatch returns a FULLY FRESH state buffer set and"
    " no host read (guard verdict fetch, health fetch, telemetry gauge,"
    " stashed reference) can touch a buffer the next generation donates."
    " Pass 4 proves it per family by abstract two-generation simulation"
    " over the real step program (evidence['double_buffer'] pins the"
    " verdict the future async engine gates on) and refuses the host-"
    " reference escapes statically that MetricSan's poison-on-donate"
    " canary otherwise only catches after the buffer dies.",
)


MTA010 = rule(
    "MTA010",
    "overflow-horizon",
    "numerics",
    "An accumulator's overflow/saturation horizon — rows until an integer"
    " state saturates, or a float state stops absorbing its own per-step"
    " increment (ulp absorption) — is below the fleet floor (default 2^40"
    " rows), or regressed below its committed NUMERICS_BASELINE.json"
    " horizon (a gated dtype narrowing).",
    "State lifetime, not step cost, is the serving-scale hazard: an int32"
    " row counter is fine in every unit test and saturates after 2^31 rows"
    " — about 25 minutes at the measured 1.40 Mrows/s — while an f32"
    " running sum silently absorbs-to-nothing long before any NaN appears."
    " Pass 5 derives each state's max per-step increment by interval"
    " abstract interpretation of the traced update program under declared"
    " per-batch input domains, converts it to a horizon in rows, gates it"
    " against the fleet floor AND the committed per-state baseline, and"
    " records every horizon so a dtype narrowing is a reviewed regression,"
    " not a silent one. StateGuard(overflow_margin=...) is the runtime"
    " counterpart (warn + count when an integer accumulator actually"
    " approaches its horizon).",
)

MTA011 = rule(
    "MTA011",
    "catastrophic-cancellation",
    "numerics",
    "Subtraction of two accumulated-sum-descended values of like"
    " sign/magnitude in a compute program (the E[x²]−E[x]² shape), with"
    " the family's measured relative error on adversarial ill-conditioned"
    " probes exceeding its committed per-family error budget"
    " (NUMERICS_BASELINE.json).",
    "Sufficient-statistics computes deliberately trade conditioning for a"
    " single fused pass: variance from Σx² and (Σx)² loses ~2·log10(shift)"
    " digits on mean-shifted data. That trade must be a MEASURED, committed"
    " number: the structural taint walk finds the cancellation-shaped"
    " subtractions, the measured leg evaluates each family on mean-shifted"
    " (1e6) and tiny-scale (1e-6) probes against an fp64 oracle fed the"
    " identical f32-cast inputs, and the observed budget is committed per"
    " family — so a refactor that worsens conditioning fails the gate even"
    " when the jaxpr shape is unchanged.",
)

MTA012 = rule(
    "MTA012",
    "scale-equivariance-broken",
    "numerics",
    "A declared scale-invariant metric (AUROC, average precision,"
    " retrieval ranks, R²) is not BIT-stable under power-of-two input"
    " rescaling, or a declared scale-equivariant one (MSE ×s², MAE ×s)"
    " does not transform exactly.",
    "Power-of-two rescaling is exact in IEEE arithmetic: it commutes"
    " bitwise with every add/sub/mul/div/sqrt in the program and preserves"
    " every comparison. A metric that should only depend on the ORDER"
    " statistics of its inputs (ranking metrics) or transform by a known"
    " exact factor (quadratic/linear losses) can therefore be checked"
    " metamorphically to the last bit — any drift is a hidden"
    " absolute-epsilon threshold, premature rounding, or a"
    " scale-dependent branch, exactly the class of bug that passes every"
    " oracle test at scale 1.0 and mis-scores real traffic at 1e-3.",
)

# ---------------------------------------------------------------------------
# pass 6 — fleet-protocol model checking (exhaustive crash/interleaving
# exploration over the REAL migration/lease/replication/failover code)
# ---------------------------------------------------------------------------
MTA013 = rule(
    "MTA013",
    "crash-consistency",
    "protocol",
    "An explored crash schedule of the two-phase tenant-migration protocol"
    " — a kill, double kill, or partition injected at a phase boundary,"
    " followed by a rebuild-from-disk in some recovery order and"
    " `MigrationCoordinator.recover()` — leaves a tenant owned by zero or"
    " two shards, regresses a replay cursor, double-folds a replayed wave,"
    " or GCs the source copy before the target's generation is durable.",
    "Chaos tests sample hand-picked kill points; the protocol explorer"
    " enumerates EVERY phase-boundary fault × recovery permutation over"
    " small real fleets (memoizing by durable-state hash so equivalent"
    " crash states are explored once) and asserts the exactly-once"
    " contract on every path: exactly-one-owner, no-lost-tenant, cursors"
    " monotone under full-stream replay, journal-GC-only-after-durable."
    " A violation carries the minimal failing schedule as a counterexample"
    " — the repro script for the bug, not just its existence. Coverage is"
    " gated against PROTOCOL_BASELINE.json (tighten-only): explored-state"
    " regressions flag, so the state space can only grow.",
)

MTA014 = rule(
    "MTA014",
    "fencing-linearizability",
    "protocol",
    "A stale-epoch owner's write (checkpoint, wave ack, replication"
    " shipment, or migration) interleaved against failover promotion"
    " becomes durable, or a shard's committed manifest records a"
    " non-monotone ownership epoch.",
    "Epoch fencing is only as good as its worst interleaving: the old"
    " owner may attempt its write after the fence but before promotion,"
    " mid-promotion, or after the fleet has moved on — and in every case"
    " the write must die typed (StaleEpochError/LeaseExpiredError) with"
    " nothing durable. The explorer drives the REAL lease/replication/"
    " failover code through each interleaving point and then audits every"
    " journal manifest for epoch monotonicity — the linearizability"
    " witness: if epochs only ever grow in committed records, no fenced"
    " writer ever won a race it should have lost.",
)


# ---------------------------------------------------------------------------
# pass 2 — repo-invariant lint (AST)
# ---------------------------------------------------------------------------
MTL101 = rule(
    "MTL101",
    "host-op-in-traced-path",
    "lint",
    "`np.*`, `.item()`, `.tolist()`, `.cpu()`, `.numpy()`, or"
    " `float()/int()/bool()` of a tensor inside an `update`/`forward`"
    " method, a `_*_update` functional or a function handed to"
    " `torch.compile`, outside an `_is_concrete`/`debug_enabled` guard.",
    "The step engine captures update paths into a CUDA graph: a host read"
    " there either fails the capture (demoting the step to eager) or bakes"
    " the value of the capture step into every replay, and off the graph it"
    " stalls the stream on a device-to-host sync every step. Value probes"
    " belong behind `_is_concrete` guards, the repo's idiom for eager-only"
    " checks.",
)

MTL102 = rule(
    "MTL102",
    "bare-jit",
    "lint",
    "`torch.cuda.graph`, `torch.cuda.CUDAGraph`,"
    " `torch.cuda.make_graphed_callables` or `torch.compile` outside"
    " `engine.py`; hot paths capture through the step engine.",
    "`engine.py` is the one place capture policy lives (the signature"
    " cache, the graph pool, the side stream, eager demotion, the"
    " watchdog's build counts). A capture or compile elsewhere silently"
    " opts out of every policy added there.",
)

MTL103 = rule(
    "MTL103",
    "hot-path-warn",
    "lint",
    "`warnings.warn`/`rank_zero_warn` inside an update path (an `update`"
    " or `forward` method, or a `_*_update` functional); use `warn_once`.",
    "Update paths run every step of a training loop; an unconditioned"
    " warning there floods logs at step rate. `warn_once` keys the"
    " warning so it fires once per process, the established idiom for"
    " engine demotion and watchdog warnings.",
)

MTL104 = rule(
    "MTL104",
    "unreduced-state",
    "lint",
    "An `add_state` call registering an array state without naming a"
    " `dist_reduce_fx` (list states may omit it: rank-order concat is"
    " their implied reduction).",
    "An array state synced with no reduction comes back as a stacked"
    " `(world, ...)` array — a silent shape change every downstream"
    " compute misreads. List states flatten in rank order, which IS"
    " concatenation, so `None` is sound there.",
)


MTL106 = rule(
    "MTL106",
    "thread-shared-state",
    "lint",
    "An instance attribute or module global reachable from more than one"
    " thread entry point (`Thread(target=...)`, `threading.Timer` bodies,"
    " `do_GET`-style HTTP handler methods, worker closures) is written"
    " without holding the owning lock.",
    "The host side of the serving loop is already multi-threaded — sync"
    " workers, the exporter's scrape threads, background checkpoint"
    " streaming next. A shared attribute written lock-free from two"
    " threads is a data race: torn updates, lost increments, and reads of"
    " half-constructed state that only reproduce under load. The lint"
    " infers thread-reachable scopes per module by walking the call graph"
    " from each spawn site and flags unprotected writes to state both"
    " sides touch; `__init__` writes are exempt (they happen-before the"
    " spawn), as is anything under a `with <lock>:` block. The dynamic"
    " twin is ThreadSan (MetricSan's arm-time instrumentation of the"
    " flagged attrs), which flight-dumps one `metricsan_thread_race` per"
    " (class, attr) when a cross-thread unsynchronized write actually"
    " happens.",
)


MTL107 = rule(
    "MTL107",
    "non-atomic-durability",
    "lint",
    "A file write in `metrics_tpu/` that bypasses the atomic tmp+fsync+"
    "rename primitives (`journal.atomic_write_json` / `checkpoint."
    "atomic_file`): a write-mode `open()` outside them, or an `os.rename`/"
    "`os.replace` with no `os.fsync` ordered before it in the same"
    " function.",
    "Every durability claim in the reliability layer rests on one write"
    " discipline: write to a temp file, fsync it, rename over the target."
    " A bare `open(path, 'w')` can tear on a kill and leave a half-written"
    " artifact a reader then trusts; a rename without a preceding fsync"
    " can land the NAME durably while the BYTES are still in the page"
    " cache — the classic crash leaves a zero-length or stale file at the"
    " final path. Both failure modes pass every test and only appear on"
    " power cuts, so the discipline must be a lint, not a code review"
    " habit. The primitives' own internals and deliberate torn-write"
    " injectors carry `# metrics-tpu: allow(MTL107)` with rationales, and"
    " MTL105 audits those suppressions for staleness like any other.",
)


MTL105 = rule(
    "MTL105",
    "stale-suppression",
    "lint",
    "A `# metrics-tpu: allow(<RULE>)` comment (or an `_analysis_allow`"
    " entry) that no longer suppresses any finding — the rule it names"
    " never fires at that site.",
    "Suppressions are an allowlist of audited exceptions, and an"
    " allowlist rots silently: the violation gets fixed, the comment"
    " stays, and a future REAL violation at the same site sails through"
    " pre-suppressed. The unused-noqa analogue: every allow must earn its"
    " keep every run, or be deleted.",
)


@dataclass
class Finding:
    """One violation (or suppressed violation) of a rule."""

    rule: str
    subject: str  # "ClassName.update" / "path.py:123"
    message: str
    severity: str = "error"  # "error" | "warning"
    suppressed: bool = False
    detail: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "rule": self.rule,
            "slug": RULES[self.rule].slug if self.rule in RULES else "",
            "subject": self.subject,
            "severity": self.severity,
            "message": self.message,
        }
        if self.suppressed:
            d["suppressed"] = True
        if self.detail:
            d["detail"] = self.detail
        return d

    def __str__(self) -> str:
        tag = " [suppressed]" if self.suppressed else ""
        return f"{self.rule}{tag} {self.subject}: {self.message}"


def parse_allow_comments(source: str) -> Dict[int, Set[str]]:
    """``# metrics-tpu: allow(RULE[, RULE])`` comments by 1-based line.

    A finding on line ``L`` is suppressed when an allow comment for its
    rule sits on ``L`` itself (trailing) or on ``L - 1`` (the line above);
    :func:`metrics_tpu_torch.analysis.lint.lint_file` applies that adjacency.

    Only real ``#`` COMMENT tokens count — a docstring that *documents* the
    syntax (like this module's own) must not widen anyone's suppression
    set, so the source is tokenized rather than regex-scanned. Sources the
    tokenizer rejects (truncated class bodies from ``inspect.getsource``)
    fall back to the line scan.
    """
    out: Dict[int, Set[str]] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(textwrap.dedent(source)).readline)
        for tok in tokens:
            if tok.type == tokenize.COMMENT:
                m = _ALLOW_RE.search(tok.string)
                if m:
                    out.setdefault(tok.start[0], set()).update(
                        r.strip() for r in m.group(1).split(",")
                    )
    except (tokenize.TokenError, IndentationError, SyntaxError):
        out.clear()
        for lineno, line in enumerate(source.splitlines(), start=1):
            m = _ALLOW_RE.search(line)
            if m:
                out[lineno] = {r.strip() for r in m.group(1).split(",")}
    return out


def _method_body_lines(source: str) -> Set[int]:
    """1-based line numbers covered by function/method bodies in ``source``
    (a class body from ``inspect.getsource``). Unparseable sources return
    the empty set — every comment then counts, the pre-scoping behavior."""
    import ast

    lines: Set[int] = set()
    try:
        tree = ast.parse(textwrap.dedent(source))
    except SyntaxError:
        return lines
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            lines.update(range(node.lineno, (node.end_lineno or node.lineno) + 1))
    return lines


def class_allowed_rules(cls: type) -> Set[str]:
    """Class-wide program-audit suppression set for a metric class: rule
    IDs from any ``# metrics-tpu: allow(...)`` comment at **class-body
    level** (directly in the class body, not inside a method — a comment
    scoped to one ``add_state`` line must not silence the rule for every
    state of every subclass), unioned over the MRO, plus an explicit
    ``_analysis_allow`` attribute (an iterable of rule IDs) for
    dynamically built classes whose source is unavailable.

    For suppression scoped to *specific states*, ``_analysis_allow`` may
    instead be a mapping ``{rule_id: (state_name, ...)}`` — resolved by
    :func:`state_allowed_rules`, not here."""
    import inspect

    attr = getattr(cls, "_analysis_allow", ()) or ()
    allowed: Set[str] = set() if isinstance(attr, dict) else set(attr)
    for klass in cls.__mro__:
        if klass in (object,):
            continue
        try:
            src = inspect.getsource(klass)
        except (OSError, TypeError):
            continue
        method_lines = _method_body_lines(src)
        for lineno, ids in parse_allow_comments(src).items():
            if lineno not in method_lines:
                allowed |= ids
    return allowed


def own_class_allowed_rules(cls: type) -> Set[str]:
    """Suppression rules declared on ``cls`` ITSELF — its own class-body
    allow comments plus its own (non-inherited) iterable
    ``_analysis_allow`` — excluding everything inherited over the MRO.
    This is the staleness universe for MTL105: an inherited allow may be
    earning its keep on the parent, so only the declaring class can be
    told its allow is stale."""
    import inspect

    attr = cls.__dict__.get("_analysis_allow", ()) or ()
    allowed: Set[str] = set() if isinstance(attr, dict) else set(attr)
    try:
        src = inspect.getsource(cls)
    except (OSError, TypeError):
        return allowed
    method_lines = _method_body_lines(src)
    for lineno, ids in parse_allow_comments(src).items():
        if lineno not in method_lines:
            allowed |= ids
    return allowed


def state_allowed_rules(obj: Any) -> Dict[str, Set[str]]:
    """State-scoped program-audit suppression: ``{rule_id: {state names}}``
    from a mapping-form ``_analysis_allow``. Accepts a metric *instance*
    (so registration code that creates states dynamically — e.g. a mixin
    building streams from a spec dict — can scope its suppression to
    exactly the states it registered) or a class."""
    attr = getattr(obj, "_analysis_allow", None)
    if not isinstance(attr, dict):
        return {}
    return {rule_id: set(names) for rule_id, names in attr.items()}
