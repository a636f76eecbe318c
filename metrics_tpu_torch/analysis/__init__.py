"""Static analysis for the port: catch the bad program before it
dispatches, not after it corrupts an epoch.

Port of ``metrics_tpu/analysis/``. One rule namespace
(:mod:`metrics_tpu_torch.analysis.rules`, the JAX package's
catalog, MTA001–MTA014 and MTL101–MTL107):

* **Pass 1 — the program audit** (:mod:`metrics_tpu_torch.analysis.program`):
  each metric family's ``update`` and the step the engine would build,
  traced with ``make_fx`` over fake tensors on the metric's device —
  accumulator dtypes (MTA001), host reads and transfers in a traced
  program (MTA002), buffers aliased across outputs (MTA003), reduction
  soundness (MTA004) — over the JAX package's 29 families with their
  cohort and quantized variants (:func:`audit_registry`, on the card unless
  the caller asks for the CPU). Its registry resolves the watchdog's
  cross-link.
* **Pass 2 — repo-invariant lint** (:mod:`metrics_tpu_torch.analysis.lint`):
  AST checks over the ``metrics_tpu_torch`` source tree — host reads in a
  path a CUDA graph captures (MTL101), graph capture or ``torch.compile``
  outside ``engine.py`` (MTL102), step-rate warnings that bypass
  ``warn_once`` (MTL103), array states registered without a
  ``dist_reduce_fx`` (MTL104), stale suppressions (MTL105), and the legs
  of passes 4 and 6 below (MTL106, MTL107).
* **Pass 3 — distributed equivalence and lifecycle**
  (:mod:`metrics_tpu_torch.analysis.distributed`): R ∈ {1, 2, 4} replicas
  against one on concrete grid probes (MTA005), reset identity, compute
  purity and residual coherence (MTA006), buffer lifetime and checkpoint
  ownership (MTA007), and the program fingerprints.
* **Pass 4 — concurrency soundness**
  (:mod:`metrics_tpu_torch.analysis.concurrency`): each engine-eligible
  family's host-seam budget gated against the committed
  ``SEAM_BASELINE.json`` (MTA008) and the port's host crossing sites; the
  double-buffer prover over the step graph and the traced two-generation
  graph (MTA009), whose AST and tensor legs ``AsyncServingEngine``'s
  admission runs; the thread-shared-state lint (MTL106) with its
  thread-shared model.
* **Pass 5 — numerical soundness**
  (:mod:`metrics_tpu_torch.analysis.numerics`): per-state
  overflow/ulp-absorption horizons in rows by interval evaluation of each
  family's traced update graph under declared per-batch input domains
  (MTA010), cancellation-shaped subtractions in compute graphs and every
  family's relative error on adversarial ill-conditioned probes against a
  float64 oracle (MTA011), and a bitwise metamorphic check of declared
  scale-invariant/-equivariant families under power-of-two rescaling
  (MTA012) — gated against the committed ``NUMERICS_BASELINE.json``.
* **Pass 6 — fleet-protocol model checking**
  (:mod:`metrics_tpu_torch.analysis.protocol`): a deterministic explorer
  drives the port's REAL migration/lease/replication/failover code over
  small on-disk fleets whose cohorts live on the card (or the CPU, when
  asked), enumerating every phase-boundary kill, double kill, partition,
  and recovery permutation (MTA013), a stale-epoch owner's writes against
  failover promotion (MTA014), and the MTL107 durability lint leg — gated
  against the committed tighten-only ``PROTOCOL_BASELINE.json``.

**MetricSan** (:mod:`metrics_tpu_torch.analysis.sanitizer`) is the opt-in
runtime twin: armed by ``METRICS_TPU_SAN=1``, :func:`enable_san` or
:func:`san_scope`, it catches at run time what the passes cannot see (a
freed or graph-owned buffer reachable after a dispatch, MTA007; a state
write outside the lifecycle and a non-identity reset, MTA006; a
world-size-1 sync that is no identity, MTA005; a cross-thread race,
MTL106) and reports each under the rule it refutes.

Suppress a rule at a site with ``# metrics-tpu: allow(<RULE-ID>)``
(stale allows are themselves flagged, MTL105).
"""
from metrics_tpu_torch.analysis.rules import RULES, Finding, Rule  # noqa: F401
from metrics_tpu_torch.analysis.program import (  # noqa: F401
    AuditResult,
    audit_collection,
    audit_metric,
    audit_registry,
    hint_for_watch_key,
    iter_eqns,
)
from metrics_tpu_torch.analysis.distributed import (  # noqa: F401
    check_donation_lifetime,
    check_lifecycle,
    check_replica_equivalence,
    fingerprint_jaxpr,
)
from metrics_tpu_torch.analysis.concurrency import (  # noqa: F401
    check_double_buffer,
    check_host_seam,
    composed_generation_hazards,
    flatten_seam_budget,
    host_seam_budget,
    host_seam_sites,
    load_seam_baseline,
    register_threadsan_target,
    thread_shared_model,
)
from metrics_tpu_torch.analysis.numerics import (  # noqa: F401
    check_numerics,
    equivariance_verdict,
    eval_jaxpr_intervals,
    load_numerics_baseline,
    measure_error_budget,
    state_horizons,
)
from metrics_tpu_torch.analysis.lint import lint_file, lint_paths  # noqa: F401
from metrics_tpu_torch.analysis.protocol import (  # noqa: F401
    check_protocol,
    counterexample_report,
    durability_findings,
    explore_crash_consistency,
    explore_fencing,
    load_protocol_baseline,
    tighten_protocol_baseline,
)
from metrics_tpu_torch.analysis.sanitizer import (  # noqa: F401
    MetricSan,
    MetricSanError,
    disable_san,
    enable_san,
    san_scope,
)

__all__ = [
    "AuditResult",
    "Finding",
    "MetricSan",
    "MetricSanError",
    "Rule",
    "RULES",
    "audit_collection",
    "audit_metric",
    "audit_registry",
    "check_donation_lifetime",
    "check_double_buffer",
    "check_host_seam",
    "check_lifecycle",
    "check_numerics",
    "check_protocol",
    "check_replica_equivalence",
    "composed_generation_hazards",
    "counterexample_report",
    "disable_san",
    "durability_findings",
    "enable_san",
    "equivariance_verdict",
    "eval_jaxpr_intervals",
    "explore_crash_consistency",
    "explore_fencing",
    "fingerprint_jaxpr",
    "flatten_seam_budget",
    "hint_for_watch_key",
    "host_seam_budget",
    "host_seam_sites",
    "iter_eqns",
    "lint_file",
    "lint_paths",
    "load_numerics_baseline",
    "load_protocol_baseline",
    "load_seam_baseline",
    "measure_error_budget",
    "register_threadsan_target",
    "san_scope",
    "state_horizons",
    "thread_shared_model",
    "tighten_protocol_baseline",
]
