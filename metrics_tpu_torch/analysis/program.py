"""Pass 1 — the program audit: its audit registry and the watchdog
cross-link.

Port of the registry half of ``metrics_tpu/analysis/program.py``. The
audit itself (abstract steps of each metric family walked for MTA001–MTA004)
is not ported yet; what is here lets every ported pass register its
findings by class name, so the
:class:`~metrics_tpu_torch.observability.RecompilationWatchdog` can name the
rule likely responsible when it fires. The fleet-protocol explorer
(:mod:`metrics_tpu_torch.analysis.protocol`) registers here today.
"""
from typing import Dict, List, Optional

from metrics_tpu_torch.analysis.rules import RULES, Finding

__all__ = ["hint_for_watch_key"]

# class name -> unsuppressed findings from the most recent audit of that
# class (any entry point: the protocol explorers, tests). The
# RecompilationWatchdog consults this when it fires so its warning can name
# the analyzer rule likely responsible for the churn it observed.
_LAST_AUDIT: Dict[str, List[Finding]] = {}


def _note_audit(cls_name: str, findings: List[Finding]) -> None:
    """Register the findings of the latest audit of ``cls_name``."""
    _LAST_AUDIT[cls_name] = list(findings)


def hint_for_watch_key(key: str) -> Optional[str]:
    """A one-line analyzer attribution for a watchdog key (an engine label
    like ``engine[Accuracy,MeanSquaredError]`` or a bare metric-class
    name), or None when the last audit holds nothing relevant. MTA001
    findings front the list: signature churn is exactly what the watchdog
    measures.

    Best-effort by construction: the lookup is keyed by bare class name
    and reflects the *most recent* audit of any class with that name —
    two same-named classes collide, and a finding fixed in source still
    hints until the class is re-audited. The hint's "a likely cause"
    phrasing is the contract; treat it as a lead, not a verdict."""
    # cohort engines suffix their watch key ("engine[A,B]@cohort"): the
    # suffix routes trace-budget accounting per cohort, not attribution —
    # strip it so churn on a cohort key still resolves to its members'
    # findings (MTA001 fronted: unbucketed cohort churn IS signature churn)
    if key.endswith("@cohort"):
        key = key[: -len("@cohort")]
    inner = key
    if "[" in key and key.endswith("]"):
        inner = key[key.index("[") + 1:-1]
    names = [p.strip() for p in inner.split(",") if p.strip()]
    relevant: List[Finding] = []
    for n in names:
        relevant.extend(_LAST_AUDIT.get(n, ()))
    if not relevant:
        return None
    relevant.sort(key=lambda f: (f.rule != "MTA001", f.rule))
    f = relevant[0]
    slug = RULES[f.rule].slug if f.rule in RULES else ""
    more = f" (+{len(relevant) - 1} more)" if len(relevant) > 1 else ""
    return (
        f"static analysis flagged {f.rule} ({slug}) on {f.subject}{more} —"
        " a likely cause; see docs/static_analysis.md"
    )
