"""The port's analysis gate: run the static-analysis passes over metrics_tpu_torch, write a report.

Usage::

    python3 scripts/torch_lint_metrics.py --device cpu            # report, exit 0
    python3 scripts/torch_lint_metrics.py --device cpu --strict   # exit 1 on any unsuppressed finding
    python3 scripts/torch_lint_metrics.py --strict                # the same on the card (the default device)
    python3 scripts/torch_lint_metrics.py --device cpu --diff-fingerprints
                                                                  # drift vs FINGERPRINTS_TORCH.json (advisory)

Passes 1 + 3 + 4 + 5 (:func:`metrics_tpu_torch.analysis.audit_registry`)
trace every metric family's update and engine step with ``make_fx`` over
fake tensors of ``--device`` — and the ``sync_precision="int8"/"bf16"`` and
``@cohort`` variants — and audit accumulator dtypes, host sync, buffer
aliasing, reduction soundness, N-replica distributed equivalence,
state-lifecycle soundness, donation lifetimes, the host-seam budget
(MTA008, gated against ``SEAM_BASELINE.json``), two-generation
double-buffer safety (MTA009) and numerical soundness (MTA010–MTA012,
gated against ``NUMERICS_BASELINE.json``). Pass 2
(:func:`metrics_tpu_torch.analysis.lint_paths`) lints the
``metrics_tpu_torch`` source tree for the repo invariants (MTL101–MTL107).
Pass 6 (:func:`metrics_tpu_torch.analysis.check_protocol`) model-checks
the fleet protocol over the port's real fleet code on ``--device``,
gated against ``PROTOCOL_BASELINE.json``. ``--strict`` folds every pass
into the exit code. ``--device`` defaults to the card; ``--device cuda``
without one raises before anything is built.

The root baselines are the JAX package's and are read, never written, by
default. ``--refresh-seam-baseline PATH``, ``--refresh-numerics-baseline
PATH`` and ``--refresh-protocol-baseline PATH`` each rewrite only the file
``PATH`` names (there is no default path): the seam budgets are rebuilt
from this run's registry (fixture entries keep their committed budgets),
the numerics entries are tightened IMPROVEMENTS ONLY (horizons up, budgets
down), and the protocol coverage TIGHTEN-ONLY. All three refuse a red or
partial run, and a missing file, so a regression is never laundered by a
rerun.

``--fingerprints`` adds each family's update/step graph digests to the
report; ``--fingerprints-json PATH`` also writes them to ``PATH``.
``--diff-fingerprints [PATH]`` compares fresh digests against a committed
file (default ``FINGERPRINTS_TORCH.json`` at the repo root, the port's
own: its digests never equal the JAX package's, whose IR is another) and
prints every drifted family; drift is advisory and leaves the exit code
alone. The digests carry no device, so the card's and the CPU's agree.

The report (``--json``, default ``ANALYSIS_TORCH.json``) is written
atomically (``reliability.journal.atomic_write_json``).
"""
import argparse
import json
import os
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from metrics_tpu_torch.analysis.protocol import refresh_protocol_baseline  # noqa: E402
from metrics_tpu_torch.reliability.journal import atomic_write_json  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FINGERPRINTS_FILE = os.path.join(REPO, "FINGERPRINTS_TORCH.json")


def _load_fingerprints(path: str):
    """The committed digests from ``path``, or None when unreadable."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            return json.load(fh).get("fingerprints") or {}
    except (OSError, ValueError) as err:
        print(f"fingerprint diff: cannot read {path} ({err}); skipping")
        return None


def _diff_fingerprints(current: dict, committed, committed_path: str) -> int:
    """Print the drift between fresh digests and the committed file (loaded
    BEFORE any write of the same file: diffing a file this run just wrote
    would vacuously report no drift); returns the number of drifted, added
    or removed families."""
    if committed is None:
        return 0
    drift = 0
    for fam in sorted(set(current) | set(committed)):
        cur, old = current.get(fam), committed.get(fam)
        if cur == old:
            continue
        drift += 1
        if old is None:
            print(f"  NEW      {fam}: {cur}")
        elif cur is None:
            print(f"  REMOVED  {fam} (was {old})")
        else:
            for leg in sorted(set(cur) | set(old)):
                if cur.get(leg) != old.get(leg):
                    print(
                        f"  DRIFTED  {fam}.{leg}: {old.get(leg)} -> {cur.get(leg)}"
                        "  (metric program changed: ops/dtypes/shapes differ)"
                    )
    if drift:
        print(
            f"fingerprint diff: {drift} famil{'y' if drift == 1 else 'ies'} drifted"
            f" vs {committed_path} — if intended, rewrite it"
            " (--fingerprints --fingerprints-json PATH); if not, a dependency or"
            " refactor changed a metric's traced program"
        )
    else:
        print(f"fingerprint diff: no drift vs {committed_path}")
    return drift


def _read_baseline(path: str, kind: str):
    """``(baseline, None)``, or ``(None, refusal line)`` when ``path`` is
    missing or unreadable: a refresh updates a committed file and never
    bootstraps one (the hand-written fixture entries would be lost)."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            return json.load(fh), None
    except (OSError, ValueError) as err:
        return None, (
            f"{kind} baseline NOT refreshed: {path} is missing or unreadable"
            f" ({err}); restore the committed file (git checkout) before refreshing"
        )


def refresh_seam_baseline(path: str, seam_families: dict, findings: int, partial: bool) -> str:
    """Apply (or refuse) one ``--refresh-seam-baseline`` request and return
    the outcome line; writes ``path`` and nothing else. A partial audit
    would prune (and ungate) every variant it skipped; a red audit would
    launder an MTA008 regression into the file (an intended crossing
    increase is a reviewed hand edit); a missing file is bootstrap-by-hand.
    A permitted refresh rebuilds the budgets from this run's registry:
    retired families are pruned, the entries named in ``fixtures`` keep
    their committed budgets."""
    from metrics_tpu_torch.analysis.concurrency import flatten_seam_budget

    if partial:
        return (
            "seam baseline NOT refreshed: --no-cohort/--no-quantized audits are"
            " partial; refresh requires the full variant namespace"
        )
    if findings:
        return (
            f"seam baseline NOT refreshed: the audit reported {findings}"
            " unsuppressed finding(s); fix them (or hand-edit the seam baseline"
            " for an intended crossing increase) and re-run"
        )
    baseline, refusal = _read_baseline(path, "seam")
    if refusal:
        return refusal
    old = baseline.get("budgets", {})
    keep = set(baseline.get("fixtures", []))
    budgets = {fam: old[fam] for fam in sorted(keep) if fam in old}
    for fam, seam in sorted(seam_families.items()):
        budgets[fam] = {"states": seam.get("states", []), "budget": flatten_seam_budget(seam)}
    pruned = sorted(set(old) - set(budgets))
    baseline["budgets"] = budgets
    atomic_write_json(path, baseline)
    return f"refreshed {path} ({len(seam_families)} registry budgets" + (f"; pruned {pruned}" if pruned else "") + ")"


def refresh_numerics_baseline(path: str, numerics_entries: dict, findings: int, partial: bool) -> str:
    """Apply (or refuse) one ``--refresh-numerics-baseline`` request and
    return the outcome line; writes ``path`` and nothing else. The refusal
    ladder is the seam baseline's (partial, red, missing). A permitted
    refresh is IMPROVEMENTS ONLY (horizons up, budgets down) via
    :func:`metrics_tpu_torch.analysis.numerics.tighten_baseline`."""
    from metrics_tpu_torch.analysis.numerics import build_numerics_entry, tighten_baseline

    if partial:
        return (
            "numerics baseline NOT refreshed: --no-cohort/--no-quantized"
            " audits are partial; refresh requires the full variant namespace"
        )
    if findings:
        return (
            "numerics baseline NOT refreshed: the audit reported"
            f" {findings} unsuppressed finding(s); fix them (or hand-edit"
            " NUMERICS_BASELINE.json for an intended horizon/budget change)"
            " and re-run"
        )
    baseline, refusal = _read_baseline(path, "numerics")
    if refusal:
        return refusal
    fresh = {fam: build_numerics_entry(ev) for fam, ev in numerics_entries.items()}
    baseline, pruned = tighten_baseline(baseline, fresh)
    atomic_write_json(path, baseline)
    return f"refreshed {path} ({len(fresh)} registry entries" + (f"; pruned {pruned}" if pruned else "") + ")"


def _run_audit(args, report: dict, fingerprints: bool, committed) -> int:
    """Passes 1 + 3 + 4 + 5 into ``report``; returns the unsuppressed count."""
    from metrics_tpu_torch.analysis import audit_registry
    from metrics_tpu_torch.analysis.numerics import min_horizon_rows

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # config-edge warnings from factories
        audit = audit_registry(
            quantized=not args.no_quantized,
            cohort=not args.no_cohort,
            fingerprints=fingerprints,
            device=args.device,
        )
    report["program_audit"] = audit
    summary = audit["summary"]
    if fingerprints:
        report["fingerprints"] = audit.get("fingerprints", {})
        if args.fingerprints_json != "-":
            atomic_write_json(args.fingerprints_json, {
                "schema": "metrics_tpu_torch.program_fingerprints",
                "version": 1,
                "fingerprints": report["fingerprints"],
            })
            print(f"wrote {args.fingerprints_json}")
    print(
        f"passes 1+3+4 (program audit): {summary['families']} families,"
        f" {summary['findings']} findings ({summary['suppressed']} suppressed)"
    )
    evidence = {fam: entry.get("evidence") or {} for fam, entry in audit["families"].items()}
    seam_families = {fam: ev["host_seam"] for fam, ev in evidence.items() if ev.get("host_seam")}
    db_safe = sum(1 for ev in evidence.values() if (ev.get("double_buffer") or {}).get("safe") is True)
    print(
        f"pass 4 (concurrency): {len(seam_families)} seam budgets,"
        f" {db_safe} families double-buffer safe,"
        f" {len(audit.get('host_seam_sites', []))} host crossing sites"
    )
    numerics_entries = {fam: ev["numerics"] for fam, ev in evidence.items() if ev.get("numerics")}
    horizon_min = min_horizon_rows(numerics_entries)
    budgets = sum(1 for ev in numerics_entries.values() if (ev.get("cancellation") or {}).get("budget") is not None)
    flagged = sum(1 for ev in numerics_entries.values() if (ev.get("cancellation") or {}).get("sites"))
    print(
        f"pass 5 (numerics): {len(numerics_entries)} entries"
        + ("" if horizon_min is None else
           f", min horizon {horizon_min:.4g} rows, {budgets} measured error budgets,"
           f" {flagged} cancellation-shaped computes")
    )
    for entry in audit["families"].values():
        for f in entry["findings"]:
            print(f"  {f['rule']} {f['subject']}: {f['message']}")
    partial = args.no_cohort or args.no_quantized
    if args.refresh_seam_baseline is not None:
        print(refresh_seam_baseline(args.refresh_seam_baseline, seam_families, summary["findings"], partial))
    if args.refresh_numerics_baseline is not None:
        print(refresh_numerics_baseline(args.refresh_numerics_baseline, numerics_entries, summary["findings"], partial))
    if args.diff_fingerprints is not None:
        report["fingerprint_drift"] = _diff_fingerprints(
            report.get("fingerprints", {}), committed, args.diff_fingerprints
        )
    return summary["findings"]


def _run_lint(report: dict) -> int:
    """Pass 2 into ``report``; returns the unsuppressed count."""
    from metrics_tpu_torch.analysis import lint_paths

    findings = lint_paths()
    live = [f for f in findings if not f.suppressed]
    report["lint"] = {
        "findings": [f.to_dict() for f in findings],
        "summary": {"findings": len(live), "suppressed": len(findings) - len(live)},
    }
    print(f"pass 2 (repo lint): {len(live)} findings ({len(findings) - len(live)} suppressed)")
    for f in live:
        print(f"  {f.rule} {f.subject}: {f.message}")
    return len(live)


def _run_protocol(args, report: dict) -> int:
    """Pass 6 into ``report``; returns the unsuppressed count."""
    from metrics_tpu_torch.analysis import check_protocol, counterexample_report

    protocol = check_protocol(device=args.device)
    report["protocol"] = protocol
    report.setdefault("evidence", {})["protocol"] = protocol["evidence"]
    summary = protocol["summary"]
    print(
        f"pass 6 (protocol): {summary['states_explored']} durable states over"
        f" {summary['schedules']} schedules, {summary['findings']} findings"
    )
    for f in protocol["findings"]:
        print(f"  {f['rule']} {f['subject']}: {f['message']}")
    if protocol["findings"]:
        print(counterexample_report(protocol["findings"]), end="")
    if args.refresh_protocol_baseline is not None:
        print(refresh_protocol_baseline(args.refresh_protocol_baseline, protocol, skipped=False))
    return summary["findings"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--strict", action="store_true", help="exit non-zero on any unsuppressed finding")
    ap.add_argument("--json", default="ANALYSIS_TORCH.json", metavar="PATH",
                    help="report path (default: ANALYSIS_TORCH.json; '-' to skip)")
    ap.add_argument("--skip-audit", action="store_true", help="no program audit (passes 1, 3, 4, 5)")
    ap.add_argument("--skip-lint", action="store_true", help="no repo lint (pass 2)")
    ap.add_argument("--skip-protocol", action="store_true", help="no fleet-protocol exploration (pass 6)")
    ap.add_argument("--no-quantized", action="store_true", help="skip the sync_precision=int8/bf16 variants")
    ap.add_argument("--no-cohort", action="store_true", help="skip the vmapped cohort-step variants")
    ap.add_argument("--fingerprints", action="store_true", help="add per-family graph digests to the report")
    ap.add_argument("--fingerprints-json", metavar="PATH", default="-",
                    help="also write the digests to PATH (default '-': write none)")
    ap.add_argument("--diff-fingerprints", metavar="COMMITTED", nargs="?", const=FINGERPRINTS_FILE, default=None,
                    help="compare fresh digests against a committed file (advisory; implies --fingerprints;"
                         " default file: FINGERPRINTS_TORCH.json at the repo root)")
    ap.add_argument("--refresh-seam-baseline", metavar="PATH", default=None,
                    help="rebuild the seam budgets in PATH from this run (refuses a red or partial audit)")
    ap.add_argument("--refresh-numerics-baseline", metavar="PATH", default=None,
                    help="tighten the numerics entries in PATH from this run, improvements only"
                         " (refuses a red or partial audit)")
    ap.add_argument("--refresh-protocol-baseline", metavar="PATH", default=None,
                    help="tighten the protocol coverage in PATH from this run (refuses a red or skipped pass)")
    ap.add_argument("--device", default=None,
                    help="where the metrics and fleets live: 'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    report = {"schema": "metrics_tpu_torch.analysis_report", "version": 4, "device": args.device or "cuda"}
    unsuppressed = 0
    fingerprints = args.fingerprints or args.diff_fingerprints is not None
    # read before any write below: --fingerprints-json may name the same file
    committed = _load_fingerprints(args.diff_fingerprints) if args.diff_fingerprints is not None else None

    if not args.skip_audit:
        unsuppressed += _run_audit(args, report, fingerprints, committed)
    elif args.refresh_seam_baseline is not None or args.refresh_numerics_baseline is not None:
        print("seam/numerics baselines NOT refreshed: --skip-audit runs have no audit to merge")
    if not args.skip_lint:
        unsuppressed += _run_lint(report)
    if not args.skip_protocol:
        unsuppressed += _run_protocol(args, report)
    elif args.refresh_protocol_baseline is not None:
        print(refresh_protocol_baseline(args.refresh_protocol_baseline, {}, skipped=True))

    report["summary"] = {"unsuppressed_findings": unsuppressed}
    if args.json != "-":
        atomic_write_json(args.json, report)
        print(f"wrote {args.json}")
    if args.strict and unsuppressed:
        print(f"STRICT: {unsuppressed} unsuppressed finding(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
