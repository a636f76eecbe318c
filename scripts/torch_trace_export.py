#!/usr/bin/env python
"""Convert the port's observability dumps to Chrome/Perfetto trace JSON.

The port's twin of ``scripts/trace_export.py``: it reads and writes through
``metrics_tpu_torch`` (``observability/trace.py::spans_to_perfetto``,
``reliability/journal.py::atomic_write_json``) and imports no JAX, so it
runs where the card is. The dump formats are the JAX package's, and on the
same files both scripts write equal JSON. It accepts either artifact the
port's observability layer writes:

* a **native trace dump** (``TraceRecorder.snapshot()`` / ``to_json()``,
  format marker ``metrics_tpu.trace``): spans become complete
  (``ph: "X"``) trace events with phase categories and step args, on a
  process track named after the dump's rank identity. Spans carrying
  causal batch ids (schema v2 ``flow`` lists: the serving pipeline's
  admission, dispatch and checkpoint chains) also emit Perfetto flow
  events (``ph: "s"/"t"/"f"`` arrows), namespaced per process track so a
  merged multi-rank timeline never joins two ranks' unrelated batches;
* a **flight-recorder dump** (``metrics_tpu.flight_dump``): the event ring
  becomes instant events on a synthetic timeline (events carry relative
  seconds, not span timestamps), one row per event kind.

Already-converted Perfetto files (a ``traceEvents`` key) pass through
unchanged, so globbing a mixed dump directory is safe; a telemetry snapshot
(no timeline) is refused.

Usage::

    python3 scripts/torch_trace_export.py DUMP.json [...more] [-o OUT.json]
    python3 scripts/torch_trace_export.py flight-dumps/*.json
    python3 scripts/torch_trace_export.py --merge rank0.json rank1.json -o merged.json

With one input, ``-o`` names the output (default: ``<input>.perfetto.json``
next to the input); with several, each converts next to its input and
``-o`` is refused, unless ``--merge`` is given, which aligns N per-rank
native trace dumps on the durable step index into one timeline with one
process track per rank. Each rank's clock has its own origin; the merge
anchors every rank at the earliest span of the smallest step index that
every rank recorded. Open the results at https://ui.perfetto.dev or
``chrome://tracing``.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from metrics_tpu_torch.observability.trace import spans_to_perfetto  # noqa: E402
from metrics_tpu_torch.reliability.journal import atomic_write_json  # noqa: E402


def flight_to_perfetto(dump: dict) -> dict:
    """Flight-dump events as Perfetto instants (µs timeline from the
    recorder's relative-seconds stamps), one row per event kind."""
    events = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": 1,
            "tid": 0,
            "args": {"name": f"flight:{dump.get('reason', 'dump')}"},
        }
    ]
    for e in dump.get("events", []):
        fields = {k: v for k, v in e.items() if k not in ("t", "kind")}
        events.append(
            {
                "name": e.get("kind", "event"),
                "cat": "flight",
                "ph": "i",
                "s": "t",
                "pid": 1,
                "tid": 1,
                "ts": round(float(e.get("t", 0.0)) * 1e6, 3),
                "args": fields,
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def convert(blob: dict) -> dict:
    if "traceEvents" in blob:
        return blob  # already Perfetto: pass through
    fmt = blob.get("format")
    if fmt == "metrics_tpu.trace" or "spans" in blob:
        return spans_to_perfetto(blob.get("spans", []), identity=blob.get("identity"))
    # the marker-less "events" fallback must not swallow telemetry exit
    # dumps (they also carry an events list, but timeline-less): globbing a
    # mixed artifact dir should skip those loudly, not emit an all-ts-0 trace
    if fmt == "metrics_tpu.flight_dump" or (
        "events" in blob and "counters" not in blob
    ):
        return flight_to_perfetto(blob)
    raise ValueError(
        "unrecognized dump: expected a metrics_tpu trace dump (spans),"
        " a flight dump (events), or trace_event JSON (traceEvents) —"
        " telemetry snapshots have no timeline to convert;"
        f" got keys {sorted(blob)[:8]}"
    )


def merge_rank_traces(blobs: list) -> dict:
    """Merge N per-rank native trace dumps into one Perfetto timeline.

    Alignment contract: each dump's ``ts_us`` clock starts at an
    arbitrary per-process origin, but the **step index** riding every
    span is durable and rank-correlated (the engine's dispatch counter,
    or the EvalSession cursor when a session pins it). The merge anchors
    every rank's clock so the earliest span of the smallest step index
    ALL ranks recorded lands at t=0 — after that, per-rank skew *within*
    a step is real signal (the slow rank), not clock noise. Ranks come
    from each dump's identity stamp (falling back to input order), one
    Perfetto process track per rank.
    """
    for i, blob in enumerate(blobs):
        if blob.get("format") != "metrics_tpu.trace" and "spans" not in blob:
            raise ValueError(
                "--merge takes native metrics_tpu trace dumps"
                f" (TraceRecorder.to_json()); input {i} has keys"
                f" {sorted(blob)[:6]}"
            )
    # rank assignment in two passes so a duplicate/unstamped dump can
    # never steal a LATER input's legitimately-stamped rank (which would
    # relabel the real rank's track and misattribute the slow-rank
    # signal): first honor every stamp (first claimer wins), then hand
    # duplicates and unstamped inputs ranks outside the claimed set.
    claimed = set()
    assigned = [None] * len(blobs)
    for i, blob in enumerate(blobs):
        identity = blob.get("identity") or {}
        if "rank" in identity and int(identity["rank"]) not in claimed:
            assigned[i] = int(identity["rank"])
            claimed.add(assigned[i])
    fallback = 0
    for i, blob in enumerate(blobs):
        if assigned[i] is not None:
            continue
        while fallback in claimed:
            fallback += 1
        assigned[i] = fallback
        claimed.add(fallback)
        print(
            f"warning: input {i} has a missing or already-claimed rank"
            f" identity; assigning it track rank {assigned[i]}",
            file=sys.stderr,
        )
    per_rank = []
    for i, blob in enumerate(blobs):
        rank = assigned[i]
        identity = dict(blob.get("identity") or {})
        identity.setdefault("world_size", len(blobs))
        identity["rank"] = rank
        spans = blob.get("spans", [])
        steps = {}
        for s in spans:
            step = s.get("step")
            if step is None:
                continue
            ts = float(s["ts_us"])
            if step not in steps or ts < steps[step]:
                steps[step] = ts
        per_rank.append({"identity": identity, "spans": spans, "steps": steps})
    common = None
    for entry in per_rank:
        stepset = set(entry["steps"])
        common = stepset if common is None else (common & stepset)
    if not common:
        raise ValueError(
            "--merge found no step index common to every input trace —"
            " step-aligned merging needs overlapping step ranges (were"
            " these dumps recorded over the same eval stream?)"
        )
    anchor = min(common)
    events = []
    for entry in sorted(per_rank, key=lambda e: e["identity"]["rank"]):
        offset = -entry["steps"][anchor]
        converted = spans_to_perfetto(
            entry["spans"], identity=entry["identity"], ts_offset_us=offset
        )
        events.extend(converted["traceEvents"])
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "merged_ranks": sorted(e["identity"]["rank"] for e in per_rank),
            "anchor_step": anchor,
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("inputs", nargs="+", help="dump file(s) to convert")
    ap.add_argument("-o", "--output", help="output path (single input only, or --merge)")
    ap.add_argument(
        "--merge",
        action="store_true",
        help="merge N per-rank native trace dumps into ONE timeline"
        " aligned on the durable step index (one process track per rank)",
    )
    args = ap.parse_args(argv)
    if args.merge:
        if len(args.inputs) < 2:
            ap.error("--merge needs at least two per-rank trace dumps")
        blobs = []
        for path in args.inputs:
            with open(path) as f:
                blobs.append(json.load(f))
        merged = merge_rank_traces(blobs)
        out = args.output or (
            os.path.splitext(args.inputs[0])[0] + ".merged.perfetto.json"
        )
        atomic_write_json(out, merged)
        print(
            f"wrote {out} (ranks {merged['metadata']['merged_ranks']},"
            f" anchored on step {merged['metadata']['anchor_step']})"
        )
        return 0
    if args.output and len(args.inputs) > 1:
        ap.error("-o/--output needs exactly one input")
    for path in args.inputs:
        with open(path) as f:
            blob = json.load(f)
        out = args.output or (os.path.splitext(path)[0] + ".perfetto.json")
        atomic_write_json(out, convert(blob))
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
