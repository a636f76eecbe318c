#!/usr/bin/env python
"""Drive the port's serving observability surface once and check what it writes.

The port's twin of ``scripts/serving_demo.py``:

1. arms telemetry, span tracing, the cost ledger and the Prometheus
   exporter (on an OS-assigned port);
2. serves an 8-tenant :class:`~metrics_tpu_torch.MetricCohort` of
   ``Accuracy`` behind an ``AsyncServingEngine`` with a ``ServingSLO``,
   fed by an ``IngestQueue``, and makes one background checkpoint through a
   ``BackgroundCheckpointer`` stamped with the last batch's flow id: the
   admission, queue, dispatch, write-back and commit chain crosses the
   submitting thread, the worker and the writer;
3. writes
   * ``<trace-out>/serving_flow.perfetto.json``: one Perfetto timeline in
     which a served batch can be followed across the three threads by its
     flow events (``ph: "s"/"t"/"f"`` arrows),
   * ``<out>``: one live ``/metrics`` scrape with the ``serving.latency.*``
     histograms, the queue depth and age gauges, the SLO burn gauges and
     ``engine.compile.{cold,warm}``,
   * ``<ledger-out>``: the cost ledger's JSON;
4. checks them: the flow chain complete across at least three threads, the
   required families in the scrape, ``/healthz`` answering with a
   ``serving_slo`` verdict, a program in the ledger. Any miss exits 1.

The cohort lives on the card unless ``--device cpu``. Check the scrape
again with ``scripts/torch_metrics_exporter.py --check <out> --require ...``.
Usage::

    python3 scripts/torch_serving_demo.py --out scrape.txt --trace-out traces --ledger-out ledger.json [--device cpu]
"""
import argparse
import json
import os
import sys
import tempfile
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REQUIRED_FAMILIES = (
    "metrics_tpu_serving_latency_e2e_ms_bucket",
    "metrics_tpu_serving_latency_queue_wait_ms_bucket",
    "metrics_tpu_serving_latency_checkpoint_commit_ms_bucket",
    "metrics_tpu_serving_queue_depth",
    "metrics_tpu_serving_queue_age_ms",
    "metrics_tpu_serving_slo_e2e_burn",
    "metrics_tpu_engine_compile_cold_total",
    "metrics_tpu_engine_program_compiles",
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="where the /metrics scrape lands")
    ap.add_argument("--trace-out", required=True, help="directory for the flow-event Perfetto trace")
    ap.add_argument("--ledger-out", required=True, help="where the cost ledger's JSON lands")
    ap.add_argument("--device", default="cuda", help="the cohort's device: the card (default) or cpu")
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--waves", type=int, default=6)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_serving_demo: no CUDA device is available (pass --device cpu to run on the CPU)")

    import metrics_tpu_torch as M
    import metrics_tpu_torch.observability as obs
    from metrics_tpu_torch.reliability.checkpoint import atomic_file
    from metrics_tpu_torch.reliability.journal import CheckpointJournal, atomic_write_json
    from metrics_tpu_torch.serving import AsyncServingEngine, BackgroundCheckpointer, IngestQueue, ServingSLO
    from metrics_tpu_torch.serving.bgcheckpoint import snapshot_pairs

    obs.enable()
    obs.enable_tracing()
    obs.enable_cost_ledger()
    exporter = obs.enable_exporter(0)

    tenants = int(args.tenants)
    rows_per_step = 32
    cohort = M.MetricCohort(M.Accuracy(device=device), tenants=tenants)
    slo = ServingSLO(e2e_p99_ms=5_000.0, max_queue_age_ms=10_000.0, name="serve-bench")
    pipe = AsyncServingEngine(cohort, slo=slo)
    queue = IngestQueue(pipe, rows_per_step=rows_per_step, max_buffered_rows=1 << 16)
    try:
        rng = np.random.RandomState(0)
        ids = np.tile(np.arange(tenants, dtype=np.int32), rows_per_step)
        for _ in range(int(args.waves)):
            p = rng.rand(tenants * rows_per_step).astype(np.float32)
            queue.submit(ids, p, (p > 0.5).astype(np.int32))
        pipe.drain()
        flow = pipe.last_flow
        if not flow:
            print("FAIL: no flow id on the last served batch", file=sys.stderr)
            return 1

        # one background checkpoint stamped with the last batch's flow: the
        # writer thread's end of the chain
        with tempfile.TemporaryDirectory(prefix="serve-demo-journal-") as journal_dir:
            bg = BackgroundCheckpointer(CheckpointJournal(journal_dir))
            descriptor = bg.submit(snapshot_pairs(cohort), type(cohort).__name__, cursor=1, flow=flow)
            bg.drain()
            bg.close()
        if descriptor.get("flow") != list(flow):
            print(f"FAIL: the checkpoint carries flow {descriptor.get('flow')}, not {list(flow)}", file=sys.stderr)
            return 1

        # ---- artifacts ------------------------------------------------------------
        os.makedirs(args.trace_out, exist_ok=True)
        trace_path = os.path.join(args.trace_out, "serving_flow.perfetto.json")
        blob = obs.get_tracer().to_perfetto()
        atomic_write_json(trace_path, blob)

        scrape = urllib.request.urlopen(exporter.url, timeout=5).read().decode()
        with atomic_file(args.out) as f:
            f.write(scrape.encode())
        healthz = json.loads(urllib.request.urlopen(exporter.url.replace("/metrics", "/healthz"), timeout=5).read())

        with atomic_file(args.ledger_out) as f:
            f.write(obs.get_ledger().to_json(indent=1).encode())
        ledger = obs.get_ledger().snapshot()
    finally:
        pipe.close()
        obs.disable_exporter()
        obs.disable_tracing()
        obs.disable_cost_ledger()
        obs.disable()

    # ---- self-checks -----------------------------------------------------------------
    failures = []
    fid = flow[0]
    flow_phs = [e["ph"] for e in blob["traceEvents"]
                if e.get("cat") == "flow" and e.get("args", {}).get("batch") == fid]
    if not (flow_phs and flow_phs[0] == "s" and flow_phs[-1] == "f"):
        failures.append(f"flow chain for batch {fid} incomplete: {flow_phs}")
    tids = {e["tid"] for e in blob["traceEvents"]
            if e["ph"] == "X" and fid in (e.get("args", {}).get("batch") or [])}
    if len(tids) < 3:
        failures.append(f"flow for batch {fid} crosses only {len(tids)} thread track(s);"
                        " expected submitter + worker + checkpoint writer")
    for family in REQUIRED_FAMILIES:
        if family not in scrape:
            failures.append(f"scrape is missing {family}")
    if "serving_slo" not in healthz:
        failures.append(f"/healthz carries no serving_slo verdict: {healthz}")
    if ledger["programs"] < 1:
        failures.append("cost ledger recorded no programs")

    for msg in failures:
        print(f"FAIL: {msg}", file=sys.stderr)
    if failures:
        return 1
    print(f"torch_serving_demo OK ({device.type}): batch {fid} followable across {len(tids)} threads"
          f" ({trace_path}); scrape -> {args.out} (healthz: {healthz['status']});"
          f" cost ledger -> {args.ledger_out} ({ledger['programs']} programs,"
          f" cold={ledger['cold_compiles']} warm={ledger['warm_compiles']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
