#!/usr/bin/env python
"""Command-line wrapper for the port's Prometheus export surface.

Three modes, all built on ``metrics_tpu_torch/observability/exporter.py``
(the in-process surface a serving binary arms with ``enable_exporter(port)``
or ``METRICS_TPU_EXPORTER=<port>``):

* ``--demo`` — arm telemetry + the exporter and drive a live 64-tenant
  :class:`~metrics_tpu_torch.MetricCohort` eval loop (one tenant
  deliberately poisoned every 5th step under a quarantine guard, so the
  per-tenant guard-verdict rows move) until interrupted. The cohort lives
  on the card unless ``--device cpu``.
  Point a browser or ``curl`` at the printed ``/metrics`` URL.
* ``--snapshot FILE`` — render a saved telemetry snapshot (the port's
  ``METRICS_TPU_TELEMETRY_DUMP`` exit dump, ``Telemetry.snapshot()``) to
  Prometheus text on stdout, under the identity stamp the dump carries.
* ``--check FILE`` — validate a text exposition (``-`` = stdin) with the
  structural parser the exporter tests run
  (:func:`~metrics_tpu_torch.observability.exporter.parse_prometheus_text`);
  exit 1 on any malformed line or histogram invariant violation, or on a
  ``--require``d family that is missing.

With no mode flag, serves an idle exporter (telemetry armed) until
interrupted. Usage::

    python3 scripts/torch_metrics_exporter.py --demo --port 0 [--device cpu]
    python3 scripts/torch_metrics_exporter.py --snapshot telemetry.json
    python3 scripts/torch_metrics_exporter.py --check scrape.txt --require 'metrics_tpu_cohort_*'
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _hydrate(snapshot: dict):
    """A Telemetry registry re-filled from a saved snapshot (counters,
    gauges, timers, histograms — the event log has no exposition form)."""
    from metrics_tpu_torch.observability.telemetry import Telemetry

    tel = Telemetry()
    tel.counters.update(snapshot.get("counters") or {})
    tel.gauges.update(snapshot.get("gauges") or {})
    for name, t in (snapshot.get("timers") or {}).items():
        tel._timers[name] = [float(t["total_s"]), int(t["count"])]
    for name, h in (snapshot.get("histograms") or {}).items():
        tel.histograms[name] = {
            "buckets": list(h["buckets"]),
            "counts": list(h["counts"]),
            "sum": float(h["sum"]),
            "count": int(h["count"]),
        }
    return tel


def _demo_loop(port: int, tenants: int, poison_tenant: int, device, steps: int = 0) -> int:
    """The demo's serve loop; ``steps`` > 0 stops it after that many steps."""
    import numpy as np
    import torch

    import metrics_tpu_torch as M
    import metrics_tpu_torch.observability as obs
    from metrics_tpu_torch.reliability import guard_scope

    obs.enable()
    exporter = obs.enable_exporter(port)
    cohort = M.MetricCohort(
        M.MetricCollection([M.MeanSquaredError(device=device), M.MeanAbsoluteError(device=device)]),
        tenants=tenants,
    )
    rng = np.random.RandomState(0)
    print(f"serving {exporter.url} (and /healthz); Ctrl-C to stop")
    print(f"demo: {tenants}-tenant cohort on {cohort._device}, tenant {poison_tenant} poisoned"
          " every 5th step (quarantine guard)")
    step = 0
    try:
        while not steps or step < steps:
            preds = rng.rand(tenants, 64).astype(np.float32)
            target = rng.rand(tenants, 64).astype(np.float32)
            if step % 5 == 4:
                preds[poison_tenant] = np.nan
            with guard_scope("quarantine"):
                cohort(torch.from_numpy(preds).to(device), torch.from_numpy(target).to(device))
            if step % 10 == 9:
                cohort.health()
            step += 1
            time.sleep(0.25)
    except KeyboardInterrupt:
        print()
    finally:
        obs.disable_exporter()
    print(f"stopped after {step} steps")
    return 0


def _check(path: str, required) -> int:
    from metrics_tpu_torch.observability.exporter import parse_prometheus_text

    if path == "-":
        text = sys.stdin.read()
    else:
        with open(path, "r", encoding="utf-8") as fh:
            text = fh.read()
    try:
        samples = parse_prometheus_text(text)
    except ValueError as err:
        print(f"INVALID exposition: {err}", file=sys.stderr)
        return 1
    missing = [
        req for req in required
        if not (any(name.startswith(req[:-1]) for name in samples) if req.endswith("*") else req in samples)
    ]
    if missing:
        print(f"INVALID exposition: required families missing: {missing}", file=sys.stderr)
        return 1
    extra = f", {len(required)} required families present" if required else ""
    print(f"valid Prometheus text format: {len(samples)} metric families{extra}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", type=int, default=None,
                    help="exporter port (default: METRICS_TPU_EXPORTER, else 9464; 0 = OS-assigned)")
    ap.add_argument("--demo", action="store_true", help="drive a live 64-tenant cohort workload")
    ap.add_argument("--tenants", type=int, default=64, help="demo cohort size")
    ap.add_argument("--poison-tenant", type=int, default=3, help="demo slot to poison periodically")
    ap.add_argument("--device", default="cuda", help="where the demo cohort lives: 'cuda' (default) or 'cpu'")
    ap.add_argument("--snapshot", help="render a saved telemetry snapshot JSON to stdout and exit")
    ap.add_argument("--check", help="validate a Prometheus text exposition file ('-' = stdin)")
    ap.add_argument("--require", action="append", default=[], metavar="FAMILY",
                    help="with --check: additionally require this metric family (repeatable; a"
                         " trailing '*' matches any family with the prefix)")
    args = ap.parse_args(argv)

    if args.check is not None:
        return _check(args.check, args.require)
    if args.require:
        ap.error("--require only applies with --check")

    if args.snapshot is not None:
        with open(args.snapshot, "r", encoding="utf-8") as fh:
            snap = json.load(fh)
        # render under the ARTIFACT's identity stamp: the exposition must
        # name the rank/host that produced the numbers, not this process
        sys.stdout.write(_hydrate(snap).to_prometheus(identity=snap.get("identity")))
        return 0

    from metrics_tpu_torch.utilities.env import exporter_port

    port = args.port
    if port is None:
        env_port = exporter_port()
        port = env_port if env_port is not None and env_port >= 0 else 9464

    if args.demo:
        import torch

        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise SystemExit("--demo runs on the card by default and none is available; pass --device cpu")
        return _demo_loop(port, args.tenants, args.poison_tenant, device)

    import metrics_tpu_torch.observability as obs

    obs.enable()
    exporter = obs.enable_exporter(port)
    print(f"serving {exporter.url} (and /healthz); Ctrl-C to stop")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        obs.disable_exporter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
