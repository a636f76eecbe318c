"""Whether a fleet verb can run beside a serving worker, on one GPU.

    python3 scripts/torch_fleet_beside_serving.py

A worker stream holds a device sleep of about 150 ms (a serving worker's
queued step). A fleet thread then runs one verb on a shard of 1,024
``MeanSquaredError`` tenants whose cohort lives on the card; 10 ms later
the main thread (the serve loop) allocates 4 MiB on the card and launches a
fill, as ``scripts/torch_read_stall.py`` does. The verbs: nothing; one
tenant's envelope (``tenant_collection`` and ``tenant_envelope``: pageable
reads of its states); one two-phase handoff (``MigrationCoordinator.migrate``:
that envelope, the wire bytes, the target's import, two whole-shard
commits). A verb that stalls the serve loop shows a launch of about the
remaining sleep; one that does not shows a launch well under a millisecond.

The ``served`` trials enroll the shard's cohort in an
``AsyncServingEngine`` and queue the sleep on the pipeline's own worker
stream ahead of a real step of that cohort. A fleet verb then drains the
pipeline before it reads (the cohort's drain barrier), so it takes at
least the rest of the sleep; the serve loop's launch shows whether that
wait stalls the main thread too. Each verb runs three times; prints the
card's name and power limit, one line a trial and one JSON line.
"""
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SLEEP_CYCLES = 300_000_000  # about 150 ms on an H100
TENANTS = 1024


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_fleet_beside_serving: no CUDA device is available")
        return 1
    from metrics_tpu_torch import MeanSquaredError
    from metrics_tpu_torch.fleet import FleetPlacement, FleetShard, MigrationCoordinator, tenant_envelope
    from metrics_tpu_torch.serving import AsyncServingEngine

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    worker = torch.cuda.Stream()
    results = {}
    with tempfile.TemporaryDirectory() as root:
        src = FleetShard("src", MeanSquaredError(), os.path.join(root, "src"))
        dst = FleetShard("dst", MeanSquaredError(), os.path.join(root, "dst"))
        keys = list(range(TENANTS))
        src.add_tenants(keys)
        rs = np.random.RandomState(0)
        src.submit_wave(0, keys, *(torch.from_numpy(rs.rand(TENANTS, 2, 8).astype(np.float32)).to(dev)
                                   for _ in range(2)))
        src.checkpoint()
        coord = MigrationCoordinator(FleetPlacement(["src", "dst"]), [src, dst])
        coord.migrate(keys[-1], "dst")  # warm-up: the first commits and the target's programs
        movers = iter(keys)
        # the served trials' pipeline: capacity-padded rows, so the step
        # keeps its shape while handoffs take tenants away
        served = [torch.from_numpy(rs.rand(src.cohort.capacity, 2, 8).astype(np.float32)).to(dev) for _ in range(2)]
        pipe = AsyncServingEngine(src.cohort)
        pipe.forward(*served)  # the first batch runs on the caller
        pipe.drain()
        torch.cuda.synchronize()

        stay = keys[TENANTS // 2]  # never handed off

        def envelope():
            tenant_envelope(src.cohort.tenant_collection(src.slot_of(stay)), stay)

        def handoff():
            coord.migrate(next(movers), "dst")

        def trial(label, verb, enrolled=False):
            with torch.cuda.stream(pipe._worker_stream() if enrolled else worker):
                torch.cuda._sleep(SLEEP_CYCLES)
            if enrolled:
                pipe.forward(*served)  # queued behind the sleep on the worker's stream
            entered, done = threading.Event(), []

            def fleet():
                entered.set()
                t = time.perf_counter()
                verb()
                done.append((t, time.perf_counter()))

            th = threading.Thread(target=fleet)
            th.start()
            entered.wait(10.0)
            time.sleep(0.01)
            t0 = time.perf_counter()
            torch.empty(1 << 20, device=dev).fill_(1)  # the serve loop's allocation and launch
            t1 = time.perf_counter()
            th.join(30.0)
            torch.cuda.synchronize()
            row = {"launch_ms": (t1 - t0) * 1e3, "verb_ms": (done[0][1] - done[0][0]) * 1e3,
                   "verb_done_after_launch_ms": (done[0][1] - t1) * 1e3}
            results.setdefault(label, []).append(row)
            print(f"{label:16s} serve-loop launch {row['launch_ms']:8.3f} ms; the verb took {row['verb_ms']:8.1f} ms"
                  f" and finished {row['verb_done_after_launch_ms']:+8.1f} ms after the launch")

        try:
            for _ in range(3):
                trial("nothing", lambda: None)
                trial("envelope", envelope)
                trial("handoff", handoff)
                trial("served envelope", envelope, enrolled=True)
                trial("served handoff", handoff, enrolled=True)
        finally:
            pipe.close()
    print(json.dumps({"card": card, "fleet_beside_serving": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
