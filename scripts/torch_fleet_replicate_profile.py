"""Where a fleet replicate cycle's host time goes, by part, at a few tenant counts.

    python3 scripts/torch_fleet_replicate_profile.py [--device cuda|cpu] [--tenants 1000,2000,4000]

For each count N: a shard of N ``MeanSquaredError`` tenants (its cohort on
``--device``, the card by default) folds one wave of 2 rows x 8 features a
tenant and commits, and a ``ShardReplicator`` ships every tenant to the
follower's ``ReplicaStore`` in one ``replicate`` cycle. The cycle runs
twice on two fresh fleets: once bare (its wall time) and once under
``cProfile``, whose cumulative times are split into the cycle's parts:
the tenant's unstack (``tenant_collection``), its envelope and bytes, the
far side's decode and checks, the envelope file's write, the replica
manifest's read and rewrite (the manifest is rewritten whole for every
stored tenant), and the ``fsync`` calls among them. A part whose share
grows with N is the quadratic one. Prints the card's name and power limit
(on the card), one line per count and one JSON line.
"""
import argparse
import cProfile
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# part name -> (file suffix, function name) whose cumulative time it is
PARTS = {
    "tenant_collection": ("metrics_tpu_torch/cohort.py", "tenant_collection"),
    "tenant_envelope": ("metrics_tpu_torch/fleet/migration.py", "tenant_envelope"),
    "envelope_to_bytes": ("metrics_tpu_torch/reliability/checkpoint.py", "envelope_to_bytes"),
    "envelope_from_bytes": ("metrics_tpu_torch/reliability/checkpoint.py", "envelope_from_bytes"),
    "store": ("metrics_tpu_torch/fleet/replication.py", "store"),
    "write_envelope": ("metrics_tpu_torch/reliability/checkpoint.py", "write_envelope"),
    "manifest_read": ("metrics_tpu_torch/fleet/replication.py", "_read_manifest"),
    "manifest_write": ("metrics_tpu_torch/reliability/journal.py", "atomic_write_json"),
    "json_encode": ("json/__init__.py", "dumps"),
    "fsync": ("~", "<built-in method posix.fsync>"),
}


def _fleet(root, n, device):
    from metrics_tpu_torch import MeanSquaredError
    from metrics_tpu_torch.fleet import FleetPlacement, FleetShard, MigrationCoordinator, ShardReplicator

    names = ["s0", "s1"]
    shards = {nm: FleetShard(nm, MeanSquaredError(device=device), os.path.join(root, nm)) for nm in names}
    keys = list(range(n))
    shards["s0"].add_tenants(keys)
    rs = np.random.RandomState(0)
    rows = [torch.from_numpy(rs.rand(n, 2, 8).astype(np.float32)).to(device) for _ in range(2)]
    shards["s0"].submit_wave(0, keys, *rows)
    shards["s0"].checkpoint()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    replicator = ShardReplicator(MigrationCoordinator(FleetPlacement(names), shards.values()))
    return shards["s0"], replicator


def _parts(profile):
    stats = pstats.Stats(profile).stats
    out = {}
    for part, (suffix, func) in PARTS.items():
        total = 0.0
        for (path, _line, name), (_cc, _nc, _tt, ct, _callers) in stats.items():
            if name == func and path.replace(os.sep, "/").endswith(suffix):
                total += ct
        out[part] = total
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tenants", default="1000,2000,4000")
    args = ap.parse_args()
    device = torch.device(args.device)
    card = None
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("torch_fleet_replicate_profile: no CUDA device is available")
            return 1
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip().splitlines()[0]
        print(card)
    results = []
    for n in (int(x) for x in args.tenants.split(",")):
        with tempfile.TemporaryDirectory() as root:
            shard, replicator = _fleet(os.path.join(root, "bare"), n, device)
            t = time.perf_counter()
            shipped = replicator.replicate(shard)
            bare_s = time.perf_counter() - t
            assert shipped == n and replicator.lag() == 0
            shard, replicator = _fleet(os.path.join(root, "profiled"), n, device)
            profile = cProfile.Profile()
            t = time.perf_counter()
            profile.enable()
            replicator.replicate(shard)
            profile.disable()
            profiled_s = time.perf_counter() - t
        parts = _parts(profile)
        row = {"tenants": n, "bare_s": bare_s, "bare_ms_a_tenant": bare_s / n * 1e3, "profiled_s": profiled_s,
               "parts_s": parts, "parts_share": {k: v / profiled_s for k, v in parts.items()}}
        results.append(row)
        print(f"{n:6d} tenants: cycle {bare_s:8.2f} s ({row['bare_ms_a_tenant']:.3f} ms a tenant); profiled"
              f" {profiled_s:8.2f} s: " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
    print(json.dumps({"card": card, "device": str(device), "fleet_replicate_profile": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
