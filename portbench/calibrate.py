"""The readings that the limits of a cell's check are set from.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--epochs 4]

For each seed, on the card, the cell's own path at the cell's own sizes:
the input sets made from the seed, ``--epochs`` epochs of updates,
``compute()`` and the read, and each number the benchmark compares (its
widest gap to the float64 reference over every epoch). Then the control for each control seed: the same path with the
port's bfloat16 policy switched on (``MetricCollection.bfloat16()``, fed
bfloat16 scores), the nearest precision below the configuration's
float32. Each reading is one JSON line; the last line sums them up: the
largest program reading and the smallest control reading of each number.
The benchmark's own runs never run this.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.run import load_spec  # noqa: E402


def readings(config: dict, traffic: dict, seed: int, epochs_n: int, control: bool, device: torch.device):
    """``(gaps, attempted, failed)``: the widest gap of each number over
    ``epochs_n`` epochs of one seed."""
    collection = harness.build_collection(config, device)
    if control:
        collection = collection.bfloat16()
    epochs = harness.Epochs(config, traffic, seed, device, collection=collection,
                            cast=torch.bfloat16 if control else None)
    for _ in range(epochs_n):
        epochs.run(record=False)
    answers = list(zip(epochs.set_of_epoch, epochs.values))
    whole = epochs.whole
    del epochs, collection
    if device.type == "cuda":
        torch.cuda.empty_cache()
    references = [harness.reference_values(config, p, t) for p, t in whole]
    checks, attempted, failed = harness.judge(config, answers, references)
    return {name: c["value"] for name, c in checks.items()}, attempted, failed


def calibrate(spec, seeds, control_seeds, epochs_n, device):
    rows = []
    for kind, chosen in (("program", seeds), ("control", control_seeds)):
        for seed in chosen:
            gaps, attempted, failed = readings(spec["config"], spec["traffic"], seed, epochs_n, kind == "control",
                                               device)
            row = {"kind": kind, "seed": seed, "gaps": gaps, "attempted": attempted, "failed": failed}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def summary(rows):
    out = {}
    for kind, pick in (("program", max), ("control", min)):
        chosen = [r["gaps"] for r in rows if r["kind"] == kind]
        if chosen:
            out[kind] = {name: pick(g[name] for g in chosen) for name in chosen[0]}
            out[kind]["seeds"] = len(chosen)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds of the program's readings")
    parser.add_argument("--control-seeds", default="", help="comma-separated seeds of the control's readings")
    parser.add_argument("--epochs", type=int, default=4)
    args = parser.parse_args(argv)
    spec = load_spec(args.workload, traced=False)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    rows = calibrate(spec, seeds, control_seeds, args.epochs, torch.device("cuda", 0))
    print(json.dumps({"summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
