"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the repository's root, on a machine with as many CUDA cards as the
cell asks for. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
against the float64 reference beside its limit (also the last lines of
standard error). A cell runs on one card, in this process.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(ROOT / "build" / _sub)
os.environ.setdefault("USE_FLAX", "0")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def load_spec(workload: str, traced: bool, shrink=None) -> dict:
    """The cell's files and metrics; ``shrink(spec)`` may cut the
    configuration and traffic (tests run tiny cells on the CPU with it)."""
    from portbench import harness

    manifest = harness.load_manifest()
    spec = harness.load_cell(manifest, workload)
    spec["metrics"] = harness.cell_metrics(manifest, workload, traced)
    return spec if shrink is None else shrink(spec)


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device_type: str = "cuda",
             shrink=None) -> dict:
    """Run ``workload``; returns its result object."""
    from portbench import harness

    return harness.run_main(load_spec(workload, traced, shrink), seed, seconds, traced, device_type, T_START)


def format_checks(checks: dict) -> str:
    return "\n".join(f"check {name} {c['value']!r} limit {c['limit']!r}" for name, c in checks.items())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from portbench import harness

    try:
        import metrics_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"portbench: the port is not importable here: {err}", file=sys.stderr)
        return 4

    chips = int(next((c["chips"] for c in harness.load_manifest()["workloads"] if c["name"] == args.workload), 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s), this machine has {found}", file=sys.stderr)
        return 2
    if chips != 1:
        print(f"portbench: the cell asks for {chips} cards; this harness runs a cell on one", file=sys.stderr)
        return 5
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = harness.forbidden_modules(sys.modules)
    if loaded:
        print(f"portbench: the measured process loaded {loaded}", file=sys.stderr)
        return 3
    print(format_checks(result["checks"]), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
