"""Tiny cuts of the cells, for runs on the CPU through the port's plain
paths: the configurations keep their collections, generators and limits,
and only their rows, classes and updates shrink."""
import copy

from portbench import harness

CELLS = tuple(w["name"] for w in harness.load_manifest()["workloads"])


def shrink(spec: dict, rows: int = 5001, classes: int = 10, per_class: int = 20, update_rows: int = 1024) -> dict:
    spec = copy.deepcopy(spec)
    config = spec["config"]
    if "classes" in config:
        config.update(rows=classes * per_class, classes=classes, per_class=per_class)
        for member in config["collection"]:
            if "num_classes" in member["kwargs"]:
                member["kwargs"]["num_classes"] = classes
        spec["traffic"]["update_rows"] = max(1, classes * per_class // 4)
    else:
        config["rows"] = rows
        spec["traffic"]["update_rows"] = update_rows
    return spec


def load(workload: str, traced: bool, **sizes) -> dict:
    """A manifest cell's spec with its metrics, cut tiny."""
    manifest = harness.load_manifest()
    spec = harness.load_cell(manifest, workload)
    spec["metrics"] = harness.cell_metrics(manifest, workload, traced)
    return shrink(spec, **sizes)


def run_tiny(workload: str, seed: int, seconds: float, traced: bool) -> dict:
    """The tiny cell on the CPU; its result object."""
    return harness.run_main(load(workload, traced), seed, seconds, traced, "cpu", 0.0)
