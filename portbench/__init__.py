"""Benchmark of ``metrics_tpu_torch``: epoch-evaluation cells on the card.

Run one cell with ``python3 portbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the repository's root; ``BENCHMARK.json``
names the cells, and each cell's configuration, traffic and per-layer
readers are files under this folder, found by name.
"""
