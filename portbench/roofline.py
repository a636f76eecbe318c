"""Published peaks of the card and the least time of a tie-scan call.

The count is a frozen copy of ``chip_smoke.py``'s ``_bound``:
a call over ``n_elements`` sorted elements reads 8 bytes each (12
weighted: key, payload, weight) and writes 16 bytes per output row, and
does 5 operations per element and 10 per tie group. The least time is the
larger of bytes over the memory bandwidth and operations over the rate, at
the published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): a card whose ``power.limit`` is lower is slower, so the
limit is printed beside every share.
"""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "f32_ops_per_s": 67e12,
        "f64_ops_per_s": 34e12,
        "power_limit_w": 700.0,
    },
}
H100 = PEAKS["NVIDIA H100 80GB HBM3"]


def scan_bound_ms(n_elements: int, groups: int, outputs: int, weighted: bool = False):
    """``(least ms, "bytes" or "operations")`` of one tie-scan call."""
    bytes_ms = ((12 if weighted else 8) * n_elements + 16 * outputs) / H100["hbm_bytes_per_s"] * 1e3
    ops_ms = (5 * n_elements + 10 * groups) / (H100["f64_ops_per_s"] if weighted else H100["f32_ops_per_s"]) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def scan_call_bound_ms(rows: int, n: int) -> float:
    """Least ms of one unweighted call over ``rows`` sorted streams of ``n``
    elements: one output row each; the tie groups counted at their most,
    one per element, which the byte count still bounds."""
    return scan_bound_ms(rows * n, rows * n, rows)[0]
