"""The byte bound of a tie-scan call, counted from its shapes."""
import pytest

from portbench.roofline import H100, scan_bound_ms, scan_call_bound_ms


@pytest.mark.parametrize("rows, n, want_ms", [(1000, 50_000, 0.1194), (1, 45_840_617, 0.1095)])
def test_call_bounds_of_the_cells(rows, n, want_ms):
    assert scan_call_bound_ms(rows, n) == pytest.approx(want_ms, abs=5e-5)
    assert scan_call_bound_ms(rows, n) == pytest.approx((8 * rows * n + 16 * rows) / 3.35e12 * 1e3)


def test_bytes_bound_the_scan_and_weights_add_a_third():
    assert scan_bound_ms(50_000_000, 50_000_000, 1000)[1] == "bytes"
    weighted = scan_bound_ms(45_840_617, 45_840_617, 1, weighted=True)
    assert weighted[1] == "bytes" and weighted[0] == pytest.approx(0.1642, abs=5e-5)
    assert H100["hbm_bytes_per_s"] == 3.35e12
