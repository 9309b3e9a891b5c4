"""The frozen yardsticks, pinned to the figures they were copied at."""

import pytest

from benchmark import harness, yardstick


def test_peaks_are_the_data_sheets():
    assert yardstick.PEAK_FLOPS == {"float32": 67e12, "float64": 34e12}
    assert yardstick.PEAK_TC == {"float32": 165e12, "float64": 67e12}
    assert yardstick.PEAK_BYTES == 3.35e12
    assert "NVIDIA H100" in yardstick.PEAK_SOURCE


@pytest.mark.parametrize("n, d, dtype, residuals, us, by", [
    (12800, 2, "float32", True, 3.22, "bytes"),
    (1600, 4, "float32", True, 0.42, "bytes"),
    (12800, 2, "float32", False, 2.06, "operations"),
    (1600, 4, "float32", False, 0.27, "operations"),
    (12800, 2, "float64", False, 4.85, "operations"),
    (12800, 2, "float64", True, 6.45, "bytes"),
])
def test_gp_bound_at_the_robomove_shapes(n, d, dtype, residuals, us, by):
    seconds, bound_by = yardstick.gp_predict_bound(n, 100, 6, d, dtype, residuals)
    assert 1e6 * seconds == pytest.approx(us, abs=0.005)
    assert bound_by == by


@pytest.mark.parametrize("workload, gflop", [("robomove-train", 117.20256),
                                             ("voliro-train", 0.13000704)])
def test_analytic_gflop_per_step(workload, gflop):
    cell = harness.Cell(workload)
    assert cell.ref.gflop_per_step(cell.cfg) == pytest.approx(gflop, rel=1e-12)
