"""The frozen work law against counts made by hand."""

import pytest

from gpad_bench import work
from gpad_bench.reference import battery

BATTERY = dict(cell_capacity_ah=0.1107, soc_limit=0.5, current_limit=0.3,
               qx_weight=100.0, qu_weight=1.0)


def _shape(n, N):
    qp = battery.condense(battery.plant(dict(BATTERY, n_cells=n, horizon=N)))
    return battery.shape(qp)


@pytest.mark.parametrize("n, N, sizes, least", [
    # n_x, n_z, m_half, n_struct; 2 m_h n_z + 2 n_z n_s + 3 m_h + 4 n_z
    (3, 10, (3, 30, 70, 40), 6930),
    (30, 30, (30, 900, 1830, 930), 4977090),
])
def test_least_flops_by_hand(n, N, sizes, least):
    shape = _shape(n, N)
    assert (shape["n_x"], shape["n_z"], shape["m_half"], shape["n_struct"]) == sizes
    forms = work.iteration_flops(shape)
    assert work.least_iteration_flops(shape) == least == forms["mvp_flat"]
    assert forms["mvp_flat"] < forms["mvp"] and forms["mvp_flat"] < forms["dual"]


def test_bounds_of_the_cells():
    """Per call: n3 N10 B16384 0.169 ms, the flagship B256 1.90 ms and
    B4096 30.4 ms, all bound by the operations."""
    for (n, N, B), ms in {(3, 10, 16384): 0.1695, (30, 30, 256): 1.902,
                          (30, 30, 4096): 30.43}.items():
        flops, nbytes = work.call_work(_shape(n, N), B, 100)
        assert flops / work.PEAK_FP32_FLOPS > nbytes / work.PEAK_HBM_BYTES
        assert work.bound_seconds(flops, nbytes) * 1e3 == pytest.approx(ms, rel=1e-3)


def test_bytes_count_each_input_and_output_once():
    shape = _shape(3, 4)
    _, one = work.call_work(shape, 1, 100)
    _, two = work.call_work(shape, 2, 100)
    _, warm = work.call_work(shape, 1, 100, warm_start=True)
    per = shape["n_x"] + shape["n_z"] + 2 * shape["m_half"]
    assert two - one == 4 * per
    assert warm - one == 4 * 2 * shape["m_half"]
