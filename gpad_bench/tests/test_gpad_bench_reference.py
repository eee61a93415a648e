"""The plain reference against tpu_gpad_torch on the CPU, at battery(3, 4).

The test may import the port; the reference does not.
"""

import numpy as np
import pytest
import torch

import tpu_gpad_torch as tg
from gpad_bench.reference import battery, gpad

PARAMS = dict(n_cells=3, horizon=4, cell_capacity_ah=0.1107, soc_limit=0.5,
              current_limit=0.3, qx_weight=100.0, qu_weight=1.0)
# float32 against float64 over 100 iterations: measured 1.6e-7 here
TOL = 2e-6


@pytest.fixture(scope="module")
def both():
    data = tg.dualize(tg.condense(tg.problems.battery(**PARAMS)),
                      iterations=100, paired="auto", device="cpu")
    qp = battery.condense(battery.plant(PARAMS))
    return data, qp, gpad.Gpad(qp, 100, "cpu")


def test_condensation_matches_the_program(both):
    _, qp, _ = both
    ours = tg.condense(tg.problems.battery(**PARAMS))
    np.testing.assert_allclose(qp.H, ours.H, rtol=1e-12)
    np.testing.assert_allclose(qp.F, ours.F, rtol=1e-12, atol=1e-15)
    # the same constraints, each row with its bound, in another order
    mine = sorted(map(tuple, np.round(np.c_[qp.G, qp.b0, qp.E], 12)))
    theirs = sorted(map(tuple, np.round(np.c_[ours.G, ours.b0, ours.E], 12)))
    assert mine == theirs


def test_lipschitz_matches_the_program(both):
    data, qp, _ = both
    assert float(data.L) == pytest.approx(gpad.lipschitz(qp.H, qp.G), rel=1e-6)


@pytest.mark.parametrize("restart", [False, True])
def test_solve_and_warm_chain_match_the_program(both, restart):
    data, _, ref = both
    X0 = np.random.default_rng(3).uniform(-0.5, 0.5, (32, 3))
    cfg = tg.SolverConfig(restart=restart)
    res = tg.solve_batch(data, X0, cfg)
    z, y = ref.solve(torch.tensor(X0), restart=restart)
    assert float((res.z.double() - z).abs().max()) < TOL
    # the next sample, each side warm-started from its own dual
    res2 = tg.solve_batch(data, 0.9 * X0, cfg, y0=res.y)
    z2, _ = ref.solve(torch.tensor(0.9 * X0), y0=y, restart=restart)
    assert float((res2.z.double() - z2).abs().max()) < TOL


def test_schedule_is_the_papers():
    theta, beta = gpad.schedule(5)
    assert theta[0] == 1.0 and beta[0] == 0.0
    for k in range(4):
        t = theta[k]
        assert theta[k + 1] == pytest.approx(t * (np.sqrt(t * t + 4) - t) / 2)
        assert beta[k + 1] == pytest.approx(theta[k + 1] * (1 / theta[k] - 1))


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-11 + 2.0**-13,
                      1.0 + 2.0**-12, -3.0], dtype=torch.float32)
    r = gpad.round_tf32(x)
    assert r.tolist() == [1.0 + 2.0**-10, 1.0 + 2.0**-10, 1.0, -3.0]
