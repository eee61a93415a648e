"""Port parity: the serving ``Controller`` and ``simulate`` of
``tpu_gpad_torch`` against ``tpu_gpad``'s on the same states."""

import dataclasses

import numpy as np
import pytest
import torch

import tpu_gpad
from tpu_gpad import problems as jp
from tpu_gpad.solver import SolverConfig

import tpu_gpad_torch
from tpu_gpad_torch import problems as tp

torch.set_num_threads(2)

# Per-step u* of two fp32 solves that differ only in summation order (and,
# warm, in the previous step's dual): a few ulps of |u| <= 0.3 per step.
U_TOL = 2e-5
# simulate compounds 30 steps of such differences through the plant.
X_TOL = 1e-5


def _states(B, n_x, seed):
    return np.random.default_rng(seed).uniform(-0.4, 0.4, (B, n_x)).astype(np.float32)


def test_controller_warm_matches_tpu_gpad():
    c_j = tpu_gpad.Controller(jp.battery(3, 10), iterations=100)
    c_t = tpu_gpad_torch.Controller(tp.battery(3, 10), iterations=100,
                                    device="cpu")
    A = np.asarray(c_j.problem.A, np.float32)
    Bm = np.asarray(c_j.problem.B, np.float32)
    x = _states(8, 3, seed=5)
    for _ in range(20):
        u_j = c_j.step(x)
        u_t = c_t.step(x)
        assert u_t.dtype == np.float32 and u_t.shape == (8, 3)
        np.testing.assert_allclose(u_t, u_j, atol=U_TOL, rtol=0)
        x = x @ A.T + u_j @ Bm.T
    np.testing.assert_allclose(
        c_t.last_result.y.numpy(), np.asarray(c_j.last_result.y), atol=U_TOL, rtol=0)
    single_j = c_j.step(x[0])
    single_t = c_t.step(x[0])  # batch change drops the warm start in both
    assert single_t.shape == (3,)
    np.testing.assert_allclose(single_t, single_j, atol=U_TOL, rtol=0)


def test_controller_parameter_layouts():
    """Tracking + input reference + disturbance + rate limits assemble the
    same parameter as tpu_gpad's Controller."""
    def problem(pkg):
        return dataclasses.replace(
            pkg.problems.battery(3, 6), du_min=np.full(3, -0.2),
            du_max=np.full(3, 0.2))

    kw = dict(iterations=60, tracking=True, input_reference=True,
              process_disturbance=True)
    c_j = tpu_gpad.Controller(problem(tpu_gpad), **kw)
    c_t = tpu_gpad_torch.Controller(problem(tpu_gpad_torch), **kw, device="cpu")
    x = _states(4, 3, seed=6)
    r = np.full(3, 0.1, np.float32)
    d = np.full(3, 1e-3, np.float32)
    for _ in range(3):
        u_j = c_j.step(x, x_ref=r, u_ref=np.zeros(3), d=d)
        u_t = c_t.step(x, x_ref=r, u_ref=np.zeros(3), d=d)
        np.testing.assert_allclose(u_t, u_j, atol=U_TOL, rtol=0)
    c_t.reset()
    assert c_t._y is None and c_t._u_prev is None
    with pytest.raises(ValueError, match="x_ref"):
        tpu_gpad_torch.Controller(tp.battery(3, 6), device="cpu").step(x, x_ref=r)


def test_controller_unported_raise():
    """Controller.gain (ported with diff.py) raises before any step, then
    gives the explicit-MPC gain of the last step: in the interior the
    unconstrained -(H^-1 F')[:n_u] (tests/test_diff.py::
    test_controller_gain_convenience)."""
    ctrl = tpu_gpad_torch.Controller(
        tp.double_integrator(horizon=6), iterations=200, device="cpu",
        config=tpu_gpad_torch.SolverConfig(iterations=200, restart=True))
    with pytest.raises(ValueError, match="step"):
        ctrl.gain()
    ctrl.step(np.array([0.01, 0.0], np.float32))
    K = ctrl.gain()
    assert isinstance(K, np.ndarray) and K.shape == (1, 2)
    np.testing.assert_allclose(K, -ctrl.data.gP_map.mT[:1].numpy(), atol=1e-6)


# Polished moves are the float64 active-set optimum of the same QP in both
# packages; they part only where the fp32 hints pick another active set,
# which they do not here. 1e-6 is tpu_gpad's own bound against the exact QP
# (tests/test_closed_loop.py::test_controller_with_polish_is_exact).
POLISH_TOL = 1e-6


def test_controller_polish_matches_tpu_gpad():
    from tpu_gpad_torch.solver.qp import solve_condensed_qp

    config = dict(iterations=60, restart=True)
    c_j = tpu_gpad.Controller(jp.battery(3, 6), iterations=60, polish=True,
                              config=SolverConfig(**config))
    c_t = tpu_gpad_torch.Controller(
        tp.battery(3, 6), iterations=60, polish=True, device="cpu",
        config=tpu_gpad_torch.SolverConfig(**config))
    A = np.asarray(c_j.problem.A, np.float64)
    Bm = np.asarray(c_j.problem.B, np.float64)
    X = _states(4, 3, seed=8).astype(np.float64)
    for _ in range(5):
        u_j = c_j.step(X.astype(np.float32))
        u_t = c_t.step(X.astype(np.float32))
        assert u_t.dtype == np.float32 and u_t.shape == (4, 3)
        np.testing.assert_allclose(u_t, u_j, atol=POLISH_TOL, rtol=0)
        for b in range(X.shape[0]):
            exact = solve_condensed_qp(c_t.qp, X[b].astype(np.float32)).z
            np.testing.assert_allclose(u_t[b], exact[: c_t.qp.n_u],
                                       atol=POLISH_TOL, rtol=0)
        X = X @ A.T + u_t.astype(np.float64) @ Bm.T
    with pytest.raises(ValueError, match="polish"):
        tpu_gpad_torch.Controller(tp.battery(3, 6), polish=True,
                                  data=c_t.data, device="cpu")


@pytest.mark.parametrize("warm_start", [False, True])
def test_simulate_matches_tpu_gpad(warm_start):
    X0 = _states(4, 3, seed=7)
    r_j = tpu_gpad.simulate(jp.battery(3, 10), X0, n_steps=30,
                            warm_start=warm_start)
    r_t = tpu_gpad_torch.simulate(tp.battery(3, 10), X0, n_steps=30,
                                  warm_start=warm_start, device="cpu")
    assert r_t.X.shape == (31, 4, 3) and r_t.U.shape == (30, 4, 3)
    np.testing.assert_allclose(r_t.X.numpy(), np.asarray(r_j.X), atol=X_TOL, rtol=0)
    np.testing.assert_allclose(r_t.U.numpy(), np.asarray(r_j.U), atol=U_TOL, rtol=0)
    np.testing.assert_allclose(r_t.residual.numpy(), np.asarray(r_j.residual),
                               atol=2e-5, rtol=0)
    np.testing.assert_array_equal(r_t.iterations.numpy(), np.asarray(r_j.iterations))
