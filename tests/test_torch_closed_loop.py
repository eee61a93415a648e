"""Port parity: the serving ``Controller`` and ``simulate`` of
``tpu_gpad_torch`` against ``tpu_gpad``'s on the same states."""

import dataclasses

import numpy as np
import pytest
import torch

import tpu_gpad
from tpu_gpad import problems as jp

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
    c_t = tpu_gpad_torch.Controller(tp.battery(3, 10), iterations=100)
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
    c_t = tpu_gpad_torch.Controller(problem(tpu_gpad_torch), **kw)
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
        tpu_gpad_torch.Controller(tp.battery(3, 6)).step(x, x_ref=r)


def test_controller_unported_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpu_gpad_torch.Controller(tp.battery(3, 6), polish=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpu_gpad_torch.Controller(tp.battery(3, 6)).gain()


@pytest.mark.parametrize("warm_start", [False, True])
def test_simulate_matches_tpu_gpad(warm_start):
    X0 = _states(4, 3, seed=7)
    r_j = tpu_gpad.simulate(jp.battery(3, 10), X0, n_steps=30,
                            warm_start=warm_start)
    r_t = tpu_gpad_torch.simulate(tp.battery(3, 10), X0, n_steps=30,
                                  warm_start=warm_start)
    assert r_t.X.shape == (31, 4, 3) and r_t.U.shape == (30, 4, 3)
    np.testing.assert_allclose(r_t.X.numpy(), np.asarray(r_j.X), atol=X_TOL, rtol=0)
    np.testing.assert_allclose(r_t.U.numpy(), np.asarray(r_j.U), atol=U_TOL, rtol=0)
    np.testing.assert_allclose(r_t.residual.numpy(), np.asarray(r_j.residual),
                               atol=2e-5, rtol=0)
    np.testing.assert_array_equal(r_t.iterations.numpy(), np.asarray(r_j.iterations))
