"""Port parity for output feedback (after tests/test_estimator.py): the
Kalman filter, the steady-state target, the offset-free controller and the
EKF of ``tpu_gpad_torch.estimator`` against ``tpu_gpad.estimator`` on the
same measurements, and the reference's rejections."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gpad import estimator as je
from tpu_gpad import problems as jp
from tpu_gpad.solver import SolverConfig as JConfig

from tpu_gpad_torch import estimator as te
from tpu_gpad_torch import problems as tp
from tpu_gpad_torch.solver import SolverConfig

torch.set_num_threads(2)

# Host float64 recursions in both packages: the same operations.
HOST_TOL = 1e-12
# Estimates and moves around fp32 solves and fp32 Jacobians (the EKF's
# f/h run in float32 in both packages), per step over the run.
TOL = 1e-5
C = np.array([[1.0, 0.0]])


def _kf_pair():
    p = jp.double_integrator(horizon=10)
    Bd = np.asarray(p.B)
    Cd = np.zeros((1, 1))
    args = (p.A, p.B, C, Bd, Cd)
    return je.KalmanFilter(*args), te.KalmanFilter(*args), p


def test_kalman_filter_and_target_match_tpu_gpad():
    kf_j, kf_t, p = _kf_pair()
    np.testing.assert_allclose(kf_t.L, kf_j.L, atol=HOST_TOL, rtol=0)
    np.testing.assert_allclose(
        te.kalman_gain(p.A, C, np.eye(2) * 1e-3, np.eye(1) * 1e-4),
        je.kalman_gain(p.A, C, np.eye(2) * 1e-3, np.eye(1) * 1e-4),
        atol=HOST_TOL, rtol=0)
    tc_j = je.TargetCalculator(p.A, p.B, C, p.B, np.zeros((1, 1)))
    tc_t = te.TargetCalculator(p.A, p.B, C, p.B, np.zeros((1, 1)))
    rng = np.random.default_rng(0)
    x, u = np.array([1.0, -0.3]), np.zeros(1)
    for _ in range(30):
        x = np.asarray(p.A) @ x + np.asarray(p.B) @ u
        xj, dj = kf_j.update(C @ x, u)
        xt, dt = kf_t.update(C @ x, u)
        np.testing.assert_allclose(np.r_[xt, dt], np.r_[xj, dj],
                                   atol=HOST_TOL, rtol=0)
        for a, b in zip(tc_t(np.array([1.5]), dt), tc_j(np.array([1.5]), dj)):
            np.testing.assert_allclose(a, b, atol=HOST_TOL, rtol=0)
        u = rng.uniform(-0.5, 0.5, 1)
    kf_t.reset(np.array([0.1, 0.2]))
    np.testing.assert_array_equal(kf_t.xa, [0.1, 0.2, 0.0])


@pytest.mark.parametrize("disturbance", ["input", "output"])
def test_offset_free_steps_match_tpu_gpad(disturbance):
    """30 closed-loop steps of the offset-free controller (the plant sees an
    input bias or a biased sensor) in both packages: the same moves, the
    same estimates."""
    if disturbance == "input":
        pj, pt = jp.double_integrator(horizon=10), tp.double_integrator(horizon=10)
        Cm = C
    else:  # an output disturbance needs a strictly stable plant
        kw = dict(A=np.array([[0.9]]), B=np.array([[1.0]]), Q=np.eye(1),
                  R=np.eye(1) * 0.1, horizon=8, u_min=np.array([-2.0]),
                  u_max=np.array([2.0]), name="stable1d")
        import tpu_gpad
        import tpu_gpad_torch

        pj = tpu_gpad.LinearMPCProblem(**kw)
        pt = tpu_gpad_torch.LinearMPCProblem(**kw)
        Cm = np.array([[1.0]])
    cfg = dict(iterations=80, restart=True)
    off_j = je.OffsetFreeController(pj, Cm, disturbance=disturbance,
                                    config=JConfig(**cfg))
    off_t = te.OffsetFreeController(pt, Cm, disturbance=disturbance,
                                    config=SolverConfig(**cfg), device="cpu")
    A, Bm = np.asarray(pj.A), np.asarray(pj.B)
    x = np.zeros(pj.n_x)
    r = np.array([1.5 if disturbance == "input" else 0.8])
    for _ in range(30):
        y = Cm @ x + (0.0 if disturbance == "input" else -0.12)
        u_j = off_j.step(y, r)
        u_t = off_t.step(y, r)
        assert u_t.dtype == np.float32
        np.testing.assert_allclose(u_t, u_j, atol=TOL, rtol=0)
        np.testing.assert_allclose(off_t.x_hat, off_j.x_hat, atol=TOL, rtol=0)
        np.testing.assert_allclose(off_t.d_hat, off_j.d_hat, atol=TOL, rtol=0)
        bias = 0.08 if disturbance == "input" else 0.0
        x = A @ x + Bm @ (u_j.astype(np.float64) + bias)
    for a, b in zip(off_t.last_target, off_j.last_target):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    off_t.reset()
    assert np.abs(off_t.filter.xa).max() == 0 and off_t.controller._y is None


def test_reference_rejections():
    p = tp.double_integrator(horizon=10)
    # two output disturbances on one output: undetectable
    with pytest.raises(ValueError, match="undetectable"):
        te.augment_disturbance(p.A, p.B, C, np.zeros((2, 2)),
                               np.array([[1.0, 1.0]]))
    with pytest.raises(ValueError, match="Cd must be"):
        te.augment_disturbance(p.A, p.B, C, p.B, np.zeros((2, 1)))
    with pytest.raises(ValueError, match="x0 must have"):
        te.KalmanFilter(p.A, p.B, C, p.B, np.zeros((1, 1)), x0=np.zeros(5))
    ltv = dataclasses.replace(p, A=np.stack([p.A] * 10), B=np.stack([p.B] * 10))
    with pytest.raises(ValueError, match="time-invariant"):
        te.OffsetFreeController(ltv, C, disturbance="input", device="cpu")


def test_ekf_linear_matches_kf_recursion():
    """On a linear system the EKF reproduces the textbook time-varying
    Kalman recursion (its Jacobians are the matrices), as tpu_gpad's does."""
    A = np.array([[0.9, 0.2], [0.0, 0.8]])
    B = np.array([[0.0], [0.5]])
    W, V = np.eye(2) * 1e-3, np.eye(1) * 1e-4
    At, Bt, Ct = (torch.as_tensor(M, dtype=torch.float32) for M in (A, B, C))
    ekf = te.ExtendedKalmanFilter(lambda x, u: At @ x + Bt @ u,
                                  lambda x: Ct @ x, n_x=2, n_y=1, W=W, V=V,
                                  device="cpu")
    x_ref, P_ref = np.zeros(2), np.eye(2)
    for t in range(20):
        u = np.array([np.sin(0.3 * t)])
        y = np.array([0.5 + 0.1 * t])
        x_hat = ekf.update(y, u)
        x_pred = A @ x_ref + B @ u
        P_pred = A @ P_ref @ A.T + W
        K = P_pred @ C.T @ np.linalg.inv(C @ P_pred @ C.T + V)
        x_ref = x_pred + K @ (y - C @ x_pred)
        IKH = np.eye(2) - K @ C
        P_ref = IKH @ P_pred @ IKH.T + K @ V @ K.T
        # tpu_gpad's CPU bounds for the same test
        np.testing.assert_allclose(x_hat, x_ref, atol=1e-4)
    np.testing.assert_allclose(ekf.P, P_ref, atol=1e-5)
    ekf.reset()
    np.testing.assert_array_equal(ekf.x, np.zeros(2))


def _pendulum(lib, dt=0.05, m=1.0, l=1.0, b=0.1, g=9.81):
    """RK4 of the damped pendulum (tpu_gpad.problems.pendulum), written
    with ``lib`` = jnp or torch."""
    def f(x, u):
        domega = (-m * g * l * lib.sin(x[0]) - b * x[1] + u[0]) / (m * l * l)
        return lib.stack([x[1], domega])

    def step(x, u):
        k1 = f(x, u)
        k2 = f(x + 0.5 * dt * k1, u)
        k3 = f(x + 0.5 * dt * k2, u)
        k4 = f(x + dt * k3, u)
        return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    return step


def test_ekf_pendulum_matches_tpu_gpad():
    """Measuring only the angle, both EKFs reconstruct the angular velocity
    of a swinging pendulum alike, step by step."""
    f_j, f_t = _pendulum(jnp), _pendulum(torch)
    kw = dict(n_x=2, n_y=1, x0=np.array([0.5, 0.0]))
    ekf_j = je.ExtendedKalmanFilter(f_j, lambda x: x[:1], **kw)
    ekf_t = te.ExtendedKalmanFilter(f_t, lambda x: x[:1], device="cpu", **kw)
    x_true = np.array([0.5, 1.0], dtype=np.float32)
    u = np.array([0.3], dtype=np.float32)
    for _ in range(40):
        x_true = np.asarray(f_j(jnp.asarray(x_true), jnp.asarray(u)))
        x_j = ekf_j.update(x_true[:1], u)
        x_t = ekf_t.update(x_true[:1], u)
        np.testing.assert_allclose(x_t, x_j, atol=TOL, rtol=0)
    np.testing.assert_allclose(ekf_t.P, ekf_j.P, atol=TOL, rtol=0)
    # the omega error fell from 1.0 to the filter's noise floor
    np.testing.assert_allclose(x_t, x_true, atol=1e-2)
