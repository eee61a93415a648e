"""Port parity for successive-linearization NMPC (after
tests/test_nonlinear.py and the NMPC cases of tests/test_device_condense.py):
``rk4``, ``rollout`` and ``linearize`` of ``tpu_gpad_torch.nonlinear`` on
both nonlinear plants against ``tpu_gpad.nonlinear``; ``NMPC.plan`` on the
host-condensed, device-condensed and stage-wise paths against
``tpu_gpad``'s on the same states; then the port's own closed loops: the
batch against the single plant, the closed loop on the device against the
per-sample loop, the pendulum swing-up, rate limits, the figure-eight
preview, and the reference's errors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gpad import nonlinear as jn
from tpu_gpad.problems.pendulum import pendulum_dynamics as j_pendulum
from tpu_gpad.problems.point_mass import figure_eight as j_figure_eight
from tpu_gpad.problems.point_mass import point_mass_drag as j_point_mass

from tpu_gpad_torch.nonlinear import (
    NMPC,
    linearize,
    rk4,
    rollout,
    simulate_nonlinear,
    simulate_nonlinear_device,
)
from tpu_gpad_torch.problems import figure_eight, pendulum_dynamics, point_mass_drag
from tpu_gpad_torch.problems.pendulum import UPRIGHT

torch.set_num_threads(2)

# rk4, rollout and the Jacobians: float32 in both packages
LIN_TOL = 1e-5
# plans of the host-condensed and stage-wise paths: float64 condensation
# in both packages, fp32 solves that differ in summation order
PLAN_TOL = 1e-4
# plans of the device-condensed path: float32 condensation in both
DEVICE_PLAN_TOL = 1e-3
# the same controller through two loops (tests/test_device_condense.py:319)
LOOP_TOL = 1e-4
SETTLE = 0.05
CPU = "cpu"

PLANTS = {
    "pendulum": (j_pendulum, pendulum_dynamics, 2, 1, 0.05),
    "point_mass": (j_point_mass, point_mass_drag, 4, 2, 0.1),
}


@pytest.mark.parametrize("plant", list(PLANTS))
def test_rk4_rollout_linearize_match_tpu_gpad(plant):
    j_f, t_f, n_x, n_u, dt = PLANTS[plant]
    fj, ft = jn.rk4(j_f(), dt), rk4(t_f(), dt)
    rng = np.random.default_rng(3)
    x0 = rng.uniform(-1.0, 1.0, n_x).astype(np.float32)
    if plant == "point_mass":
        x0[2:] = 0.0  # v = 0: the drag's Jacobian stays finite
    us = (rng.standard_normal((7, n_u)) * 0.8).astype(np.float32)
    x_t, us_t = torch.from_numpy(x0), torch.from_numpy(us)
    np.testing.assert_allclose(ft(x_t, us_t[0]).numpy(),
                               np.asarray(fj(jnp.asarray(x0), jnp.asarray(us[0]))),
                               atol=LIN_TOL, rtol=0)
    xs_t = rollout(ft, x_t, us_t)
    xs_j = np.asarray(jn.rollout(fj, x0, us))
    np.testing.assert_allclose(xs_t.numpy(), xs_j, atol=LIN_TOL, rtol=0)
    xl = np.concatenate([x0[None], xs_j[:-1]]).astype(np.float32)
    for a, b in zip(linearize(ft, torch.from_numpy(xl), us_t),
                    jn.linearize(fj, xl, us)):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=LIN_TOL,
                                   rtol=0)
    # scenarios on a leading axis: the same as one at a time
    X = torch.stack([x_t, x_t + 0.1])
    U = torch.stack([us_t, -us_t])
    xs_b = rollout(ft, X, U)
    for b in range(2):
        torch.testing.assert_close(xs_b[b], rollout(ft, X[b], U[b]))


def test_linearize_exact_on_linear_dynamics(rng):
    A = torch.as_tensor(rng.normal(size=(3, 3)) * 0.5, dtype=torch.float32)
    B = torch.as_tensor(rng.normal(size=(3, 2)), dtype=torch.float32)
    xs = torch.as_tensor(rng.normal(size=(4, 3)), dtype=torch.float32)
    us = torch.as_tensor(rng.normal(size=(4, 2)), dtype=torch.float32)
    As, Bs, cs = linearize(lambda x, u: A @ x + B @ u, xs, us)
    for k in range(4):
        torch.testing.assert_close(As[k], A, atol=LIN_TOL, rtol=0)
        torch.testing.assert_close(Bs[k], B, atol=LIN_TOL, rtol=0)
    torch.testing.assert_close(cs, torch.zeros_like(cs), atol=LIN_TOL, rtol=0)


def test_linearization_exact_at_nominal(rng):
    """The affine model reproduces the nonlinear rollout at the nominal."""
    f = rk4(pendulum_dynamics(), dt=0.05)
    x0 = torch.tensor([0.3, -0.2])
    us = torch.as_tensor(rng.normal(size=(6, 1)) * 0.5, dtype=torch.float32)
    xs_next = rollout(f, x0, us)
    A, B, c = linearize(f, torch.cat([x0[None], xs_next[:-1]]), us)
    x = x0.double()
    for k in range(6):
        x = A[k].double() @ x + B[k].double() @ us[k].double() + c[k].double()
        np.testing.assert_allclose(x.numpy(), xs_next[k].numpy(), atol=1e-5)


def test_rk4_accuracy():
    f = rk4(lambda x, u: -x + 0.0 * u, dt=0.1)
    assert abs(float(f(torch.ones(1), torch.zeros(1))[0]) - np.exp(-0.1)) < 1e-7


PEND = dict(n_x=2, n_u=1, horizon=12, Q=np.diag([10.0, 1.0]), R=np.diag([0.1]),
            u_min=np.array([-11.0]), u_max=np.array([11.0]), iterations=150,
            sqp_iters=2)
BOX = dict(x_min=np.array([-10.0, -12.0]), x_max=np.array([10.0, 12.0]))
PATHS = {
    "host": ({}, PLAN_TOL),
    "device": (dict(device_condense=True, **BOX), DEVICE_PLAN_TOL),
    "host_rate_box": (dict(du_min=np.array([-2.0]), du_max=np.array([2.0]),
                           **BOX), PLAN_TOL),
    "device_rate": (dict(device_condense=True, du_min=np.array([-2.0]),
                         du_max=np.array([2.0]), **BOX), DEVICE_PLAN_TOL),
    "stagewise": (dict(engine="stagewise", u_min=np.array([-2.0]),
                       u_max=np.array([2.0])), PLAN_TOL),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_plan_matches_tpu_gpad(path):
    """Four samples of the same closed loop in both packages (tpu_gpad's
    moves applied to both): every plan, warm starts engaged."""
    extra, tol = PATHS[path]
    kw = {**PEND, **extra}
    fj = jn.rk4(j_pendulum(), 0.05)
    cj = jn.NMPC(fj, **kw)
    ct = NMPC(rk4(pendulum_dynamics(), 0.05), **kw, device=CPU)
    x = np.array([1.8, 0.3], dtype=np.float32)
    for _ in range(4):
        uj, ut = cj.plan(x, UPRIGHT), ct.plan(x, UPRIGHT)
        assert ut.shape == (12, 1) and ut.dtype == np.float32
        np.testing.assert_allclose(ut, uj, atol=tol, rtol=0)
        x = np.asarray(fj(jnp.asarray(x), jnp.asarray(uj[0])), np.float32)


def _pendulum_nmpc(device_condense, sqp_iters=2, **kw):
    return NMPC(rk4(pendulum_dynamics(), 0.05),
                **{**PEND, **BOX, "sqp_iters": sqp_iters},
                device_condense=device_condense, device=CPU, **kw)


@pytest.mark.parametrize("device_condense", [False, True],
                         ids=["host", "device"])
def test_plan_batch_matches_plan(device_condense):
    """B scenarios planned together equal each planned alone, over warm
    samples; identical states plan identically."""
    X = np.array([[1.8, 0.3], [1.8, 0.3], [2.6, -0.5]], dtype=np.float32)
    batch = _pendulum_nmpc(device_condense, sqp_iters=1)
    singles = [_pendulum_nmpc(device_condense, sqp_iters=1) for _ in X]
    f = batch.f
    for _ in range(3):
        ub = batch.plan_batch(X, UPRIGHT)
        assert ub.shape == (3, 12, 1)
        for s, ctrl in enumerate(singles):
            np.testing.assert_allclose(ub[s], ctrl.plan(X[s], UPRIGHT),
                                       atol=PLAN_TOL, rtol=0)
        np.testing.assert_allclose(ub[0], ub[1], atol=1e-6, rtol=0)
        X = np.stack([f(torch.from_numpy(X[b]), torch.from_numpy(ub[b, 0])).numpy()
                      for b in range(3)])
    assert batch._y_b.shape[0] == 3
    assert batch.step_batch(X[:2], UPRIGHT).shape == (2, 1)  # size change


def test_simulate_nonlinear_device_matches_host_loop():
    """The closed loop on the device == the per-sample loop driving the
    same device-condensed controller (tests/test_device_condense.py:307)."""
    ref = np.array([np.pi, 0.0], dtype=np.float32)
    x0 = np.array([2.2, 0.0], dtype=np.float32)
    dev_loop = _pendulum_nmpc(True, sqp_iters=1)
    X_scan, U_scan = simulate_nonlinear_device(dev_loop.f, dev_loop, x0, 45,
                                               x_ref=ref)
    assert dev_loop._us is None  # the controller's own state is untouched
    dev_host = _pendulum_nmpc(True, sqp_iters=1)
    X_host, U_host = simulate_nonlinear(dev_host.f, dev_host, x0, 45, x_ref=ref)
    assert X_scan.shape == (46, 2) and U_scan.shape == (45, 1)
    np.testing.assert_allclose(X_scan, X_host, atol=LOOP_TOL, rtol=0)
    np.testing.assert_allclose(U_scan, U_host, atol=LOOP_TOL, rtol=0)
    assert abs(X_scan[-1, 0] - np.pi) < 0.1


def test_nmpc_pendulum_upright():
    """Swing the damped pendulum from 61 degrees short of upright to the
    unstable upright equilibrium under the torque limit (horizon 25)."""
    f = rk4(pendulum_dynamics(), dt=0.05)
    ctrl = NMPC(f, n_x=2, n_u=1, horizon=25, Q=np.diag([10.0, 1.0]),
                R=np.diag([0.1]), u_min=np.array([-11.0]),
                u_max=np.array([11.0]), iterations=200, sqp_iters=2,
                device=CPU)
    X, U = simulate_nonlinear(f, ctrl, np.array([2.07, 0.0]), n_steps=80,
                              x_ref=UPRIGHT)
    assert np.abs(U).max() <= 11.0 + 1e-3
    tail = X[-10:]
    assert np.abs(tail[:, 0] - np.pi).max() < SETTLE, tail[-1]
    assert np.abs(tail[:, 1]).max() < 0.1


@pytest.mark.parametrize("device_condense", [False, True],
                         ids=["host", "device"])
def test_rate_limits_hold_in_closed_loop(device_condense):
    f = rk4(pendulum_dynamics(), dt=0.05)
    ctrl = NMPC(f, n_x=2, n_u=1, horizon=12, Q=np.diag([10.0, 1.0]),
                R=np.diag([0.1]), u_min=np.array([-8.0]), u_max=np.array([8.0]),
                du_min=np.array([-1.0]), du_max=np.array([1.0]), iterations=200,
                device_condense=device_condense, device=CPU)
    sim = simulate_nonlinear_device if device_condense else simulate_nonlinear
    X, U = sim(f, ctrl, np.array([2.6, 0.0]), 30, x_ref=UPRIGHT)
    dU = np.diff(np.concatenate([[np.zeros(1)], U], axis=0), axis=0)
    assert np.abs(dU).max() <= 1.0 + 1e-3


def test_device_loop_seeds_u_prev_from_reset():
    def make():
        return NMPC(rk4(pendulum_dynamics(), 0.05), n_x=2, n_u=1, horizon=10,
                    Q=np.diag([10.0, 1.0]), R=0.1 * np.eye(1),
                    u_min=np.array([-11.0]), u_max=np.array([11.0]),
                    du_min=np.array([-1.0]), du_max=np.array([1.0]),
                    iterations=150, device_condense=True, device=CPU)

    x0 = np.array([2.4, 0.0], np.float32)
    c1 = make()
    c1.reset(u_prev=np.array([5.0]))
    _, U1 = simulate_nonlinear_device(c1.f, c1, x0, 3, x_ref=UPRIGHT)
    assert abs(U1[0, 0] - 5.0) <= 1.0 + 1e-3
    c0 = make()
    _, U0 = simulate_nonlinear_device(c0.f, c0, x0, 3, x_ref=UPRIGHT)
    assert abs(U0[0, 0]) <= 1.0 + 1e-3
    assert abs(U1[0, 0] - U0[0, 0]) > 0.5


@pytest.mark.parametrize("extra", ["soft", "polytopes"])
def test_device_soft_and_polytopes_track_the_host_path(extra):
    f = rk4(pendulum_dynamics(), dt=0.05)
    box = dict(x_min=np.array([-6.0, -5.5]), x_max=np.array([6.0, 5.5]))
    more = (dict(soft_state=30.0) if extra == "soft" else
            dict(H_x=np.array([[1.0, 0.4]]), h_x=np.array([4.0]),
                 H_u=np.array([[1.0]]), h_u=np.array([10.0])))
    kw = dict(n_x=2, n_u=1, horizon=8, Q=np.diag([10.0, 1.0]), R=np.diag([0.1]),
              u_min=np.array([-11.0]), u_max=np.array([11.0]), iterations=120,
              device=CPU, **box, **more)
    x0 = np.array([2.4, 0.0], np.float32)
    X_h, _ = simulate_nonlinear(f, NMPC(f, **kw), x0, 10, x_ref=UPRIGHT)
    X_d, _ = simulate_nonlinear(f, NMPC(f, device_condense=True, **kw), x0, 10,
                                x_ref=UPRIGHT)
    np.testing.assert_allclose(X_d, X_h, atol=5e-3)


def test_nmpc_preview_figure_eight():
    """The drag point mass follows a figure-eight with per-stage preview."""
    dt, N, n_steps = 0.1, 12, 60
    f = rk4(point_mass_drag(k=0.3), dt=dt)
    traj = figure_eight(n_steps + N + 1, dt, scale=1.0, period=6.0)
    ctrl = NMPC(f, n_x=4, n_u=2, horizon=N, Q=np.diag([20.0, 20.0, 1.0, 1.0]),
                R=np.diag([0.05, 0.05]), u_min=np.full(2, -6.0),
                u_max=np.full(2, 6.0), iterations=200, sqp_iters=2,
                preview=True, device=CPU)
    X, U = simulate_nonlinear(f, ctrl, traj[0], n_steps, x_ref=traj)
    pos_err = np.linalg.norm(X[1:, :2] - traj[1: n_steps + 1, :2], axis=1)
    assert pos_err[10:].max() < 0.08, pos_err[10:].max()
    assert np.abs(U).max() <= 6.0 + 1e-3


def test_figure_eight_matches_tpu_gpad():
    np.testing.assert_array_equal(figure_eight(20, 0.1, scale=1.2, period=5.0),
                                  j_figure_eight(20, 0.1, scale=1.2, period=5.0))


@pytest.mark.parametrize("device_condense", [False, True],
                         ids=["host", "device"])
def test_preview_shapes_and_batch(device_condense):
    f = rk4(point_mass_drag(), dt=0.1)
    ctrl = NMPC(f, n_x=4, n_u=2, horizon=6, Q=np.eye(4), R=np.eye(2) * 0.1,
                u_min=np.full(2, -6.0), u_max=np.full(2, 6.0), iterations=100,
                preview=True, device_condense=device_condense, device=CPU)
    window = np.zeros((6, 4), dtype=np.float32)
    assert ctrl.step(np.zeros(4), window).shape == (2,)
    assert ctrl.step_batch(np.zeros((3, 4)), window).shape == (3, 2)
    assert ctrl.step_batch(np.zeros((3, 4)), np.zeros((3, 6, 4))).shape == (3, 2)
    X, U = (simulate_nonlinear_device if device_condense else simulate_nonlinear)(
        f, ctrl, np.zeros(4), 3, x_ref=figure_eight(5, 0.1))
    assert X.shape == (4, 4) and U.shape == (3, 2)


def test_stagewise_engine_matches_condensed():
    """engine='stagewise' plans as the condensed path does, single and
    batched, warm starts carried and reset on a batch-size change."""
    f = rk4(pendulum_dynamics(), dt=0.05)
    kw = dict(n_x=2, n_u=1, horizon=10, Q=np.diag([5.0, 0.5]),
              R=np.eye(1) * 0.1, u_min=np.array([-2.0]), u_max=np.array([2.0]),
              iterations=300, sqp_iters=2, device=CPU)
    nm_c, nm_s = NMPC(f, **kw), NMPC(f, engine="stagewise", **kw)
    x = np.array([np.pi * 0.8, 0.0], dtype=np.float32)
    for _ in range(3):
        us_c = nm_c.plan(x, np.zeros(2))
        np.testing.assert_allclose(nm_s.plan(x, np.zeros(2)), us_c, atol=2e-3)
        x = f(torch.from_numpy(x), torch.from_numpy(us_c[0])).numpy()
    rng = np.random.default_rng(0)
    X = (rng.uniform(-0.5, 0.5, size=(3, 2)) + [np.pi * 0.7, 0.0]).astype(
        np.float32)
    for _ in range(2):
        np.testing.assert_allclose(nm_s.plan_batch(X, np.zeros(2)),
                                   nm_c.plan_batch(X, np.zeros(2)), atol=5e-3)
    assert nm_s._y_b is not None
    assert nm_s.plan_batch(X[:2], np.zeros(2)).shape == (2, 10, 1)


def test_plan_batch_stagewise_matches_tpu_gpad():
    kw = dict(n_x=2, n_u=1, horizon=10, Q=np.diag([5.0, 0.5]),
              R=np.eye(1) * 0.1, u_min=np.array([-2.0]), u_max=np.array([2.0]),
              iterations=150, sqp_iters=2, engine="stagewise")
    cj = jn.NMPC(jn.rk4(j_pendulum(), 0.05), **kw)
    ct = NMPC(rk4(pendulum_dynamics(), 0.05), **kw, device=CPU)
    X = np.array([[2.0, 0.1], [2.3, -0.2], [2.6, 0.0]], np.float32)
    for _ in range(2):
        np.testing.assert_allclose(ct.plan_batch(X, np.zeros(2)),
                                   cj.plan_batch(X, np.zeros(2)),
                                   atol=PLAN_TOL, rtol=0)


def test_errors_match_tpu_gpad():
    f = rk4(pendulum_dynamics(), dt=0.05)
    box = dict(u_min=np.array([-1.0]), u_max=np.array([1.0]))
    cases = [
        (dict(damping=0.0), "damping"),
        (dict(sqp_iters=0), "sqp_iters"),
        (dict(engine="xla"), "engine must be"),
        (dict(engine="stagewise", du_min=np.array([-0.1]),
              du_max=np.array([0.1])), "rate limits"),
        (dict(engine="stagewise", device_condense=True, **box), "exclusive"),
        (dict(engine="stagewise", soft_state=1.0), "soft_state"),
        (dict(device_condense=True), "input boxes"),
        (dict(device_condense=True, x_min=np.zeros(2), **box),
         "both state bounds"),
        (dict(device_condense=True, du_min=np.array([-0.1]), **box),
         "both rate bounds"),
        (dict(device_condense=True, soft_state=10.0, **box), "no state box"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            NMPC(f, 2, 1, 5, np.eye(2), np.eye(1), device=CPU, **kw)
    from tpu_gpad_torch.solver import SolverConfig

    with pytest.raises(ValueError, match="fixed-iteration"):
        NMPC(f, 2, 1, 5, np.eye(2), np.eye(1), device_condense=True,
             config=SolverConfig(mode="eps"), device=CPU, **box)
    host = NMPC(f, 2, 1, 5, np.eye(2), np.eye(1), device=CPU, **box)
    with pytest.raises(ValueError, match="device_condense"):
        simulate_nonlinear_device(f, host, np.zeros(2), 5)
    assert host.step(np.array([0.3, 0.0])).shape == (1,)
    host.reset()
    assert host._us is None and host._y is None

