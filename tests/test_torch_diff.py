"""Port parity for implicit differentiation (after tests/test_diff.py):
``tpu_gpad_torch.diff`` against ``tpu_gpad.diff`` on the same seeded
inputs. The backward alone (both ``sensitivity``s on JAX's converged dual,
paired, dense, soft rows, a tracking parameter), end to end (each package
runs its own forward: the same active sets, the same p-gradients), and the
float64 active-set QP differentiated by central differences as the
solver-independent oracle; CG against Cholesky; ``Controller.gain``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_gpad
from tpu_gpad import diff as jdiff
from tpu_gpad import problems as jp
from tpu_gpad.device_condense import dualize_ltv_device as j_dualize_ltv
from tpu_gpad.solver import SolverConfig as JConfig
from tpu_gpad.solver import solve_batch as j_solve_batch

import tpu_gpad_torch as tg
from tpu_gpad_torch import diff as tdiff
from tpu_gpad_torch import problems as tp
from tpu_gpad_torch.solver import SolverConfig as TConfig
from tpu_gpad_torch.solver import solve_batch as t_solve_batch
from tpu_gpad_torch.problems.battery import default_x0
from tpu_gpad_torch.solver.qp import solve_condensed_qp

torch.set_num_threads(2)

CPU = "cpu"
ITERS = 300  # restart iterations of every forward, as tests/test_diff.py
# The same backward on the same dual: float32 products in another order
SAME_Y_TOL = 1e-5
# Each package's own converged forward: p-gradients
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
# Gains against central differences of the float64 exact QP
# (tests/test_diff.py), 3e-3 with soft rows against the slack QP
FD_TOL, FD_SOFT_TOL = 2e-3, 3e-3
# CG against Cholesky: CG exits at a 1e-5 residual reduction by design
# (tests/test_diff.py::test_cg_solver_matches_cholesky)
CG_RTOL, CG_ATOL = 1e-4, 1e-5


def _di_polytope(P):
    """One-sided H_x rows force the dense (unpaired) dual layout."""
    return dataclasses.replace(P.double_integrator(horizon=8),
                               H_x=np.array([[1.0, 0.6]]), h_x=np.array([2.0]))


def _soft_ltv():
    rng = np.random.default_rng(2)
    n, nu, N = 3, 2, 8
    A = np.stack([np.eye(n) + 0.03 * rng.standard_normal((n, n))
                  for _ in range(N)])
    B = np.stack([0.2 * rng.standard_normal((n, nu)) for _ in range(N)])
    kw = dict(x_min=np.full(n, -0.25), x_max=np.full(n, 0.25))
    return A, B, kw


def _soft_pair():
    """Device soft rows (dual damping) in both packages, and the host
    slack-variable QP of the same LTV plant as the oracle."""
    A, B, kw = _soft_ltv()
    n, nu, N, rho = 3, 2, 8, 8.0
    args = (np.eye(n), 0.5 * np.eye(nu), np.full(nu, -1.0), np.full(nu, 1.0))
    dj = j_dualize_ltv(jnp.asarray(A, jnp.float32), jnp.asarray(B, jnp.float32),
                       jnp.zeros((N, n), jnp.float32), *args, iterations=400,
                       soft_state=rho, **kw)
    dt = tg.dualize_ltv_device(torch.as_tensor(A, dtype=torch.float32),
                               torch.as_tensor(B, dtype=torch.float32),
                               torch.zeros((N, n)), *args, iterations=400,
                               soft_state=rho, **kw)
    prob = tg.LinearMPCProblem(A=A, B=B, Q=np.eye(n), R=0.5 * np.eye(nu),
                               horizon=N, u_min=np.full(nu, -1.0),
                               u_max=np.full(nu, 1.0), **kw)
    qp = tg.condense(prob, soft_state=rho, tracking=True)
    x0 = np.array([0.4, -0.3, 0.2], np.float32)
    P = np.concatenate([x0, np.zeros(n)]).astype(np.float32)[None]
    return qp, dj, dt, P


def _case(name):
    """(port QP for the oracle, JAX data, port data, parameters)."""
    if name == "soft":
        return _soft_pair()
    if name == "paired":
        qp_j = tpu_gpad.condense(jp.battery(n_cells=3, horizon=8))
        qp_t = tg.condense(tp.battery(n_cells=3, horizon=8))
        P = np.stack([default_x0(3, seed=s) for s in (0, 1, 2, 3)])
    elif name == "dense":
        qp_j, qp_t = tpu_gpad.condense(_di_polytope(jp)), tg.condense(
            _di_polytope(tp))
        P = np.array([[1.5, 0.8], [1.2, 0.9]])  # the polytope row active
    else:  # tracking: p = [x0; r]
        qp_j = tpu_gpad.condense(jp.double_integrator(horizon=8),
                                 tracking=True)
        qp_t = tg.condense(tp.double_integrator(horizon=8), tracking=True)
        P = np.array([[0.4, 0.2, -0.3, 0.0]])
    dj = tpu_gpad.dualize(qp_j, iterations=400, paired="auto")
    dt = tg.dualize(qp_t, iterations=400, paired="auto", device=CPU)
    return qp_t, dj, dt, P.astype(np.float32)


_SOLVES = {}


def _solved(name):
    """The case, and each package's converged forward (restart, ITERS),
    computed once per module."""
    if name not in _SOLVES:
        qp, dj, dt, P = _case(name)
        rj = j_solve_batch(dj, jnp.asarray(P), config=JConfig(
            iterations=ITERS, restart=True, engine="xla"))
        rt = t_solve_batch(dt, torch.as_tensor(P), config=TConfig(
            iterations=ITERS, restart=True, engine="torch"))
        _SOLVES[name] = qp, dj, dt, P, rj, rt
    return _SOLVES[name]


def _exact_u(qp, p, n_keep=None):
    sol = solve_condensed_qp(qp, np.asarray(p, np.float64))
    assert sol.status == "optimal", sol.status
    return sol.z[: (n_keep or qp.n_u)]


def _fd_gain(qp, p, h=1e-5, n_keep=None):
    p = np.asarray(p, np.float64)
    cols = []
    for j in range(p.size):
        e = np.zeros_like(p)
        e[j] = h
        cols.append((_exact_u(qp, p + e, n_keep) - _exact_u(qp, p - e, n_keep))
                    / (2 * h))
    return np.stack(cols, axis=1)  # (n_keep, n_p)


CASES = ["paired", "dense", "soft", "tracking"]


@pytest.mark.parametrize("case", CASES)
def test_sensitivity_on_the_same_dual_matches_tpu_gpad(case):
    """The backward alone: JAX's converged y into both sensitivities."""
    _, dj, dt, _, rj, _ = _solved(case)
    assert dt.paired == dj.paired == (case != "dense")
    if case == "soft":
        assert dt.soft_damp is not None
    y = np.array(rj.y)
    Ku_j, Kz_j = jdiff.sensitivity(dj, jnp.asarray(y))
    Ku_t, Kz_t = tdiff.sensitivity(dt, y)
    assert Ku_t.shape == Ku_j.shape and Kz_t.shape == Kz_j.shape
    np.testing.assert_allclose(Ku_t.numpy(), np.asarray(Ku_j), atol=SAME_Y_TOL,
                               rtol=0)
    np.testing.assert_allclose(Kz_t.numpy(), np.asarray(Kz_j), atol=SAME_Y_TOL,
                               rtol=0)
    # one dual without the batch axis
    Ku1, Kz1 = tdiff.sensitivity(dt, y[0])
    np.testing.assert_allclose(Ku1.numpy(), Ku_t[0].numpy(), atol=1e-7)
    assert Kz1.shape == Kz_t.shape[1:]


@pytest.mark.parametrize("case", CASES)
def test_gain_matches_tpu_gpad_and_the_exact_qp(case):
    """End to end: each package's own forward gives the same active set
    and the same gain, which is the float64 QP's derivative."""
    qp, dj, dt, P, rj, rt = _solved(case)
    mj, pj = jdiff.active_signs(dj, rj.y)
    mt, pt = tdiff.active_signs(dt, rt.y)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    if pj is not None:
        # the side only matters on active rows
        on = np.asarray(mj) > 0
        np.testing.assert_array_equal(pt.numpy()[on], np.asarray(pj)[on])
    if case != "tracking":
        assert float(np.asarray(rj.y).max()) > 1e-4  # rows really active
    K_j = np.asarray(jdiff.feedback_gain(dj, rj))
    K_t = tdiff.feedback_gain(dt, rt).numpy()
    np.testing.assert_allclose(K_t, K_j, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    tol = FD_SOFT_TOL if case == "soft" else FD_TOL
    for b in range(min(2, P.shape[0])):
        np.testing.assert_allclose(K_t[b], _fd_gain(qp, P[b]), atol=tol)


def test_gain_unconstrained_is_analytic():
    """Interior x0: no active row, so K_u == -(H^-1 F')[:n_u] exactly."""
    qp = tg.condense(tp.double_integrator(horizon=8))
    data = tg.dualize(qp, iterations=400, paired="auto", device=CPU)
    x0 = np.array([[0.01, -0.005]], np.float32)
    res = t_solve_batch(data, x0, config=TConfig(iterations=ITERS,
                                                 restart=True))
    assert float(res.y.max()) < 1e-7
    K_u, K_z = tdiff.sensitivity(data, res.y)
    np.testing.assert_allclose(K_u[0].numpy(), -data.gP_map.mT[:data.n_u]
                               .numpy(), atol=1e-6)
    assert K_z.shape == (1, data.n_z, 2)


@pytest.mark.parametrize("method", ["chol", "cg"])
def test_p_grads_match_tpu_gpad_and_fd(method):
    """grad of 0.5 |u*|^2 through make_differentiable_solver on each
    package's own forward: equal gradients, equal to K' u, and to central
    differences of the float64 QP's loss."""
    qp, dj, dt, P, rj, rt = _solved("paired")
    P = P[1:]
    fj = jdiff.make_differentiable_solver(
        dj, JConfig(iterations=ITERS, restart=True, engine="xla"))
    gj = jax.grad(lambda p: 0.5 * jnp.sum(fj(p) ** 2))(jnp.asarray(P))
    ft = tdiff.make_differentiable_solver(
        dt, TConfig(iterations=ITERS, restart=True, engine="torch"),
        method=method)
    p = torch.as_tensor(P).requires_grad_(True)
    u = ft(p)
    np.testing.assert_allclose(u.detach().numpy(), rt.u[1:].numpy(), atol=0)
    (0.5 * (u ** 2).sum()).backward()
    g = p.grad.numpy()
    np.testing.assert_allclose(g, np.asarray(gj), atol=GRAD_ATOL,
                               rtol=GRAD_RTOL)
    if method == "chol":  # the same factorization: K' u to fp32 rounding
        K_u, _ = tdiff.sensitivity(dt, rt.y[1:], method=method)
        np.testing.assert_allclose(
            g, torch.einsum("bup,bu->bp", K_u, rt.u[1:]).numpy(), atol=5e-7,
            rtol=1e-5)
    h, g_fd = 1e-5, np.zeros(qp.n_x)
    for j in range(qp.n_x):
        e = np.zeros(qp.n_x)
        e[j] = h
        g_fd[j] = (0.5 * np.sum(_exact_u(qp, P[0] + e) ** 2)
                   - 0.5 * np.sum(_exact_u(qp, P[0] - e) ** 2)) / (2 * h)
    np.testing.assert_allclose(g[0], g_fd, atol=FD_TOL)


def test_full_trajectory_grads_and_batch_shapes():
    """full_trajectory=True against central differences of the exact QP's
    whole trajectory; a single parameter and a (2, 2, n_p) batch."""
    qp = tg.condense(tp.double_integrator(horizon=6))
    data = tg.dualize(qp, iterations=300, paired="auto", device=CPU)
    cfg = TConfig(iterations=200, restart=True)
    f = tdiff.make_differentiable_solver(data, cfg, full_trajectory=True)
    p0 = np.array([0.5, -0.2], np.float32)
    p = torch.tensor(p0, requires_grad=True)
    z = f(p)
    assert z.shape == (data.n_z,)
    z.abs().sum().backward()
    h, g_fd = 1e-5, np.zeros(2)
    for j in range(2):
        e = np.zeros(2)
        e[j] = h
        g_fd[j] = (np.abs(_exact_u(qp, p0 + e, qp.n_z)).sum()
                   - np.abs(_exact_u(qp, p0 - e, qp.n_z)).sum()) / (2 * h)
    np.testing.assert_allclose(p.grad.numpy(), g_fd, atol=FD_TOL)
    P4 = torch.tensor(np.stack([[p0, 0.9 * p0]] * 2), requires_grad=True)
    f(P4).abs().sum().backward()
    assert P4.grad.shape == (2, 2, 2)
    np.testing.assert_allclose(P4.grad[1, 0].numpy(), p.grad.numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("case", ["paired", "dense", "soft"])
def test_cg_matches_cholesky(case):
    """method='cg' == method='chol' on every layout, gains and the data
    path's p-gradients; 'auto' is the port's size rule; an unknown method
    raises."""
    _, _, dt, P, _, rt = _solved(case)
    K_chol, _ = tdiff.sensitivity(dt, rt.y, method="chol")
    before = tdiff.CG_ITERATIONS
    K_cg, _ = tdiff.sensitivity(dt, rt.y, method="cg")
    assert 0 < tdiff.CG_ITERATIONS - before <= dt.MG_T.shape[0] + 8
    np.testing.assert_allclose(K_cg.numpy(), K_chol.numpy(), rtol=CG_RTOL,
                               atol=CG_ATOL)
    K_auto, _ = tdiff.sensitivity(dt, rt.y)
    K_same, _ = tdiff.sensitivity(
        dt, rt.y, method=tdiff.resolve_method(dt, rt.y.shape[0]))
    np.testing.assert_array_equal(K_auto.numpy(), K_same.numpy())
    with pytest.raises(ValueError, match="method"):
        tdiff.sensitivity(dt, rt.y, method="qr")
    cfg = TConfig(iterations=ITERS, restart=True)
    grads = []
    for method in ("cg", "chol"):
        f = tdiff.make_data_differentiable_solver(cfg, method=method)
        p = torch.as_tensor(P).requires_grad_(True)
        (0.5 * (f(dt, p) ** 2).sum()).backward()
        grads.append(p.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=CG_RTOL, atol=CG_ATOL)


def test_cg_matches_tpu_gpad_cg_over_a_batch():
    """Over a batch (battery n3 N10, 64 scenarios) some scenarios' CG gains
    leave test_cg_matches_cholesky's element bound against Cholesky: CG
    exits at a 1e-5 residual reduction. tpu_gpad's CG gives the same gains
    on the same duals, so that spread is the method's, not the port's."""
    dj = tpu_gpad.dualize(tpu_gpad.condense(jp.battery(3, 10)),
                          iterations=100, paired="auto")
    dt = tg.dualize(tg.condense(tp.battery(3, 10)), iterations=100,
                    paired="auto", device=CPU)
    X0 = np.random.default_rng(31).uniform(-0.4, 0.4, (64, 3))
    y = t_solve_batch(dt, X0.astype(np.float32), config=TConfig(
        iterations=100, restart=True)).y
    for method in ("cg", "chol"):
        K_t, _ = tdiff.sensitivity(dt, y, method=method)
        K_j, _ = jdiff.sensitivity(dj, jnp.asarray(y.numpy()), method=method)
        np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j),
                                   atol=SAME_Y_TOL, rtol=0, err_msg=method)


def test_auto_method_takes_cg_past_the_system_size():
    """'auto' factors by Cholesky below AUTO_CG_MIN_SYSTEM elements of the
    (B, S, S) systems and runs CG from there (measured on an H100)."""
    _, _, dt, _, _, _ = _solved("paired")
    S = dt.MG_T.shape[0]
    edge = -(-tdiff.AUTO_CG_MIN_SYSTEM // (S * S))  # the first CG batch
    assert tdiff.resolve_method(dt, edge - 1) == "chol"
    assert tdiff.resolve_method(dt, edge) == "cg"
    assert tdiff.resolve_method(dt, edge, "chol") == "chol"
    assert tdiff.resolve_method(dt, 1, "cg") == "cg"


def test_chol_gives_nan_where_the_system_is_not_definite():
    """A scenario whose masked system is singular gives NaN, as JAX's
    Cholesky does, and leaves its neighbours alone."""
    _, _, dt, _, _, rt = _solved("paired")
    S = dt.MG_T.shape[0]
    m_b = torch.ones((2, S))
    B = torch.ones((2, S, 1))
    bad = dataclasses.replace(dt, D=torch.zeros_like(dt.D))
    X = tdiff._solve_masked_system(bad, m_b, -1.0, B, "chol")
    assert bool(torch.isnan(X).all())
    good = tdiff._solve_masked_system(dt, m_b * 0, 0.0, B, "chol")
    np.testing.assert_allclose(good.numpy(), B.numpy(), atol=1e-6)


def test_controller_gain_matches_tpu_gpad_batched():
    """Controller.gain after a batched restart step: (B, n_u, n_p), equal
    to tpu_gpad's Controller.gain on the same states."""
    kw = dict(iterations=ITERS)
    c_j = tpu_gpad.Controller(jp.battery(3, 8), config=JConfig(
        iterations=ITERS, restart=True), **kw)
    c_t = tg.Controller(tp.battery(3, 8), config=TConfig(
        iterations=ITERS, restart=True), device=CPU, **kw)
    X = np.stack([default_x0(3, seed=s) for s in (0, 3, 5)])
    c_j.step(X.astype(np.float32))
    c_t.step(X.astype(np.float32))
    K_j, K_t = c_j.gain(), c_t.gain()
    assert isinstance(K_t, np.ndarray) and K_t.shape == (3, 3, 3)
    np.testing.assert_allclose(K_t, K_j, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    c_t.step(X[0].astype(np.float32))
    assert c_t.gain().shape == (3, 3)
