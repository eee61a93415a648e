"""Port parity for the stage-wise implicit adjoint (after
tests/test_diff_stagewise.py): the hand-written transpose of the zeroed
closed-loop rollout against ``jax.vjp`` of tpu_gpad's ``_lqr_solve``,
``stagewise_feedback_gain`` against tpu_gpad's and against central
differences of the float64 exact QP, against the port's condensed
``sensitivity`` on the same problem, the whole-trajectory VJP against the
condensed one, and the interior gain against the LQR gain."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gpad import diff as jdiff
from tpu_gpad import problems as jp
from tpu_gpad import stagewise as js
from tpu_gpad.solver import SolverConfig as JConfig

import tpu_gpad_torch as tg
from tpu_gpad_torch import diff as tdiff
from tpu_gpad_torch import problems as tp
from tpu_gpad_torch.condense import lipschitz_constant
from tpu_gpad_torch.solver import SolverConfig as TConfig
from tpu_gpad_torch.solver.qp import solve_condensed_qp

torch.set_num_threads(2)

CPU = "cpu"
ITERS = 400  # restart iterations, as tests/test_diff_stagewise.py
# the transpose against jax.vjp: the same products in another order
VJP_RTOL = 1e-5
# gains: against tpu_gpad's and the condensed adjoint (converged fp32
# forwards, CG exits at a 1e-5 reduction), and against the exact QP
GAIN_TOL, FD_TOL, LQR_TOL = 5e-4, 2e-3, 1e-4


def _pair(n_cells, horizon):
    """The battery problem's stage-wise data in both packages (the same L)
    and the port's condensed QP."""
    prob_t = tp.battery(n_cells, horizon)
    qp = tg.condense(prob_t)
    L = lipschitz_constant(qp)
    d_t = tg.build_stagewise(prob_t, iterations=ITERS, L=L, device=CPU)
    d_j = js.build_stagewise(jp.battery(n_cells, horizon), iterations=ITERS,
                             L=L)
    return qp, L, d_j, d_t


def _fd_gain(qp, p, h=1e-5):
    def u(x):
        sol = solve_condensed_qp(qp, x)
        assert sol.status == "optimal", sol.status
        return sol.z[:qp.n_u]

    p = np.asarray(p, np.float64)
    return np.stack([(u(p + h * e) - u(p - h * e)) / (2 * h)
                     for e in np.eye(p.size)], axis=1)


def test_x0_vjp_matches_jax_vjp_of_lqr_solve():
    """_sw_x0_vjp (one backward sweep over E_k, K_k) is the transpose of
    the zeroed closed loop that jax.vjp takes of tpu_gpad's _lqr_solve."""
    _, _, d_j, d_t = _pair(3, 8)
    N, n, p, B = 8, d_t.n_x, d_t.n_u, 3
    rng = np.random.default_rng(3)
    cx = rng.standard_normal((B, N, n)).astype(np.float32)
    cu = rng.standard_normal((B, N, p)).astype(np.float32)
    d0 = jdiff._sw_zeroed(d_j)
    f = lambda x: js._lqr_solve(d0, jnp.zeros((N, n)), jnp.zeros((N, p)), x)
    _, vjp = jax.vjp(f, jnp.zeros(n))
    want = np.stack([np.asarray(vjp((jnp.asarray(cx[b]), jnp.asarray(cu[b])))[0])
                     for b in range(B)])
    got = tdiff._sw_x0_vjp(tdiff._sw_zeroed(d_t),
                           torch.as_tensor(cx).transpose(0, 1),
                           torch.as_tensor(cu).transpose(0, 1)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=VJP_RTOL * np.abs(want).max())


def test_stagewise_gain_matches_tpu_gpad_and_the_exact_qp():
    """Active boxes and coupling rows: du*/dx0 from the stage-wise adjoint
    of each package, and central differences of the float64 QP."""
    qp, _, d_j, d_t = _pair(3, 8)
    x0 = np.random.default_rng(2).uniform(-0.35, 0.35, 3).astype(np.float32)
    K_j = np.asarray(jdiff.stagewise_feedback_gain(
        d_j, x0, config=JConfig(iterations=ITERS, restart=True)))
    before = tdiff.CG_ITERATIONS
    K_t = tdiff.stagewise_feedback_gain(
        d_t, x0, config=TConfig(iterations=ITERS, restart=True))
    used = tdiff.CG_ITERATIONS - before
    assert 0 < used <= 8 * d_t.n_u + 40  # the default cap, N n_u + 40
    assert K_t.shape == (3, 3)
    np.testing.assert_allclose(K_t.numpy(), K_j, atol=GAIN_TOL, rtol=0)
    np.testing.assert_allclose(K_t.numpy(), _fd_gain(qp, x0), atol=FD_TOL,
                               rtol=0)


def test_stagewise_gain_matches_condensed_sensitivity():
    """The same QP on both engines, both adjoints: one gain."""
    qp, L, _, d_t = _pair(3, 10)
    d_c = tg.dualize(qp, iterations=ITERS, paired="auto", L=L, device=CPU)
    X0 = np.random.default_rng(7).uniform(-0.3, 0.3, (3, 3)).astype(np.float32)
    cfg = TConfig(iterations=ITERS, restart=True)
    res_c = tg.solve_batch(d_c, X0, config=cfg)
    K_c, _ = tdiff.sensitivity(d_c, res_c.y)
    K_s = tdiff.stagewise_feedback_gain(d_t, X0, config=cfg)
    assert K_s.shape == (3, 3, 3)
    np.testing.assert_allclose(K_s.numpy(), K_c.numpy(), atol=GAIN_TOL,
                               rtol=0)


def test_stagewise_full_trajectory_vjp_matches_condensed():
    """full_trajectory VJPs of the stage-wise and the condensed solver on
    the twin problem, for a random linear functional of z*."""
    qp, L, _, d_t = _pair(3, 8)
    d_c = tg.dualize(qp, iterations=ITERS, paired="auto", L=L, device=CPU)
    cfg = TConfig(iterations=ITERS, restart=True)
    f_s = tdiff.make_differentiable_stagewise_solver(d_t, config=cfg,
                                                     full_trajectory=True)
    f_c = tdiff.make_differentiable_solver(d_c, config=cfg,
                                           full_trajectory=True)
    rng = np.random.default_rng(9)
    X0 = rng.uniform(-0.3, 0.3, (2, 3)).astype(np.float32)
    w = torch.as_tensor(rng.normal(size=qp.n_z).astype(np.float32))
    grads, vals = [], []
    for f in (f_s, f_c):
        x = torch.tensor(X0, requires_grad=True)
        loss = (f(x) @ w).sum()
        loss.backward()
        vals.append(float(loss.detach()))
        grads.append(x.grad.numpy())
    assert vals[0] == pytest.approx(vals[1], rel=1e-4)
    np.testing.assert_allclose(grads[0], grads[1], atol=GAIN_TOL, rtol=0)


def test_stagewise_interior_gain_is_lqr():
    """Interior x0 (boxes only, all released): the stage-wise gain is the
    unconstrained LQR feedback -(H^-1 F')[:n_u]."""
    prob = tp.double_integrator(horizon=8)
    qp = tg.condense(prob)
    data = tg.build_stagewise(prob, iterations=300, L=lipschitz_constant(qp),
                              device=CPU)
    x0 = np.array([0.01, -0.005], np.float32)
    K = tdiff.stagewise_feedback_gain(
        data, x0, config=TConfig(iterations=ITERS, restart=True))
    K_ref = -np.linalg.solve(qp.H, qp.F.T)[:qp.n_u]
    np.testing.assert_allclose(K.numpy(), K_ref, atol=LQR_TOL, rtol=0)
