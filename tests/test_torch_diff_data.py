"""Port parity for the data-side gradients (after tests/test_diff_data.py):
``tpu_gpad_torch.diff.make_data_differentiable_solver`` against
``tpu_gpad.diff``'s on the same data and parameters, every data leaf's
cotangent (paired, dense, soft rows), central differences of the port's
own solve on a few leaves, the p-gradient against the p-only path, any
leading batch shape, and the weight-learning composition through
``dualize_ltv_device`` with tensor cost weights: ``Q.grad`` against
``jax.grad`` and against central differences."""

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

import tpu_gpad_torch as tg
from tpu_gpad_torch import diff as tdiff
from tpu_gpad_torch import problems as tp
from tpu_gpad_torch.problems.battery import default_x0
from tpu_gpad_torch.solver import SolverConfig as TConfig
from tpu_gpad_torch.solver import solve_batch as t_solve_batch

torch.set_num_threads(2)

CPU = "cpu"
# tests/test_diff_data.py's forward: 300 restart iterations in the mvp form
# (a lone leaf's perturbation keeps the fixed point consistent only there)
J_CFG = JConfig(iterations=300, restart=True, engine="xla", form="mvp")
T_CFG = TConfig(iterations=300, restart=True, engine="torch", form="mvp")
# Each package's own converged forward: cotangents are outer products of
# duals and trajectories up to ~10, so 1e-4 relative
LEAF_ATOL, LEAF_RTOL = 1e-5, 1e-4
# Central differences of the port's solve (tests/test_diff_data.py on CPU)
H, FD_ABS, FD_REL = 3e-5, 2e-3, 5e-3
# Q.grad through the repaired device condensation: against jax.grad,
# relative; against central differences, tests/test_diff_data.py's bound
Q_RTOL = 1e-4
Q_FD_ABS, Q_FD_REL, Q_H = 2e-3, 2e-2, 1e-3
LEAVES = ("MG_T", "GL_T", "gP_map", "gP_const", "pD_map", "pD_const",
          "soft_damp")


def _soft_ltv(pkg_dualize, as_arr):
    rng = np.random.default_rng(2)
    n, nu, N = 3, 2, 8
    A = np.stack([np.eye(n) + 0.03 * rng.standard_normal((n, n))
                  for _ in range(N)])
    B = np.stack([0.2 * rng.standard_normal((n, nu)) for _ in range(N)])
    return pkg_dualize(
        as_arr(A), as_arr(B), as_arr(np.zeros((N, n))), np.eye(n),
        0.5 * np.eye(nu), np.full(nu, -1.0), np.full(nu, 1.0),
        iterations=400, x_min=np.full(n, -0.25), x_max=np.full(n, 0.25),
        soft_state=8.0)


def _case(name):
    """(JAX data, port data, parameters)."""
    if name == "soft":
        dj = _soft_ltv(j_dualize_ltv, lambda a: jnp.asarray(a, jnp.float32))
        dt = _soft_ltv(tg.dualize_ltv_device,
                       lambda a: torch.as_tensor(a, dtype=torch.float32))
        P = np.array([[0.4, -0.3, 0.2, 0.0, 0.0, 0.0]])
        return dj, dt, P.astype(np.float32)
    if name == "paired":
        pj, pt = jp.battery(n_cells=3, horizon=8), tp.battery(n_cells=3,
                                                              horizon=8)
        P = np.stack([default_x0(3, seed=s) for s in (1, 2)])
    else:
        pj, pt = (dataclasses.replace(P.double_integrator(horizon=8),
                                      H_x=np.array([[1.0, 0.6]]),
                                      h_x=np.array([2.0])) for P in (jp, tp))
        P = np.array([[1.5, 0.8]])
    dj = tpu_gpad.dualize(tpu_gpad.condense(pj), iterations=400,
                          paired="auto")
    dt = tg.dualize(tg.condense(pt), iterations=400, paired="auto",
                    device=CPU)
    return dj, dt, P.astype(np.float32)


_GRADS = {}


def _grads(name):
    """Both packages' (data, p) gradients of 0.5 |u*|^2, once per module."""
    if name not in _GRADS:
        dj, dt, P = _case(name)
        fj = jdiff.make_data_differentiable_solver(J_CFG)
        gdj, gpj = jax.grad(lambda d, p: 0.5 * jnp.sum(fj(d, p) ** 2),
                            argnums=(0, 1))(dj, jnp.asarray(P))
        leaves = {f: getattr(dt, f).clone().requires_grad_(True)
                  for f in LEAVES if getattr(dt, f) is not None}
        d = dataclasses.replace(dt, **leaves)
        p = torch.as_tensor(P).requires_grad_(True)
        ft = tdiff.make_data_differentiable_solver(T_CFG)
        (0.5 * (ft(d, p) ** 2).sum()).backward()
        _GRADS[name] = dj, dt, P, gdj, gpj, leaves, p.grad
    return _GRADS[name]


@pytest.mark.parametrize("case", ["paired", "dense", "soft"])
def test_leaf_cotangents_match_tpu_gpad(case):
    dj, dt, P, gdj, gpj, leaves, gp = _grads(case)
    assert dt.paired == (case != "dense")
    assert (dt.soft_damp is not None) == (case == "soft")
    for f, leaf in leaves.items():
        ref = np.asarray(getattr(gdj, f))
        assert leaf.grad is not None and leaf.grad.shape == ref.shape, f
        np.testing.assert_allclose(leaf.grad.numpy(), ref, atol=LEAF_ATOL,
                                   rtol=LEAF_RTOL, err_msg=f)
        # not trivially 0 (the dense case's u* sits on its input bound, so
        # the cotangents of g_P's maps vanish in both packages)
        if f in (("MG_T", "GL_T", "gP_map", "pD_map") if case == "paired"
                 else ("GL_T", "pD_map")):
            assert float(leaf.grad.abs().max()) > 1e-3, f
    np.testing.assert_allclose(gp.numpy(), np.asarray(gpj), atol=LEAF_ATOL,
                               rtol=LEAF_RTOL)
    if case == "soft":
        assert float(leaves["soft_damp"].grad.abs().max()) > 0.0


FD_COORDS = {
    "paired": [("MG_T", (4, 7)), ("GL_T", (5, 9)), ("gP_map", (1, 3)),
               ("gP_const", (2,)), ("pD_map", (0, 0, 11)),
               ("pD_const", (1, 40))],
    "dense": [("MG_T", (3, 2)), ("GL_T", (4, 19)), ("pD_map", (1, 8)),
              ("pD_const", (8,))],
}


@pytest.mark.parametrize("case", list(FD_COORDS))
def test_leaf_cotangents_match_fd_of_the_port(case):
    """Central differences of the port's own solve, one leaf coordinate at
    a time (the mvp form: a lone perturbation stays a fixed point)."""
    _, dt, P, _, _, leaves, _ = _grads(case)

    def loss(d):
        return 0.5 * float((t_solve_batch(d, P, config=T_CFG).u ** 2).sum())

    for f, idx in FD_COORDS[case]:
        vals = []
        for sgn in (1.0, -1.0):
            pert = getattr(dt, f).clone()
            pert[idx] += sgn * H
            vals.append(loss(dataclasses.replace(dt, **{f: pert})))
        fd = (vals[0] - vals[1]) / (2 * H)
        got = float(leaves[f].grad[idx])
        assert got == pytest.approx(fd, abs=FD_ABS, rel=FD_REL), (f, idx, got,
                                                                  fd)


def test_p_grad_matches_p_only_path_and_any_batch_shape():
    dt = tg.dualize(tg.condense(tp.battery(n_cells=3, horizon=8)),
                    iterations=400, paired="auto", device=CPU)
    P = torch.as_tensor(np.stack([default_x0(3, seed=s) for s in (1, 4)]),
                        dtype=torch.float32)
    f2 = tdiff.make_data_differentiable_solver(T_CFG)
    f1 = tdiff.make_differentiable_solver(dt, T_CFG)
    g = []
    for f in (lambda p: f2(dt, p), f1):
        p = P.clone().requires_grad_(True)
        (0.5 * (f(p) ** 2).sum()).backward()
        g.append(p.grad)
    torch.testing.assert_close(g[0], g[1], rtol=1e-5, atol=1e-7)
    p1 = P[0].clone().requires_grad_(True)
    (0.5 * (f2(dt, p1) ** 2).sum()).backward()
    P4 = torch.stack([torch.stack([P[0], 0.9 * P[0]])] * 2).requires_grad_(True)
    (0.5 * (f2(dt, P4) ** 2).sum()).backward()
    assert p1.grad.shape == P[0].shape and P4.grad.shape == P4.shape
    torch.testing.assert_close(P4.grad[0, 0], p1.grad, rtol=1e-5, atol=1e-7)


# the double integrator of tests/test_diff_data.py::
# test_end_to_end_weight_learning_gradient; p = [x0; r], a zero reference
_WL_N, _WL_A = 6, np.array([[1.0, 0.1], [0.0, 0.95]])
_WL_B = np.array([[0.005], [0.1]])
_WL_P = np.array([[1.2, -0.4, 0.0, 0.0], [0.6, 0.3, 0.0, 0.0]], np.float32)


def _wl_loss_jax(q_diag):
    f = jdiff.make_data_differentiable_solver(JConfig(
        iterations=250, restart=True, engine="xla", form="mvp"))
    A = jnp.asarray(np.stack([_WL_A] * _WL_N), jnp.float32)
    B = jnp.asarray(np.stack([_WL_B] * _WL_N), jnp.float32)
    data = j_dualize_ltv(A, B, jnp.zeros((_WL_N, 2), jnp.float32),
                         jnp.diag(q_diag), 0.4 * np.eye(1), np.full(1, -0.5),
                         np.full(1, 0.5), iterations=300)
    return 0.5 * jnp.sum(f(data, jnp.asarray(_WL_P)) ** 2)


def _wl_loss_port(q_diag, lead=()):
    f = tdiff.make_data_differentiable_solver(TConfig(
        iterations=250, restart=True, form="mvp"))
    A = torch.as_tensor(np.stack([_WL_A] * _WL_N), dtype=torch.float32)
    B = torch.as_tensor(np.stack([_WL_B] * _WL_N), dtype=torch.float32)
    data = tg.dualize_ltv_device(A, B, torch.zeros((_WL_N, 2)),
                                 torch.diag(q_diag), 0.4 * np.eye(1),
                                 np.full(1, -0.5), np.full(1, 0.5),
                                 iterations=300)
    P = torch.as_tensor(_WL_P).expand(*lead, *_WL_P.shape)
    return 0.5 * (f(data, P) ** 2).sum()


def test_weight_learning_gradient_reaches_q_through_device_condensation():
    """The flagship composition: backward through the solve and the
    repaired dualize_ltv_device reaches the stage-cost weights."""
    q0 = np.array([1.0, 0.6], np.float32)
    g_j = np.asarray(jax.grad(_wl_loss_jax)(jnp.asarray(q0)))
    q = torch.tensor(q0, requires_grad=True)
    _wl_loss_port(q).backward()
    g = q.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 1e-3
    np.testing.assert_allclose(g, g_j, rtol=Q_RTOL, atol=0)
    for j in range(2):
        e = np.zeros(2, np.float32)
        e[j] = Q_H
        with torch.no_grad():
            fd = (float(_wl_loss_port(torch.as_tensor(q0 + e)))
                  - float(_wl_loss_port(torch.as_tensor(q0 - e)))) / (2 * Q_H)
        assert float(g[j]) == pytest.approx(fd, abs=Q_FD_ABS, rel=Q_FD_REL), (
            j, float(g[j]), fd)
    # a leading batch shape of the parameter: the same gradient, twice
    q2 = torch.tensor(q0, requires_grad=True)
    _wl_loss_port(q2, lead=(2,)).backward()
    np.testing.assert_allclose(q2.grad.numpy(), 2 * g, rtol=1e-5, atol=0)
