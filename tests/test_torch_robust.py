"""Port parity for the robust stacks (after tests/test_robust.py and
tests/test_tube.py): ``tpu_gpad_torch.robust`` against ``tpu_gpad.robust``
on the same plants, ``Controller.from_qp`` against
``tpu_gpad.Controller.from_qp`` over warm steps, and the stage-wise twin's
plans against the condensed stack's."""

import dataclasses

import numpy as np
import pytest
import torch

import tpu_gpad
from tpu_gpad import problems as jp
from tpu_gpad import robust as jr
from tpu_gpad.solver import SolverConfig as JConfig

import tpu_gpad_torch
from tpu_gpad_torch import problems as tp
from tpu_gpad_torch import robust as tr
from tpu_gpad_torch.solver import SolverConfig
from tpu_gpad_torch.solver.qp import solve_qp_exact

torch.set_num_threads(2)

# Both packages assemble in float64 NumPy with the same operations.
ASM_TOL = 1e-12
# u* of two fp32 warm solves that differ in summation order, per step.
U_TOL = 1e-5
# The twin (equality rows) and the condensed stack (selector) reach the
# same optimum; both solves converged to 1e-6 in float32.
TWIN_TOL = 1e-4
TWIN_EPS = 1e-6
S = 3


def _variants(pkg, robust, horizon=6, **extra):
    """Battery n3 with three actuator realizations (B x 0.8, 1.0, 1.2)."""
    nominal = dataclasses.replace(pkg.problems.battery(3, horizon), **extra)
    return robust.scenario_problem_variants(
        nominal, B_list=[np.asarray(nominal.B) * s for s in (0.8, 1.0, 1.2)])


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _assert_same(a, b):
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None, k
            assert np.shape(x) == np.shape(y), k
            np.testing.assert_allclose(x, y, atol=ASM_TOL, rtol=0, err_msg=k)
        else:
            assert x == y, k


@pytest.mark.parametrize("kw", [dict(), dict(dedupe=False),
                                dict(weights=[0.5, 0.3, 0.2]),
                                dict(n_shared=6)],
                         ids=["default", "no_dedupe", "weights", "n_shared"])
def test_scenario_qp_matches_tpu_gpad(kw):
    qj = jr.scenario_qp([tpu_gpad.condense(p) for p in _variants(tpu_gpad, jr)], **kw)
    qt = tr.scenario_qp([tpu_gpad_torch.condense(p)
                         for p in _variants(tpu_gpad_torch, tr)], **kw)
    assert isinstance(qt, tpu_gpad_torch.CondensedQP)
    _assert_same(qt, qj)


@pytest.mark.parametrize("extra", [dict(), dict(Q_terminal=np.eye(3) * 2.0)],
                         ids=["plain", "terminal"])
def test_scenario_stagewise_problem_matches_tpu_gpad(extra):
    pj = jr.scenario_stagewise_problem(_variants(tpu_gpad, jr, **extra),
                                       weights=[0.2, 0.5, 0.3])
    pt = tr.scenario_stagewise_problem(_variants(tpu_gpad_torch, tr, **extra),
                                       weights=[0.2, 0.5, 0.3])
    assert isinstance(pt, tpu_gpad_torch.LinearMPCProblem)
    _assert_same(pt, pj)


def test_tube_and_lqr_gain_match_tpu_gpad():
    pj = jp.double_integrator(horizon=8)
    pt = tp.double_integrator(horizon=8)
    Kj, Kt = jr.lqr_gain(pj), tr.lqr_gain(pt)
    np.testing.assert_allclose(Kt, Kj, atol=ASM_TOL, rtol=0)
    w = np.array([0.01, 0.02])
    for K in (None, Kt):
        _assert_same(tr.tube_tightened_problem(pt, w, K=K),
                     jr.tube_tightened_problem(pj, w, K=K))


def test_reference_rejections_carry_over():
    pt = tp.double_integrator(horizon=40, x_limit=0.1)
    with pytest.raises(ValueError, match="tube outgrows"):
        tr.tube_tightened_problem(pt, np.array([0.05, 0.05]))
    rate = dataclasses.replace(pt, du_min=np.full(1, -0.1),
                               du_max=np.full(1, 0.1))
    with pytest.raises(ValueError, match="du_min/du_max/K_u"):
        tr.tube_tightened_problem(rate, np.zeros(2), K=tr.lqr_gain(pt))
    with pytest.raises(ValueError, match="at least one"):
        tr.scenario_qp([])
    with pytest.raises(ValueError, match="at least two"):
        tr.scenario_stagewise_problem(_variants(tpu_gpad_torch, tr)[:1])
    with pytest.raises(ValueError, match="A_list/B_list"):
        tr.scenario_problem_variants(pt)


def test_scenario_plans_take_tensors():
    z = np.random.default_rng(0).normal(size=(4, 3 + S * 15)).astype(np.float32)
    for s in range(S):
        want = jr.scenario_plan(z, s, 3, 6, S)
        np.testing.assert_array_equal(
            tr.scenario_plan(torch.as_tensor(z), s, 3, 6, S), want)
    zs = np.random.default_rng(1).normal(size=(4, 6 * S * 3))
    np.testing.assert_array_equal(
        tr.scenario_stagewise_plans(torch.as_tensor(zs), S, 3, 6),
        jr.scenario_stagewise_plans(zs, S, 3, 6))
    x0 = np.arange(3.0)
    np.testing.assert_array_equal(
        tr.scenario_stagewise_x0(torch.as_tensor(x0), S),
        jr.scenario_stagewise_x0(x0, S))


LAYOUTS = {
    # tracking setpoint + the previous move of a rate-limited plant
    "tracking_rate": dict(condense=dict(tracking=True),
                          serve=dict(tracking=True, rate=True),
                          extra=dict(du_min=np.full(3, -0.2),
                                     du_max=np.full(3, 0.2))),
    # a reference preview and a process disturbance need `problem`
    "preview_disturbance": dict(
        condense=dict(tracking="preview", process_disturbance=True),
        serve=dict(tracking="preview", process_disturbance=True),
        extra=dict()),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_from_qp_follows_tpu_gpad(layout):
    spec = LAYOUTS[layout]
    vj = _variants(tpu_gpad, jr, **spec["extra"])
    vt = _variants(tpu_gpad_torch, tr, **spec["extra"])
    qj = jr.scenario_qp([tpu_gpad.condense(p, **spec["condense"]) for p in vj])
    qt = tr.scenario_qp([tpu_gpad_torch.condense(p, **spec["condense"])
                         for p in vt])
    cfg = dict(iterations=100, restart=True)
    need = spec["serve"].get("process_disturbance", False)
    c_j = tpu_gpad.Controller.from_qp(
        qj, config=JConfig(**cfg), problem=vj[1] if need else None,
        **spec["serve"])
    c_t = tpu_gpad_torch.Controller.from_qp(
        qt, config=SolverConfig(**cfg), problem=vt[1] if need else None,
        device="cpu", **spec["serve"])
    A, Bm = np.asarray(vj[1].A), np.asarray(vj[1].B)
    x = np.random.default_rng(3).uniform(-0.4, 0.4, (4, 3)).astype(np.float32)
    if layout == "tracking_rate":
        kw = dict(x_ref=np.full(3, 0.1, np.float32))
    else:
        kw = dict(x_ref=np.full((6, 3), 0.1, np.float32),
                  d=np.full(3, 1e-3, np.float32))
    for _ in range(5):
        u_j = c_j.step(x, **kw)
        u_t = c_t.step(x, **kw)
        assert u_t.dtype == np.float32 and u_t.shape == (4, 3)
        np.testing.assert_allclose(u_t, u_j, atol=U_TOL, rtol=0)
        x = (x @ A.T + u_j @ Bm.T).astype(np.float32)
    assert c_t.data.device.type == "cpu"


def test_from_qp_errors_and_polish():
    vt = _variants(tpu_gpad_torch, tr, horizon=5)
    qt = tr.scenario_qp([tpu_gpad_torch.condense(p, tracking=True) for p in vt])
    with pytest.raises(ValueError, match="need `problem`"):
        tpu_gpad_torch.Controller.from_qp(qt, tracking="preview", device="cpu")
    with pytest.raises(ValueError, match="need `problem`"):
        tpu_gpad_torch.Controller.from_qp(qt, process_disturbance=True,
                                          device="cpu")
    c = tpu_gpad_torch.Controller.from_qp(
        qt, config=SolverConfig(iterations=400, restart=True, form="dual"),
        tracking=True, polish=True, device="cpu")
    u = c.step(np.zeros(3, np.float32), x_ref=np.full(3, 0.2, np.float32))
    p = np.concatenate([np.zeros(3), np.full(3, 0.2)])
    exact = solve_qp_exact(qt.H, qt.F.T @ p + qt.g, qt.G, qt.b0 + qt.E @ p)
    # tpu_gpad's own bound for a polished move against the exact QP
    np.testing.assert_allclose(u, exact.z[:3], atol=1e-6)


def test_stagewise_twin_plans_match_condensed_stack():
    vt = _variants(tpu_gpad_torch, tr)
    qt = tr.scenario_qp([tpu_gpad_torch.condense(p) for p in vt])
    data_c = tpu_gpad_torch.dualize(qt, iterations=2000, device="cpu")
    twin = tpu_gpad_torch.build_stagewise(
        tr.scenario_stagewise_problem(vt), iterations=2000, device="cpu")
    X = np.random.default_rng(4).uniform(-0.45, 0.45, (4, 3)).astype(np.float32)
    res_c = tpu_gpad_torch.solve_to_accuracy(data_c, X, tol=TWIN_EPS,
                                             max_iterations=2000)
    res_s = tpu_gpad_torch.solve_stagewise(
        twin, tr.scenario_stagewise_x0(X, S), mode="eps", eps_g=TWIN_EPS,
        eps_V=TWIN_EPS, iterations=2000, restart=True)
    assert bool(res_c.converged.all()) and bool(res_s.converged.all())
    plans = tr.scenario_stagewise_plans(res_s.z, S, 3, 6)
    for s in range(S):
        np.testing.assert_allclose(
            plans[:, s], tr.scenario_plan(res_c.z, s, 3, 6, S), atol=TWIN_TOL,
            rtol=0)
        # non-anticipativity: every scenario applies the shared first move
        np.testing.assert_allclose(plans[:, s, 0], res_c.u.numpy(),
                                   atol=TWIN_TOL, rtol=0)
