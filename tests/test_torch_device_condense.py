"""Port parity for device-side condensation (after
tests/test_device_condense.py and tests/test_device_scenario.py):
``tpu_gpad_torch.device_condense`` against ``tpu_gpad.device_condense`` on
the same seeded LTV stacks, every ``GPADData`` leaf of every variant (no
state box, rate, K_u, polytopes, soft, preview, per-stage boxes, the
scenario stack), against the port's own float64 host pipeline at the JAX
tests' tolerances, batched against one at a time, and the errors."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gpad import device_condense as jd

import tpu_gpad_torch as tg
from tpu_gpad_torch import device_condense as td
from tpu_gpad_torch import problems as tp
from tpu_gpad_torch.condense import prediction_matrices_ltv
from tpu_gpad_torch.robust import scenario_qp
from tpu_gpad_torch.solver import SolverConfig, solve_batch, solve_multi
from tpu_gpad_torch.types import LinearMPCProblem

torch.set_num_threads(2)

# float32 operands of the two packages: the same algebra, sums in another
# order (the port's prediction recursion runs forward, JAX's backward)
OP_TOL = 1e-4
# L: the same power method from the same start vector, relative
L_RTOL = 1e-4
# the port against its own float64 host pipeline: the JAX tests' bounds
# (tests/test_device_condense.py:70-96)
HOST_OP_TOL, HOST_D_TOL, HOST_PD_TOL = 2e-4, 2e-3, 1e-4
# converged eps solves of device and host data (tests/test_device_condense.py)
SOLVE_TOL = 2e-3
CPU = "cpu"

BOUNDS = dict(
    x_min=np.full(3, -2.0), x_max=np.full(3, 2.0),
    u_min=np.full(2, -1.0), u_max=np.full(2, 1.0),
)


def _ltv(N=6, n_x=3, n_u=2, seed=0):
    rng = np.random.default_rng(seed)
    A = np.stack([
        np.eye(n_x) + 0.08 * rng.standard_normal((n_x, n_x)) for _ in range(N)
    ])
    B = 0.4 * rng.standard_normal((N, n_x, n_u))
    c = 0.02 * rng.standard_normal((N, n_x))
    return A, B, c


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a, np.float32)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(np.asarray(a, np.float32)) for a in arrays]


def _assert_leaves(dev, ref):
    """Every leaf of the port's GPADData against tpu_gpad's: operands at
    OP_TOL, L at L_RTOL, the inert rows' -PAD_BIG/L (which scale with L) at
    L_RTOL, the schedule and the metadata exactly."""
    for f in ("n_u", "n_x", "horizon", "paired", "n_struct"):
        assert getattr(dev, f) == getattr(ref, f), f
    np.testing.assert_allclose(float(dev.L), float(ref.L), rtol=L_RTOL)
    for f in ("theta", "beta"):
        np.testing.assert_array_equal(getattr(dev, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    for f in ("MG_T", "GL_T", "gP_map", "gP_const", "pD_map", "pD_const",
              "D", "soft_damp"):
        a, b = getattr(dev, f), getattr(ref, f)
        if b is None:
            assert a is None, f
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, f
        big = np.abs(b) > 1e15
        np.testing.assert_allclose(a[~big], b[~big], atol=OP_TOL, rtol=0,
                                   err_msg=f)
        np.testing.assert_allclose(a[big], b[big], rtol=L_RTOL, err_msg=f)


def test_prediction_matrices_match_tpu_gpad_and_host():
    A, B, _ = _ltv()
    T, S = td.prediction_matrices_device(*_t(A, B))
    T_j, S_j = jd.prediction_matrices_device(*_j(A, B))
    np.testing.assert_allclose(T.numpy(), np.asarray(T_j), atol=OP_TOL, rtol=0)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_j), atol=OP_TOL, rtol=0)
    T_h, S_h = prediction_matrices_ltv(A, B)
    np.testing.assert_allclose(T.numpy(), T_h, atol=1e-5, rtol=0)
    np.testing.assert_allclose(S.numpy(), S_h, atol=1e-5, rtol=0)


def _battery_ltv():
    prob = tp.battery(3, 5)
    N = prob.horizon
    return (np.repeat(prob.A[None], N, axis=0), np.repeat(prob.B[None], N, 0),
            np.zeros((N, prob.n_x)), prob)


# variant -> (seed, keyword arguments beyond A, B, c, Q, R, u boxes)
POLY = dict(H_x=np.array([[1.0, 1.0, 0.0]]), h_x=np.array([0.08]),
            H_u=np.array([[1.0, -1.0]]), h_u=np.array([0.6]))
VARIANTS = {
    "state_box": (0, dict(x_min=BOUNDS["x_min"], x_max=BOUNDS["x_max"])),
    "no_state_box": (7, {}),
    "rate": (13, dict(x_min=BOUNDS["x_min"], x_max=BOUNDS["x_max"],
                      du_min=np.full(2, -0.3), du_max=np.full(2, 0.3))),
    "polytopes": (13, dict(x_min=BOUNDS["x_min"], x_max=BOUNDS["x_max"],
                           **POLY)),
    "soft": (11, dict(x_min=np.full(3, -0.15), x_max=np.full(3, 0.15),
                      soft_state=50.0)),
    "preview": (3, dict(x_min=BOUNDS["x_min"], x_max=BOUNDS["x_max"],
                        preview=True)),
    "per_stage_boxes_terminal": (5, dict(
        x_min=-np.linspace(2.0, 1.5, 6)[:, None] * np.ones(3),
        x_max=np.linspace(2.0, 1.5, 6)[:, None] * np.ones(3),
        Q_terminal=3.0 * np.eye(3))),
}


@pytest.mark.parametrize("variant", list(VARIANTS) + ["K_u"])
def test_dualize_ltv_device_leaves_match_tpu_gpad(variant):
    if variant == "K_u":
        A, B, c, prob = _battery_ltv()
        Q, R = prob.Q, prob.R
        kw = dict(x_min=prob.x_min, x_max=prob.x_max, K_u=prob.K_u)
        u_min, u_max = prob.u_min, prob.u_max
    else:
        seed, kw = VARIANTS[variant]
        A, B, c = _ltv(seed=seed)
        Q, R = np.eye(3), 0.5 * np.eye(2)
        u_min, u_max = BOUNDS["u_min"], BOUNDS["u_max"]
    dev = td.dualize_ltv_device(*_t(A, B, c), Q, R, u_min, u_max,
                                iterations=100, **kw)
    ref = jd.dualize_ltv_device(*_j(A, B, c), Q, R, u_min, u_max,
                                iterations=100, **kw)
    _assert_leaves(dev, ref)
    assert dev.device.type == "cpu" and dev.D.dtype == torch.float32
    if variant == "polytopes":
        assert dev.n_struct == 18 + 6 + 6  # polytope rows are structure


def _host_data(A, B, c, Q, R, bounds, iterations, preview=False):
    problem = LinearMPCProblem(A=A, B=B, Q=Q, R=R, horizon=A.shape[0], c=c,
                               **bounds)
    qp = tg.condense(problem, tracking="preview" if preview else True)
    return tg.dualize(qp, iterations=iterations, paired=True, device=CPU)


def test_gpaddata_matches_the_ports_host_pipeline():
    A, B, c = _ltv()
    Q, R = np.eye(3), 0.5 * np.eye(2)
    host = _host_data(A, B, c, Q, R, BOUNDS, iterations=100)
    dev = td.dualize_ltv_device(*_t(A, B, c), Q, R, BOUNDS["u_min"],
                                BOUNDS["u_max"], iterations=100,
                                x_min=BOUNDS["x_min"], x_max=BOUNDS["x_max"])
    assert dev.paired and dev.n_struct == host.n_struct == 18
    assert dev.m_half == host.m_half
    for f in ("MG_T", "gP_map", "gP_const"):
        np.testing.assert_allclose(getattr(dev, f).numpy(),
                                   getattr(host, f).numpy(),
                                   atol=HOST_OP_TOL, rtol=0, err_msg=f)
    L_h, L_d = float(host.L), float(dev.L)
    assert 0.999 * L_h <= L_d <= 1.10 * L_h
    np.testing.assert_allclose(dev.D.numpy() * L_d, host.D.numpy() * L_h,
                               atol=HOST_D_TOL, rtol=0)
    for f in ("pD_const", "pD_map"):
        np.testing.assert_allclose(getattr(dev, f).numpy() * L_d,
                                   getattr(host, f).numpy() * L_h,
                                   atol=HOST_PD_TOL, rtol=0, err_msg=f)


EPS = SolverConfig(mode="eps", eps_g=1e-6, eps_V=1e-6, iterations=2000,
                   restart=True)


@pytest.mark.parametrize("case", ["tracking", "preview", "rate", "K_u"])
def test_solutions_match_the_ports_host_pipeline(case):
    """Converged eps solves of device and float64 host data agree."""
    rng = np.random.default_rng(5)
    Q, R = np.eye(3), 0.5 * np.eye(2)
    bounds, extra = dict(BOUNDS), {}
    if case == "K_u":
        A, B, c, prob = _battery_ltv()
        Q, R = prob.Q, prob.R
        bounds = dict(x_min=prob.x_min, x_max=prob.x_max, u_min=prob.u_min,
                      u_max=prob.u_max, K_u=prob.K_u)
        p = np.r_[0.3, -0.25, 0.05, np.zeros(3)]
    else:
        A, B, c = _ltv(seed={"tracking": 3, "preview": 3, "rate": 13}[case])
        x0 = rng.uniform(-0.4, 0.4, size=3)
        r = rng.uniform(-0.3, 0.3, size=18 if case == "preview" else 3)
        p = np.r_[x0, r]
        if case == "rate":
            bounds.update(du_min=np.full(2, -0.3), du_max=np.full(2, 0.3))
            u_prev = rng.uniform(-0.5, 0.5, size=2)
            p = np.r_[p, u_prev]
        extra = dict(preview=case == "preview")
    host = _host_data(A, B, c, Q, R, bounds, 2000, **extra)
    kw = {k: v for k, v in bounds.items() if k not in ("u_min", "u_max")}
    dev = td.dualize_ltv_device(*_t(A, B, c), Q, R, bounds["u_min"],
                                bounds["u_max"], iterations=2000, **kw, **extra)
    assert dev.m_half == host.m_half and dev.n_x == host.n_x
    p = torch.as_tensor(p, dtype=torch.float32)[None]
    r_h, r_d = solve_batch(host, p, config=EPS), solve_batch(dev, p, config=EPS)
    assert bool(r_h.converged.all()) and bool(r_d.converged.all())
    np.testing.assert_allclose(r_d.u.numpy(), r_h.u.numpy(), atol=SOLVE_TOL)
    if case == "rate":  # the slew limit binds on the first move
        assert (np.abs(r_d.u[0].numpy() - u_prev) <= 0.3 + 1e-4).all()
    if case == "K_u":  # sum(u) = 0 at every stage
        z = r_d.z[0].numpy().reshape(5, 3)
        np.testing.assert_allclose(z.sum(axis=1), 0.0, atol=1e-4)


def test_batched_dualize_matches_one_at_a_time_and_solves_through_multi():
    """Leading batch dimensions (the NMPC batch): each item's data as if
    condensed alone, the schedule carried per item, and solve_multi on the
    batch as solve_batch per item."""
    Q, R = np.eye(3), 0.5 * np.eye(2)
    kw = dict(x_min=BOUNDS["x_min"], x_max=BOUNDS["x_max"])
    stacks = [_ltv(seed=20 + s) for s in range(3)]
    A, B, c = (np.stack(t) for t in zip(*stacks))
    k = td.ltv_constants(6, 3, 2, Q, R, BOUNDS["u_min"], BOUNDS["u_max"], 150,
                         device=CPU, **kw)
    batch = td.dualize_ltv(k, *_t(A, B, c))
    assert batch.L.shape == (3,) and batch.theta.shape == (3, 150)
    P = torch.as_tensor(np.stack([np.r_[np.full(3, 0.1 * (s + 1)), np.zeros(3)]
                                  for s in range(3)]), dtype=torch.float32)
    cfg = SolverConfig(iterations=150)
    res = solve_multi(batch, P[:, None], config=cfg)
    for s in range(3):
        one = td.dualize_ltv(k, *_t(A[s], B[s], c[s]))
        for f in ("MG_T", "GL_T", "D", "pD_map", "pD_const", "gP_map", "L"):
            np.testing.assert_allclose(getattr(batch, f)[s].numpy(),
                                       getattr(one, f).numpy(), atol=1e-6,
                                       rtol=1e-6, err_msg=f)
        u_one = solve_batch(one, P[s:s + 1], config=cfg).u
        np.testing.assert_allclose(res.u[s].numpy(), u_one.numpy(), atol=1e-5)


def _orthogonal_top_mode():
    n = 16
    v_top = np.ones(n)
    v_top[: n // 2] = -1.0
    v_top /= np.linalg.norm(v_top)
    rng = np.random.default_rng(2)
    Qm, _ = np.linalg.qr(rng.standard_normal((n, n)))
    rest_q, _ = np.linalg.qr(Qm - Qm @ v_top[:, None] @ v_top[None, :])
    vecs = np.concatenate([v_top[:, None], rest_q[:, : n - 1]], axis=1)
    vals = np.concatenate([[1.0], 0.9 * rng.uniform(0.1, 1.0, n - 1)])
    return (vecs * vals) @ vecs.T


def _small_gap():
    n = 32
    rng = np.random.default_rng(5)
    Qm, _ = np.linalg.qr(rng.standard_normal((n, n)))
    vals = np.concatenate([[1.0, 0.999], rng.uniform(0.1, 0.9, n - 2)])
    return (Qm * vals) @ Qm.T


@pytest.mark.parametrize("case", ["top_mode_orthogonal_to_ones",
                                  "small_gap_two_iterations"])
def test_power_lmax_matches_tpu_gpad(case):
    """The fixed start vector finds a dominant mode orthogonal to the ones
    vector; too few iterations on a small eigengap leave a residual that
    sends dualize to the certified bound. Both as tpu_gpad's."""
    M, iters = ((_orthogonal_top_mode(), 96) if case.startswith("top")
                else (_small_gap(), 2))
    v0 = torch.as_tensor(td.power_start(M.shape[0]))
    lam, resid = td._power_lmax(torch.as_tensor(M, dtype=torch.float32), v0,
                                iters)
    lam_j, resid_j = jd._power_lmax(jnp.asarray(M, jnp.float32), iters)
    np.testing.assert_allclose(float(lam), float(lam_j), rtol=L_RTOL)
    np.testing.assert_allclose(float(resid), float(resid_j), rtol=1e-2,
                               atol=1e-6)
    if iters == 96:
        assert float(lam) > 0.97 and float(resid) < 0.02
    else:
        assert float(resid) > 0.02


def _gain_scenarios(pkg, horizon=6, scales=(0.7, 1.0, 1.3)):
    nominal = pkg.problems.double_integrator(
        horizon=horizon, x_limit=8.0, u_limit=1.0, qu_weight=0.05)
    return nominal, pkg.robust.scenario_problem_variants(
        nominal, B_list=[nominal.B * s for s in scales])


def _scenario_stacks(variants, horizon):
    A = np.stack([np.tile(p.A, (horizon, 1, 1)) for p in variants])
    B = np.stack([np.tile(p.B, (horizon, 1, 1)) for p in variants])
    return A, B, np.zeros((len(variants), horizon, variants[0].n_x))


@pytest.mark.parametrize("case", ["uniform", "weighted", "per_stage_boxes",
                                  "soft_weighted", "preview"])
def test_dualize_scenario_device_leaves_match_tpu_gpad(case):
    horizon = 6
    nominal, variants = _gain_scenarios(tg, horizon)
    A, B, c = _scenario_stacks(variants, horizon)
    kw = dict(x_min=nominal.x_min, x_max=nominal.x_max)
    u_min, u_max = nominal.u_min, nominal.u_max
    if case == "weighted":
        kw["weights"] = (0.5, 0.2, 0.3)
    elif case == "per_stage_boxes":
        shrink = 1.0 - 0.04 * np.arange(horizon)[:, None]
        kw["x_max"] = np.tile(np.asarray(nominal.x_max)[None], (horizon, 1)) * shrink
        kw["x_min"] = -kw["x_max"]
        u_max = np.tile(np.asarray(nominal.u_max)[None], (horizon, 1)) * shrink
        u_min = -u_max
    elif case == "soft_weighted":
        rng = np.random.default_rng(3)
        c = 0.03 * rng.standard_normal(c.shape)
        kw.update(weights=(0.25, 0.5, 0.25), soft_state=40.0,
                  x_min=np.full(2, -0.2), x_max=np.full(2, 0.2))
    elif case == "preview":
        kw["preview"] = True
    dev = td.dualize_scenario_device(*_t(A, B, c), nominal.Q, nominal.R,
                                     u_min, u_max, iterations=200, **kw)
    ref = jd.dualize_scenario_device(*_j(A, B, c), nominal.Q, nominal.R,
                                     u_min, u_max, iterations=200, **kw)
    _assert_leaves(dev, ref)
    S = len(variants)
    assert dev.m_half == dev.n_struct + nominal.n_u * (1 + S * (horizon - 1))
    if case == "soft_weighted":  # each scenario's damping scales with 1/w_s
        damp, blk = dev.soft_damp.numpy(), horizon * 2
        np.testing.assert_allclose(damp[:blk] * 0.25, damp[blk:2 * blk] * 0.5,
                                   rtol=1e-5)


@pytest.mark.parametrize("weights", [None, (0.5, 0.2, 0.3)])
def test_scenario_device_solves_match_the_ports_host_stack(weights):
    """The device stack against the port's scenario_qp -> dualize, solved
    to the same restart budget (tests/test_device_scenario.py's bounds)."""
    horizon, iters = 6, 600
    nominal, variants = _gain_scenarios(tg, horizon)
    A, B, c = _scenario_stacks(variants, horizon)
    dev = td.dualize_scenario_device(
        *_t(A, B, c), nominal.Q, nominal.R, nominal.u_min, nominal.u_max,
        iterations=iters, weights=weights, x_min=nominal.x_min,
        x_max=nominal.x_max)
    host = tg.dualize(scenario_qp([tg.condense(p, tracking=True)
                                   for p in variants], weights=weights),
                      iterations=iters, paired="auto", device=CPU)
    p = torch.tensor([[1.5, -0.4, 4.0, 0.0]])
    cfg = SolverConfig(iterations=iters, restart=True)
    r_d, r_h = solve_batch(dev, p, config=cfg), solve_batch(host, p, config=cfg)
    np.testing.assert_allclose(r_d.u.numpy(), r_h.u.numpy(), atol=2e-4)
    np.testing.assert_allclose(r_d.z.numpy(), r_h.z.numpy(), atol=5e-4)


def test_single_scenario_degenerates_to_ltv():
    horizon = 6
    nominal, variants = _gain_scenarios(tg, horizon)
    A, B, c = _scenario_stacks(variants[:1], horizon)
    kw = dict(iterations=400, x_min=nominal.x_min, x_max=nominal.x_max)
    args = (nominal.Q, nominal.R, nominal.u_min, nominal.u_max)
    d_s = td.dualize_scenario_device(*_t(A, B, c), *args, **kw)
    d_l = td.dualize_ltv_device(*_t(A[0], B[0], c[0]), *args, **kw)
    cfg = SolverConfig(iterations=400, restart=True)
    p = torch.tensor([[1.0, -0.2, 3.0, 0.0]])
    np.testing.assert_allclose(solve_batch(d_s, p, config=cfg).z.numpy(),
                               solve_batch(d_l, p, config=cfg).z.numpy(),
                               atol=2e-5)


def test_validation_messages_match_tpu_gpad():
    A, B, c = _t(*_ltv())
    box = dict(u_min=np.full(2, -1.0), u_max=np.full(2, 1.0))
    cases = [
        (dict(u_min=None, u_max=None), "input boxes"),
        (dict(**box, x_min=np.full(3, -1.0)), "both x_min and x_max"),
        (dict(**box, du_min=np.full(2, -0.1)), "both du_min and du_max"),
        (dict(**box, du_min=np.full(3, -0.1), du_max=np.full(3, 0.1)),
         r"du bounds must be \(2,\)"),
        (dict(**box, soft_state=10.0), "no state box"),
        (dict(**box, x_min=-np.ones(3), x_max=np.ones(3), soft_state=-1.0),
         "must be positive"),
        (dict(**box, H_x=np.ones((1, 3))), "H_x and h_x"),
        (dict(**box, H_u=np.ones((1, 3)), h_u=np.ones(1)), "H_u must be"),
        (dict(**box, K_u=np.ones((1, 3))), "K_u must be"),
        (dict(u_min=np.full(3, -1.0), u_max=np.full(2, 1.0)), "u_min must be"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            td.dualize_ltv_device(A, B, c, np.eye(3), np.eye(2),
                                  iterations=50, **kw)
    for bad_q in (np.array([1.0, 2.0, 3.0]), 2.0, np.ones((1, 3))):
        with pytest.raises(ValueError, match="Q must be"):
            td.dualize_ltv_device(A, B, c, bad_q, np.eye(2), iterations=50,
                                  **box)
    with pytest.raises(ValueError, match="R must be"):
        td.dualize_ltv_device(A, B, c, np.eye(3), np.array([0.5, 0.5]),
                              iterations=50, **box)
    with pytest.raises(ValueError, match="weights must be"):
        td.dualize_scenario_device(A[None], B[None], c[None], np.eye(3),
                                   np.eye(2), iterations=50, weights=(1.0, 2.0),
                                   **box)


# Q.grad through the condensation: the same float32 algebra in both
# packages, the power method's L included, relative to the gradient's scale
WEIGHT_GRAD_RTOL = 1e-4


def test_tensor_weights_keep_the_graph_and_match_tpu_gpad():
    """Cost weights as tensors that require grad (a learned Q, per-stage R
    and a terminal weight) give exactly the NumPy weights' operands, and
    the gradient of a weighted sum of every operand reaches them equal to
    jax.grad through tpu_gpad's dualize_ltv_device (the composition
    diff.make_data_differentiable_solver exists for)."""
    A, B, c = _ltv()
    rng = np.random.default_rng(11)
    Q0 = np.diag([1.0, 0.6, 0.8]).astype(np.float32)
    R0 = np.stack([0.5 * np.eye(2) + 0.05 * k * np.eye(2)
                   for k in range(6)]).astype(np.float32)
    Qf0 = 3.0 * np.eye(3, dtype=np.float32)
    kw = dict(x_min=BOUNDS["x_min"], x_max=BOUNDS["x_max"], iterations=100)
    u_box = (BOUNDS["u_min"], BOUNDS["u_max"])
    fields = ("MG_T", "GL_T", "gP_map", "gP_const", "pD_map", "pD_const", "D",
              "L")
    ref = td.dualize_ltv_device(*_t(A, B, c), Q0, R0, *u_box, Q_terminal=Qf0,
                                **kw)
    W = {f: rng.standard_normal(np.shape(getattr(ref, f))).astype(np.float32)
         for f in fields}
    Q, R, Qf = (torch.tensor(a, requires_grad=True) for a in (Q0, R0, Qf0))
    dev = td.dualize_ltv_device(*_t(A, B, c), Q, R, *u_box, Q_terminal=Qf,
                                **kw)
    for f in fields:
        torch.testing.assert_close(getattr(dev, f).detach(), getattr(ref, f),
                                   atol=0, rtol=0)
    loss = sum((getattr(dev, f) * torch.as_tensor(W[f])).sum() for f in fields)
    loss.backward()

    def jax_loss(q, r, qf):
        d = jd.dualize_ltv_device(*_j(A, B, c), q, r, *u_box, Q_terminal=qf,
                                  **kw)
        return sum(jnp.sum(getattr(d, f) * W[f]) for f in fields)

    import jax

    grads = jax.grad(jax_loss, argnums=(0, 1, 2))(*_j(Q0, R0, Qf0))
    for got, want in zip((Q.grad, R.grad, Qf.grad), grads):
        want = np.asarray(want)
        assert np.abs(want).max() > 1e-3
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=WEIGHT_GRAD_RTOL * np.abs(want).max())
