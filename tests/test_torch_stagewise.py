"""Port parity for the stage-wise O(N) engine: ``build_stagewise`` bit for
bit, the routing rules, the torch engine against
``tpu_gpad.solve_stagewise(engine="xla", scan="sequential")`` on the same
data and scenarios (its parallel-prefix sweeps against ``scan=
"associative"``), ``auto_solver``, ``StagewiseController``, the
condensation wall's redirect and ``cli solve --engine stagewise`` (after
tests/test_stagewise.py)."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gpad import problems as jp
from tpu_gpad import stagewise as js
from tpu_gpad.cli import main as jax_main

import tpu_gpad_torch
from tpu_gpad_torch import problems as tp
from tpu_gpad_torch import stagewise as ts
from tpu_gpad_torch.convert import stagewise_data_from_numpy
from tpu_gpad_torch.solver import SolverConfig

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
ITERS = 60
FIXED_TOL = 2e-6  # |u|, |z|: fp32 sums in another order, fixed budget
Y_TOL = 1e-5  # |y|: the duals are up to ~10, so a few ulps more
# A restart decision taken where r is near 0 may differ and part the
# trajectories for a while: tpu_gpad's pallas-vs-xla restart bound.
RESTART_TOL = 5e-5
EPS_U_TOL = 2e-4  # eps runs may stop one window apart


def _problem(P, case):
    if case == "battery":
        return P.battery(3, 8)
    if case == "random_ltv":
        return P.random_ltv(n_x=3, n_u=2, horizon=6, seed=3)
    return dataclasses.replace(P.double_integrator(horizon=8),
                               c=np.array([0.01, -0.02]))


def _build_kw(case):
    return {"x_ref": np.array([0.25, 0.0])} if case == "di_affine_ref" else {}


CASES = ["battery", "random_ltv", "di_affine_ref"]


def _pair(case, iterations=ITERS):
    kw = _build_kw(case)
    d_j = js.build_stagewise(_problem(jp, case), iterations=iterations, **kw)
    d_t = ts.build_stagewise(_problem(tp, case), iterations=iterations,
                             device="cpu", **kw)
    return d_j, d_t


def _x0(B, n, seed):
    return np.random.default_rng(seed).uniform(-0.3, 0.3, (B, n)).astype(np.float32)


def _close(a, b, tol, name):
    np.testing.assert_allclose(np.asarray(a), b.numpy() if torch.is_tensor(b)
                               else b, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_build_stagewise_bit_exact(case):
    d_j, d_t = _pair(case)
    for name in ts.STAGEWISE_TENSOR_FIELDS:
        a, b = np.asarray(getattr(d_j, name)), getattr(d_t, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    for name in ts.STAGEWISE_META_FIELDS + ("m_x", "m_u", "m", "max_iters"):
        assert getattr(d_j, name) == getattr(d_t, name), name
    assert d_t.device.type == "cpu"


def test_stagewise_data_from_numpy_round_trips():
    d_j, d_t = _pair("di_affine_ref")
    fields = {f: np.asarray(getattr(d_j, f)) for f in ts.STAGEWISE_TENSOR_FIELDS}
    meta = {f: getattr(d_j, f) for f in ts.STAGEWISE_META_FIELDS}
    d_c = stagewise_data_from_numpy(fields, meta, "cpu")
    for name in ts.STAGEWISE_TENSOR_FIELDS:
        assert torch.equal(getattr(d_c, name), getattr(d_t, name)), name
    with pytest.raises(ValueError, match="missing StagewiseData fields"):
        stagewise_data_from_numpy({}, meta, "cpu")


def test_routing_rules_match():
    grid = [(n, N, b) for n in (3, 8, 30) for N in (10, 60, 170, 400)
            for b in (None, 64, 1440, 4096)]
    for n, N, b in grid:
        p_j, p_t = jp.battery(n, N), tp.battery(n, N)
        assert js.condensed_operand_mb(p_j) == ts.condensed_operand_mb(p_t)
        assert js.stagewise_compatible(p_j) == ts.stagewise_compatible(p_t)
        for mb in (None, 1.0):
            assert (js.stagewise_preferred(p_j, batch_hint=b, threshold_mb=mb)[0]
                    == ts.stagewise_preferred(p_t, batch_hint=b,
                                              threshold_mb=mb)[0]), (n, N, b, mb)
    for P, mod in ((jp, js), (tp, ts)):
        rate = dataclasses.replace(P.battery(3, 8), du_max=np.full(3, 0.1))
        assert mod.stagewise_compatible(rate) == (
            False, "rate limits couple adjacent stages")
    assert ts.stagewise_preferred(tp.battery(8, 60), batch_hint=4096)[0]
    assert ts.stagewise_preferred(tp.battery(30, 200))[0]


def _solve_pair(d_j, d_t, X0, **kw):
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    r_j = js.solve_stagewise(d_j, jnp.asarray(X0), engine="xla",
                             scan="sequential", **jkw)
    r_t = ts.solve_stagewise(d_t, X0, engine="torch", **kw)
    return r_j, r_t


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("variant", ["fixed", "restart", "warm", "runtime"])
def test_torch_engine_matches_xla(case, variant):
    d_j, d_t = _pair(case)
    X0 = _x0(5, d_t.n_x, seed=7)
    kw = {"iterations": ITERS}
    if variant == "restart":
        kw["restart"] = True
    elif variant == "warm":
        y0 = np.asarray(js.solve_stagewise(d_j, jnp.asarray(X0 * 0.8),
                                           iterations=40, engine="xla",
                                           scan="sequential").y)
        kw["y0"] = y0
    elif variant == "runtime":
        rng = np.random.default_rng(3)
        N, n = d_t.horizon, d_t.n_x
        kw["q_lin"] = rng.normal(0, 0.1, (5, N, n)).astype(np.float32)
        kw["c"] = rng.normal(0, 0.01, (N, n)).astype(np.float32)
    r_j, r_t = _solve_pair(d_j, d_t, X0, **kw)
    tol = RESTART_TOL if variant == "restart" else FIXED_TOL
    _close(r_j.u, r_t.u, tol, "u")
    _close(r_j.z, r_t.z, tol, "z")
    if variant != "restart":
        _close(r_j.y, r_t.y, Y_TOL, "y")
        _close(r_j.residual, r_t.residual, FIXED_TOL, "residual")
    assert r_t.u.shape == (5, d_t.n_u) and r_t.y.shape == (5, d_t.horizon,
                                                           d_t.m_x + d_t.m_u)
    assert r_t.iterations.dtype == torch.int32 and bool(r_t.converged.all())


@pytest.mark.parametrize("restart", [False, True], ids=["plain", "restart"])
def test_eps_mode_matches_xla(restart):
    d_j, d_t = _pair("battery", iterations=400)
    X0 = _x0(6, 3, seed=11)
    kw = dict(iterations=400, mode="eps", eps_g=1e-4, eps_V=1e-4,
              check_every=20, restart=restart)
    r_j, r_t = _solve_pair(d_j, d_t, X0, **kw)
    it_j, it_t = np.asarray(r_j.iterations), r_t.iterations.numpy()
    assert np.abs(it_j - it_t).max() <= 20  # within one window
    assert np.array_equal(np.asarray(r_j.converged), r_t.converged.numpy())
    _close(r_j.u, r_t.u, EPS_U_TOL, "u")
    assert bool(r_t.converged.all()) and float(r_t.residual.max()) <= 1e-4 + 1e-6


def test_config_and_argument_checks():
    d_t = ts.build_stagewise(tp.battery(3, 6), iterations=20, device="cpu")
    X0 = _x0(2, 3, seed=1)
    # scan="associative" runs the torch engine's parallel-prefix sweeps
    # (test_associative_scan_matches_xla); a forced kernel refuses it
    res = ts.solve_stagewise(d_t, X0, iterations=10, scan="associative")
    assert res.u.shape == (2, 3) and bool(torch.isfinite(res.z).all())
    for engine in ("cuda", "stream"):
        with pytest.raises(ValueError, match="imply sequential scan"):
            ts.solve_stagewise(d_t, X0, engine=engine, scan="associative")
    with pytest.raises(ValueError, match="engine must be"):
        ts.solve_stagewise(d_t, X0, engine="pallas")
    with pytest.raises(ValueError, match="shipped schedule"):
        ts.solve_stagewise(d_t, X0, iterations=21)
    for engine in ("cuda", "stream"):  # kernels need the data on the card
        with pytest.raises(ValueError, match="CUDA device"):
            ts.solve_stagewise(d_t, X0, engine=engine)
        with pytest.raises(ValueError, match="runtime q_lin/c"):
            ts.solve_stagewise(d_t, X0, engine=engine, q_lin=np.zeros(3))
        with pytest.raises(ValueError, match="mode='fixed'"):
            ts.solve_stagewise(d_t, X0, engine=engine, mode="eps")
    assert ts.resolve_stagewise_engine(d_t, 2) == "torch"  # CPU data
    # a config supplies the budget; its condensed engine names map to auto
    res = ts.solve_stagewise(d_t, X0, config=SolverConfig(iterations=10))
    ref = ts.solve_stagewise(d_t, X0, iterations=10)
    assert torch.equal(res.u, ref.u) and int(res.iterations[0]) == 10
    # batch dimensions beyond one are kept
    res = ts.solve_stagewise(d_t, np.stack([X0, X0]), iterations=10)
    assert res.u.shape == (2, 2, 3) and torch.equal(res.u[1], ref.u)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("variant", ["fixed", "restart", "eps",
                                     "eps_restart", "runtime"])
def test_associative_scan_matches_xla(case, variant):
    """scan="associative": the torch engine's doubling prefixes against
    tpu_gpad's ``associative_scan`` sweeps on JAX-CPU, same data and
    scenarios; tolerances as the sequential engine's (the two compose the
    stage maps in different trees, fp32)."""
    iters = 200 if variant.startswith("eps") else ITERS
    d_j, d_t = _pair(case, iterations=iters)
    X0 = _x0(5, d_t.n_x, seed=17)
    kw = {"iterations": iters}
    if "restart" in variant:
        kw["restart"] = True
    if variant.startswith("eps"):
        kw.update(mode="eps", eps_g=1e-4, eps_V=1e-4, check_every=10)
    if variant == "runtime":
        kw["q_lin"] = np.random.default_rng(5).normal(
            0, 0.1, (5, d_t.horizon, d_t.n_x)).astype(np.float32)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    r_j = js.solve_stagewise(d_j, jnp.asarray(X0), engine="xla",
                             scan="associative", **jkw)
    r_t = ts.solve_stagewise(d_t, X0, engine="torch", scan="associative", **kw)
    if variant.startswith("eps"):
        it_j, it_t = np.asarray(r_j.iterations), r_t.iterations.numpy()
        assert np.abs(it_j - it_t).max() <= 10  # within one window
        _close(r_j.u, r_t.u, EPS_U_TOL, "u")
        return
    tol = RESTART_TOL if variant == "restart" else FIXED_TOL
    _close(r_j.u, r_t.u, tol, "u")
    _close(r_j.z, r_t.z, tol, "z")
    if variant != "restart":
        _close(r_j.y, r_t.y, Y_TOL, "y")
        _close(r_j.residual, r_t.residual, FIXED_TOL, "residual")


def test_scan_auto_rule_matches_tpu_gpad():
    """scan="auto" picks the parallel prefixes where tpu_gpad does: n_x +
    n_u <= 24 below a batch of 1024 (a TPU-measured rule)."""
    for n, B, want in ((3, 5, "associative"), (12, 1023, "associative"),
                       (12, 1024, "sequential"), (13, 8, "sequential")):
        d_t = ts.build_stagewise(tp.battery(n, 4), iterations=5, L=1.0,
                                 device="cpu")
        assert ts.resolve_scan(d_t, B) == want, (n, B)
        assert ts.resolve_scan(d_t, B, "sequential") == "sequential"
    # the parallel prefixes of one affine chain, against the chain itself
    rng = np.random.default_rng(2)
    M = torch.as_tensor(rng.normal(0, 0.5, (11, 4, 4)))
    b = torch.as_tensor(rng.normal(0, 1.0, (11, 3, 4)))
    v0 = torch.as_tensor(rng.normal(0, 1.0, (3, 4)))
    P, c = ts._affine_prefix(M, b)
    v = v0
    for t in range(11):
        v = v @ M[t] + b[t]
        torch.testing.assert_close(v0 @ P[t] + c[t], v, atol=1e-12, rtol=0)


def test_auto_solver_kinds_agree():
    X0 = _x0(3, 3, seed=2)
    for kw in ({}, {"threshold_mb": 0.0}):
        f_j, d_j, k_j = js.auto_solver(jp.battery(3, 10), iterations=ITERS, **kw)
        f_t, d_t, k_t = ts.auto_solver(tp.battery(3, 10), iterations=ITERS,
                                       device="cpu", **kw)
        assert k_j == k_t
        u_j = np.asarray(f_j(jnp.asarray(X0)).u)
        u_t = f_t(X0).u.numpy()
        np.testing.assert_allclose(u_t, u_j, atol=1e-5, rtol=0, err_msg=str(kw))
    assert ts.auto_solver(tp.battery(3, 10), iterations=ITERS, device="cpu",
                          x_ref=np.zeros(3))[2] == "stagewise"


def test_stagewise_controller_follows_jax():
    c_j = js.StagewiseController(jp.battery(3, 8), iterations=ITERS)
    c_t = tpu_gpad_torch.StagewiseController(tp.battery(3, 8), iterations=ITERS,
                                             device="cpu")
    A = np.asarray(c_j.problem.A, np.float32)
    Bm = np.asarray(c_j.problem.B, np.float32)
    x = _x0(4, 3, seed=5)
    for _ in range(5):
        u_j, u_t = c_j.step(x), c_t.step(x)
        assert u_t.dtype == np.float32 and u_t.shape == (4, 3)
        np.testing.assert_allclose(u_t, u_j, atol=2e-5, rtol=0)
        x = x @ A.T + u_j @ Bm.T
    assert c_t._y is not None
    assert c_t.step(x[0]).shape == (3,)  # a new batch shape drops the warm start
    c_t.reset()
    assert c_t._y is None


def test_condense_wall_points_to_the_stagewise_engine():
    with pytest.raises(ValueError, match="tpu_gpad_torch.stagewise.auto_solver"):
        tpu_gpad_torch.condense(tp.battery(30, 400))


def test_cli_stagewise_matches_jax(capsys):
    argv = ["solve", "--engine", "stagewise", "--batch", "4", "--horizon", "8",
            "--iterations", "40"]
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_gpad_torch", *argv, "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    (out_t,) = [json.loads(ln) for ln in proc.stdout.strip().splitlines()]
    assert jax_main(argv) == 0
    (out_j,) = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert set(out_t) == set(out_j) | {"device"}
    assert out_t["device"] == "cpu" and out_t["engine"] == "stagewise"
    for key in ("problem", "n_u", "horizon", "m", "batch", "iterations",
                "converged_all"):
        assert out_t[key] == out_j[key], key
    np.testing.assert_allclose(out_t["u_star"], out_j["u_star"], atol=1e-5, rtol=0)
