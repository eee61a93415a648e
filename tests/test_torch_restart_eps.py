"""Port parity for adaptive restart and eps-terminated solves: the torch
engine against ``tpu_gpad.solve_batch(engine="xla")`` on the same data and
scenarios, ``solve_to_accuracy``, the serving ``Controller``/``simulate``
with restart, and ``cli solve --mode eps --restart`` (after
tests/test_restart.py)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_gpad
from tpu_gpad import problems as jp
from tpu_gpad.cli import main as jax_main
from tpu_gpad.solver import SolverConfig as JConfig

import tpu_gpad_torch
from tpu_gpad_torch import problems as tp
from tpu_gpad_torch.convert import gpad_data_from_numpy, solve_result_to_numpy
from tpu_gpad_torch.solver import SolverConfig, core
from tpu_gpad_torch.types import GPAD_META_FIELDS, GPAD_TENSOR_FIELDS

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
# fp32 sums in another order. A restart decision taken where r is near 0
# may differ between the two, and the trajectories then part for a while,
# so restart runs are compared on u and z at tpu_gpad's pallas-vs-xla
# restart bound (tests/test_restart.py), not iterate by iterate.
RESTART_TOL = 5e-5
EPS_U_TOL = 2e-4  # eps runs may stop one window apart (tests/test_restart.py)


def _carry(d_j):
    fields = {k: None if getattr(d_j, k) is None else np.asarray(getattr(d_j, k))
              for k in GPAD_TENSOR_FIELDS}
    return gpad_data_from_numpy(
        fields, {k: getattr(d_j, k) for k in GPAD_META_FIELDS}, device="cpu")


@pytest.fixture(scope="module")
def setup():
    d_j = tpu_gpad.dualize(tpu_gpad.condense(jp.battery(3, 10)),
                           iterations=100, paired="auto")
    X0 = np.random.default_rng(7).uniform(-0.4, 0.4, (6, 3)).astype(np.float32)
    return d_j, _carry(d_j), X0


def _both(d_j, d_t, X0, y0=None, **kw):
    res_j = tpu_gpad.solve_batch(d_j, jnp.asarray(X0), JConfig(engine="xla", **kw),
                                 y0=None if y0 is None else jnp.asarray(y0))
    res_t = tpu_gpad_torch.solve_batch(d_t, X0, SolverConfig(engine="torch", **kw),
                                       y0=y0)
    return res_j, solve_result_to_numpy(res_t)


@pytest.mark.parametrize(
    "form,flat,iterations,warm",
    [("dual", "auto", 80, False), ("mvp", "on", 80, False),
     ("mvp", "off", 80, False), ("dual", "auto", 80, True),
     ("dual", "auto", 150, False), ("mvp", "on", 150, True)],
    ids=["dual", "mvp_flat", "mvp_dense", "dual_warm", "dual_past_schedule",
         "mvp_past_schedule_warm"],
)
def test_restart_matches_xla_engine(setup, form, flat, iterations, warm):
    d_j, d_t, X0 = setup
    y0 = None
    if warm:
        y0 = np.random.default_rng(1).uniform(
            0.0, 0.5, (6, 2, d_t.m_half)).astype(np.float32)
    res_j, out = _both(d_j, d_t, X0, y0, iterations=iterations, restart=True,
                       form=form, flat=flat)
    for name in ("u", "z", "residual"):
        np.testing.assert_allclose(out[name], np.asarray(getattr(res_j, name)),
                                   atol=RESTART_TOL, rtol=0, err_msg=name)
    np.testing.assert_array_equal(out["iterations"], iterations)
    assert out["converged"].all()


def test_restart_forms_agree_and_reach_optimum(setup):
    """Restart lands within fp32 of the optimum in 100 iterations where the
    plain schedule does not; the dual and mvp forms agree."""
    _, d_t, X0 = setup
    kw = dict(iterations=100, restart=True)
    r_dual = tpu_gpad_torch.solve_batch(d_t, X0, SolverConfig(form="dual", **kw))
    r_mvp = tpu_gpad_torch.solve_batch(d_t, X0, SolverConfig(form="mvp", **kw))
    plain = tpu_gpad_torch.solve_batch(d_t, X0, SolverConfig(iterations=100))
    torch.testing.assert_close(r_dual.u, r_mvp.u, atol=2e-5, rtol=0)
    assert r_dual.residual.max() < 1e-5 < plain.residual.max()


@pytest.mark.parametrize("restart", [True, False], ids=["restart", "plain"])
@pytest.mark.parametrize("iterations", [300, 95], ids=["long", "partial"])
def test_eps_matches_xla_engine(setup, restart, iterations):
    """Same check cadence: converged flags, iteration counts and u agree.
    95 is not a multiple of the window, so the last check is partial."""
    d_j, _, X0 = setup
    d_j = tpu_gpad.dualize(tpu_gpad.condense(jp.battery(3, 10)),
                           iterations=300, paired="auto")
    d_t = _carry(d_j)
    res_j, out = _both(d_j, d_t, X0, mode="eps", eps_g=1e-5, eps_V=1e-5,
                       check_every=10, iterations=iterations, restart=restart)
    np.testing.assert_array_equal(out["converged"], np.asarray(res_j.converged))
    assert np.abs(out["iterations"] - np.asarray(res_j.iterations)).max() <= 10
    np.testing.assert_allclose(out["u"], np.asarray(res_j.u), atol=EPS_U_TOL,
                               rtol=0)
    assert out["iterations"].dtype == np.int32
    if restart and iterations == 300:
        assert out["converged"].all()
        assert out["residual"].max() <= 1e-5 + 1e-7


def test_eps_rejects_dual_form_on_torch_engine(setup):
    """As tpu_gpad's XLA engine: the dual form is a fixed-mode algebra."""
    _, d_t, X0 = setup
    with pytest.raises(ValueError, match="form='dual'"):
        tpu_gpad_torch.solve_batch(d_t, X0, SolverConfig(mode="eps", form="dual"))
    with pytest.raises(ValueError, match="diagnostics"):
        tpu_gpad_torch.solve_batch(
            d_t, X0, SolverConfig(mode="eps", diagnostics=False))


def test_solve_to_accuracy(setup):
    d_j, d_t, X0 = setup
    res_j = tpu_gpad.solve_to_accuracy(d_j, jnp.asarray(X0), tol=1e-5)
    res_t = tpu_gpad_torch.solve_to_accuracy(d_t, X0, tol=1e-5)
    assert res_t.converged.all() and res_t.residual.max() <= 1e-5 + 1e-7
    np.testing.assert_array_equal(res_t.iterations.numpy(),
                                  np.asarray(res_j.iterations))
    np.testing.assert_allclose(res_t.u.numpy(), np.asarray(res_j.u),
                               atol=EPS_U_TOL, rtol=0)
    # single-scenario form
    r1 = tpu_gpad_torch.solve_to_accuracy(d_t, X0[0], tol=1e-5)
    assert r1.u.shape == (1, 3)
    torch.testing.assert_close(r1.u[0], res_t.u[0], atol=1e-6, rtol=0)
    # a budget below the check cadence caps, not inflates, the budget
    small = tpu_gpad_torch.solve_to_accuracy(d_t, X0[:2], tol=1e-5,
                                             max_iterations=5, check_every=64)
    small_j = tpu_gpad.solve_to_accuracy(d_j, jnp.asarray(X0[:2]), tol=1e-5,
                                         max_iterations=5, check_every=64)
    assert int(small.iterations.max()) <= 5
    np.testing.assert_array_equal(small.iterations.numpy(),
                                  np.asarray(small_j.iterations))
    np.testing.assert_allclose(small.u.numpy(), np.asarray(small_j.u),
                               atol=RESTART_TOL, rtol=0)


def test_routing_on_cpu(setup):
    """On CPU data every restart and eps solve runs the torch engine; the
    kernels' cases are named for a CUDA device."""
    _, d_t, _ = setup
    for kw in (dict(restart=True), dict(mode="eps"), dict(mode="eps", restart=True)):
        assert core.resolve_engine(d_t, SolverConfig(**kw)) == "torch"
    assert core.cuda_kernel(d_t, SolverConfig(restart=True)) == "dual"
    assert core.cuda_kernel(d_t, SolverConfig(mode="eps")) == "dual_chunk"
    assert core.cuda_kernel(d_t, SolverConfig(mode="eps", form="mvp")) is None
    assert core.cuda_kernel(d_t, SolverConfig(restart=True, form="mvp")) is None
    assert core.cuda_kernel(d_t, SolverConfig(flat="off")) == "dual"
    diag = [core.cuda_kernel(d_t, SolverConfig(restart=True, diagnostics=d))
            for d in (True, False)]
    assert diag == ["dual", "dual"]
    for kw in (dict(restart=True), dict(mode="eps")):  # forced, on CPU data
        with pytest.raises(ValueError, match="CUDA device"):
            tpu_gpad_torch.solve_batch(d_t, np.zeros((2, 3), np.float32),
                                       SolverConfig(engine="cuda", **kw))


def test_controller_restart_matches_tpu_gpad():
    """The flagship example's serving loop: 60 restart iterations per
    sample, warm-started, on the same states for 20 steps."""
    c_j = tpu_gpad.Controller(jp.battery(3, 10),
                              config=JConfig(iterations=60, restart=True))
    c_t = tpu_gpad_torch.Controller(tp.battery(3, 10),
                                    config=SolverConfig(iterations=60, restart=True),
                                    device="cpu")
    A = np.asarray(c_j.problem.A, np.float32)
    Bm = np.asarray(c_j.problem.B, np.float32)
    x = np.random.default_rng(5).uniform(-0.4, 0.4, (8, 3)).astype(np.float32)
    for _ in range(20):
        u_j = c_j.step(x)
        u_t = c_t.step(x)
        np.testing.assert_allclose(u_t, u_j, atol=RESTART_TOL, rtol=0)
        x = x @ A.T + u_j @ Bm.T


def test_simulate_restart_matches_tpu_gpad():
    X0 = np.random.default_rng(6).uniform(-0.4, 0.4, (4, 3)).astype(np.float32)
    kw = dict(n_steps=20, warm_start=True, iterations=60)
    r_j = tpu_gpad.simulate(jp.battery(3, 10), X0,
                            config=JConfig(iterations=60, restart=True), **kw)
    r_t = tpu_gpad_torch.simulate(tp.battery(3, 10), X0,
                                  config=SolverConfig(iterations=60, restart=True),
                                  **kw, device="cpu")
    np.testing.assert_allclose(r_t.U.numpy(), np.asarray(r_j.U),
                               atol=RESTART_TOL, rtol=0)
    np.testing.assert_allclose(r_t.X.numpy(), np.asarray(r_j.X),
                               atol=RESTART_TOL, rtol=0)


def test_cli_solve_eps_restart(capsys):
    argv = ["solve", "--batch", "16", "--mode", "eps", "--restart"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "tpu_gpad_torch", *argv,
                           "--device", "cpu"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    (out_t,) = [json.loads(ln) for ln in proc.stdout.strip().splitlines()]
    assert jax_main(argv) == 0
    (out_j,) = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert set(out_t) == set(out_j) | {"engine", "device"}
    assert out_t["converged_all"] and out_j["converged_all"]
    assert abs(out_t["iterations"] - out_j["iterations"]) <= 10
    np.testing.assert_allclose(out_t["u_star"], out_j["u_star"], atol=EPS_U_TOL,
                               rtol=0)
