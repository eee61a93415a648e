"""Port parity for the diagnostics (after tests/test_analysis.py and
tests/test_debug.py): per-iteration residual and gap traces of
``tpu_gpad_torch.analysis`` against ``tpu_gpad.analysis``, and the checks
of ``tpu_gpad_torch.utils.debug``."""

import dataclasses

import numpy as np
import pytest
import torch

import tpu_gpad
from tpu_gpad import problems as jp
from tpu_gpad.analysis import convergence_trace as jax_trace
from tpu_gpad.solver import SolverConfig as JConfig

import tpu_gpad_torch
from tpu_gpad_torch import problems as tp
from tpu_gpad_torch.analysis import convergence_trace, plot_convergence
from tpu_gpad_torch.solver import SolverConfig, solve_batch
from tpu_gpad_torch.utils import solve_batch_checked, validate_data

torch.set_num_threads(2)

# residual and gap of two fp32 runs of one iteration in another summation
# order; both are O(1) at the start and fall below 1e-3
TRACE_TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    d_j = tpu_gpad.dualize(tpu_gpad.condense(jp.battery(3, 6)), iterations=150,
                           paired="auto")
    d_t = tpu_gpad_torch.dualize(tpu_gpad_torch.condense(tp.battery(3, 6)),
                                 iterations=150, paired="auto", device="cpu")
    X0 = np.random.default_rng(4).uniform(-0.4, 0.4, (3, 3)).astype(np.float32)
    return d_j, d_t, X0


@pytest.mark.parametrize("restart", [False, True], ids=["fixed", "restart"])
def test_trace_matches_tpu_gpad(pair, restart):
    d_j, d_t, X0 = pair
    cfg = dict(iterations=150, restart=restart)
    tr_j = jax_trace(d_j, X0, JConfig(**cfg))
    tr_t = convergence_trace(d_t, X0, SolverConfig(**cfg))
    assert tr_t.residual.shape == tr_t.gap.shape == (150, 3)
    np.testing.assert_allclose(tr_t.residual, tr_j.residual, atol=TRACE_TOL,
                               rtol=0)
    np.testing.assert_allclose(tr_t.gap, tr_j.gap, atol=TRACE_TOL, rtol=0)
    np.testing.assert_allclose(tr_t.u, tr_j.u, atol=TRACE_TOL, rtol=0)
    # the final move is the production solver's (same math)
    ref = solve_batch(d_t, X0, SolverConfig(engine="torch", form="mvp", **cfg))
    np.testing.assert_allclose(tr_t.u, ref.u.numpy(), atol=1e-6, rtol=0)


def test_trace_guards_and_plot(pair, tmp_path):
    _, d_t, X0 = pair
    with pytest.raises(ValueError, match="schedule"):
        convergence_trace(d_t, X0, SolverConfig(iterations=500))
    # restart is schedule-free, so a longer budget runs
    assert convergence_trace(d_t, X0[:1], SolverConfig(
        iterations=160, restart=True)).residual.shape == (160, 1)
    tr = convergence_trace(d_t, X0[0], SolverConfig(iterations=20))
    assert tr.residual.shape == (20, 1)
    out = tmp_path / "conv.png"
    fig = plot_convergence(tr, path=str(out))
    if fig is not None:
        assert out.exists()


def test_validate_data_messages(pair):
    _, d_t, _ = pair
    assert validate_data(d_t) == []
    gP = d_t.gP_const.clone()
    gP[0] = float("nan")
    assert validate_data(dataclasses.replace(d_t, gP_const=gP)) == [
        "gP_const contains non-finite values"]
    assert validate_data(dataclasses.replace(d_t, L=-d_t.L)) == [
        f"Lipschitz constant L={float(-d_t.L)} is not positive"]
    th = d_t.theta.clone()
    th[3] = 1.5
    assert validate_data(dataclasses.replace(d_t, theta=th)) == [
        "theta schedule leaves (0, 1]"]


def test_checked_solve_passes_and_raises(pair):
    _, d_t, X0 = pair
    res = solve_batch_checked(d_t, X0, SolverConfig(iterations=80))
    assert bool(torch.isfinite(res.u).all())
    # NaN data poisons the iterates
    gP = d_t.gP_const.clone()
    gP[0] = float("nan")
    with pytest.raises(RuntimeError, match="primal iterate z is non-finite"):
        solve_batch_checked(dataclasses.replace(d_t, gP_const=gP), X0,
                            SolverConfig(iterations=80))
    # L far too small: the dual iteration of the dense (unpaired) layout
    # diverges, as in tpu_gpad's test
    dense = tpu_gpad_torch.dualize(tpu_gpad_torch.condense(tp.battery(3, 6)),
                                   iterations=80, device="cpu")
    bad = dataclasses.replace(dense, GL_T=dense.GL_T * 1e4,
                              pD_const=dense.pD_const * 1e4,
                              pD_map=dense.pD_map * 1e4)
    with pytest.raises(RuntimeError, match="non-finite|diverged"):
        solve_batch_checked(bad, X0, SolverConfig(iterations=80))
