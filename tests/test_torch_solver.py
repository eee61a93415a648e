"""Port parity: ``tpu_gpad_torch.solve_batch`` (torch engine) against
``tpu_gpad.solve_batch(engine="xla")`` on the same data and scenarios, plus
u* against the NumPy oracle and the routing/refusal rules."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_gpad
from tpu_gpad import problems as jp
from tpu_gpad.solver import SolverConfig as JConfig

import tpu_gpad_torch
from tpu_gpad_torch.convert import gpad_data_from_numpy, solve_result_to_numpy
from tpu_gpad_torch.solver import SolverConfig, core
from tpu_gpad_torch.solver.reference import gpad_solve_qp
from tpu_gpad_torch.types import GPAD_META_FIELDS, GPAD_TENSOR_FIELDS

torch.set_num_threads(2)

ITERS = 100
# fp32 sums in another order over 100 iterations. Iterates and the residual
# take tpu_gpad's pallas-vs-xla bound; the gap is O(1e-4) at these states,
# so it gets a bound two orders tighter (measured differences: ~1e-6 on y,
# ~3e-7 on the gap).
TOL = {"u": 2e-5, "z": 2e-5, "y": 2e-5, "residual": 2e-5, "gap": 2e-6}


def _pair(problem, paired):
    qp = tpu_gpad.condense(problem)
    d_j = tpu_gpad.dualize(qp, iterations=ITERS, paired=paired)
    fields = {k: None if getattr(d_j, k) is None else np.asarray(getattr(d_j, k))
              for k in GPAD_TENSOR_FIELDS}
    d_t = gpad_data_from_numpy(fields, {k: getattr(d_j, k) for k in GPAD_META_FIELDS})
    return qp, d_j, d_t


@pytest.fixture(scope="module")
def paired_pair():
    return _pair(jp.battery(3, 10), "auto")


@pytest.fixture(scope="module")
def dense_pair():
    return _pair(jp.battery(3, 10), False)


def _x0(n, n_x, seed):
    return np.random.default_rng(seed).uniform(-0.4, 0.4, (n, n_x)).astype(np.float32)


def _compare(res_j, res_t):
    out = solve_result_to_numpy(res_t)
    for name, tol in TOL.items():
        np.testing.assert_allclose(out[name], np.asarray(getattr(res_j, name)),
                                   atol=tol, rtol=0, err_msg=name)
    np.testing.assert_array_equal(out["iterations"], np.asarray(res_j.iterations))
    assert out["iterations"].dtype == np.int32 and out["converged"].all()


@pytest.mark.parametrize(
    "form,flat,warm",
    [("mvp", "on", False), ("mvp", "off", False), ("dual", "auto", False),
     ("mvp", "on", True), ("dual", "auto", True)],
)
def test_paired_matches_xla_engine(paired_pair, form, flat, warm):
    qp, d_j, d_t = paired_pair
    X0 = _x0(6, qp.n_x, seed=1)
    y0 = None
    if warm:  # warm start from a short cold solve
        y0 = np.array(tpu_gpad.solve_batch(
            d_j, jnp.asarray(X0), JConfig(iterations=20, engine="xla")).y)
    kw = dict(form=form, flat=flat)
    res_j = tpu_gpad.solve_batch(
        d_j, jnp.asarray(X0), JConfig(engine="xla", **kw),
        y0=None if y0 is None else jnp.asarray(y0))
    res_t = tpu_gpad_torch.solve_batch(
        d_t, X0, SolverConfig(engine="torch", **kw), y0=y0)
    _compare(res_j, res_t)


def test_dense_matches_xla_engine(dense_pair):
    qp, d_j, d_t = dense_pair
    X0 = _x0(5, qp.n_x, seed=2)
    res_j = tpu_gpad.solve_batch(d_j, jnp.asarray(X0), JConfig(engine="xla"))
    res_t = tpu_gpad_torch.solve_batch(d_t, X0, SolverConfig())
    _compare(res_j, res_t)


def test_diagnostics_off_and_batch_dims(paired_pair):
    qp, d_j, d_t = paired_pair
    X0 = _x0(6, qp.n_x, seed=3)
    cfg = SolverConfig(form="mvp", diagnostics=False)
    res = tpu_gpad_torch.solve_batch(d_t, X0.reshape(2, 3, qp.n_x), cfg)
    assert res.u.shape == (2, 3, 3) and res.y.shape == (2, 3, 2, d_t.m_half)
    assert torch.isnan(res.residual).all() and torch.isnan(res.gap).all()
    full = tpu_gpad_torch.solve_batch(d_t, X0, dataclasses.replace(cfg, diagnostics=True))
    torch.testing.assert_close(res.z.reshape(6, -1), full.z, rtol=0, atol=0)


@pytest.mark.parametrize("paired", ["auto", False])
def test_u_star_matches_oracle(paired):
    problem = tpu_gpad_torch.problems.battery(3, 10)
    qp = tpu_gpad_torch.condense(problem)
    data = tpu_gpad_torch.dualize(qp, iterations=ITERS, paired=paired)
    X0 = _x0(3, qp.n_x, seed=4)
    for form in (("mvp", "dual") if paired else ("mvp",)):
        res = tpu_gpad_torch.solve_batch(data, X0, SolverConfig(form=form))
        for i in range(X0.shape[0]):
            ref = gpad_solve_qp(qp, X0[i].astype(np.float64), iterations=ITERS)
            np.testing.assert_allclose(res.u[i].numpy(), ref.u, atol=1e-4, rtol=0)
    single = tpu_gpad_torch.solve(data, X0[0])
    assert single.u.shape == (1, 3)


def test_routing_on_cpu(paired_pair):
    _, _, d_t = paired_pair
    cfg = SolverConfig()
    assert core.resolve_engine(d_t, cfg) == "torch"
    assert core.resolve_form(d_t, cfg) == "dual"  # as tpu_gpad on CPU
    assert core.resolve_flat(d_t, cfg)
    assert core.resolve_form(d_t, SolverConfig(form="mvp")) == "mvp"
    with pytest.raises(ValueError, match="unknown engine"):
        core.resolve_engine(d_t, SolverConfig(engine="pallas"))


def test_too_many_iterations_raises(paired_pair):
    _, _, d_t = paired_pair
    with pytest.raises(ValueError, match="schedule only has"):
        tpu_gpad_torch.solve_batch(
            d_t, np.zeros((1, 3), np.float32), SolverConfig(iterations=ITERS + 1))


@pytest.mark.parametrize(
    "kw",
    [dict(mode="eps"), dict(restart=True), dict(model_axis="model"),
     dict(collective_axes=("data",)), dict(precision="high"),
     dict(matmul_dtype="bfloat16")],
    ids=["eps", "restart", "model_axis", "collective_axes", "precision",
         "matmul_dtype"],
)
def test_unported_modes_raise(paired_pair, kw):
    _, _, d_t = paired_pair
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpu_gpad_torch.solve_batch(
            d_t, np.zeros((1, 3), np.float32), SolverConfig(**kw))
