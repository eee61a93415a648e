"""Port parity for plant stacks on the stage-wise engine:
``stack_stagewise`` and ``solve_stagewise_multi`` of ``tpu_gpad_torch``
against ``tpu_gpad``'s on the same three plants (different actuators), one
state per plant and a batch per plant, fixed budget and eps mode."""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_gpad import problems as jp
from tpu_gpad import stagewise as js

from tpu_gpad_torch import problems as tp
from tpu_gpad_torch import stagewise as ts
from tpu_gpad_torch.solver import SolverConfig

torch.set_num_threads(2)

P = 3
ITERS = 80
# u, z, y of two fp32 runs of the same sweeps in another summation order
TOL = 1e-5


def _plants(pkg_problems, horizon=8):
    base = pkg_problems.battery(3, horizon)
    return [dataclasses.replace(base, B=np.asarray(base.B) * s,
                                name=f"battery_b{s}")
            for s in (0.8, 1.0, 1.2)]


@pytest.fixture(scope="module")
def stacks():
    d_j = js.stack_stagewise([js.build_stagewise(p, iterations=ITERS)
                              for p in _plants(jp)])
    builds = [ts.build_stagewise(p, iterations=ITERS, device="cpu")
              for p in _plants(tp)]
    return d_j, ts.stack_stagewise(builds), builds


def test_stack_shapes(stacks):
    _, d_t, builds = stacks
    assert d_t.E.shape == (P,) + tuple(builds[0].E.shape)
    assert d_t.L.shape == (P,)
    # the row counts and the budget read trailing dimensions on a stack
    assert (d_t.m_x, d_t.m_u, d_t.max_iters) == (
        builds[0].m_x, builds[0].m_u, ITERS)
    assert d_t.name == builds[0].name


def test_stack_rejects_other_shapes(stacks):
    _, _, builds = stacks
    other = ts.build_stagewise(tp.battery(3, 6), iterations=ITERS, device="cpu")
    with pytest.raises(ValueError, match="identical shapes"):
        ts.stack_stagewise(builds + [other])
    short = ts.build_stagewise(tp.battery(3, 8), iterations=ITERS // 2,
                               device="cpu")
    with pytest.raises(ValueError, match="identical shapes"):
        ts.stack_stagewise([builds[0], short])
    with pytest.raises(ValueError, match="at least one"):
        ts.stack_stagewise([])


def test_multi_argument_checks(stacks):
    _, d_t, builds = stacks
    with pytest.raises(ValueError, match=r"\(P, n_x\)"):
        ts.solve_stagewise_multi(d_t, np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match="stack_stagewise build"):
        ts.solve_stagewise_multi(builds[0], np.zeros((P, 3), np.float32))
    with pytest.raises(ValueError, match="solve_stagewise_multi"):
        ts.solve_stagewise(d_t, np.zeros((P, 3), np.float32))
    with pytest.raises(ValueError, match="scan"):
        ts.solve_stagewise_multi(d_t, np.zeros((P, 3), np.float32), scan="x")
    with pytest.raises(ValueError, match="schedule"):
        ts.solve_stagewise_multi(d_t, np.zeros((P, 3), np.float32),
                                 iterations=ITERS + 1)


CASES = {
    "fixed": dict(iterations=ITERS),
    "fixed_sequential": dict(iterations=ITERS, scan="sequential"),
    "restart": dict(iterations=ITERS, restart=True),
    "eps": dict(iterations=ITERS, mode="eps", eps_g=1e-4, eps_V=1e-4),
}


@pytest.mark.parametrize("inner", [(), (4,)], ids=["per_plant", "batch"])
@pytest.mark.parametrize("case", list(CASES))
def test_multi_matches_tpu_gpad(stacks, case, inner):
    d_j, d_t, _ = stacks
    x0 = np.random.default_rng(7).uniform(
        -0.4, 0.4, (P, *inner, 3)).astype(np.float32)
    r_j = js.solve_stagewise_multi(d_j, x0, **CASES[case])
    r_t = ts.solve_stagewise_multi(d_t, x0, **CASES[case])
    for name in ("u", "z", "y", "residual", "gap"):
        a, b = getattr(r_t, name).numpy(), np.asarray(getattr(r_j, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0, err_msg=name)
    np.testing.assert_array_equal(r_t.iterations.numpy(),
                                  np.asarray(r_j.iterations))
    np.testing.assert_array_equal(r_t.converged.numpy(),
                                  np.asarray(r_j.converged))


def test_multi_config_and_warm_start(stacks):
    """A SolverConfig supplies the budget and mode, and a shared y0 warm
    start broadcasts over the plants, as in tpu_gpad."""
    d_j, d_t, _ = stacks
    x0 = np.random.default_rng(8).uniform(-0.4, 0.4, (P, 3)).astype(np.float32)
    cold = ts.solve_stagewise_multi(d_t, x0, iterations=ITERS)
    y0 = cold.y[0].numpy()
    r_j = js.solve_stagewise_multi(d_j, x0, iterations=20, y0=y0)
    r_t = ts.solve_stagewise_multi(d_t, x0, y0=y0,
                                   config=SolverConfig(iterations=20))
    np.testing.assert_allclose(r_t.u.numpy(), np.asarray(r_j.u), atol=TOL,
                               rtol=0)


def test_multi_matches_per_plant_solves(stacks):
    """Each plant of the stack solves as its own build does."""
    _, d_t, builds = stacks
    x0 = np.random.default_rng(9).uniform(-0.4, 0.4, (P, 5, 3)).astype(
        np.float32)
    res = ts.solve_stagewise_multi(d_t, x0, iterations=ITERS)
    for i, d in enumerate(builds):
        one = ts.solve_stagewise(d, x0[i], iterations=ITERS, engine="torch")
        np.testing.assert_allclose(res.z[i].numpy(), one.z.numpy(), atol=TOL,
                                   rtol=0)
