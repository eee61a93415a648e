"""The port's sharded solves across processes, against tpu_gpad's.

One launch of ``tpu_gpad_torch.parallel.mp_worker`` (the ``small`` suite:
4 gloo ranks on the CPU, each a fresh interpreter, one process group
through a ``file://`` rendezvous) runs every case; each test holds one
case against ``tpu_gpad.parallel``'s sharded solve of the same numpy-made
problem and batch on the 8-device virtual CPU mesh of ``conftest.py``
(as ``tests/test_distrib.py``, ``test_multi.py``, ``test_stagewise.py``
and ``test_mhe.py`` do for the JAX package alone).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpu_gpad
from tpu_gpad import problems
from tpu_gpad.parallel import (
    make_mesh,
    shard_batch,
    solve_batch_sharded,
    solve_multi_sharded,
    solve_stagewise_multi_sharded,
)
from tpu_gpad.solver import SolverConfig

import tpu_gpad_torch
from tpu_gpad_torch.parallel import mp_worker

torch.set_num_threads(2)

# fp32 sums in another order than XLA's: DP keeps each scenario's
# arithmetic, TP splits the step-2 product over the ranks
DP_TOL = 1e-5
TP_TOL = 1e-4
EPS_RESTART_TOL = 2e-4  # restart decisions near 0 may part by a window
X_TOL = 1e-4  # MHE windows across packages (tests/test_torch_mhe.py)


@pytest.fixture(scope="module")
def run():
    """Every case of the small suite, from one 4-rank launch."""
    arrays, report = mp_worker.run_multiprocess_check(world_size=4,
                                                      suite="small")
    return arrays, report


def _data(paired):
    qp = tpu_gpad.condense(problems.battery(n_cells=3, horizon=4))  # m 56
    return tpu_gpad.dualize(qp, iterations=400, paired=paired)


def _x0():
    return jnp.asarray(mp_worker._small_x0())


def _devices(n):
    return jax.devices()[:n]


def test_every_rank_ran_every_case(run):
    _, report = run
    assert report["world_size"] == 4
    assert len(report["outputs"]) == 4
    assert all("MP_OK" in out for out in report["outputs"])
    # the fourth rank sits out the 1x3 meshes
    assert {c for c in report["launches_by_rank"][3]} == (
        set(report["cases"]) - {"tp_odd_dense", "tp_odd_paired"})


def test_dp_matches_jax(run):
    arrays, _ = run
    data = _data(False)
    mesh = make_mesh(n_data=4, devices=_devices(4))
    ref = solve_batch_sharded(data, shard_batch(mesh, _x0()),
                              SolverConfig(iterations=100), mesh=mesh)
    np.testing.assert_allclose(arrays["dp_u"], np.asarray(ref.u), atol=DP_TOL)
    np.testing.assert_allclose(arrays["dp_y"], np.asarray(ref.y), atol=DP_TOL)


@pytest.mark.parametrize("case, shape", [("tp", (1, 4)), ("dptp", (2, 2))],
                         ids=["tp_1x4", "dp_tp_2x2"])
def test_tp_matches_jax(run, case, shape):
    arrays, _ = run
    data = _data(False)
    mesh = make_mesh(*shape, devices=_devices(4))
    ref = solve_batch_sharded(data, _x0(), SolverConfig(iterations=100),
                              mesh=mesh, model_axis="model")
    np.testing.assert_allclose(arrays[f"{case}_u"], np.asarray(ref.u),
                               atol=TP_TOL)
    np.testing.assert_allclose(arrays[f"{case}_y"], np.asarray(ref.y),
                               atol=TP_TOL)


def test_eps_collective_exit_matches_jax(run):
    """Every rank ran until the last scenario of all four converged, so
    the per-scenario first-pass iteration counts equal tpu_gpad's."""
    arrays, _ = run
    data = _data(False)
    mesh = make_mesh(n_data=4, devices=_devices(4))
    cfg = SolverConfig(mode="eps", eps_g=1e-4, eps_V=1e-4, check_every=10)
    ref = solve_batch_sharded(data, shard_batch(mesh, _x0()), cfg, mesh=mesh)
    assert arrays["eps_converged"].all()
    np.testing.assert_array_equal(arrays["eps_iterations"],
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(arrays["eps_u"], np.asarray(ref.u), atol=TP_TOL)


def test_eps_restart_nondivisible_budget(run):
    arrays, _ = run
    data = _data(True)
    mesh = make_mesh(n_data=4, devices=_devices(4))
    cfg = SolverConfig(mode="eps", eps_g=1e-5, eps_V=1e-5, check_every=10,
                       iterations=195, restart=True)
    ref = solve_batch_sharded(data, shard_batch(mesh, _x0()), cfg, mesh=mesh)
    assert arrays["eps_restart_converged"].all()
    assert np.asarray(ref.converged).all()
    np.testing.assert_allclose(arrays["eps_restart_u"], np.asarray(ref.u),
                               atol=EPS_RESTART_TOL)


@pytest.mark.parametrize("paired", [False, True], ids=["dense", "paired"])
def test_tp_nondivisible_m(run, paired):
    """m 56 (dense) and m_h 28 (paired) over a 1x3 mesh: inert rows pad
    the dual, and y comes back at the true m."""
    arrays, _ = run
    case = "tp_odd_paired" if paired else "tp_odd_dense"
    data = _data(paired)
    mesh = make_mesh(1, 3, devices=_devices(3))
    ref = solve_batch_sharded(data, _x0(), SolverConfig(iterations=100),
                              mesh=mesh, model_axis="model")
    assert arrays[f"{case}_y"].shape == ref.y.shape
    for f in ("u", "y", "residual"):
        np.testing.assert_allclose(arrays[f"{case}_{f}"],
                                   np.asarray(getattr(ref, f)), atol=TP_TOL,
                                   err_msg=f)


def test_solve_multi_sharded_matches_jax(run):
    """8 heterogeneous plants, 2 a rank (tests/test_multi.py's plants)."""
    from tpu_gpad.solver.multi import stack_data

    arrays, _ = run
    datas = [tpu_gpad.dualize(tpu_gpad.condense(problems.random_lti(
        n_x=3, n_u=2, horizon=8, seed=s)), iterations=200, paired="auto")
        for s in range(8)]
    X0 = np.random.default_rng(3).uniform(-0.3, 0.3, (8, 4, 3)).astype(
        np.float32)
    mesh = make_mesh(4, devices=_devices(4))
    ref = solve_multi_sharded(stack_data(datas), X0,
                              config=SolverConfig(iterations=200), mesh=mesh)
    np.testing.assert_allclose(arrays["multi_u"], np.asarray(ref.u), atol=DP_TOL)
    np.testing.assert_allclose(arrays["multi_z"], np.asarray(ref.z), atol=DP_TOL)


def test_solve_stagewise_multi_sharded_matches_jax(run):
    """4 random LTV plants, one a rank (tests/test_stagewise.py's)."""
    from tpu_gpad.stagewise import build_stagewise, stack_stagewise

    arrays, _ = run
    st = stack_stagewise([build_stagewise(problems.random_ltv(
        n_x=3, n_u=2, horizon=6, seed=s), iterations=60) for s in range(4)])
    X = jnp.asarray(np.random.default_rng(1).uniform(
        -0.3, 0.3, (4, 2, 3)).astype(np.float32))
    mesh = make_mesh(n_data=4, n_model=1, devices=_devices(4))
    ref = solve_stagewise_multi_sharded(st, X, SolverConfig(iterations=60),
                                        mesh=mesh)
    np.testing.assert_allclose(arrays["stagewise_multi_u"], np.asarray(ref.u),
                               atol=DP_TOL)
    np.testing.assert_allclose(arrays["stagewise_multi_y"], np.asarray(ref.y),
                               atol=DP_TOL)


def test_mhe_fleet_windows(run):
    """MHE fleet estimation over the mesh: the port's window QPs through
    solve_batch_sharded equal its own solve_window, and their estimates
    tpu_gpad's sharded ones."""
    from tpu_gpad.mhe import MovingHorizonEstimator as JaxMHE

    arrays, _ = run
    kw = dict(**mp_worker.MHE_PLANT, **mp_worker.MHE_KW)
    xbar, Y, U = mp_worker.mhe_windows()
    est = tpu_gpad_torch.MovingHorizonEstimator(**kw, device="cpu")
    _, local = est.solve_window(xbar, Y, U)
    np.testing.assert_allclose(arrays["mhe_z"], local.z.numpy(), atol=DP_TOL)

    jest = JaxMHE(**kw)
    n = len(xbar)
    p = jnp.concatenate([jnp.asarray(xbar), jnp.asarray(Y).reshape(n, -1),
                         jnp.asarray(U).reshape(n, -1)], axis=1)
    mesh = make_mesh(4, devices=_devices(4))
    ref = solve_batch_sharded(jest.data, p, jest.config, mesh=mesh)
    st = est.structure
    x_hat = lambda z: z @ st.M[-st.n_x:].T + U.reshape(n, -1) @ st.N_u[-st.n_x:].T
    np.testing.assert_allclose(x_hat(arrays["mhe_z"]), x_hat(np.asarray(ref.z)),
                               atol=X_TOL)


def test_uneven_meshes_raise_before_any_collective(run):
    """tpu_gpad's ValueErrors, from every rank without a hang."""
    _, report = run
    errors = report["errors"]
    assert errors["uneven_batch"] == "batch 30 not divisible by data axis 4"
    assert errors["plant_count"] == "plant count 3 not divisible by mesh axis 4"
    assert errors["stagewise_plant_count"] == (
        "plant count 3 not divisible by mesh axis 4")
