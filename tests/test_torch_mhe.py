"""Port parity for moving-horizon estimation (after tests/test_mhe.py):
``tpu_gpad_torch.mhe`` against ``tpu_gpad.mhe`` on the same plant,
windows and measurements: the condensed and stage-wise structures, batched
``solve_window`` on both engines, the streaming ``update`` through the
fill phase, and the ``auto`` engine's memory backstop."""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_gpad import mhe as jm
from tpu_gpad.solver import SolverConfig as JConfig

from tpu_gpad_torch import mhe as tm
from tpu_gpad_torch.solver import SolverConfig
from tpu_gpad_torch.stagewise import STAGEWISE_TENSOR_FIELDS

torch.set_num_threads(2)

A = np.array([[1.0, 0.1], [0.0, 0.97]])
B = np.array([[0.005], [0.1]])
C = np.array([[1.0, 0.0]])
W = np.diag([1e-4, 4e-3])
V = np.array([[1e-2]])
T = 8
ITERS = 300
STREAM_ITERS = 150  # per slide, warm-started from the last slide's dual
# Both packages assemble the structures in float64 NumPy alike.
ASM_TOL = 1e-12
# x_hat of two fp32 solves of one window QP in another summation order,
# over 300 restart iterations (x_hat is O(1)).
X_TOL = 1e-4
BOUNDS = dict(x_min=np.array([-0.6, -0.5]), x_max=np.array([0.6, 0.5]),
              w_min=np.full(2, -0.05), w_max=np.full(2, 0.05))


def _simulate(steps, seed):
    rng = np.random.default_rng(seed)
    ys, us = [], []
    x = np.array([0.5, 0.0])
    for k in range(steps):
        ys.append(C @ x + rng.normal(0, np.sqrt(V[0, 0]), 1))
        u = np.array([0.4 * np.sin(0.11 * k)])
        us.append(u)
        x = A @ x + B @ u + np.clip(rng.multivariate_normal(np.zeros(2), W),
                                    -0.05, 0.05)
    return np.array(ys), np.array(us)


@pytest.fixture(scope="module")
def windows():
    xbars, Ys, Us = [], [], []
    for seed in range(4):
        ys, us = _simulate(T, seed=seed)
        xbars.append(np.random.default_rng(seed).normal(0, 0.1, 2))
        Ys.append(ys)
        Us.append(us[:-1])
    return np.stack(xbars), np.stack(Ys), np.stack(Us)


def test_mhe_qp_structure_matches_tpu_gpad():
    P = np.eye(2) * 0.3
    sj = jm.mhe_qp(A, B, C, T, P, W, V, **BOUNDS)
    st = tm.mhe_qp(A, B, C, T, P, W, V, **BOUNDS)
    for name in ("M", "N_u"):
        np.testing.assert_allclose(getattr(st, name), getattr(sj, name),
                                   atol=ASM_TOL, rtol=0)
    assert (st.window, st.n_x, st.n_u, st.n_y) == (sj.window, sj.n_x,
                                                   sj.n_u, sj.n_y)
    for f in dataclasses.fields(sj.qp):
        a, b = getattr(st.qp, f.name), getattr(sj.qp, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_allclose(a, b, atol=ASM_TOL, rtol=0)
        else:
            assert a == b, f.name


def test_mhe_stagewise_structure_matches_tpu_gpad():
    P = np.eye(2) * 0.3
    sj = jm.mhe_stagewise(A, B, C, T, P, W, V, iterations=50, **BOUNDS)
    st = tm.mhe_stagewise(A, B, C, T, P, W, V, iterations=50, device="cpu",
                          **BOUNDS)
    np.testing.assert_allclose(st.CtVinv, sj.CtVinv, atol=ASM_TOL, rtol=0)
    assert (st.window, st.n_x, st.n_u, st.n_y) == (sj.window, sj.n_x,
                                                   sj.n_u, sj.n_y)
    for name in STAGEWISE_TENSOR_FIELDS:  # float32 builds, bit for bit
        np.testing.assert_array_equal(getattr(st.data, name).numpy(),
                                      np.asarray(getattr(sj.data, name)),
                                      err_msg=name)


def test_validation_matches_tpu_gpad():
    with pytest.raises(ValueError, match="Kalman"):
        tm.mhe_qp(A, B, C, 5, np.eye(2), W, V)
    with pytest.raises(ValueError, match="Kalman"):
        tm.mhe_stagewise(A, B, C, 5, np.eye(2), W, V, device="cpu")
    with pytest.raises(ValueError, match="window"):
        tm.mhe_qp(A, B, C, 1, np.eye(2), W, V, w_max=np.ones(2))
    with pytest.raises(ValueError, match="engine"):
        tm.MovingHorizonEstimator(A, B, C, window=4, engine="x", device="cpu")
    est = tm.MovingHorizonEstimator(A, B, C, window=4, W=W, V=V,
                                    w_max=np.ones(2), w_min=-np.ones(2),
                                    device="cpu")
    est.update(np.zeros(1))
    with pytest.raises(ValueError, match="u_prev"):
        est.update(np.zeros(1))


def _pair(engine, **kw):
    kw = dict(dict(W=W, V=V, x0=np.zeros(2), iterations=ITERS, engine=engine,
                   **BOUNDS), **kw)
    return (jm.MovingHorizonEstimator(A, B, C, window=T, **kw),
            tm.MovingHorizonEstimator(A, B, C, window=T, device="cpu", **kw))


@pytest.mark.parametrize("engine", ["condensed", "stagewise"])
def test_solve_window_matches_tpu_gpad(windows, engine):
    est_j, est_t = _pair(engine)
    assert est_t.engine == est_j.engine == engine
    xj, rj = est_j.solve_window(*windows)
    xt, rt = est_t.solve_window(*windows)
    assert xt.dtype == torch.float32 and xt.shape == (4, 2)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=X_TOL, rtol=0)
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), atol=X_TOL,
                               rtol=0)


def test_stagewise_window_in_float64(windows):
    """The stage-wise window solve runs in the data's dtype: the same solve
    on a float64 copy of the float32 build agrees with it (the reference
    the card's MHE path is held against)."""
    import copy

    from tpu_gpad_torch.stagewise import STAGEWISE_TENSOR_FIELDS

    _, est = _pair("stagewise")
    d64 = dataclasses.replace(est.data, **{
        f: getattr(est.data, f).double() for f in STAGEWISE_TENSOR_FIELDS})
    est64 = copy.copy(est)
    est64.data = d64
    est64.structure = dataclasses.replace(est.structure, data=d64)
    x32, _ = est.solve_window(*windows)
    x64, r64 = est64.solve_window(*windows)
    assert x64.dtype == r64.z.dtype == torch.float64
    np.testing.assert_allclose(x32.numpy(), x64.numpy(), rtol=0,
                               atol=X_TOL * x64.abs().max().item())


@pytest.mark.parametrize("engine", ["condensed", "stagewise"])
def test_streaming_update_matches_tpu_gpad(engine):
    """15 samples through a window of 8: the Kalman fill phase, then
    warm-started window solves as the window slides."""
    est_j, est_t = _pair(engine, iterations=STREAM_ITERS)
    ys, us = _simulate(15, seed=3)
    for k in range(len(ys)):
        u_prev = us[k - 1] if k > 0 else None
        xj = est_j.update(ys[k], u_prev)
        xt = est_t.update(ys[k], u_prev)
        assert xt.dtype == np.float64
        np.testing.assert_allclose(xt, xj, atol=X_TOL, rtol=0)
        np.testing.assert_allclose(est_t.x_bar, est_j.x_bar, atol=X_TOL,
                                   rtol=0)
    assert est_t._y0 is not None and est_t.last_result is not None


def test_condensed_window_restart_config_is_kept():
    """A caller's SolverConfig replaces the default restart budget."""
    est_j, est_t = _pair("condensed", config=None)
    assert est_t.config == SolverConfig(iterations=ITERS, restart=True)
    cfg = dict(iterations=150, restart=False)
    est_j = jm.MovingHorizonEstimator(A, B, C, window=T, W=W, V=V,
                                      iterations=ITERS, config=JConfig(**cfg),
                                      **BOUNDS)
    est_t = tm.MovingHorizonEstimator(A, B, C, window=T, W=W, V=V,
                                      iterations=ITERS,
                                      config=SolverConfig(**cfg),
                                      device="cpu", **BOUNDS)
    ys, us = _simulate(T, seed=5)
    args = (np.zeros((1, 2)), ys[None], us[:-1][None])
    np.testing.assert_allclose(est_t.solve_window(*args)[0].numpy(),
                               np.asarray(est_j.solve_window(*args)[0]),
                               atol=X_TOL, rtol=0)


@pytest.mark.parametrize("window, n_x, engine", [
    (1400, 2, "condensed"),  # 250.9 MB projected
    (1500, 2, "stagewise"),  # 288.0 MB
    (94, 30, "condensed"),   # 254.5 MB
    (95, 30, "stagewise"),   # 259.9 MB
    (180, 2, "condensed"),   # the MHE_STAGEWISE.json shape, 4.1 MB
])
def test_auto_backstop_sides_of_256_mb(window, n_x, engine):
    """engine="auto" is the memory backstop alone, reckoned from the window
    and the state size without building either QP: tpu_gpad's formula."""
    mb = 2 * (4 * window * n_x) * (window * n_x) * 4 / 1e6
    assert tm.condensed_window_mb(window, n_x) == mb
    assert (mb > 256.0) == (engine == "stagewise")
    assert tm.auto_engine(window, n_x) == engine


def test_auto_engine_picks_condensed_for_a_short_window():
    est_j = jm.MovingHorizonEstimator(A, B, C, window=5, W=W, V=V,
                                      w_max=np.ones(2), iterations=10)
    est_t = tm.MovingHorizonEstimator(A, B, C, window=5, W=W, V=V,
                                      w_max=np.ones(2), iterations=10,
                                      device="cpu")
    assert est_t.engine == est_j.engine == "condensed"
