"""Port parity for multi-model robust NMPC (after tests/test_robust_nmpc.py
and the robust cases of tests/test_device_condense.py):
``tpu_gpad_torch.RobustNMPC`` on the host-condensed, device-condensed and
stage-wise paths against ``tpu_gpad.RobustNMPC`` on the same states, then
the port's own closed loops, the shared first move, and the errors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gpad import nonlinear as jn

from tpu_gpad_torch.nonlinear import NMPC, RobustNMPC, rk4

torch.set_num_threads(2)

# plans of the host-condensed and stage-wise paths (float64 condensation in
# both packages), and of the device path (float32 condensation in both)
PLAN_TOL = 1e-4
DEVICE_PLAN_TOL = 1e-3
CPU = "cpu"
GS = (8.8, 9.81, 10.8)
REF = np.array([np.pi, 0.0], dtype=np.float32)

_KW = dict(
    n_x=2, n_u=1, horizon=10,
    Q=np.diag([10.0, 1.0]), R=0.1 * np.eye(1),
    x_min=np.array([-10.0, -12.0]), x_max=np.array([10.0, 12.0]),
    u_min=np.array([-11.0]), u_max=np.array([11.0]),
    iterations=150, sqp_iters=1,
)


def _f(g):
    """tests/test_robust_nmpc.py's pendulum of gravity g, in torch."""
    def f_cont(x, u):
        return torch.stack([x[1], g * torch.sin(x[0]) - 0.1 * x[1] + u[0]])

    return rk4(f_cont, 0.05)


def _jf(g):
    def f_cont(x, u):
        th, om = x
        return jnp.array([om, g * jnp.sin(th) - 0.1 * om + u[0]])

    return jn.rk4(f_cont, 0.05)


def _robust(gs=GS, **kw):
    return RobustNMPC([_f(g) for g in gs], **{**_KW, **kw}, device=CPU)


def _step(f, x, u):
    return f(torch.as_tensor(x), torch.as_tensor(u, dtype=torch.float32)).numpy()


PATHS = {
    "host": ({}, PLAN_TOL),
    "host_weighted_preview": (dict(weights=(0.2, 0.5, 0.3), preview=True),
                              PLAN_TOL),
    "device": (dict(device_condense=True), DEVICE_PLAN_TOL),
    "device_soft": (dict(device_condense=True, soft_state=25.0,
                         x_min=np.array([-6.0, -4.0]),
                         x_max=np.array([6.0, 4.0])), DEVICE_PLAN_TOL),
    "stagewise": (dict(engine="stagewise", iterations=300), PLAN_TOL),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_steps_match_tpu_gpad(path):
    """Three warm samples in both packages (tpu_gpad's moves applied to
    both): the applied move and every scenario's plan."""
    extra, tol = PATHS[path]
    kw = {**_KW, **extra}
    rj = jn.RobustNMPC([_jf(g) for g in GS], **kw)
    rt = RobustNMPC([_f(g) for g in GS], **kw, device=CPU)
    ref = (np.tile(REF, (10, 1)) if kw.get("preview") else REF)
    x = np.array([2.3, -0.1], dtype=np.float32)
    for _ in range(3):
        uj, ut = rj.step(x, ref), rt.step(x, ref)
        np.testing.assert_allclose(ut, uj, atol=tol, rtol=0)
        np.testing.assert_allclose(rt.plans, rj.plans, atol=tol, rtol=0)
        assert rt.plans.shape == (3, 10, 1)
        x = np.asarray(_jf(9.81)(jnp.asarray(x), jnp.asarray(uj)), np.float32)


def test_identical_models_match_plain_nmpc():
    f = _f(9.81)
    plain = NMPC(f, **_KW, device=CPU)
    robust = RobustNMPC([f, f, f], **_KW, device=CPU)
    x = np.array([2.0, 0.3], dtype=np.float32)
    np.testing.assert_allclose(robust.step(x, REF), plain.step(x, REF),
                               atol=2e-3)


@pytest.mark.parametrize("path", ["host", "device", "stagewise"])
def test_shared_first_move_across_scenarios(path):
    extra = {"host": {}, "device": dict(device_condense=True),
             "stagewise": dict(engine="stagewise")}[path]
    robust = _robust(damping=0.5, **extra)
    x = np.array([2.4, -0.2], dtype=np.float32)
    for _ in range(3):
        u = robust.step(x, REF)
        firsts = robust.plans[:, 0]
        if path == "stagewise":  # equality rows, not a selector
            np.testing.assert_allclose(firsts[0], firsts[2], atol=5e-5)
        else:
            np.testing.assert_array_equal(firsts[0], firsts[1])
            np.testing.assert_array_equal(firsts[1], firsts[2])
        x = _step(_f(9.81), x, u)
    assert not np.allclose(robust.plans[0, 1:], robust.plans[2, 1:])


@pytest.mark.parametrize("device_condense", [False, True],
                         ids=["host", "device"])
def test_closed_loop_on_offnominal_plant_settles(device_condense):
    """The strongest-gravity realization as the plant: the robust
    controller swings up and settles near upright, warm starts threaded."""
    robust = _robust(device_condense=device_condense)
    plant = _f(10.8)
    x = np.array([2.2, 0.0], dtype=np.float32)
    for _ in range(45):
        x = _step(plant, x, robust.step(x, REF))
    assert abs(x[0] - np.pi) < 0.1


def test_device_soft_closed_loop_tracks_the_host_path():
    kw = dict(horizon=6, x_min=np.array([-6.0, -4.0]), x_max=np.array([6.0, 4.0]),
              soft_state=25.0, iterations=300)
    plant = _f(10.8)
    trajs = {}
    for label, dev in (("host", False), ("device", True)):
        ctrl = _robust(device_condense=dev, **kw)
        x = np.array([2.3, 0.0], np.float32)
        X = [x]
        for _ in range(10):
            x = _step(plant, x, ctrl.step(x, REF))
            X.append(x)
        trajs[label] = np.stack(X)
    np.testing.assert_allclose(trajs["device"], trajs["host"], atol=5e-3)


def test_errors_and_reset_match_tpu_gpad():
    f = _f(9.81)
    kw = {k: v for k, v in _KW.items() if k not in ("u_min", "u_max")}
    cases = [
        ([], {}, "at least one"),
        ([f, f], dict(engine="xla"), "engine must be"),
        ([f, f], dict(engine="stagewise", device_condense=True), "exclusive"),
        ([f, f], dict(engine="stagewise", soft_state=1.0), "soft_state"),
        ([f], dict(engine="stagewise"), ">= 2"),
        ([f], dict(device_condense=True, u_min=None), "input boxes"),
    ]
    for models, extra, match in cases:
        with pytest.raises(ValueError, match=match):
            RobustNMPC(models, **{**_KW, **extra}, device=CPU)
    with pytest.raises(ValueError, match="both state bounds"):
        RobustNMPC([f], **{**kw, "x_max": None}, u_min=np.array([-1.0]),
                   u_max=np.array([1.0]), device_condense=True, device=CPU)
    # soft state boxes are supported on the device path
    RobustNMPC([f], device_condense=True, soft_state=1e3, **_KW, device=CPU)
    robust = RobustNMPC([f], **_KW, device=CPU)
    robust.step(np.array([1.0, 0.0], dtype=np.float32))
    assert robust.plans is not None
    robust.reset()
    assert robust.plans is None and robust._y is None
