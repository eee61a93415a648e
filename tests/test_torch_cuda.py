"""The CUDA kernel against its plain torch version, on the card.

Every test here needs a CUDA device and skips without one. This file
imports no jax, so it runs on the machine with the card (which has none):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import tpu_gpad_torch as tg
from tpu_gpad_torch.solver import core, kernels

pytestmark = pytest.mark.cuda

ITERS = 100
TOL = 1e-4  # fp32 sums in another order than cuBLAS's over 100 iterations


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _data(dev, n=3, N=10):
    return tg.dualize(tg.condense(tg.problems.battery(n, N)), ITERS,
                      paired="auto", device=dev)


def _inputs(data, B, seed=0):
    X0 = np.random.default_rng(seed).uniform(-0.4, 0.4, (B, data.n_x))
    return core.affine_params(
        data, torch.as_tensor(X0, dtype=torch.float32, device=data.device))


def _both(data, g_P, p_D, y0=None, diagnostics=True, iterations=ITERS):
    kw = dict(iterations=iterations, diagnostics=diagnostics)
    out_k = kernels.gpad_fixed_paired_flat(data, g_P, p_D, y0, **kw)
    out_p = kernels.gpad_fixed_paired_flat_torch(data, g_P, p_D, y0, **kw)
    torch.cuda.synchronize()
    return out_k, out_p


def _assert_close(out_k, out_p):
    for name, a, b in zip(("z", "y", "w", "zhat"), out_k, out_p):
        if b is None:
            assert a is None, name
            continue
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a, b, atol=TOL, rtol=0, msg=name)


@pytest.mark.parametrize(
    "case", ["cold", "warm_shared", "warm_one_row", "warm_per_scenario",
             "no_diagnostics", "soft", "B1", "B5", "B33"])
def test_kernel_matches_plain(dev, case):
    data = _data(dev)
    B = {"B1": 1, "B5": 5, "B33": 33}.get(case, 256)
    g_P, p_D = _inputs(data, B, seed=B)
    rng = np.random.default_rng(1)
    y0 = None
    if case == "warm_shared":
        y0 = rng.uniform(0, 0.5, (2, data.m_half))
    elif case == "warm_one_row":
        y0 = rng.uniform(0, 0.5, (1, 2, data.m_half))
    elif case in ("warm_per_scenario", "B1", "B5", "B33"):
        y0 = rng.uniform(0, 0.5, (B, 2, data.m_half))
    if y0 is not None:
        y0 = torch.as_tensor(y0, dtype=torch.float32, device=dev)
    if case == "soft":
        data = dataclasses.replace(data, soft_damp=torch.as_tensor(
            rng.uniform(0, 0.2, data.m_half), dtype=torch.float32, device=dev))
    out_k, out_p = _both(data, g_P, p_D, y0, diagnostics=case != "no_diagnostics")
    _assert_close(out_k, out_p)


def test_kernel_near_shared_memory_limit(dev):
    data = _data(dev, 5, 20)
    g_P, p_D = _inputs(data, 1024, seed=2)
    _assert_close(*_both(data, g_P, p_D))


def test_kernel_zero_iterations(dev):
    data = _data(dev)
    g_P, p_D = _inputs(data, 4)
    y0 = torch.rand((4, 2, data.m_half), device=dev)
    z, y, w, zhat = kernels.gpad_fixed_paired_flat(data, g_P, p_D, y0, iterations=0)
    torch.cuda.synchronize()
    assert not z.any() and not w.any() and not zhat.any()
    torch.testing.assert_close(y, y0, rtol=0, atol=0)


def test_solve_batch_routes_through_kernel(dev):
    data = _data(dev)
    X0 = torch.rand((64, data.n_x), device=dev) * 0.8 - 0.4
    before = kernels.PAIRED_FLAT_LAUNCHES
    res = tg.solve_batch(data, X0)
    assert kernels.PAIRED_FLAT_LAUNCHES == before + 1
    ref = tg.solve_batch(data, X0, tg.SolverConfig(engine="torch", form="mvp"))
    for name in ("u", "z", "y", "residual", "gap"):
        torch.testing.assert_close(getattr(res, name), getattr(ref, name),
                                   atol=TOL, rtol=0, msg=name)
    assert res.iterations.dtype == torch.int32 and res.converged.all()


def test_controller_routes_through_kernel(dev):
    ctl = tg.Controller(tg.problems.battery(3, 10), device=dev)
    before = kernels.PAIRED_FLAT_LAUNCHES
    x = np.random.default_rng(3).uniform(-0.4, 0.4, (16, 3)).astype(np.float32)
    for _ in range(3):
        u = ctl.step(x)
    assert kernels.PAIRED_FLAT_LAUNCHES == before + 3
    assert u.shape == (16, 3) and np.isfinite(u).all()


def test_forced_cuda_engine_refuses_unserved_cases(dev):
    data = _data(dev)
    X0 = torch.zeros((2, data.n_x), device=dev)
    with pytest.raises(ValueError, match="engine='cuda'"):
        tg.solve_batch(data, X0, tg.SolverConfig(engine="cuda", form="dual"))
    dense = tg.dualize(tg.condense(tg.problems.battery(3, 10)), ITERS,
                       paired=False, device=dev)
    with pytest.raises(ValueError, match="engine='cuda'"):
        tg.solve_batch(dense, X0, tg.SolverConfig(engine="cuda"))
    assert core.resolve_engine(dense, tg.SolverConfig()) == "torch"
