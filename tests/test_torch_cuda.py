"""The CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device and skips without one. This file
imports no jax, so it runs on the machine with the card (which has none):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import tpu_gpad_torch as tg
from tpu_gpad_torch.solver import core, dual_kernels, kernels

pytestmark = pytest.mark.cuda

ITERS = 100
TOL = 1e-4  # fp32 sums in another order than cuBLAS's over 100 iterations
# Restart decisions near r = 0 may differ between kernel and plain version
# and part the trajectories for a while: restart runs are compared on u and
# z at tpu_gpad's pallas-vs-xla restart bound (tests/test_restart.py).
RESTART_TOL = 5e-5


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
        tg.solve_batch(data, X0, tg.SolverConfig(engine="cuda", form="mvp",
                                                 restart=True))
    # the flagship's forced dual, eps and restart solves ride the tiled
    # kernels, soft rows or not (the tiled kernels carry the damp column)
    flagship = tg.dualize(tg.condense(tg.problems.battery(30, 30)), 10,
                          paired="auto", device=dev)
    X30 = torch.zeros((2, flagship.n_x), device=dev)
    served = (tg.SolverConfig(engine="cuda", form="dual"),
              tg.SolverConfig(engine="cuda", mode="eps", restart=True),
              tg.SolverConfig(engine="cuda", restart=True))
    for cfg in served:
        assert torch.isfinite(tg.solve_batch(flagship, X30, cfg).u).all()
    assert core.resolve_engine(flagship, tg.SolverConfig(restart=True)) == "cuda"
    soft30 = dataclasses.replace(flagship, soft_damp=torch.full(
        (flagship.m_half,), 0.1, device=dev))
    for cfg in served + (tg.SolverConfig(engine="cuda", form="mvp"),):
        assert torch.isfinite(tg.solve_batch(soft30, X30, cfg).u).all()
    assert core.resolve_engine(soft30, tg.SolverConfig(restart=True)) == "cuda"
    dense = tg.dualize(tg.condense(tg.problems.battery(3, 10)), ITERS,
                       paired=False, device=dev)
    soft = dataclasses.replace(dense, soft_damp=torch.full(
        (dense.m,), 0.1, device=dev))
    for d, cfg in ((dense, tg.SolverConfig(engine="cuda", restart=True)),
                   (dense, tg.SolverConfig(engine="cuda", mode="eps")),
                   (soft, tg.SolverConfig(engine="cuda"))):
        with pytest.raises(ValueError, match="engine='cuda'"):
            tg.solve_batch(d, X0, cfg)
    assert core.resolve_engine(dense, tg.SolverConfig(restart=True)) == "torch"
    assert core.resolve_engine(soft, tg.SolverConfig()) == "torch"


def _dense_data(dev, n=3, N=10):
    return tg.dualize(tg.condense(tg.problems.battery(n, N)), ITERS,
                      paired=False, device=dev)


def _dense_both(data, g_P, p_D, y0=None, diagnostics=True):
    kw = dict(iterations=ITERS, diagnostics=diagnostics)
    before = kernels.DENSE_LAUNCHES
    out_k = kernels.gpad_fixed_dense(data, g_P, p_D, y0, **kw)
    assert kernels.DENSE_LAUNCHES == before + 1
    out_p = kernels.gpad_fixed_dense_torch(data, g_P, p_D, y0, **kw)
    torch.cuda.synchronize()
    return out_k, out_p


@pytest.mark.parametrize(
    "case", ["cold", "warm_shared", "warm_one_row", "warm_per_scenario",
             "no_diagnostics", "B1", "B5", "B33", "near_guard"])
def test_dense_kernel_matches_plain(dev, case):
    data = _dense_data(dev, 3, 20) if case == "near_guard" else _dense_data(dev)
    B = {"B1": 1, "B5": 5, "B33": 33}.get(case, 256)
    g_P, p_D = _inputs(data, B, seed=B)
    rng = np.random.default_rng(5)
    y0 = None
    if case == "warm_shared":
        y0 = rng.uniform(0, 0.5, (data.m,))
    elif case == "warm_one_row":
        y0 = rng.uniform(0, 0.5, (1, data.m))
    elif case in ("warm_per_scenario", "B1", "B5", "B33"):
        y0 = rng.uniform(0, 0.5, (B, data.m))
    if y0 is not None:
        y0 = torch.as_tensor(y0, dtype=torch.float32, device=dev)
    _assert_close(*_dense_both(data, g_P, p_D, y0,
                               diagnostics=case != "no_diagnostics"))


def _paired_both(data, g_P, p_D, y0=None, diagnostics=True):
    kw = dict(iterations=ITERS, diagnostics=diagnostics)
    before = kernels.PAIRED_LAUNCHES
    out_k = kernels.gpad_fixed_paired(data, g_P, p_D, y0, **kw)
    assert kernels.PAIRED_LAUNCHES == before + 1
    out_p = kernels.gpad_fixed_paired_torch(data, g_P, p_D, y0, **kw)
    torch.cuda.synchronize()
    return out_k, out_p


@pytest.mark.parametrize(
    "case", ["cold", "warm_shared", "warm_per_scenario", "no_diagnostics",
             "soft", "B1", "B5"])
def test_paired_kernel_matches_plain(dev, case):
    data = _data(dev)
    B = {"B1": 1, "B5": 5}.get(case, 256)
    g_P, p_D = _inputs(data, B, seed=B)
    rng = np.random.default_rng(6)
    y0 = None
    if case == "warm_shared":
        y0 = rng.uniform(0, 0.5, (2, data.m_half))
    elif case in ("warm_per_scenario", "B1", "B5"):
        y0 = rng.uniform(0, 0.5, (B, 2, data.m_half))
    if y0 is not None:
        y0 = torch.as_tensor(y0, dtype=torch.float32, device=dev)
    if case == "soft":
        data = dataclasses.replace(data, soft_damp=torch.as_tensor(
            rng.uniform(0, 0.2, data.m_half), dtype=torch.float32, device=dev))
    _assert_close(*_paired_both(data, g_P, p_D, y0,
                                diagnostics=case != "no_diagnostics"))


# Launch plans of the paired kernels (log2_tile, split cap; None: the pick)
PAIRED_PLANS = [(None, None), (0, None), (1, None), (2, None), (3, None),
                (4, None), (4, 1), (1, 2), (0, 1)]
PAIRED_CASES = {  # B, warm start, soft rows
    "B4096_cold": (4096, None, False),
    "B256_warm": (256, "per_scenario", False),
    "B300_warm_shared": (300, "shared", False),
    "B5_soft": (5, "per_scenario", True),
    "B1": (1, "per_scenario", False),
}


def _paired_case(data, case, seed):
    B, warm, soft = PAIRED_CASES[case]
    g_P, p_D = _inputs(data, B, seed=B + seed)
    rng = np.random.default_rng(seed)
    y0 = None
    if warm is not None:
        rows = B if warm == "per_scenario" else 1
        y0 = torch.as_tensor(rng.uniform(0, 0.5, (rows, 2, data.m_half)),
                             dtype=torch.float32, device=data.device)
    if soft:
        data = dataclasses.replace(data, soft_damp=torch.as_tensor(
            rng.uniform(0, 0.2, data.m_half), dtype=torch.float32,
            device=data.device))
    return data, g_P, p_D, y0


@pytest.mark.parametrize("plan", PAIRED_PLANS, ids=lambda p: (
    "pick" if p[0] is None else f"tile{1 << p[0]}_split{p[1]}"))
@pytest.mark.parametrize("case", list(PAIRED_CASES))
@pytest.mark.parametrize("kernel", ["paired_flat", "paired"])
def test_paired_kernel_plans_match_plain(dev, kernel, case, plan):
    """Both paired instances at every plan against the plain version: the
    headline and serving batches, a partial last tile, soft rows, one
    scenario."""
    data, g_P, p_D, y0 = _paired_case(_data(dev), case, seed=8)
    kw = dict(iterations=ITERS)
    out_k = getattr(kernels, f"gpad_fixed_{kernel}")(
        data, g_P, p_D, y0, log2_tile=plan[0], split=plan[1], **kw)
    out_p = getattr(kernels, f"gpad_fixed_{kernel}_torch")(data, g_P, p_D, y0,
                                                           **kw)
    torch.cuda.synchronize()
    _assert_close(out_k, out_p)


@pytest.mark.parametrize("kernel", ["paired_flat", "paired"])
def test_paired_kernels_diagnostics_off_and_zero_iterations(dev, kernel):
    """diagnostics=False leaves z and y bit for bit; an empty loop returns
    y0 and zeros, at the serving plan (2 per block)."""
    data, g_P, p_D, y0 = _paired_case(_data(dev), "B256_warm", seed=9)
    fn = getattr(kernels, f"gpad_fixed_{kernel}")
    on = fn(data, g_P, p_D, y0, iterations=ITERS)
    off = fn(data, g_P, p_D, y0, iterations=ITERS, diagnostics=False)
    assert off[2] is None and off[3] is None
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    z, y, w, zhat = fn(data, g_P, p_D, y0, iterations=0)
    torch.cuda.synchronize()
    assert not z.any() and not w.any() and not zhat.any()
    torch.testing.assert_close(y, y0, rtol=0, atol=0)


def _synthetic_paired(dev, m_h, n_z, n_s, seed):
    """Paired data of any shape: battery n3 N10's schedule, L = 2 and
    GL_T = MG_T', with MG_T random and small enough (spectral norm about
    0.5) that the iteration stays bounded; a flat stack's rows [n_s:] are
    its box rows, 0.5 I in MG_T, so that its q = zhat / L."""
    rng = np.random.default_rng(seed)
    MG = rng.uniform(-1.0, 1.0, (m_h, n_z))
    MG *= 0.5 / np.linalg.norm(MG, 2)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    if n_s < m_h:  # the identity block of a flat stack, as I / L
        MG[n_s:] = 0.5 * np.eye(n_z)
    return dataclasses.replace(_data(dev), MG_T=as_t(MG),
                               GL_T=as_t(np.ascontiguousarray(MG.T)),
                               L=as_t(2.0), n_struct=n_s, D=None)


@pytest.mark.parametrize("shape", [(1700, 8, 1692, "paired_flat"),
                                   (1700, 8, 1700, "paired"),
                                   (89, 317, 89, "paired")],
                         ids=["flat_past_registers", "full_past_registers",
                              "full_unpadded"])
@pytest.mark.parametrize("B", [1, 3])
def test_paired_kernels_near_their_guards(dev, shape, B):
    """Shapes only the fallbacks take: 1700 dual rows, past the block's
    registers at one scenario (the rest of the state in device memory),
    and the full instance at m_h 89, n_z 317, which fits shared memory
    only unpadded."""
    m_h, n_z, n_s, kernel = shape
    data = _synthetic_paired(dev, m_h, n_z, n_s, seed=B)
    plan = kernels._paired_plan(m_h, n_z, n_s, B)
    assert plan.log2_tile == 0
    assert (plan.vec == 1) == (shape[2:] == (89, "paired"))
    rng = np.random.default_rng(B)
    g_P = torch.as_tensor(rng.uniform(-0.2, 0.2, (B, n_z)),
                          dtype=torch.float32, device=dev)
    # both offsets negative: every box holds 0, so the duals stay bounded
    p_D = torch.as_tensor(-rng.uniform(0.01, 0.2, (B, 2, m_h)),
                          dtype=torch.float32, device=dev)
    y0 = torch.rand((B, 2, m_h), device=dev) * 0.2
    kw = dict(iterations=ITERS)
    out_k = getattr(kernels, f"gpad_fixed_{kernel}")(data, g_P, p_D, y0, **kw)
    out_p = getattr(kernels, f"gpad_fixed_{kernel}_torch")(data, g_P, p_D, y0,
                                                           **kw)
    torch.cuda.synchronize()
    _assert_close(out_k, out_p)


def test_dense_and_paired_solves_route_through_kernels(dev):
    dense = _dense_data(dev)
    X0 = torch.rand((64, dense.n_x), device=dev) * 0.8 - 0.4
    y_warm = torch.rand((64, dense.m), device=dev) * 0.1
    for d, cfg, counter in (
            (dense, tg.SolverConfig(), "DENSE_LAUNCHES"),
            (_data(dev), tg.SolverConfig(form="mvp", flat="off"),
             "PAIRED_LAUNCHES")):
        assert core.resolve_engine(d, cfg) == "cuda"
        for y0 in (None, y_warm if d is dense else None):
            before = getattr(kernels, counter)
            res = tg.solve_batch(d, X0, cfg, y0=y0)
            assert getattr(kernels, counter) == before + 1
            ref = tg.solve_batch(d, X0, dataclasses.replace(cfg, engine="torch"),
                                 y0=y0)
            for name in ("u", "z", "y", "residual", "gap"):
                torch.testing.assert_close(getattr(res, name), getattr(ref, name),
                                           atol=TOL, rtol=0, msg=name)


def _dual_both(data, g_P, p_D, y0=None, **kw):
    out_k = dual_kernels.gpad_fixed_dual(data, g_P, p_D, y0, **kw)
    out_p = dual_kernels.gpad_fixed_dual_torch(data, g_P, p_D, y0, **kw)
    torch.cuda.synchronize()
    return out_k, out_p


@pytest.mark.parametrize(
    "case", ["cold", "warm_shared", "warm_per_scenario", "no_diagnostics",
             "soft", "B1", "B5", "restart_cold", "restart_warm",
             "restart_past_schedule"])
def test_dual_kernel_matches_plain(dev, case):
    data = _data(dev)
    B = {"B1": 1, "B5": 5}.get(case, 256)
    g_P, p_D = _inputs(data, B, seed=B)
    rng = np.random.default_rng(2)
    y0 = None
    if case == "warm_shared":
        y0 = rng.uniform(0, 0.5, (2, data.m_half))
    elif case in ("warm_per_scenario", "B1", "B5", "restart_warm"):
        y0 = rng.uniform(0, 0.5, (B, 2, data.m_half))
    if y0 is not None:
        y0 = torch.as_tensor(y0, dtype=torch.float32, device=dev)
    if case == "soft":
        data = dataclasses.replace(data, soft_damp=torch.as_tensor(
            rng.uniform(0, 0.2, data.m_half), dtype=torch.float32, device=dev))
    restart = case.startswith("restart")
    kw = dict(iterations=ITERS + 50 if case == "restart_past_schedule" else ITERS,
              restart=restart, diagnostics=case != "no_diagnostics")
    before = dual_kernels.DUAL_LAUNCHES
    out_k, out_p = _dual_both(data, g_P, p_D, y0, **kw)
    assert dual_kernels.DUAL_LAUNCHES == before + 1
    if not restart:
        _assert_close(out_k, out_p)
        return
    assert all(bool(torch.isfinite(t).all()) for t in out_k)
    torch.testing.assert_close(out_k[0], out_p[0], atol=RESTART_TOL, rtol=0)


@pytest.mark.parametrize("restart", [False, True], ids=["plain", "restart"])
def test_dual_chunk_kernel_matches_plain(dev, restart):
    """One chunk of 10 from k0 = 30 on the state 30 iterations left."""
    data = _data(dev)
    g_P, p_D = _inputs(data, 256, seed=4)
    c = dual_kernels.relu_offsets(data, g_P, p_D)
    y = torch.zeros((256, 2, data.m_half), device=dev)
    state = dual_kernels.gpad_dual_chunk_torch(
        data, c, y, y, torch.zeros((256, data.m_half), device=dev),
        torch.ones((256, 2), device=dev), k0=0, chunk=30, restart=restart)[:4]
    before = dual_kernels.DUAL_CHUNK_LAUNCHES
    out_k = dual_kernels.gpad_dual_chunk(data, c, *state, k0=30, chunk=10,
                                         restart=restart)
    out_p = dual_kernels.gpad_dual_chunk_torch(data, c, *state, k0=30,
                                               chunk=10, restart=restart)
    torch.cuda.synchronize()
    assert dual_kernels.DUAL_CHUNK_LAUNCHES == before + 1
    tol = RESTART_TOL if restart else TOL
    for name, a, b in zip(("y", "y_prev", "s", "mom", "w"), out_k, out_p):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        if not restart or name == "s":
            torch.testing.assert_close(a, b, atol=tol, rtol=0, msg=name)


def test_restart_and_eps_route_through_dual_kernels(dev):
    data = _data(dev)
    X0 = torch.rand((64, data.n_x), device=dev) * 0.8 - 0.4
    before = dual_kernels.DUAL_LAUNCHES
    res = tg.solve_batch(data, X0, tg.SolverConfig(iterations=80, restart=True))
    assert dual_kernels.DUAL_LAUNCHES == before + 1
    ref = tg.solve_batch(data, X0, tg.SolverConfig(iterations=80, restart=True,
                                                   engine="torch"))
    torch.testing.assert_close(res.u, ref.u, atol=RESTART_TOL, rtol=0)
    for cfg in (tg.SolverConfig(form="dual"), tg.SolverConfig(flat="off")):
        before = dual_kernels.DUAL_LAUNCHES
        res = tg.solve_batch(data, X0, cfg)
        assert dual_kernels.DUAL_LAUNCHES == before + 1
        ref = tg.solve_batch(data, X0, dataclasses.replace(cfg, engine="torch"))
        torch.testing.assert_close(res.u, ref.u, atol=TOL, rtol=0)
    before = dual_kernels.DUAL_CHUNK_LAUNCHES
    res = tg.solve_to_accuracy(data, X0, tol=1e-5)
    # one launch per window of 10, up to the last scenario's convergence
    windows = -(-int(res.iterations.max()) // 10)
    assert dual_kernels.DUAL_CHUNK_LAUNCHES - before == windows > 0
    assert res.converged.all() and res.residual.max() <= 1e-5 + 1e-6
    ref = tg.solve_to_accuracy(data, X0, tol=1e-5, engine="torch")
    assert (res.iterations - ref.iterations).abs().max() <= 10
    torch.testing.assert_close(res.u, ref.u, atol=2e-4, rtol=0)


# ---------------------------------------------------------------------------
# every launch plan of the register-tiled dense and dual kernels
# ---------------------------------------------------------------------------

# (log2_tile, split cap): each tile width the kernels instantiate, with the
# split-K parts as picked and capped at 1 (the dense kernel's register
# epilogue); None: the picks for the batch
PLANS = [None, (0, None), (0, 1), (1, None), (2, None), (3, None), (3, 1),
         (4, None), (5, None), (5, 1)]


def _plan_id(plan):
    return "pick" if plan is None else f"tile{1 << plan[0]}_split{plan[1]}"


@pytest.mark.parametrize("plan", PLANS, ids=_plan_id)
@pytest.mark.parametrize("shape,B", [((3, 10), 256), ((3, 10), 4096),
                                     ((3, 7), 300)],
                         ids=["n3N10_B256", "n3N10_B4096", "n3N7_B300"])
def test_dense_kernel_plans_match_plain(dev, shape, B, plan):
    """battery n3 N7 (m 98, n_z 21): rows not a multiple of 4, and a
    ragged last tile at every width."""
    data = _dense_data(dev, *shape)
    g_P, p_D = _inputs(data, B, seed=B + 11)
    y0 = torch.rand((B, data.m), device=dev) * 0.5
    log2_tile, split = plan or (None, None)
    kw = dict(iterations=ITERS, log2_tile=log2_tile, split=split)
    out_k = kernels.gpad_fixed_dense(data, g_P, p_D, y0, **kw)
    out_p = kernels.gpad_fixed_dense_torch(data, g_P, p_D, y0,
                                           iterations=ITERS)
    torch.cuda.synchronize()
    _assert_close(out_k, out_p)


def test_dense_kernel_unpadded_near_the_guard(dev):
    """m 98, n_z 289: the first design's carve-up fits one block and the
    padded one does not, so the kernel runs unpadded (vec 1)."""
    base = _dense_data(dev)
    rng = np.random.default_rng(12)
    m, n_z = 98, 289
    data = dataclasses.replace(
        base, MG_T=torch.as_tensor(rng.uniform(-0.01, 0.01, (m, n_z)),
                                   dtype=torch.float32, device=dev),
        GL_T=torch.as_tensor(rng.uniform(-0.01, 0.01, (n_z, m)),
                             dtype=torch.float32, device=dev))
    assert kernels._dense_plan(m, n_z, 64) == kernels.DensePlan(0, 1, 1, 1)
    g_P = torch.as_tensor(rng.uniform(-0.1, 0.1, (64, n_z)),
                          dtype=torch.float32, device=dev)
    p_D = torch.as_tensor(rng.uniform(-0.1, 0.1, (64, m)),
                          dtype=torch.float32, device=dev)
    out_k = kernels.gpad_fixed_dense(data, g_P, p_D, iterations=20)
    out_p = kernels.gpad_fixed_dense_torch(data, g_P, p_D, iterations=20)
    torch.cuda.synchronize()
    _assert_close(out_k, out_p)


# the dual kernels keep a thread's share of the state in registers: at m_h
# 70, 32 scenarios per block is past it
DUAL_PLANS = [p for p in PLANS if p is None or p[0] <= 4]


@pytest.mark.parametrize("plan", DUAL_PLANS, ids=_plan_id)
@pytest.mark.parametrize("case", ["n3N10_B256", "n3N10_B4096_restart",
                                  "n3N7_B300_soft", "n3N7_B300_restart_soft"])
def test_dual_kernel_plans_match_plain(dev, case, plan):
    """battery n3 N7 (m_h 49): rows not a multiple of 4, a ragged last
    tile at every width, soft rows and restart. The warm start and the
    soft damping come from a seeded generator; restart runs are held
    scenario by scenario (_assert_restart_close)."""
    data = _data(dev, 3, 7) if "n3N7" in case else _data(dev)
    B = int(case.split("_B")[1].split("_")[0])
    gen = torch.Generator(device=dev).manual_seed(B + 17)
    if "soft" in case:
        data = dataclasses.replace(data, soft_damp=torch.rand(
            data.m_half, device=dev, generator=gen) * 0.2)
    restart = "restart" in case
    g_P, p_D = _inputs(data, B, seed=B + 13)
    y0 = torch.rand((B, 2, data.m_half), device=dev, generator=gen) * 0.5
    log2_tile, split = plan or (None, None)
    kw = dict(iterations=ITERS, restart=restart)
    out_k = dual_kernels.gpad_fixed_dual(data, g_P, p_D, y0, log2_tile=log2_tile,
                                         split=split, **kw)
    out_p = dual_kernels.gpad_fixed_dual_torch(data, g_P, p_D, y0, **kw)
    torch.cuda.synchronize()
    if not restart:
        _assert_close(out_k, out_p)
        return
    assert all(bool(torch.isfinite(t).all()) for t in out_k)
    _assert_restart_close(out_k[0], out_p[0])


@pytest.mark.parametrize("plan", DUAL_PLANS, ids=_plan_id)
@pytest.mark.parametrize("restart", [False, True], ids=["plain", "restart"])
def test_dual_chunks_compose_at_every_plan(dev, restart, plan):
    """Ten windows of 10 at B 300 (n3 N10) give the whole launch's state,
    and a window holds its plain version."""
    data = _data(dev)
    B = 300
    g_P, p_D = _inputs(data, B, seed=17)
    c = dual_kernels.relu_offsets(data, g_P, p_D)
    log2_tile, split = plan or (None, None)
    over = dict(log2_tile=log2_tile, split=split)
    y = torch.zeros((B, 2, data.m_half), device=dev)
    state = (y, y, torch.zeros((B, data.m_half), device=dev),
             torch.ones((B, 2), device=dev))
    for k0 in range(0, ITERS, 10):
        before = state
        *state, w = dual_kernels.gpad_dual_chunk(data, c, *state, k0=k0,
                                                 chunk=10, restart=restart,
                                                 **over)
        if k0 == 50 and not restart:
            ref = dual_kernels.gpad_dual_chunk_torch(
                data, c, *before, k0=k0, chunk=10)
            for a, b in zip((*state, w), ref):
                torch.testing.assert_close(a, b, atol=TOL, rtol=0)
    z, y_f, w_f, _ = dual_kernels.gpad_fixed_dual(
        data, g_P, p_D, iterations=ITERS, restart=restart, **over)
    torch.cuda.synchronize()
    z_c = -(state[2] @ data.MG_T) - g_P
    torch.testing.assert_close(z_c, z, atol=RESTART_TOL if restart else TOL,
                               rtol=0)
    if not restart:
        torch.testing.assert_close(state[0], y_f, atol=TOL, rtol=0)
        torch.testing.assert_close(w, w_f, atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# the tiled kernels (csrc/gpad_dual_tiled.cu, csrc/gpad_flat_tiled.cu)
# ---------------------------------------------------------------------------

_TILED_DATA = {}


def _tiled_data(dev, n, N):
    """battery n N10 data, built once per shape: 30x30 is the flagship (m_h
    1830), 5x30 (m_h 330) just past the resident dual guard."""
    if (n, N) not in _TILED_DATA:
        _TILED_DATA[n, N] = _data(dev, n, N)
    return _TILED_DATA[n, N]


TILED_CASES = {
    # case: (battery shape, B, warm start, restart, diagnostics, tile,
    # blocks per cluster; None: the picks)
    "flagship_cold": ((30, 30), 256, None, False, True, None, None),
    "flagship_warm": ((30, 30), 256, "per_scenario", False, True, None, None),
    "flagship_warm_shared": ((30, 30), 33, "shared", False, True, None, None),
    "flagship_restart": ((30, 30), 256, None, True, True, None, None),
    "flagship_no_diagnostics": ((30, 30), 33, "per_scenario", False, False,
                                None, None),
    "flagship_B1": ((30, 30), 1, "per_scenario", False, True, None, None),
    "flagship_B1_restart": ((30, 30), 1, "per_scenario", True, True, None,
                            None),
    "flagship_B5": ((30, 30), 5, None, True, True, None, None),
    "flagship_B33": ((30, 30), 33, None, False, True, None, None),
    # 300 = 18 x 16 + 12: the last cluster's tile is partial
    "flagship_B300": ((30, 30), 300, "per_scenario", False, True, None, None),
    "flagship_B300_warm_restart": ((30, 30), 300, "per_scenario", True, True,
                                   None, None),
    "flagship_B300_cluster16": ((30, 30), 300, None, False, True, None, 16),
    "n5N30": ((5, 30), 256, None, False, True, None, None),
    "n5N30_restart": ((5, 30), 256, "per_scenario", True, True, None, None),
    "n3N10_tile1": ((3, 10), 33, None, False, True, 0, None),
    "n3N10_tile8": ((3, 10), 33, "per_scenario", True, True, 3, None),
    # m_h 70: some blocks of a cluster own no columns
    "n3N10_tile16_cluster16": ((3, 10), 33, "per_scenario", False, True, 4,
                               16),
    "n3N10_tile1_cluster1": ((3, 10), 33, None, True, True, 0, 1),
    "n3N10_tile2_cluster2": ((3, 10), 33, "shared", False, True, 1, 2),
    # one block a cluster: the products' rows in one group (the flat tiled
    # kernel's columns summed whole in a thread or a fragment)
    "flagship_B1_cluster1": ((30, 30), 1, None, False, True, None, 1),
}


def _tiled_args(dev, case):
    shape, B, warm, restart, diagnostics, tile, cluster = TILED_CASES[case]
    data = _tiled_data(dev, *shape)
    g_P, p_D = _inputs(data, B, seed=B + 7)
    y0 = None
    if warm is not None:
        rows = B if warm == "per_scenario" else 1
        y0 = torch.rand((rows, 2, data.m_half), device=dev) * 0.5
    return data, g_P, p_D, y0, restart, diagnostics, tile, cluster


@pytest.mark.parametrize("case", list(TILED_CASES))
def test_dual_tiled_kernel_matches_plain(dev, case):
    data, g_P, p_D, y0, restart, diagnostics, tile, cluster = _tiled_args(
        dev, case)
    kw = dict(iterations=ITERS, restart=restart, diagnostics=diagnostics)
    before = dual_kernels.DUAL_TILED_LAUNCHES
    out_k = dual_kernels.gpad_fixed_dual_tiled(data, g_P, p_D, y0,
                                               log2_tile=tile, cluster=cluster,
                                               **kw)
    assert dual_kernels.DUAL_TILED_LAUNCHES == before + 1
    out_p = dual_kernels.gpad_fixed_dual_torch(data, g_P, p_D, y0, **kw)
    torch.cuda.synchronize()
    if not restart:
        _assert_close(out_k, out_p)
        return
    assert all(bool(torch.isfinite(t).all()) for t in out_k if t is not None)
    _assert_restart_close(out_k[0], out_p[0])


def _assert_restart_close(a, b):
    """Restart runs scenario by scenario: a restart decision is the sign of
    a sum that float32 rounding may flip where it is near 0, and a scenario
    whose decision flipped parts from the other run for a while. At most 1%
    of the scenarios (at least one) may part; the rest agree within
    RESTART_TOL (chip_smoke.py's restart_parting holds both against a
    float64 run)."""
    err = (a - b).abs().amax(dim=-1)
    parted = err > RESTART_TOL
    assert int(parted.sum()) <= max(1, a.shape[0] // 100), err.max().item()
    if not parted.all():
        assert err[~parted].max().item() <= RESTART_TOL


@pytest.mark.parametrize("case", [c for c, v in TILED_CASES.items()
                                  if not v[3]])
def test_flat_tiled_kernel_matches_plain(dev, case):
    data, g_P, p_D, y0, _, diagnostics, tile, cluster = _tiled_args(dev, case)
    kw = dict(iterations=ITERS, diagnostics=diagnostics)
    before = kernels.FLAT_TILED_LAUNCHES
    out_k = kernels.gpad_fixed_flat_tiled(data, g_P, p_D, y0, log2_tile=tile,
                                          cluster=cluster, **kw)
    assert kernels.FLAT_TILED_LAUNCHES == before + 1
    out_p = kernels.gpad_fixed_paired_flat_torch(data, g_P, p_D, y0, **kw)
    torch.cuda.synchronize()
    _assert_close(out_k, out_p)


# The flat tiled kernel at every tile and cluster size (log2_tile, blocks
# per cluster) at the flagship and at n5 N30
FLAT_TILED_PLANS = [(t, c) for t in range(5) for c in (4, 8, 16)]


@pytest.mark.parametrize("plan", FLAT_TILED_PLANS,
                         ids=lambda p: f"tile{1 << p[0]}_cluster{p[1]}")
@pytest.mark.parametrize("shape,B", [((30, 30), 256), ((30, 30), 1),
                                     ((30, 30), 300), ((5, 30), 256)],
                         ids=["flagship_B256", "flagship_B1", "flagship_B300",
                              "n5N30_B256"])
def test_flat_tiled_kernel_at_every_plan(dev, shape, B, plan):
    data = _tiled_data(dev, *shape)
    g_P, p_D = _inputs(data, B, seed=B + 11)
    y0 = torch.rand((B, 2, data.m_half), device=dev) * 0.5
    kw = dict(iterations=ITERS)
    out_k = kernels.gpad_fixed_flat_tiled(data, g_P, p_D, y0, log2_tile=plan[0],
                                          cluster=plan[1], **kw)
    out_p = kernels.gpad_fixed_paired_flat_torch(data, g_P, p_D, y0, **kw)
    torch.cuda.synchronize()
    _assert_close(out_k, out_p)


def test_tiled_kernels_diagnostics_off_bit_identical(dev):
    data = _tiled_data(dev, 30, 30)
    g_P, p_D = _inputs(data, 33, seed=3)
    for fn in (dual_kernels.gpad_fixed_dual_tiled, kernels.gpad_fixed_flat_tiled):
        on = fn(data, g_P, p_D, iterations=ITERS)
        off = fn(data, g_P, p_D, iterations=ITERS, diagnostics=False)
        assert off[2] is None and off[3] is None
        assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])


def test_tiled_kernels_zero_iterations(dev):
    data = _tiled_data(dev, 30, 30)
    g_P, p_D = _inputs(data, 4)
    y0 = torch.rand((4, 2, data.m_half), device=dev)
    for fn in (dual_kernels.gpad_fixed_dual_tiled, kernels.gpad_fixed_flat_tiled):
        z, y, w, zhat = fn(data, g_P, p_D, y0, iterations=0)
        torch.cuda.synchronize()
        assert not z.any() and not w.any()
        torch.testing.assert_close(y, y0, rtol=0, atol=0)


@pytest.mark.parametrize("B", [256, 1, 300])
@pytest.mark.parametrize("restart", [False, True], ids=["plain", "restart"])
def test_dual_tiled_chunks(dev, restart, B):
    """One window of 10 from k0 = 30 against the plain version, and ten
    windows against one whole launch (bit for bit: the same body), from a
    warm start; B 1 runs one scenario per cluster, B 300 a partial last
    tile."""
    data = _tiled_data(dev, 30, 30)
    g_P, p_D = _inputs(data, B, seed=4)
    c = dual_kernels.relu_offsets(data, g_P, p_D)
    y0 = torch.rand((B, 2, data.m_half), device=dev) * 0.5
    start = (y0, y0, torch.zeros((B, data.m_half), device=dev),
             torch.ones((B, 2), device=dev))
    state = dual_kernels.gpad_dual_chunk_torch(data, c, *start, k0=0, chunk=30,
                                               restart=restart)[:4]
    before = dual_kernels.DUAL_TILED_CHUNK_LAUNCHES
    out_k = dual_kernels.gpad_dual_tiled_chunk(data, c, *state, k0=30,
                                               chunk=10, restart=restart)
    out_p = dual_kernels.gpad_dual_chunk_torch(data, c, *state, k0=30,
                                               chunk=10, restart=restart)
    torch.cuda.synchronize()
    assert dual_kernels.DUAL_TILED_CHUNK_LAUNCHES == before + 1
    tol = RESTART_TOL if restart else TOL
    for name, a, b in zip(("y", "y_prev", "s", "mom", "w"), out_k, out_p):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        if not restart or name == "s":
            torch.testing.assert_close(a, b, atol=tol, rtol=0, msg=name)
    state = start
    for k0 in range(0, ITERS, 10):
        *state, w = dual_kernels.gpad_dual_tiled_chunk(data, c, *state, k0=k0,
                                                       chunk=10,
                                                       restart=restart)
    z, y, w_f, _ = dual_kernels.gpad_fixed_dual_tiled(data, g_P, p_D, y0,
                                                      iterations=ITERS,
                                                      restart=restart)
    torch.cuda.synchronize()
    assert torch.equal(state[0], y) and torch.equal(w, w_f)
    torch.testing.assert_close(-(state[2] @ data.MG_T) - g_P, z, atol=1e-6,
                               rtol=0)


# Soft (dual-damped) rows through the tiled kernels: a seeded od = 1 -
# soft_damp in [0.5, 1] at n5 N30 (m_h 330, past the resident kernels'
# shared memory) and the flagship, each kernel against its plain version
SOFT_TILED = ["flat_tiled", "paired_tiled", "dual_tiled",
              "dual_tiled_restart", "dual_tiled_chunk",
              "dual_tiled_chunk_restart"]


def _soft(data, damp=None):
    if damp is None:
        gen = torch.Generator().manual_seed(data.m_half)
        damp = torch.rand(data.m_half, generator=gen) * 0.5
    return dataclasses.replace(data, soft_damp=damp.to(data.device))


def _soft_pair(data, kernel, B, y0):
    """The tiled kernel's and its plain version's outputs on ``data``."""
    g_P, p_D = _inputs(data, B, seed=B + 29)
    restart = kernel.endswith("restart")
    if kernel.startswith("dual_tiled_chunk"):
        c = dual_kernels.relu_offsets(data, g_P, p_D)
        state = (y0, y0, torch.zeros((B, data.m_half), device=y0.device),
                 torch.ones((B, 2), device=y0.device))
        kw = dict(k0=30, chunk=10, restart=restart)
        return (dual_kernels.gpad_dual_tiled_chunk(data, c, *state, **kw),
                dual_kernels.gpad_dual_chunk_torch(data, c, *state, **kw))
    kw = dict(iterations=ITERS)
    fns = {"flat_tiled": (kernels.gpad_fixed_flat_tiled,
                          kernels.gpad_fixed_paired_flat_torch),
           "paired_tiled": (kernels.gpad_fixed_paired_tiled,
                            kernels.gpad_fixed_paired_torch)}
    if kernel.startswith("dual_tiled"):
        fns[kernel] = (dual_kernels.gpad_fixed_dual_tiled,
                       dual_kernels.gpad_fixed_dual_torch)
        kw["restart"] = restart
    tiled, plain = fns[kernel]
    return tiled(data, g_P, p_D, y0, **kw), plain(data, g_P, p_D, y0, **kw)


@pytest.mark.parametrize("kernel", SOFT_TILED)
@pytest.mark.parametrize("shape", [(5, 30), (30, 30)],
                         ids=["n5N30", "flagship"])
def test_tiled_kernels_carry_soft_rows(dev, shape, kernel):
    """Each tiled kernel on soft rows against its plain version at B256
    from a warm start: every output within TOL, restart per scenario (z
    of the whole solve; s of a window)."""
    data = _soft(_tiled_data(dev, *shape))
    y0 = torch.rand((256, 2, data.m_half), device=dev) * 0.5
    out_k, out_p = _soft_pair(data, kernel, 256, y0)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(t).all()) for t in out_k if t is not None)
    if kernel == "dual_tiled_restart":
        _assert_restart_close(out_k[0], out_p[0])
    elif kernel == "dual_tiled_chunk_restart":
        _assert_restart_close(out_k[2], out_p[2])
    elif kernel == "dual_tiled_chunk":
        for a, b in zip(out_k, out_p):
            torch.testing.assert_close(a, b, atol=TOL, rtol=0)
    else:
        _assert_close(out_k, out_p)


@pytest.mark.parametrize("kernel", SOFT_TILED)
def test_tiled_kernels_zero_damp_is_the_hard_launch(dev, kernel):
    """soft_damp = 0 (od exactly 1) gives the hard launch's outputs bit for
    bit, at n5 N30 B33 (a partial last tile)."""
    data = _tiled_data(dev, 5, 30)
    y0 = torch.rand((33, 2, data.m_half), device=dev) * 0.5
    hard, _ = _soft_pair(data, kernel, 33, y0)
    soft, _ = _soft_pair(_soft(data, torch.zeros(data.m_half)), kernel, 33,
                         y0)
    torch.cuda.synchronize()
    for a, b in zip(hard, soft):
        assert (a is None and b is None) or torch.equal(a, b)


def test_flagship_routes_through_tiled_kernels(dev):
    data = _tiled_data(dev, 30, 30)
    X0 = torch.rand((64, data.n_x), device=dev) * 0.8 - 0.4
    for cfg, counter in (
            (tg.SolverConfig(restart=True), "DUAL_TILED_LAUNCHES"),
            (tg.SolverConfig(form="dual"), "DUAL_TILED_LAUNCHES"),
            (tg.SolverConfig(engine="cuda", form="mvp"), "FLAT_TILED_LAUNCHES")):
        mod = kernels if counter.startswith("FLAT") else dual_kernels
        before = getattr(mod, counter)
        res = tg.solve_batch(data, X0, cfg)
        assert getattr(mod, counter) == before + 1
        ref = tg.solve_batch(data, X0, dataclasses.replace(cfg, engine="torch"))
        if cfg.restart:
            _assert_restart_close(res.u, ref.u)
        else:
            torch.testing.assert_close(res.u, ref.u, atol=TOL, rtol=0)
    launches = (dual_kernels.DUAL_TILED_LAUNCHES, kernels.FLAT_TILED_LAUNCHES)
    res = tg.solve_batch(data, X0)  # auto: the flat tiled kernel
    assert (dual_kernels.DUAL_TILED_LAUNCHES,
            kernels.FLAT_TILED_LAUNCHES) == (launches[0], launches[1] + 1)
    ref = tg.solve_batch(data, X0, tg.SolverConfig(engine="torch"))
    torch.testing.assert_close(res.u, ref.u, atol=TOL, rtol=0)
    before = dual_kernels.DUAL_TILED_CHUNK_LAUNCHES
    res = tg.solve_to_accuracy(data, X0, tol=1e-4, flat="off")
    windows = -(-int(res.iterations.max()) // 10)
    assert dual_kernels.DUAL_TILED_CHUNK_LAUNCHES - before == windows > 0
    assert res.converged.all() and res.residual.max() <= 1e-4 + 1e-6
    # the same loop on the plain chunk version: a scenario whose restart
    # decision flipped near r = 0 stops at another point within the
    # tolerance; at least 90% agree to 2e-4 (chip_smoke.py, flagship_path)
    cfg = tg.SolverConfig(mode="eps", eps_g=1e-4, eps_V=1e-4, check_every=10,
                          iterations=2000, restart=True, flat="off")
    g_P, p_D = core.affine_params(data, X0)
    ref = dual_kernels.gpad_eps_dual(data, g_P, p_D, cfg,
                                     chunk_fn=dual_kernels.gpad_dual_chunk_torch)
    assert ref.converged.all()
    agree = (res.u - ref.u).abs().amax(dim=-1) < 2e-4
    assert int(agree.sum()) >= 0.9 * X0.shape[0]


# ---------------------------------------------------------------------------
# the stage-wise kernels (csrc/gpad_stagewise.cu)
# ---------------------------------------------------------------------------

from tpu_gpad_torch import stagewise as ts  # noqa: E402
from tpu_gpad_torch import stagewise_kernel as sk  # noqa: E402
from tpu_gpad_torch import stagewise_stream as ss  # noqa: E402

SW_ITERS = 60


def _sw_data(dev, n, N, **kw):
    problem = tg.problems.battery(n, N)
    if "c" in kw:
        problem = dataclasses.replace(problem, c=kw.pop("c"))
    return tg.build_stagewise(problem, iterations=SW_ITERS, device=dev, **kw)


def _sw_both(fn, data, x0, y0=None, restart=False):
    out_k = fn(data, x0, SW_ITERS, restart=restart, y0=y0)
    out_p = sk.stagewise_plain(sk.pack_stagewise_constants(data), x0, y0,
                               iterations=SW_ITERS, restart=restart)
    torch.cuda.synchronize()
    return out_k, out_p


@pytest.mark.parametrize("kernel", ["resident", "stream"])
@pytest.mark.parametrize("case", ["cold", "warm", "warm_shared", "restart",
                                  "affine", "B1", "B5"])
def test_stagewise_kernel_matches_plain(dev, kernel, case):
    fn = sk.solve_stagewise_cuda if kernel == "resident" else ss.solve_stagewise_stream
    if case == "affine":
        data = _sw_data(dev, 3, 7, c=np.array([0.02, -0.01, 0.015]),
                        x_ref=np.full(3, 0.05))
    else:
        data = _sw_data(dev, 8, 24)
    B = {"B1": 1, "B5": 5}.get(case, 64)
    rng = np.random.default_rng(B)
    x0 = torch.as_tensor(rng.uniform(-0.4, 0.4, (B, data.n_x)),
                         dtype=torch.float32, device=dev)
    y0 = None
    if case in ("warm", "B1", "B5"):
        y0 = fn(data, 0.9 * x0, SW_ITERS)[2]
    elif case == "warm_shared":
        y0 = fn(data, 0.9 * x0[:1], SW_ITERS)[2][0]
    launches = (sk.STAGEWISE_LAUNCHES, ss.STAGEWISE_STREAM_LAUNCHES)
    out_k, out_p = _sw_both(fn, data, x0, y0, restart=case == "restart")
    after = (sk.STAGEWISE_LAUNCHES, ss.STAGEWISE_STREAM_LAUNCHES)
    assert after[kernel == "stream"] == launches[kernel == "stream"] + 1
    assert after[kernel != "stream"] == launches[kernel != "stream"]
    tol = RESTART_TOL if case == "restart" else TOL
    for name, a, b in zip(("u0", "zu", "y", "residual", "gap"), out_k, out_p):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        if case != "restart" or name in ("u0", "zu"):
            torch.testing.assert_close(a, b, atol=tol, rtol=0, msg=name)


# (battery n, N, B, y0, restart, chains in shared memory); at n >= 24 the
# segment products alone (2 x 16 n^2 floats) crowd the slabs, so the
# chains read their matrices from device memory; at n8 N60 one scenario a
# block (B5) leaves the L1 room for them, and so does N = 1
RESIDENT_CASES = {
    "n8N60_B1024_cold": (8, 60, 1024, None, False, True),
    "n8N60_B1024_warm": (8, 60, 1024, "per_scenario", False, True),
    "n8N60_B1024_shared_y0": (8, 60, 1024, "shared", False, True),
    "n8N60_B1024_restart": (8, 60, 1024, None, True, True),
    "n8N60_B5": (8, 60, 5, "per_scenario", False, False),
    "n8N60_B1025": (8, 60, 1025, None, False, True),
    "n32": (32, 10, 64, None, False, False),  # every lane of a chain group
    "n24N60": (24, 60, 64, "per_scenario", False, False),
    "N1": (8, 1, 64, None, False, False),
}


@pytest.mark.parametrize("case", list(RESIDENT_CASES))
def test_resident_kernel_at_its_launches(dev, case):
    """The resident kernel (segmented chains over 16 warps, each warp on
    its own stages) against its plain version: the main-path shape cold,
    warm, with one shared dual and under restart; ragged batches; n = 32
    (every lane of a chain group) and n = 24, whose chains read their
    matrices from device memory; N = 1."""
    n, N, B, warm, restart, staged = RESIDENT_CASES[case]
    data = _sw_data(dev, n, N)
    x0 = torch.as_tensor(np.random.default_rng(B).uniform(-0.4, 0.4, (B, n)),
                         dtype=torch.float32, device=dev)
    lay = sk.resident_layout(data, B, sk.sm_count(dev))
    assert lay.chains_in_smem == staged
    y0 = None
    if warm:
        y0 = sk.solve_stagewise_cuda(data, 0.9 * x0, SW_ITERS)[2]
        y0 = y0[0] if warm == "shared" else y0
    before = sk.STAGEWISE_LAUNCHES
    out_k, out_p = _sw_both(sk.solve_stagewise_cuda, data, x0, y0, restart)
    assert sk.STAGEWISE_LAUNCHES == before + 1
    assert all(bool(torch.isfinite(t).all()) for t in out_k)
    if restart:
        _assert_restart_close(out_k[1].flatten(1), out_p[1].flatten(1))
        return
    for name, a, b in zip(("u0", "zu", "y", "residual", "gap"), out_k, out_p):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, atol=TOL, rtol=0, msg=name)


@pytest.mark.parametrize("log2", [0, 2, 3])
def test_resident_kernel_every_block_and_placement(dev, log2):
    """Every launch of a tile: 16 or 8 warps (16 or 8 chain segments), the
    chains' matrices staged in shared memory or read from device memory."""
    data = _sw_data(dev, 8, 24)
    x0 = torch.as_tensor(np.random.default_rng(log2).uniform(
        -0.4, 0.4, (40, 8)), dtype=torch.float32, device=dev)
    ref = sk.stagewise_plain(sk.pack_stagewise_constants(data), x0,
                             iterations=SW_ITERS)
    lays = sk.resident_layouts(data, log2)
    assert len(lays) == 4
    for lay in lays:
        out = sk.solve_stagewise_cuda(data, x0, SW_ITERS, log2_tile=log2,
                                      warps=lay.warps,
                                      chains_in_smem=lay.chains_in_smem)
        torch.cuda.synchronize()
        for name, a, b in zip(("u0", "zu", "y", "residual", "gap"), out, ref):
            torch.testing.assert_close(a, b, atol=TOL, rtol=0,
                                       msg=f"{lay} {name}")


@pytest.mark.parametrize("plant", ["double_integrator", "ltv_n2_p6",
                                   "ltv_n12_p3"])
def test_resident_kernel_with_unequal_state_and_input(dev, plant):
    """n_x != n_u (a warp's scratch is laid out by max(n_x, n_u)): every
    launch of one and of eight scenarios per block against the plain
    version."""
    problem = {
        "double_integrator": lambda: tg.problems.double_integrator(horizon=40),
        "ltv_n2_p6": lambda: tg.problems.random_ltv(n_x=2, n_u=6, horizon=30,
                                                    seed=4),
        "ltv_n12_p3": lambda: tg.problems.random_ltv(n_x=12, n_u=3,
                                                     horizon=33, seed=5),
    }[plant]()
    data = tg.build_stagewise(problem, iterations=SW_ITERS, device=dev)
    x0 = torch.as_tensor(np.random.default_rng(1).uniform(
        -0.3, 0.3, (100, problem.n_x)), dtype=torch.float32, device=dev)
    ref = sk.stagewise_plain(sk.pack_stagewise_constants(data), x0,
                             iterations=SW_ITERS)
    for log2 in (0, 3):
        for lay in sk.resident_layouts(data, log2):
            out = sk.solve_stagewise_cuda(data, x0, SW_ITERS, log2_tile=log2,
                                          warps=lay.warps,
                                          chains_in_smem=lay.chains_in_smem)
            torch.cuda.synchronize()
            for name, a, b in zip(("u0", "zu", "y", "residual", "gap"), out,
                                  ref):
                torch.testing.assert_close(a, b, atol=TOL, rtol=0,
                                           msg=f"{lay} {name}")


@pytest.mark.parametrize("case", ["cold", "warm", "restart", "B1", "B67"])
def test_stream_kernel_at_full_width(dev, case):
    """The streamed kernel at battery n30 N200, the serving batch (64
    plants) cold, warm and under restart, one plant, and 67 (a partial
    last tile)."""
    data = _sw_data(dev, 30, 200)
    B = {"B1": 1, "B67": 67}.get(case, 64)
    x0 = torch.as_tensor(np.random.default_rng(B).uniform(-0.4, 0.4, (B, 30)),
                         dtype=torch.float32, device=dev)
    y0 = None
    if case in ("warm", "B1", "B67"):
        y0 = ss.solve_stagewise_stream(data, 0.9 * x0, SW_ITERS)[2]
    before = ss.STAGEWISE_STREAM_LAUNCHES
    out_k, out_p = _sw_both(ss.solve_stagewise_stream, data, x0, y0,
                            restart=case == "restart")
    assert ss.STAGEWISE_STREAM_LAUNCHES == before + 1
    if case == "restart":
        assert all(bool(torch.isfinite(t).all()) for t in out_k)
        _assert_restart_close(out_k[1].flatten(1), out_p[1].flatten(1))
        return
    for name, a, b in zip(("u0", "zu", "y", "residual", "gap"), out_k, out_p):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        # the gap sums 24,400 rows: its rounding grows with its size
        rtol = 1e-4 if name == "gap" else 0
        torch.testing.assert_close(a, b, atol=TOL, rtol=rtol, msg=name)


def test_stagewise_routes_through_kernels(dev):
    small = _sw_data(dev, 8, 24)
    assert ts.resolve_stagewise_engine(small, 64) == "cuda"
    X0 = torch.rand((64, small.n_x), device=dev) * 0.8 - 0.4
    before = sk.STAGEWISE_LAUNCHES
    res = ts.solve_stagewise(small, X0)
    assert sk.STAGEWISE_LAUNCHES == before + 1
    ref = ts.solve_stagewise(small, X0, engine="torch")
    for name in ("u", "z", "y", "residual", "gap"):
        torch.testing.assert_close(getattr(res, name), getattr(ref, name),
                                   atol=TOL, rtol=0, msg=name)
    # eps mode and runtime parameters ride the torch engine
    before = (sk.STAGEWISE_LAUNCHES, ss.STAGEWISE_STREAM_LAUNCHES)
    ts.solve_stagewise(small, X0, mode="eps", eps_g=1e-3, eps_V=1e-3)
    ts.solve_stagewise(small, X0, q_lin=torch.zeros(small.n_x, device=dev))
    assert (sk.STAGEWISE_LAUNCHES, ss.STAGEWISE_STREAM_LAUNCHES) == before
    # past one block's shared memory: the streamed kernel
    big = tg.build_stagewise(tg.problems.battery(30, 200), iterations=20,
                             device=dev)
    assert not sk.stagewise_fits_smem(big, 1)
    assert ts.resolve_stagewise_engine(big, 4) == "stream"
    with pytest.raises(ValueError, match="stagewise kernel cannot take"):
        ts.solve_stagewise(big, torch.zeros((4, 30), device=dev), engine="cuda")


def test_stagewise_float64_on_the_card_raises_on_kernel_routes(dev):
    small = _sw_data(dev, 8, 24)
    d64 = dataclasses.replace(small, **{
        f: getattr(small, f).double() for f in ts.STAGEWISE_TENSOR_FIELDS})
    X0 = torch.rand((8, small.n_x), device=dev, dtype=torch.float64)
    for engine in ("auto", "cuda", "stream"):
        with pytest.raises(ValueError, match="device='cpu'"):
            ts.solve_stagewise(d64, X0, engine=engine)
    # the torch engine, asked for by name, runs float64 where the data is
    res = ts.solve_stagewise(d64, X0, engine="torch")
    assert res.z.dtype == torch.float64 and bool(torch.isfinite(res.z).all())


def test_stagewise_controller_serves_through_a_kernel(dev):
    ctl = tg.StagewiseController(tg.problems.battery(8, 24), iterations=SW_ITERS,
                                 device=dev)
    x = np.random.default_rng(3).uniform(-0.4, 0.4, (16, 8)).astype(np.float32)
    before = sk.STAGEWISE_LAUNCHES
    for _ in range(3):
        u = ctl.step(x)
    assert sk.STAGEWISE_LAUNCHES == before + 3
    assert u.shape == (16, 8) and np.isfinite(u).all()


# --------------------------------------------------------------------------
# the estimation and robust stacks on the kernels


def _mhe_window(dev, window, engine="torch"):
    """The double integrator (dt 0.1) over one window with state and
    disturbance boxes: 64 windows of noisy position measurements."""
    from tpu_gpad_torch import mhe

    di = tg.problems.double_integrator(dt=0.1)
    A, B, C = np.asarray(di.A), np.asarray(di.B), np.array([[1.0, 0.0]])
    est = mhe.MovingHorizonEstimator(
        A, B, C, window, W=np.diag([1e-4, 4e-3]), V=np.array([[1e-2]]),
        x_min=np.array([-1.2, -0.8]), x_max=np.array([1.2, 0.8]),
        w_min=np.full(2, -0.05), w_max=np.full(2, 0.05), iterations=400,
        device=dev)
    rng = np.random.default_rng(window)
    x = rng.uniform(-0.5, 0.5, (64, 2)) * [1.0, 0.2]
    ys, us = [], []
    for k in range(window):
        ys.append(x @ C.T + rng.normal(0, 0.1, (64, 1)))
        u = 0.4 * np.sin(0.11 * k) - x @ np.array([[0.5], [1.0]])
        us.append(u)
        x = x @ A.T + u @ B.T
    return est, (np.zeros((64, 2)), np.stack(ys, 1), np.stack(us, 1)[:, :-1])


def test_mhe_window_180_on_the_tiled_dual_kernel(dev):
    est, args = _mhe_window(dev, 180)
    assert core.cuda_kernel(est.data, est.config) == "dual_tiled"
    before = dual_kernels.DUAL_TILED_LAUNCHES
    x_k, _ = est.solve_window(*args)
    torch.cuda.synchronize()
    assert dual_kernels.DUAL_TILED_LAUNCHES == before + 1
    est.config = dataclasses.replace(est.config, engine="torch")
    x_t, _ = est.solve_window(*args)
    # restart runs converge to one optimum; x_hat within 1e-4 of its scale
    scale = x_t.abs().max().item()
    torch.testing.assert_close(x_k, x_t, atol=1e-4 * scale, rtol=0)


def test_robust_twin_n8_N60_on_the_streamed_kernel(dev):
    from tpu_gpad_torch import robust, stagewise, stagewise_stream

    nominal = tg.problems.battery(8, 60)
    variants = robust.scenario_problem_variants(
        nominal, B_list=[np.asarray(nominal.B) * s for s in (0.8, 1.0, 1.2)])
    data = tg.build_stagewise(robust.scenario_stagewise_problem(variants),
                              iterations=200, device=dev)
    X = robust.scenario_stagewise_x0(np.random.default_rng(3).uniform(
        -0.4, 0.4, (64, 8)).astype(np.float32), 3)
    assert stagewise.resolve_stagewise_engine(data, 64) == "stream"
    before = stagewise_stream.STAGEWISE_STREAM_LAUNCHES
    r_k = tg.solve_stagewise(data, X)
    torch.cuda.synchronize()
    assert stagewise_stream.STAGEWISE_STREAM_LAUNCHES == before + 1
    r_t = tg.solve_stagewise(data, X, engine="torch")
    torch.testing.assert_close(r_k.z, r_t.z, atol=TOL, rtol=0)


def test_from_qp_restart_serving_on_the_dual_kernel(dev):
    from tpu_gpad_torch import robust

    nominal = tg.problems.battery(3, 10)
    variants = robust.scenario_problem_variants(
        nominal, B_list=[np.asarray(nominal.B) * s for s in (0.8, 1.0, 1.2)])
    qp = robust.scenario_qp([tg.condense(p) for p in variants])
    cfg = tg.SolverConfig(iterations=ITERS, restart=True)
    ctl = tg.Controller.from_qp(qp, config=cfg, device=dev)
    assert core.cuda_kernel(ctl.data, cfg) == "dual"
    x = np.random.default_rng(4).uniform(-0.4, 0.4, (256, 3)).astype(np.float32)
    A, Bm = np.asarray(nominal.A), np.asarray(nominal.B)
    for _ in range(5):
        y0 = ctl._y
        before = dual_kernels.DUAL_LAUNCHES
        u = ctl.step(x)
        assert dual_kernels.DUAL_LAUNCHES == before + 1
        ref = tg.solve_batch(ctl.data, x, dataclasses.replace(
            cfg, engine="torch"), y0=y0)
        du = (ctl.last_result.u - ref.u).abs().amax(dim=1)
        # a restart decision near r = 0 may flip in about 1% of the
        # scenarios (2 of 256) and part them from the torch engine's run
        parted = du > RESTART_TOL
        assert int(parted.sum()) <= 2 and du[~parted].max() <= RESTART_TOL
        x = (x @ A.T + u @ Bm.T).astype(np.float32)


# ---------------------------------------------------------------------------
# the NMPC layer: device condensation on the card, its dual-kernel solves
# ---------------------------------------------------------------------------

NMPC_KW = dict(n_x=2, n_u=1, horizon=25, Q=np.diag([10.0, 1.0]),
               R=np.diag([0.1]), u_min=np.array([-11.0]),
               u_max=np.array([11.0]), iterations=200, sqp_iters=2)
UPRIGHT = np.array([np.pi, 0.0])
# plans from float32 condensation on two devices (cuSOLVER and cuBLAS
# against the host's LAPACK and BLAS), 200 dual-form iterations a pass
NMPC_PLAN_TOL = 1e-3


def _pendulum_linearization(dev, x0=(2.07, 0.0)):
    f = tg.rk4(tg.problems.pendulum_dynamics(), 0.05)
    x = torch.tensor(x0, device=dev)
    us = torch.zeros((NMPC_KW["horizon"], 1), device=dev)
    xs = tg.nonlinear.rollout(f, x, us)
    return tg.nonlinear.linearize(f, torch.cat([x[None], xs[:-1]]), us)


def test_device_pass_on_the_card_matches_the_cpu(dev):
    """The condensed data and the plans of the device-condensed controller
    on the card against the same on the CPU."""
    kw = {k: NMPC_KW[k] for k in ("Q", "R", "u_min", "u_max")}
    on = {d: tg.dualize_ltv_device(*_pendulum_linearization(d), iterations=200,
                                   **kw) for d in (dev, torch.device("cpu"))}
    for f in ("MG_T", "GL_T", "gP_map", "pD_map", "pD_const", "D", "L"):
        torch.testing.assert_close(getattr(on[dev], f).cpu(),
                                   getattr(on[torch.device("cpu")], f),
                                   atol=TOL, rtol=1e-4, msg=f)
    # the dual form without restart: no restart decision to flip between
    # the card's and the host's sums
    cfg = tg.SolverConfig(iterations=200, form="dual")
    f = tg.rk4(tg.problems.pendulum_dynamics(), 0.05)
    card = tg.NMPC(f, **NMPC_KW, config=cfg, device_condense=True, device=dev)
    host = tg.NMPC(f, **NMPC_KW, config=cfg, device_condense=True,
                   device="cpu")
    x = np.array([2.07, 0.0], np.float32)
    for _ in range(3):
        before = dual_kernels.DUAL_LAUNCHES
        u_card = card.plan(x, UPRIGHT)
        assert dual_kernels.DUAL_LAUNCHES == before + NMPC_KW["sqp_iters"]
        np.testing.assert_allclose(u_card, host.plan(x, UPRIGHT),
                                   atol=NMPC_PLAN_TOL, rtol=0)
        x = f(torch.as_tensor(x), torch.as_tensor(u_card[0])).numpy()


@pytest.mark.parametrize("B", [1, 64])
def test_dual_kernel_on_device_condensed_data(dev, B):
    kw = {k: NMPC_KW[k] for k in ("Q", "R", "u_min", "u_max")}
    data = tg.dualize_ltv_device(*_pendulum_linearization(dev), iterations=200,
                                 **kw)
    assert core.cuda_kernel(data, tg.SolverConfig(iterations=200,
                                                  restart=True)) == "dual"
    rng = np.random.default_rng(8)
    P = np.concatenate([np.array([2.07, 0.0]) + rng.uniform(-0.1, 0.1, (B, 2)),
                        np.tile(UPRIGHT, (B, 1))], axis=1)
    g_P, p_D = core.affine_params(data, torch.as_tensor(
        P, dtype=torch.float32, device=dev))
    out_k, out_p = _dual_both(data, g_P, p_D, iterations=200)
    scale = max(1.0, max(t.abs().max().item() for t in out_p))
    for name, a, b in zip(("z", "y", "w", "zhat"), out_k, out_p):
        torch.testing.assert_close(a / scale, b / scale, atol=TOL, rtol=0,
                                   msg=name)
    out_k, out_p = _dual_both(data, g_P, p_D, iterations=200, restart=True)
    du = (out_k[0] - out_p[0]).abs().amax(dim=1)
    parted = du > RESTART_TOL  # a restart decision flipped near r = 0
    assert int(parted.sum()) <= max(1, B // 100)
    if not parted.all():
        assert du[~parted].max() <= RESTART_TOL


@pytest.mark.parametrize("device_condense", [False, True],
                         ids=["host", "device"])
def test_plan_batch_launches_one_dual_kernel_per_plant(dev, device_condense):
    f = tg.rk4(tg.problems.pendulum_dynamics(), 0.05)
    ctrl = tg.NMPC(f, **{**NMPC_KW, "sqp_iters": 1},
                   device_condense=device_condense, device=dev)
    X = np.array([2.07, 0.0]) + np.random.default_rng(0).uniform(
        -0.1, 0.1, (8, 2))
    for _ in range(2):  # cold, then warm
        before = dual_kernels.DUAL_LAUNCHES
        U = ctrl.plan_batch(X, UPRIGHT)
        assert dual_kernels.DUAL_LAUNCHES == before + 8
        assert U.shape == (8, 25, 1) and np.isfinite(U).all()


def test_one_rank_nccl_sharded_solve_is_solve_batch(dev, tmp_path):
    """A one-rank nccl group on the card: solve_batch_sharded at the
    headline (B4096) equals solve_batch exactly, through one launch of the
    flat paired kernel."""
    import torch.distributed as dist

    from tpu_gpad_torch.parallel import (make_mesh, shard_batch,
                                         solve_batch_sharded)

    data = _data(dev)
    X0 = np.random.default_rng(1).uniform(-0.4, 0.4, (4096, 3)).astype(
        np.float32)
    cfg = tg.SolverConfig(iterations=ITERS)
    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh()
        before = kernels.PAIRED_FLAT_LAUNCHES
        out = solve_batch_sharded(data, shard_batch(mesh, X0), cfg, mesh=mesh)
        torch.cuda.synchronize()
        assert kernels.PAIRED_FLAT_LAUNCHES == before + 1
        ref = tg.solve_batch(data, X0, cfg)
        for f in ("u", "z", "y", "residual", "gap"):
            assert torch.equal(getattr(out, f).full_tensor(), getattr(ref, f)), f
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the kernels as registered ops, and AOT artifacts (tpu_gpad_torch.aot)
# ---------------------------------------------------------------------------

_COUNTERS = {"paired_flat": (kernels, "PAIRED_FLAT_LAUNCHES"),
             "dual": (dual_kernels, "DUAL_LAUNCHES"),
             "dual_chunk": (dual_kernels, "DUAL_CHUNK_LAUNCHES"),
             "resident": (sk, "STAGEWISE_LAUNCHES")}


def _launches(route):
    module, name = _COUNTERS[route]
    return getattr(module, name)


@pytest.mark.parametrize("route", sorted(_COUNTERS))
def test_loaded_artifact_launches_as_the_live_call(dev, route):
    """A concrete artifact exported on the card, saved and loaded: it
    launches the live call's kernel as many times (one per eps window for
    the chunk kernel) and equals the live call; exporting launches
    nothing."""
    from tpu_gpad_torch import aot

    B = 64
    X0 = torch.as_tensor(np.random.default_rng(5).uniform(
        -0.4, 0.4, (B, 3)).astype(np.float32), device=dev)
    if route == "resident":
        data = tg.build_stagewise(tg.problems.battery(3, 10),
                                  iterations=SW_ITERS, device=dev)
        cfg = tg.SolverConfig(iterations=SW_ITERS)
        live_fn = lambda: ts.solve_stagewise(data, X0, config=cfg)
        export = aot.export_stagewise_solver
    else:
        data = _data(dev)
        cfg = {"paired_flat": tg.SolverConfig(iterations=ITERS),
               "dual": tg.SolverConfig(iterations=ITERS, restart=True),
               "dual_chunk": tg.SolverConfig(
                   mode="eps", eps_g=1e-5, eps_V=1e-5, iterations=ITERS,
                   restart=True)}[route]
        live_fn = lambda: tg.solve_batch(data, X0, cfg)
        export = aot.export_solver
    before = _launches(route)
    live = live_fn()
    torch.cuda.synchronize()
    want = _launches(route) - before
    assert want >= 1
    blob = export(data, cfg, batch_size=B)
    assert _launches(route) - before == want
    solve = aot.load_solver(blob)
    out = solve(X0)
    torch.cuda.synchronize()
    assert _launches(route) - before == 2 * want
    for k in ("u", "z", "y", "iterations", "residual", "gap", "converged"):
        assert torch.equal(out[k], getattr(live, k)), k


def test_wrappers_on_the_card_never_run_the_plain_versions(dev, monkeypatch):
    """Each wrapper on CUDA tensors launches its kernel: with every plain
    loop replaced by one that raises, all ten still run."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on CUDA tensors")

    for module, name in ((kernels, "_paired_loop"), (kernels, "_dense_loop"),
                         (dual_kernels, "_dual_loop"),
                         (sk, "stagewise_plain")):
        monkeypatch.setattr(module, name, refuse)
    data = _data(dev)
    dense = tg.dualize(tg.condense(tg.problems.battery(3, 10)), ITERS,
                       paired=False, device=dev)
    g_P, p_D = _inputs(data, 8)
    gd, pd = _inputs(dense, 8)
    kw = dict(iterations=ITERS)
    kernels.gpad_fixed_paired_flat(data, g_P, p_D, **kw)
    kernels.gpad_fixed_paired(data, g_P, p_D, **kw)
    kernels.gpad_fixed_flat_tiled(data, g_P, p_D, **kw)
    kernels.gpad_fixed_dense(dense, gd, pd, **kw)
    dual_kernels.gpad_fixed_dual(data, g_P, p_D, **kw)
    dual_kernels.gpad_fixed_dual_tiled(data, g_P, p_D, **kw)
    c = dual_kernels.relu_offsets(data, g_P, p_D)
    y = torch.zeros_like(p_D)
    s = torch.zeros((8, data.m_half), device=dev)
    mom = torch.ones((8, 2), device=dev)
    dual_kernels.gpad_dual_chunk(data, c, y, y, s, mom, k0=0, chunk=10)
    dual_kernels.gpad_dual_tiled_chunk(data, c, y, y, s, mom, k0=0, chunk=10)
    sw = _sw_data(dev, 3, 10)
    x0 = torch.full((8, 3), 0.1, device=dev)
    sk.solve_stagewise_cuda(sw, x0, SW_ITERS)
    ss.solve_stagewise_stream(sw, x0, SW_ITERS)
    torch.cuda.synchronize()


def test_a_refused_launch_raises_and_counts_nothing(dev):
    """An op called with a launch plan past shared memory: the launch is
    refused, the op raises with the CUDA error, and no launch is counted."""
    data = _data(dev)
    g_P, p_D = _inputs(data, 8)
    before = kernels.PAIRED_FLAT_LAUNCHES
    with pytest.raises(RuntimeError, match="gpad_paired_flat launch failed"):
        kernels.paired_flat_op(
            data.MG_T, data.GL_T, g_P, p_D, None, None, data.theta, data.beta,
            data.L, data.n_struct, ITERS, 10, 4, 1, 1, True)
    assert kernels.PAIRED_FLAT_LAUNCHES == before
    before = dual_kernels.DUAL_LAUNCHES
    c = dual_kernels.relu_offsets(data, g_P, p_D)
    with pytest.raises(RuntimeError, match="gpad_dual launch failed"):
        dual_kernels.dual_op(data.D, None, c, None, data.theta, data.beta,
                             ITERS, False, 10, 1, True)
    assert dual_kernels.DUAL_LAUNCHES == before


# ---------------------------------------------------------------------------
# the precision tiers of the resident condensed kernels (csrc/mma_product.cuh)
# ---------------------------------------------------------------------------

# Each tier's kernel against its plain version at that tier (operands
# rounded as the kernel rounds them, fp32 sums with TF32 off): a tenth of
# chip_smoke.py's TIER_TOL on z (u's source) and on every output over one
# iteration, where a rounding mode that differs would show. Past one
# iteration a tier's roundings amplify any fp32 difference: the plain
# version moves as far when its products are summed in float64 or its
# input moves by one fp32 unit (the larger is its spread), so every output
# over the budget is held to TIER_SENSITIVITY times that spread.
TIER_KERNEL_TOL = {"high": 1e-4, "default": 5e-4, "bfloat16": 5e-3}
# a tensor core's mma sums inside it without IEEE round-to-nearest (its
# aligned addends are truncated), a bias that the plain version's fp32 or
# fp64 sums do not share: measured on an H100 at up to 3.0 times that
# spread (a 10-iteration window at "default"); no such excess over one
# iteration, where every output meets TIER_KERNEL_TOL
TIER_SENSITIVITY = 4.0
TIER_KW = {"high": dict(precision="high"), "default": dict(precision="default"),
           "bfloat16": dict(matmul_dtype="bfloat16")}


def _parted(du, tol):
    """Scenarios whose |du| passes ``tol`` (a restart decision near r = 0
    may part one), and how many may."""
    per = du.abs().amax(dim=-1)
    return int((per > tol).sum()), max(1, per.shape[0] // 100)


def _tier_close(out_k, out_p, tier, names=("z", "y", "w", "zhat")):
    for name, a, b in zip(names, out_k, out_p):
        if b is None:
            assert a is None, name
            continue
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a, b, atol=TIER_KERNEL_TOL[tier], rtol=0,
                                   msg=f"{tier} {name}")


def _tier_fns(kernel):
    """(wrapper, plain version, launch counter, keywords) of a kernel;
    "dual_restart" and "dual_tiled_restart" are the dual kernels under
    restart."""
    if kernel == "dense":
        return (kernels.gpad_fixed_dense, kernels.gpad_fixed_dense_torch,
                (kernels, "DENSE_LAUNCHES"), {})
    if kernel == "dense_tiled":
        return (kernels.gpad_fixed_dense_tiled, kernels.gpad_fixed_dense_torch,
                (kernels, "DENSE_TILED_LAUNCHES"), {})
    if kernel == "flat_tiled":
        return (kernels.gpad_fixed_flat_tiled,
                kernels.gpad_fixed_paired_flat_torch,
                (kernels, "FLAT_TILED_LAUNCHES"), {})
    if kernel.startswith("dual_tiled"):
        return (dual_kernels.gpad_fixed_dual_tiled,
                dual_kernels.gpad_fixed_dual_torch,
                (dual_kernels, "DUAL_TILED_LAUNCHES"),
                dict(restart=kernel == "dual_tiled_restart"))
    if kernel.startswith("dual"):
        return (dual_kernels.gpad_fixed_dual, dual_kernels.gpad_fixed_dual_torch,
                (dual_kernels, "DUAL_LAUNCHES"),
                dict(restart=kernel == "dual_restart"))
    counter = "PAIRED_FLAT_LAUNCHES" if kernel == "paired_flat" else (
        "PAIRED_LAUNCHES")
    return (getattr(kernels, f"gpad_fixed_{kernel}"),
            getattr(kernels, f"gpad_fixed_{kernel}_torch"), (kernels, counter),
            {})


def _tier_run(kernel, data, g_P, p_D, y0, tier, iterations=ITERS, **plan):
    """A kernel at ``tier`` (counted) and its plain version at it."""
    fn, plain, counter, kw = _tier_fns(kernel)
    kw = dict(kw, iterations=iterations, tier=tier)
    before = getattr(*counter)
    out_k = fn(data, g_P, p_D, y0, **plan, **kw)
    assert getattr(*counter) == before + 1
    out_p = plain(data, g_P, p_D, y0, **kw)
    torch.cuda.synchronize()
    return out_k, out_p


def _tier_mm_fp64(a, b, tier):
    """``kernels._tier_mm`` with its products summed in float64: the same
    rounded operands, another summation."""
    d = lambda t: t.double()  # noqa: E731
    if tier == "high":
        (a_hi, a_lo), (b_hi, b_lo) = core._split_tf32_rna(a), b
        return ((d(a_lo) @ d(b_hi) + d(a_hi) @ d(b_lo))
                + d(a_hi) @ d(b_hi)).float()
    rnd = core._round_tf32 if tier == "default" else core._round_bf16
    return (d(rnd(a)) @ d(b)).float()


def _spread(plain_call, out_p, monkeypatch, moved_call):
    """Per output the plain version's own spread: the larger of its move
    with its products summed in float64 and with its input moved by one
    fp32 unit."""
    with monkeypatch.context() as m:
        m.setattr(kernels, "_tier_mm", _tier_mm_fp64)
        fp64 = plain_call()
    moved = moved_call()
    return [max((x - b).abs().max().item(), (y - b).abs().max().item())
            for x, y, b in zip(fp64, moved, out_p)]


def _tier_held(kernel, data, g_P, p_D, y0, tier, monkeypatch, **plan):
    """``kernel`` at ``tier`` held to its plain version: every output over
    one iteration from a warm state and z over 100 iterations within
    TIER_KERNEL_TOL (under restart, where a decision near r = 0 may part a
    scenario, z as the last iterates), every output over 100 iterations
    within TIER_SENSITIVITY times the plain version's own spread. Returns
    the 100-iteration outputs."""
    tol = TIER_KERNEL_TOL[tier]
    warm = y0 if y0 is not None else (
        kernels.gpad_fixed_dense_torch if kernel == "dense"
        else kernels.gpad_fixed_paired_flat_torch)(
            data, g_P, p_D, iterations=30)[1]
    _tier_close(*_tier_run(kernel, data, g_P, p_D, warm, tier, iterations=1,
                           **plan), tier)
    out_k, out_p = _tier_run(kernel, data, g_P, p_D, y0, tier, **plan)
    _, plain, _, kw = _tier_fns(kernel)
    kw = dict(kw, iterations=ITERS, tier=tier)
    spread = _spread(
        lambda: plain(data, g_P, p_D, y0, **kw), out_p, monkeypatch,
        lambda: plain(data, g_P, torch.nextafter(p_D, p_D + 1.0), y0, **kw))
    restart = kernel.endswith("restart")
    names = ("z",) if restart else ("z", "y", "w", "zhat")
    for name, a, b, own in zip(names, out_k, out_p, spread):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), name
        if kernel == "dual_tiled_restart":  # per scenario, 1% may part
            parted, most = _parted(a - b, max(tol, TIER_SENSITIVITY * own))
            assert parted <= most, (tier, name, parted, own)
            continue
        err = (a - b).abs().max().item()
        assert err <= max(tol, TIER_SENSITIVITY * own), (tier, name, err, own)
    if not restart:
        torch.testing.assert_close(out_k[0], out_p[0], atol=tol, rtol=0,
                                   msg=f"{tier} z")
    return out_k


@pytest.mark.parametrize("tier", list(TIER_KERNEL_TOL))
@pytest.mark.parametrize("case", list(PAIRED_CASES))
@pytest.mark.parametrize("kernel",
                         ["paired_flat", "paired", "dual", "dual_restart"])
def test_tier_kernel_matches_plain(dev, monkeypatch, kernel, case, tier):
    """Each resident kernel at each tier against its plain version at the
    tier: the headline and serving batches, a partial last tile, soft rows,
    one scenario; and the tier took effect (z differs from "highest"'s)."""
    data, g_P, p_D, y0 = _paired_case(_data(dev), case, seed=12)
    out_k = _tier_held(kernel, data, g_P, p_D, y0, tier, monkeypatch)
    highest = _tier_run(kernel, data, g_P, p_D, y0, "highest")[0]
    assert not torch.equal(out_k[0], highest[0]), "the tier took no effect"


@pytest.mark.parametrize("tier", list(TIER_KERNEL_TOL))
@pytest.mark.parametrize("plan", PAIRED_PLANS, ids=lambda p: (
    "pick" if p[0] is None else f"tile{1 << p[0]}_split{p[1]}"))
@pytest.mark.parametrize("kernel", ["paired_flat", "paired"])
def test_tier_paired_plans_match_plain(dev, monkeypatch, kernel, plan, tier):
    """Both paired instances at every plan and tier: each tile width's warp
    tiles (T 1 to 16) and split-K parts."""
    data, g_P, p_D, y0 = _paired_case(_data(dev), "B300_warm_shared", seed=13)
    _tier_held(kernel, data, g_P, p_D, y0, tier, monkeypatch,
               log2_tile=plan[0], split=plan[1])


@pytest.mark.parametrize("tier", list(TIER_KERNEL_TOL))
@pytest.mark.parametrize("plan", DUAL_PLANS, ids=_plan_id)
@pytest.mark.parametrize("shape", [(3, 10), (3, 7)], ids=["n3N10", "n3N7"])
def test_tier_dual_plans_match_plain(dev, monkeypatch, shape, plan, tier):
    """The dual kernel at every plan its registers take (T 1 to 16) and
    tier, at m_h 70 and 49 (rows not a multiple of the warp tile's 16)."""
    data, g_P, p_D, y0 = _paired_case(_data(dev, *shape), "B300_warm_shared",
                                      seed=14)
    log2, split = (None, None) if plan is None else plan
    _tier_held("dual", data, g_P, p_D, y0, tier, monkeypatch, log2_tile=log2,
               split=split)


@pytest.mark.parametrize("tier", list(TIER_KERNEL_TOL))
@pytest.mark.parametrize("B", [256, 4096])
def test_tier_dual_chunk_matches_plain(dev, monkeypatch, B, tier):
    """One window of 10 at each tier from k0 = 30, on the state 30
    iterations left, against the plain version at the tier: one iteration
    of it on every output, the recovered z, and the window's outputs
    against the plain version's own one-unit move, as ``_tier_held``."""
    data = _data(dev)
    g_P, p_D = _inputs(data, B, seed=5)
    c = dual_kernels.relu_offsets(data, g_P, p_D)
    y = torch.zeros((B, 2, data.m_half), device=dev)
    state = dual_kernels.gpad_dual_chunk_torch(
        data, c, y, y, torch.zeros((B, data.m_half), device=dev),
        torch.ones((B, 2), device=dev), k0=0, chunk=30, tier=tier)[:4]
    names = ("y", "y_prev", "s", "mom", "w")
    before = dual_kernels.DUAL_CHUNK_LAUNCHES
    one = [fn(data, c, *state, k0=30, chunk=1, tier=tier) for fn in (
        dual_kernels.gpad_dual_chunk, dual_kernels.gpad_dual_chunk_torch)]
    out_k = dual_kernels.gpad_dual_chunk(data, c, *state, k0=30, chunk=10,
                                         tier=tier)
    out_p = dual_kernels.gpad_dual_chunk_torch(data, c, *state, k0=30,
                                               chunk=10, tier=tier)
    window = lambda c: dual_kernels.gpad_dual_chunk_torch(  # noqa: E731
        data, c, *state, k0=30, chunk=10, tier=tier)
    spread = _spread(lambda: window(c), out_p, monkeypatch,
                     lambda: window(torch.nextafter(c, c + 1.0)))
    torch.cuda.synchronize()
    assert dual_kernels.DUAL_CHUNK_LAUNCHES == before + 2
    _tier_close(*one, tier, names)
    tol = TIER_KERNEL_TOL[tier]
    z_err = ((out_k[2] - out_p[2]) @ data.MG_T).abs().max().item()
    assert z_err <= tol, z_err
    for name, a, b, own in zip(names, out_k, out_p, spread):
        err = (a - b).abs().max().item()
        assert err <= max(tol, TIER_SENSITIVITY * own), (tier, name, err, own)


@pytest.mark.parametrize("tier", list(TIER_KERNEL_TOL))
def test_tier_solves_route_through_resident_kernels(dev, tier):
    """Under each tier ``auto`` launches the kernel "highest" launches: the
    flat kernel at the headline, the full paired one with the flat block
    off, the dual one under restart, the chunk one in eps mode; each u
    within chip_smoke.py's TIER_TOL of "highest"'s."""
    tol = {"high": 5e-4, "default": 5e-3, "bfloat16": 5e-2}[tier]
    data = _data(dev)
    X0 = torch.as_tensor(np.random.default_rng(15).uniform(
        -0.4, 0.4, (512, data.n_x)), dtype=torch.float32, device=dev)
    routes = {("PAIRED_FLAT_LAUNCHES", kernels): {},
              ("PAIRED_LAUNCHES", kernels): dict(form="mvp", flat="off"),
              ("DUAL_LAUNCHES", dual_kernels): dict(restart=True)}
    for (counter, module), kw in routes.items():
        before = getattr(module, counter)
        res = tg.solve_batch(data, X0, tg.SolverConfig(**kw, **TIER_KW[tier]))
        torch.cuda.synchronize()
        assert getattr(module, counter) == before + 1, counter
        ref = tg.solve_batch(data, X0, tg.SolverConfig(**kw))
        assert (res.u - ref.u).abs().max().item() <= tol, counter
    before = dual_kernels.DUAL_CHUNK_LAUNCHES
    res = tg.solve_to_accuracy(data, X0, tol=1e-5, **TIER_KW[tier])
    assert dual_kernels.DUAL_CHUNK_LAUNCHES > before
    assert bool(torch.isfinite(res.u).all())
    ref = tg.solve_to_accuracy(data, X0, tol=1e-5)
    assert (res.u - ref.u).abs().max().item() <= tol


def test_unknown_tier_is_refused(dev):
    """A tier the kernels do not know: the launcher refuses it, the op
    raises, and no launch is counted."""
    data = _data(dev)
    g_P, p_D = _inputs(data, 8)
    plan = kernels._paired_plan(data.m_half, data.n_z, data.n_struct, 8)
    before = kernels.PAIRED_FLAT_LAUNCHES
    with pytest.raises(RuntimeError, match="gpad_paired_flat launch failed"):
        kernels.paired_flat_op(
            data.MG_T, data.GL_T, g_P, p_D, None, None, data.theta, data.beta,
            data.L, data.n_struct, ITERS, *plan, True, "float16")
    assert kernels.PAIRED_FLAT_LAUNCHES == before
    c = dual_kernels.relu_offsets(data, g_P, p_D)
    before = dual_kernels.DUAL_LAUNCHES
    with pytest.raises(RuntimeError, match="gpad_dual launch failed"):
        dual_kernels.dual_op(data.D, None, c, None, data.theta, data.beta,
                             ITERS, False, *dual_kernels._dual_plan(
                                 data.m_half, 8), True, "float16")
    assert dual_kernels.DUAL_LAUNCHES == before


# the dense and tiled kernels under each tier: the dense kernel on the
# unpaired headline stack at the serving and headline batches and near its
# guard (n3 N20); the tiled ones on the flagship and at forced tiles and
# clusters (TILED_CASES: T 1 to 16, clusters of 1 to 16, partial tiles)
TIER_DENSE_CASES = {"n3N10_B4096": ((3, 10), 4096),
                    "n3N10_B256": ((3, 10), 256), "n3N20_B33": ((3, 20), 33)}
TIER_TILED_CASES = ("flagship_cold", "flagship_B5", "flagship_B300_cluster16",
                    "flagship_B1_cluster1", "n5N30_restart", "n3N10_tile1",
                    "n3N10_tile8", "n3N10_tile16_cluster16",
                    "n3N10_tile1_cluster1", "n3N10_tile2_cluster2")


@pytest.mark.parametrize("tier", list(TIER_KERNEL_TOL))
@pytest.mark.parametrize("case", list(TIER_DENSE_CASES))
def test_tier_dense_kernel_matches_plain(dev, monkeypatch, case, tier):
    """The dense kernel at each tier against its plain version at the tier
    (``_tier_held``), and the tier took effect."""
    data = _dense_data(dev, *TIER_DENSE_CASES[case][0])
    B = TIER_DENSE_CASES[case][1]
    g_P, p_D = _inputs(data, B, seed=B + 16)
    out_k = _tier_held("dense", data, g_P, p_D, None, tier, monkeypatch)
    highest = _tier_run("dense", data, g_P, p_D, None, "highest")[0]
    assert not torch.equal(out_k[0], highest[0]), "the tier took no effect"


@pytest.mark.parametrize("tier", list(TIER_KERNEL_TOL))
@pytest.mark.parametrize("case", TIER_TILED_CASES)
def test_tier_tiled_kernels_match_plain(dev, monkeypatch, case, tier):
    """The tiled dual kernel (under restart where the case restarts) and the
    flat tiled kernel at each tier against their plain versions at the tier
    (``_tier_held``), at the case's tile and cluster; the fixed ones show
    that the tier took effect."""
    data, g_P, p_D, y0, restart, _, tile, cluster = _tiled_args(dev, case)
    plan = dict(log2_tile=tile, cluster=cluster)
    for kernel in (("dual_tiled_restart",) if restart
                   else ("dual_tiled", "flat_tiled")):
        out_k = _tier_held(kernel, data, g_P, p_D, y0, tier, monkeypatch,
                           **plan)
        if not restart:
            highest = _tier_run(kernel, data, g_P, p_D, y0, "highest",
                                **plan)[0]
            assert not torch.equal(out_k[0], highest[0]), kernel


@pytest.mark.parametrize("tier", ["highest", *TIER_KERNEL_TOL])
@pytest.mark.parametrize("cluster", [1, 4])
def test_flat_tiled_ungrouped_plan_matches_plain(dev, cluster, tier):
    """The flat tiled kernel's plan near its guard, one scenario a cluster
    without the groups' scratch (``pick_flat_tiled``'s fallback), forced
    through the op at the flagship B3: its sums go from each thread (or,
    under a tier, each fragment) to the epilogue. One iteration from a warm
    state on every output and 100 on z, against the plain version at the
    tier; a wider tile without the scratch is refused under a tier."""
    data = _tiled_data(dev, 30, 30)
    g_P, p_D = _inputs(data, 3, seed=21)
    warm = kernels.gpad_fixed_paired_flat_torch(data, g_P, p_D,
                                                iterations=30)[1]
    tol = TOL if tier == "highest" else TIER_KERNEL_TOL[tier]

    def op(y0, iterations, log2_tile=0):
        return kernels.flat_tiled_op(
            data.MG_T, data.GL_T, g_P, p_D, y0, None, data.theta, data.beta,
            data.L, data.n_struct, iterations, log2_tile, cluster, False, True,
            tier)

    for y0, iterations in ((warm, 1), (None, ITERS)):
        before = kernels.FLAT_TILED_LAUNCHES
        out_k = op(y0, iterations)
        assert kernels.FLAT_TILED_LAUNCHES == before + 1
        out_p = kernels.gpad_fixed_paired_flat_torch(
            data, g_P, p_D, y0, iterations=iterations, tier=tier)
        torch.cuda.synchronize()
        for name, a, b in zip(("z", "y", "w", "zhat"), out_k, out_p):
            if iterations == 1 or name == "z":
                torch.testing.assert_close(a, b, atol=tol, rtol=0,
                                           msg=f"{tier} {name}")
    if tier != "highest":
        with pytest.raises(RuntimeError, match="gpad_flat_tiled launch failed"):
            op(None, 1, log2_tile=1)


@pytest.mark.parametrize("tier", list(TIER_KERNEL_TOL))
def test_tier_dual_tiled_chunk_matches_plain(dev, monkeypatch, tier):
    """One window of 10 of the tiled chunk kernel at each tier from k0 = 30
    at the flagship B256, on the state 30 iterations left, against the
    plain version at the tier: one iteration on every output, the recovered
    z, and the window's outputs against the plain version's own spread."""
    data = _tiled_data(dev, 30, 30)
    B = 256
    g_P, p_D = _inputs(data, B, seed=6)
    c = dual_kernels.relu_offsets(data, g_P, p_D)
    y = torch.zeros((B, 2, data.m_half), device=dev)
    state = dual_kernels.gpad_dual_chunk_torch(
        data, c, y, y, torch.zeros((B, data.m_half), device=dev),
        torch.ones((B, 2), device=dev), k0=0, chunk=30, tier=tier)[:4]
    names = ("y", "y_prev", "s", "mom", "w")
    before = dual_kernels.DUAL_TILED_CHUNK_LAUNCHES
    one = [fn(data, c, *state, k0=30, chunk=1, tier=tier) for fn in (
        dual_kernels.gpad_dual_tiled_chunk, dual_kernels.gpad_dual_chunk_torch)]
    out_k = dual_kernels.gpad_dual_tiled_chunk(data, c, *state, k0=30,
                                               chunk=10, tier=tier)
    window = lambda c: dual_kernels.gpad_dual_chunk_torch(  # noqa: E731
        data, c, *state, k0=30, chunk=10, tier=tier)
    out_p = window(c)
    spread = _spread(lambda: window(c), out_p, monkeypatch,
                     lambda: window(torch.nextafter(c, c + 1.0)))
    torch.cuda.synchronize()
    assert dual_kernels.DUAL_TILED_CHUNK_LAUNCHES == before + 2
    _tier_close(*one, tier, names)
    tol = TIER_KERNEL_TOL[tier]
    z_err = ((out_k[2] - out_p[2]) @ data.MG_T).abs().max().item()
    assert z_err <= tol, z_err
    for name, a, b, own in zip(names, out_k, out_p, spread):
        err = (a - b).abs().max().item()
        assert err <= max(tol, TIER_SENSITIVITY * own), (tier, name, err, own)


@pytest.mark.parametrize("tier", list(TIER_KERNEL_TOL))
def test_tier_solves_route_through_dense_and_tiled_kernels(dev, tier):
    """Under each tier ``auto`` launches the kernel "highest" launches: the
    dense kernel on the unpaired headline (B4096), at the flagship (B256)
    the flat tiled kernel, the tiled dual one under restart and the tiled
    chunk one in eps mode with the flat block off; each u within
    chip_smoke.py's TIER_TOL of "highest"'s (restart per scenario, 1% may
    part; eps per scenario too, where a scenario that converged in both
    solves, in another window than "highest"'s, meets the tolerance at
    another point and is not held to TIER_TOL)."""
    tol = {"high": 5e-4, "default": 5e-3, "bfloat16": 5e-2}[tier]
    dense = _dense_data(dev)
    flag = _tiled_data(dev, 30, 30)
    legs = [(dense, 4096, ("DENSE_LAUNCHES", kernels), {}),
            (flag, 256, ("FLAT_TILED_LAUNCHES", kernels), {}),
            (flag, 256, ("DUAL_TILED_LAUNCHES", dual_kernels),
             dict(restart=True)),
            (flag, 256, ("DUAL_TILED_CHUNK_LAUNCHES", dual_kernels),
             dict(mode="eps", restart=True, flat="off", eps_g=1e-4,
                  eps_V=1e-4))]
    for data, B, (counter, module), kw in legs:
        X0 = torch.as_tensor(np.random.default_rng(17).uniform(
            -0.4, 0.4, (B, data.n_x)), dtype=torch.float32, device=dev)
        before = getattr(module, counter)
        res = tg.solve_batch(data, X0, tg.SolverConfig(**kw, **TIER_KW[tier]))
        torch.cuda.synchronize()
        assert getattr(module, counter) > before, counter
        assert bool(torch.isfinite(res.u).all()), counter
        ref = tg.solve_batch(data, X0, tg.SolverConfig(**kw))
        if kw.get("mode") == "eps":
            apart = ((res.iterations != ref.iterations) & res.converged
                     & ref.converged)
            parted = _parted((res.u - ref.u)[~apart], tol)[0]
            assert parted <= max(1, B // 100), (counter, parted)
        elif kw:
            parted, most = _parted(res.u - ref.u, tol)
            assert parted <= most, (counter, parted)
        else:
            assert (res.u - ref.u).abs().max().item() <= tol, counter


# The dense and full paired loops past one block's shared memory: the tiled
# dense kernel (battery n5 N20, m 440; n10 N20, m 840; the flagship's dense
# layout, m 3660) and the flat tiled kernel at n_s = m_h (n5 N30, m_h 330;
# n10 N30, m_h 630)
_ROUTE_DATA = {}


def _route_data(dev, n, N, paired):
    if (n, N, paired) not in _ROUTE_DATA:
        _ROUTE_DATA[n, N, paired] = tg.dualize(
            tg.condense(tg.problems.battery(n, N)), ITERS, paired=paired,
            device=dev)
    return _ROUTE_DATA[n, N, paired]


ROUTE_CASES = {
    # case: (route, battery shape, B, warm start, diagnostics, plan
    # overrides: the tiled dense kernel's tile, parts_a and parts_b, the
    # flat tiled kernel's log2_tile and cluster; {}: the picks)
    "dense_n5N20": ("dense", (5, 20), 256, None, True, {}),
    "dense_n5N20_warm": ("dense", (5, 20), 256, "per_scenario", True, {}),
    "dense_n5N20_warm_shared": ("dense", (5, 20), 33, "shared", True, {}),
    "dense_n5N20_no_diagnostics": ("dense", (5, 20), 33, "per_scenario",
                                   False, {}),
    "dense_n5N20_B1": ("dense", (5, 20), 1, None, True, {}),
    "dense_n5N20_B300": ("dense", (5, 20), 300, "per_scenario", True, {}),
    "dense_n10N20": ("dense", (10, 20), 256, None, True, {}),
    "dense_flagship": ("dense", (30, 30), 256, "per_scenario", True, {}),
    # a batch past one tile of 128 that fills none, one scenario, a batch
    # whose phase B runs in two waves of units
    "dense_flagship_B130": ("dense", (30, 30), 130, "shared", True, {}),
    "dense_flagship_B1": ("dense", (30, 30), 1, "per_scenario", False, {}),
    "dense_n10N20_B1024": ("dense", (10, 20), 1024, None, True, {}),
    # m and n_z not multiples of the tiles, nor of 4 floats (n3 N31: m 434,
    # n_z 93, operand rows staged from zero-padded copies)
    "dense_n3N30": ("dense", (3, 30), 77, "per_scenario", True, {}),
    "dense_n3N31": ("dense", (3, 31), 77, "shared", True, {}),
    "paired_n5N30": ("paired", (5, 30), 256, None, True, {}),
    "paired_n5N30_warm_shared": ("paired", (5, 30), 33, "shared", True, {}),
    "paired_n10N30": ("paired", (10, 30), 256, "per_scenario", False, {}),
}
ROUTE_CASES.update({
    f"dense_tile{t}_parts{pa}x{pb}": ("dense", (5, 20), 33, "per_scenario",
                                      True, dict(tile=t, parts_a=pa,
                                                 parts_b=pb))
    for t in (16, 32, 64, 128) for pa, pb in ((1, 1), (5, 2), (14, 4))})
ROUTE_CASES.update({
    f"paired_tile{1 << t}_cluster{c}": ("paired", (5, 30), 33, "per_scenario",
                                        True, dict(log2_tile=t, cluster=c))
    for t in (0, 2, 4) for c in (4, 16)})


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_tiled_route_kernels_match_plain(dev, case):
    route, shape, B, warm, diagnostics, plan = ROUTE_CASES[case]
    data = _route_data(dev, *shape, "auto" if route == "paired" else False)
    g_P, p_D = _inputs(data, B, seed=B + 19)
    dual = (2, data.m_half) if data.paired else (data.m,)
    y0 = (None if warm is None else torch.rand(
        (B if warm == "per_scenario" else 1, *dual), device=dev) * 0.5)
    kw = dict(iterations=ITERS, diagnostics=diagnostics)
    fn, plain, counter = {
        "dense": (kernels.gpad_fixed_dense_tiled,
                  kernels.gpad_fixed_dense_torch, "DENSE_TILED_LAUNCHES"),
        "paired": (kernels.gpad_fixed_paired_tiled,
                   kernels.gpad_fixed_paired_torch, "PAIRED_TILED_LAUNCHES"),
    }[route]
    before = getattr(kernels, counter), kernels.FLAT_TILED_LAUNCHES
    out_k = fn(data, g_P, p_D, y0, **plan, **kw)
    assert (getattr(kernels, counter), kernels.FLAT_TILED_LAUNCHES) == (
        before[0] + 1, before[1])
    out_p = plain(data, g_P, p_D, y0, **kw)
    torch.cuda.synchronize()
    _assert_close(out_k, out_p)


@pytest.mark.parametrize("case", ["dense_flagship", "dense_n5N20_B300",
                                  "dense_tile16_parts14x4",
                                  "dense_tile128_parts5x2"])
def test_dense_tiled_launches_are_bit_equal(dev, case):
    """Every sum of the tiled dense kernel is taken in one fixed order (no
    atomics; the parts added in part order): two launches on the same
    inputs give the same bits."""
    _, shape, B, warm, diagnostics, plan = ROUTE_CASES[case]
    data = _route_data(dev, *shape, False)
    g_P, p_D = _inputs(data, B, seed=B + 19)
    y0 = None if warm is None else torch.rand((B, data.m), device=dev) * 0.5
    runs = [kernels.gpad_fixed_dense_tiled(data, g_P, p_D, y0, iterations=ITERS,
                                           **plan) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tier", ["highest", *TIER_KERNEL_TOL])
def test_dense_tiled_tiles_are_bit_equal(dev, tier):
    """A scenario's sums do not depend on the tile it shares: each is
    taken by one thread (FFMA) or one fragment lane (mma) over the same
    k-tiles and parts, so every tile of the same parts gives the same
    bits, at every tier."""
    data = _route_data(dev, 5, 20, False)
    g_P, p_D = _inputs(data, 33, seed=31)
    y0 = torch.rand((33, data.m), device=dev) * 0.5
    outs = {t: kernels.gpad_fixed_dense_tiled(
        data, g_P, p_D, y0, iterations=ITERS, tile=t, parts_a=5, parts_b=2,
        tier=tier) for t in kernels.DENSE_TILED_TILES}
    torch.cuda.synchronize()
    for t, out in outs.items():
        for name, a, b in zip(("z", "y", "w", "zhat"), out, outs[16]):
            assert torch.equal(a, b), (t, name, (a - b).abs().max().item())


@pytest.mark.parametrize("tier", list(TIER_KERNEL_TOL))
@pytest.mark.parametrize("case", ["dense_n5N20_B300", "dense_flagship_B130",
                                  "dense_n3N31", "dense_tile16_parts14x4",
                                  "dense_tile128_parts5x2"])
def test_tier_dense_tiled_matches_plain(dev, monkeypatch, case, tier):
    """The tiled dense kernel at each tier (mma.sync from its staged tiles)
    against its plain version at the tier, as ``_tier_held``; and the tier
    took effect."""
    _, shape, B, warm, _, plan = ROUTE_CASES[case]
    data = _route_data(dev, *shape, False)
    g_P, p_D = _inputs(data, B, seed=B + 29)
    y0 = None if warm is None else torch.rand(
        (B if warm == "per_scenario" else 1, data.m), device=dev) * 0.5
    out_k = _tier_held("dense_tiled", data, g_P, p_D, y0, tier, monkeypatch,
                       **plan)
    highest = _tier_run("dense_tiled", data, g_P, p_D, y0, "highest",
                        **plan)[0]
    assert not torch.equal(out_k[0], highest[0]), "the tier took no effect"


def test_tiled_routes_through_solve_batch(dev):
    """``auto`` on the dense n10 N20 layout and a ``flat="off"`` solve at
    n10 N30 each launch their tiled route once at B256, u within TOL of the
    torch engine's; at B4096 auto's dense solve launches the kernel too
    (the redesigned kernel beat the torch engine at every measured batch),
    and the default flat solve at n10 N30 B16384, past auto's flat tiled
    work edge, launches none."""
    legs = [(_route_data(dev, 10, 20, False), "DENSE_TILED_LAUNCHES", {}),
            (_route_data(dev, 10, 30, "auto"), "PAIRED_TILED_LAUNCHES",
             dict(form="mvp", flat="off"))]
    for data, counter, kw in legs:
        X0 = torch.as_tensor(np.random.default_rng(23).uniform(
            -0.4, 0.4, (256, data.n_x)), dtype=torch.float32, device=dev)
        before = getattr(kernels, counter)
        res = tg.solve_batch(data, X0, tg.SolverConfig(**kw))
        torch.cuda.synchronize()
        assert getattr(kernels, counter) == before + 1, counter
        ref = tg.solve_batch(data, X0, tg.SolverConfig(engine="torch", **kw))
        assert (res.u - ref.u).abs().max().item() <= TOL, counter
    data = legs[0][0]
    before = kernels.DENSE_TILED_LAUNCHES
    tg.solve_batch(data, torch.zeros((4096, data.n_x), device=dev),
                   tg.SolverConfig())
    torch.cuda.synchronize()
    assert kernels.DENSE_TILED_LAUNCHES == before + 1
    wide = legs[1][0]
    before = kernels.FLAT_TILED_LAUNCHES
    tg.solve_batch(wide, torch.zeros((16384, wide.n_x), device=dev),
                   tg.SolverConfig())
    torch.cuda.synchronize()
    assert kernels.FLAT_TILED_LAUNCHES == before
