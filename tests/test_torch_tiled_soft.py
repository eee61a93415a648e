"""Soft (dual-damped) rows through the tiled kernels, on the CPU.

Device-side condensation with ``soft_state`` damps the state box's dual
rows by ``GPADData.soft_damp`` (``od = 1 - soft_damp`` in the dual step).
``tpu_gpad`` carries those rows in its resident Pallas kernels up to their
12 MB VMEM budget; the port's resident kernels stop at one block's 227 KB,
so past it the tiled kernels carry them. Here the tiled wrappers on CPU
tensors (their plain versions, the ops' CPU implementations) are held
against ``tpu_gpad``'s resident soft kernels in interpret mode on battery
n5 N30 condensed by ``dualize_ltv_device`` (m_h 330, n_z 150): the flat
tiled op against ``_gpad_kernel_paired_flat``, the paired tiled route
against ``_gpad_kernel_paired``, the tiled dual op against
``_gpad_kernel_dual`` (fixed and restart) and the eps loop on the tiled
chunk op against ``_gpad_kernel_dual_chunk``; the port's own condensation
against ``tpu_gpad``'s; ``kernels.solve_batch_cuda`` (the kernel route) on
each soft config; ``core.cuda_kernel`` at n5 N30, n10 N30 and the 30x30
flagship; and zero damping against the hard call, bit for bit. The CUDA
kernels themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py's tiled_soft_vs_plain and
tiled_soft_path)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gpad import device_condense as jd
from tpu_gpad import problems as jp
from tpu_gpad.problems.battery import default_x0
from tpu_gpad.solver import SolverConfig as JConfig
from tpu_gpad.solver import kernels as jkernels
from tpu_gpad.solver import solve_batch as j_solve_batch
from tpu_gpad.solver.core import affine_params as j_affine_params

import tpu_gpad_torch as tg
from tpu_gpad_torch import device_condense as td
from tpu_gpad_torch import problems as tp
from tpu_gpad_torch.convert import gpad_data_from_numpy
from tpu_gpad_torch.solver import SolverConfig, core, dual_kernels, kernels
from tpu_gpad_torch.types import GPAD_META_FIELDS, GPAD_TENSOR_FIELDS

torch.set_num_threads(2)

ITERS = 60
B = 8
TOL = 2e-5  # the bound of tests/test_torch_tiled.py
EPS_U_TOL = 2e-4  # eps runs stop at different windows (tests/test_tiled.py)
# the two packages' condensations: float32 operands summed in another
# order, L by the same power method (tests/test_torch_device_condense.py)
OP_TOL, L_RTOL = 1e-4, 1e-4
SOFT_STATE = 1e3
SCHEDULE = 200  # the schedule's length: eps budgets of up to 200


def _battery_ltv(n, N):
    prob = jp.battery(n, N)
    A = np.repeat(prob.A[None], N, axis=0).astype(np.float32)
    Bm = np.repeat(prob.B[None], N, axis=0).astype(np.float32)
    return prob, A, Bm, np.zeros((N, n), np.float32)


def _kw(prob):
    return dict(x_min=prob.x_min, x_max=prob.x_max, K_u=prob.K_u,
                soft_state=SOFT_STATE)


def _carry(d_j):
    fields = {k: None if getattr(d_j, k) is None else np.asarray(getattr(d_j, k))
              for k in GPAD_TENSOR_FIELDS}
    return gpad_data_from_numpy(
        fields, {k: getattr(d_j, k) for k in GPAD_META_FIELDS}, device="cpu")


def _port_soft(n, N):
    """The port's device condensation of soft battery nN, on the CPU."""
    prob, A, Bm, c = _battery_ltv(n, N)
    return td.dualize_ltv_device(
        torch.from_numpy(A), torch.from_numpy(Bm), torch.from_numpy(c),
        prob.Q, prob.R, prob.u_min, prob.u_max, iterations=SCHEDULE,
        **_kw(prob))


@pytest.fixture(scope="module")
def soft():
    """Battery n5 N30 soft, condensed by tpu_gpad's dualize_ltv_device and
    carried across, with B seeded parameters p = [x0; 0]: x0 within 0.5 of
    the reference's default_x0(5), so some cells start past the 0.5 state
    box and the soft rows hold active duals (a farther x0 grows the duals,
    and float32's spread with them, past TOL)."""
    prob, A, Bm, c = _battery_ltv(5, 30)
    d_j = jd.dualize_ltv_device(
        jnp.asarray(A), jnp.asarray(Bm), jnp.asarray(c), prob.Q, prob.R,
        prob.u_min, prob.u_max, iterations=SCHEDULE, **_kw(prob))
    rng = np.random.default_rng(20)
    x0 = default_x0(5)[None] + rng.uniform(-0.5, 0.5, (B, 5))
    P = np.concatenate([x0, np.zeros((B, 5))], axis=1).astype(np.float32)
    g_P, p_D = j_affine_params(d_j, jnp.asarray(P))
    return d_j, _carry(d_j), np.array(g_P), np.array(p_D), P


def _seeded(d_j, d_t):
    """Both packages' data with a seeded damp in [0, 0.5] on every row (od
    in [0.5, 1]): far stronger than soft_state's, so a row indexed wrong
    shows."""
    damp = np.random.default_rng(3).uniform(0.0, 0.5, d_t.m_half).astype(
        np.float32)
    return (dataclasses.replace(d_j, soft_damp=jnp.asarray(damp)),
            dataclasses.replace(d_t, soft_damp=torch.from_numpy(damp)))


def test_the_data_is_past_the_resident_kernels(soft):
    """m_h 330: tpu_gpad's resident kernels take it, the port's resident
    ones do not, and its tiled ones do, soft rows and all."""
    d_j, d_t = soft[:2]
    assert (d_t.m_half, d_t.n_z) == (330, 150) and d_t.soft_damp is not None
    assert float(d_t.soft_damp.max()) > 0
    assert jkernels.flat_fits_vmem(d_j) and jkernels.fits_vmem(d_j)
    assert jkernels.dual_fits_vmem(d_j) and jkernels.dual_fits_vmem(
        d_j, chunked=True)
    assert not (kernels.flat_fits_smem(d_t) or kernels.paired_fits_smem(d_t)
                or dual_kernels.dual_fits_smem(d_t))
    assert kernels.flat_tiled_fits(d_t) and kernels.paired_tiled_fits(d_t)
    assert dual_kernels.dual_tiled_fits(d_t)


# kernel -> (tpu_gpad's resident soft kernel, the port's tiled wrapper,
# keyword arguments of both)
KERNELS = {
    "flat": (jkernels.gpad_pallas_fixed_paired_flat,
             kernels.gpad_fixed_flat_tiled, {}),
    "paired": (jkernels.gpad_pallas_fixed_paired,
               kernels.gpad_fixed_paired_tiled, {}),
    "dual": (jkernels.gpad_pallas_fixed_dual,
             dual_kernels.gpad_fixed_dual_tiled, {}),
    "dual_restart": (jkernels.gpad_pallas_fixed_dual,
                     dual_kernels.gpad_fixed_dual_tiled, dict(restart=True)),
}


def _assert_per_scenario(out_j, out_t, restart):
    """z, y, w and zhat within TOL; under restart scenario by scenario,
    where a decision flipped near r = 0 may part one scenario (1%, at
    least one) from the other run."""
    for name, a, b in zip(("z", "y", "w", "zhat"), out_j, out_t):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape, name
        err = np.abs(b.numpy() - a).reshape(a.shape[0], -1).max(axis=1)
        parted = err > TOL
        assert parted.sum() <= (max(1, a.shape[0] // 100) if restart else 0), (
            name, err.max())


@pytest.mark.parametrize("damp", ["condensed", "seeded"])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_tiled_plain_matches_resident_soft_pallas(soft, kernel, damp):
    """Each tiled op's plain version with od against tpu_gpad's resident
    Pallas kernel carrying the same soft rows (interpret mode), 60
    iterations: cold with the condensed damp, warm per scenario with the
    seeded one."""
    d_j, d_t, g_P, p_D, _ = soft
    y0 = None
    if damp == "seeded":
        d_j, d_t = _seeded(d_j, d_t)
        y0 = np.random.default_rng(4).uniform(
            0.0, 0.5, (B, 2, d_t.m_half)).astype(np.float32)
    jfn, tfn, kw = KERNELS[kernel]
    out_j = jfn(d_j, jnp.asarray(g_P), jnp.asarray(p_D),
                None if y0 is None else jnp.asarray(y0), iterations=ITERS,
                interpret=True, **kw)
    out_t = tfn(d_t, torch.from_numpy(g_P), torch.from_numpy(p_D),
                None if y0 is None else torch.from_numpy(y0),
                iterations=ITERS, **kw)
    _assert_per_scenario(out_j, out_t, kw.get("restart", False))
    # non-vacuous: the soft rows carry active duals, and the damp moved y
    hard = tfn(dataclasses.replace(d_t, soft_damp=None),
               torch.from_numpy(g_P), torch.from_numpy(p_D),
               None if y0 is None else torch.from_numpy(y0),
               iterations=ITERS, **kw)
    assert (hard[1] - out_t[1]).abs().max() > 100 * TOL


@pytest.mark.parametrize("restart", [False, True], ids=["plain", "restart"])
def test_eps_on_the_tiled_chunk_matches_resident_soft_pallas(soft, restart,
                                                             monkeypatch):
    """The eps loop with the flat block off on soft data: the port's on the
    tiled chunk op, window by window, tpu_gpad's on its resident chunk
    kernel (interpret mode). Scenario by scenario: the converged flag, the
    iterations within a window and u within EPS_U_TOL of tpu_gpad's Pallas
    run; one scenario (1%, at least one) whose residual meets eps within
    float32's rounding may stop where tpu_gpad's XLA engine stops instead
    (its two engines part there too: 160 against 180 iterations for a
    residual of 9.985e-5 against eps 1e-4 in this data)."""
    d_j, d_t, g_P, p_D, P = soft
    windows = []
    orig = dual_kernels.dual_tiled_chunk_op

    def spy(*a):
        windows.append(a[1] is not None)  # od reaches the op
        return orig(*a)

    monkeypatch.setattr(dual_kernels, "dual_tiled_chunk_op", spy)
    kw = dict(mode="eps", eps_g=1e-4, eps_V=1e-4, check_every=10,
              iterations=400 if restart else SCHEDULE, flat="off",
              restart=restart)
    res_t = dual_kernels.gpad_eps_dual(
        d_t, torch.from_numpy(g_P), torch.from_numpy(p_D), SolverConfig(**kw))
    assert windows and all(windows)
    _assert_eps_per_scenario(res_t, d_j, P, kw)
    assert res_t.converged.any()


def _assert_eps_per_scenario(res_t, d_j, P, kw):
    """An eps solve of the port against tpu_gpad's Pallas engine on the
    same p, scenario by scenario (see the test above): one scenario may
    match its XLA engine's run instead."""
    refs = [j_solve_batch(d_j, jnp.asarray(P),
                          config=JConfig(engine=engine, **kw))
            for engine in ("pallas", "xla")]
    it_t = res_t.iterations.numpy()
    parted = 0
    for i in range(B):
        ref = next((r for r in refs
                    if abs(it_t[i] - int(r.iterations[i])) <= 10), None)
        assert ref is not None, (i, it_t[i])
        parted += ref is not refs[0]
        assert bool(res_t.converged[i]) == bool(ref.converged[i]), i
        np.testing.assert_allclose(res_t.u[i].numpy(), np.asarray(ref.u[i]),
                                   atol=EPS_U_TOL, rtol=0, err_msg=str(i))
    assert parted <= max(1, B // 100)


def test_port_condensation_matches_tpu_gpad(soft):
    """The port's dualize_ltv_device on the CPU against tpu_gpad's at n5
    N30 soft: every operand within OP_TOL, L within L_RTOL, the schedule
    and the layout exactly."""
    d_j = soft[0]
    dev = _port_soft(5, 30)
    for f in ("n_u", "n_x", "horizon", "paired", "n_struct"):
        assert getattr(dev, f) == getattr(d_j, f), f
    np.testing.assert_allclose(float(dev.L), float(d_j.L), rtol=L_RTOL)
    for f in ("theta", "beta"):
        np.testing.assert_array_equal(getattr(dev, f).numpy(),
                                      np.asarray(getattr(d_j, f)))
    for f in ("MG_T", "GL_T", "gP_map", "gP_const", "pD_map", "pD_const",
              "D", "soft_damp"):
        a, b = getattr(dev, f).numpy(), np.asarray(getattr(d_j, f))
        assert a.shape == b.shape, f
        big = np.abs(b) > 1e15
        np.testing.assert_allclose(a[~big], b[~big], atol=OP_TOL, rtol=0,
                                   err_msg=f)
        np.testing.assert_allclose(a[big], b[big], rtol=L_RTOL, err_msg=f)


# the soft slice's configs, the tiled kernel each takes past shared memory
SOFT_CONFIGS = {
    "fixed": ({}, "flat_tiled"),
    "flat_off": (dict(form="mvp", flat="off"), "paired_tiled"),
    "restart": (dict(restart=True, iterations=150), "dual_tiled"),
    "eps_flat_off": (dict(mode="eps", eps_g=1e-4, eps_V=1e-4, check_every=10,
                          iterations=SCHEDULE, flat="off"),
                     "dual_tiled_chunk"),
}


@pytest.mark.parametrize("config", list(SOFT_CONFIGS))
def test_kernel_route_solves_soft_data_as_tpu_gpad(soft, config,
                                                   monkeypatch):
    """``solve_batch``'s kernel entry (``kernels.solve_batch_cuda``) on CPU
    tensors takes the tiled route ``core.cuda_kernel`` names, its op gets
    the damp column, and u agrees with tpu_gpad's Pallas engine on the
    same p (per scenario under restart, EPS_U_TOL under eps)."""
    d_j, d_t, _, _, P = soft
    kw, route = SOFT_CONFIGS[config]
    cfg = SolverConfig(**{"iterations": ITERS, **kw})
    assert core.cuda_kernel(d_t, cfg, batch=B) == route
    module, attr, od_at = {
        "flat_tiled": (kernels, "flat_tiled_op", 5),
        "paired_tiled": (kernels, "flat_tiled_op", 5),
        "dual_tiled": (dual_kernels, "dual_tiled_op", 1),
        "dual_tiled_chunk": (dual_kernels, "dual_tiled_chunk_op", 1)}[route]
    seen, orig = [], getattr(module, attr)

    def spy(*a):
        seen.append(a[od_at])
        return orig(*a)

    monkeypatch.setattr(module, attr, spy)
    x0 = torch.from_numpy(P)
    g_P, p_D = core.affine_params(d_t, x0)
    res = kernels.solve_batch_cuda(d_t, g_P, p_D, cfg)
    assert seen and all(torch.equal(od, 1.0 - d_t.soft_damp) for od in seen)
    if config == "eps_flat_off":
        _assert_eps_per_scenario(res, d_j, P, kw)
        return
    res_j = j_solve_batch(d_j, jnp.asarray(P), config=JConfig(
        engine="pallas", **{"iterations": ITERS, **kw}))
    err = np.abs(res.u.numpy() - np.asarray(res_j.u)).max(axis=1)
    parted = (err > TOL).sum()
    assert parted <= (1 if config == "restart" else 0), err.max()


@pytest.fixture(scope="module")
def shapes():
    """The port's soft condensation of n5 N30, n10 N30 and the flagship."""
    return {(n, N): _port_soft(n, N) for n, N in ((5, 30), (10, 30),
                                                  (30, 30))}


ROUTES = [  # config, auto's kernel at B256, a forced "cuda"'s
    # a forced "cuda" takes the dual form past the flat kernel's shared
    # memory, as tpu_gpad's forced Pallas engine does past VMEM
    (dict(), "flat_tiled", "dual_tiled"),
    (dict(form="mvp"), "flat_tiled", "flat_tiled"),
    (dict(form="mvp", flat="off"), "paired_tiled", "paired_tiled"),
    (dict(restart=True), "dual_tiled", "dual_tiled"),
    (dict(form="dual"), "dual_tiled", "dual_tiled"),
    (dict(mode="eps", flat="off"), "dual_tiled_chunk", "dual_tiled_chunk"),
    (dict(mode="eps", flat="off", restart=True), "dual_tiled_chunk",
     "dual_tiled_chunk"),
    # tpu_gpad's auto keeps the mvp+flat eps loop: the torch engine
    (dict(mode="eps"), None, "dual_tiled_chunk"),
]


@pytest.mark.parametrize("shape", [(5, 30), (10, 30), (30, 30)],
                         ids=["n5N30", "n10N30", "flagship"])
def test_cuda_kernel_names_a_tiled_kernel_for_soft_data(shapes, shape):
    """What the card would run on soft data past shared memory, at B256:
    the route hard data of the same shape takes, a kernel for every fixed,
    flat-off, restart and eps config (the flat-on eps solve under auto
    excepted, as tpu_gpad's auto); the dense layout alone refuses soft
    rows."""
    n, N = shape
    data = shapes[shape]
    # rows: the state box, K_u, the input box (n_struct = N (n + 1))
    assert data.soft_damp is not None and data.m_half == N * (2 * n + 1)
    hard = dataclasses.replace(data, soft_damp=None)
    for kw, auto, forced in ROUTES:
        for engine, want in (("auto", auto), ("cuda", forced)):
            cfg = SolverConfig(engine=engine, **kw)
            assert core.cuda_kernel(data, cfg, batch=256) == want, (kw, engine)
            assert core.cuda_kernel(hard, cfg, batch=256) == want, (kw, engine)
    if shape == (5, 30):
        dense = tg.dualize(tg.condense(tp.battery(n, N)), iterations=5,
                           paired=False, device="cpu")
        soft_dense = dataclasses.replace(dense,
                                         soft_damp=torch.zeros(dense.m))
        assert kernels.dense_tiled_fits(dense)
        assert not kernels.dense_tiled_fits(soft_dense)
        for engine in ("auto", "cuda"):
            assert core.cuda_kernel(soft_dense, SolverConfig(engine=engine),
                                    batch=256) is None


@pytest.mark.parametrize("kernel", ["flat", "paired", "dual", "dual_restart",
                                    "chunk", "chunk_restart"])
def test_zero_damp_is_the_hard_call_bit_for_bit(soft, kernel):
    """soft_damp = 0 (od exactly 1) through each tiled op's plain version
    gives the hard call's outputs bit for bit, from a warm start."""
    _, d_t, g_P, p_D, _ = soft
    zero = dataclasses.replace(d_t, soft_damp=torch.zeros(d_t.m_half))
    hard = dataclasses.replace(d_t, soft_damp=None)
    g, p = torch.from_numpy(g_P), torch.from_numpy(p_D)
    y0 = torch.from_numpy(np.random.default_rng(6).uniform(
        0.0, 0.5, (B, 2, d_t.m_half)).astype(np.float32))
    restart = kernel.endswith("restart")
    if kernel.startswith("chunk"):
        c = dual_kernels.relu_offsets(d_t, g, p)
        state = (y0, y0, torch.zeros((B, d_t.m_half)), torch.ones((B, 2)))

        def run(data):
            return dual_kernels.gpad_dual_tiled_chunk(
                data, c, *state, k0=20, chunk=10, restart=restart)
    else:
        fn, kw = KERNELS[kernel][1:]

        def run(data):
            return fn(data, g, p, y0, iterations=ITERS, **kw)
    for a, b in zip(run(zero), run(hard)):
        assert torch.equal(a, b)
