"""The dual kernels' wrappers on CPU tensors (their plain torch versions)
against ``tpu_gpad``'s Pallas dual kernels in interpret mode, on the same
g_P, p_D and y0; the eps loop against ``tpu_gpad``'s; chunk composition;
and the shared-memory guard. The CUDA kernels themselves are held against
the plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_gpad
from tpu_gpad import problems as jp
from tpu_gpad.solver import SolverConfig as JConfig
from tpu_gpad.solver import kernels as jkernels
from tpu_gpad.solver.core import affine_params as j_affine_params

import tpu_gpad_torch
from tpu_gpad_torch.convert import gpad_data_from_numpy
from tpu_gpad_torch.solver import SolverConfig, dual_kernels
from tpu_gpad_torch.types import GPAD_META_FIELDS, GPAD_TENSOR_FIELDS

torch.set_num_threads(2)

ITERS = 100
TOL = 2e-5  # the bound tpu_gpad holds its pallas-vs-xla parity to
EPS_U_TOL = 2e-4  # eps runs stop at different windows (tests/test_restart.py)


def _carry(d_j):
    fields = {k: None if getattr(d_j, k) is None else np.asarray(getattr(d_j, k))
              for k in GPAD_TENSOR_FIELDS}
    return gpad_data_from_numpy(
        fields, {k: getattr(d_j, k) for k in GPAD_META_FIELDS}, device="cpu")


@pytest.fixture(scope="module")
def pair():
    d_j = tpu_gpad.dualize(
        tpu_gpad.condense(jp.battery(3, 10)), iterations=ITERS, paired="auto"
    )
    return d_j, _carry(d_j)


def _inputs(d_j, B, seed=0):
    X0 = np.random.default_rng(seed).uniform(-0.4, 0.4, (B, d_j.n_x))
    g_P, p_D = j_affine_params(d_j, jnp.asarray(X0, dtype=jnp.float32))
    return np.array(g_P), np.array(p_D)  # writable copies for torch


def _warm_y0(d_j, B, seed):
    """A nonnegative dual near the cold solution's scale."""
    return np.random.default_rng(seed).uniform(
        0.0, 0.5, (B, 2, d_j.m_half)).astype(np.float32)


def _soft(d_j, d_t, seed=4):
    damp = np.random.default_rng(seed).uniform(0.0, 0.2, d_j.m_half)
    damp = damp.astype(np.float32)
    return (dataclasses.replace(d_j, soft_damp=jnp.asarray(damp)),
            dataclasses.replace(d_t, soft_damp=torch.from_numpy(damp)))


@pytest.mark.parametrize(
    "case",
    ["cold", "warm_shared", "warm_one_row", "warm_per_scenario",
     "no_diagnostics", "soft", "restart_cold", "restart_warm", "B1", "B5"],
)
def test_plain_version_matches_pallas_interpret(pair, case):
    d_j, d_t = pair
    B = {"B1": 1, "B5": 5}.get(case, 6)
    g_P, p_D = _inputs(d_j, B, seed=B)
    y0 = None
    if case == "warm_shared":
        y0 = _warm_y0(d_j, 1, 1)[0]  # (2, m_h)
    elif case == "warm_one_row":
        y0 = _warm_y0(d_j, 1, 2)  # (1, 2, m_h)
    elif case in ("warm_per_scenario", "restart_warm", "B1", "B5"):
        y0 = _warm_y0(d_j, B, 3)  # (B, 2, m_h)
    elif case == "soft":
        d_j, d_t = _soft(d_j, d_t)
    kw = dict(iterations=ITERS, restart=case.startswith("restart"),
              diagnostics=case != "no_diagnostics")
    out_j = jkernels.gpad_pallas_fixed_dual(
        d_j, jnp.asarray(g_P), jnp.asarray(p_D),
        None if y0 is None else jnp.asarray(y0), interpret=True, **kw)
    out_t = dual_kernels.gpad_fixed_dual(
        d_t, torch.from_numpy(g_P), torch.from_numpy(p_D),
        None if y0 is None else torch.from_numpy(y0), **kw)
    for name, a, b in zip(("z", "y", "w", "zhat"), out_j, out_t):
        if a is None:
            assert b is None, name
            continue
        assert tuple(b.shape) == tuple(a.shape), name
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("iterations", [60, 45], ids=["divisible", "partial"])
@pytest.mark.parametrize("restart", [True, False], ids=["restart", "plain"])
def test_eps_loop_matches_pallas_eps(pair, iterations, restart):
    """Budget 60 is six windows of 10; 45 ends in a partial window of 5.
    Converged flags must agree, and iterations within one window."""
    d_j, d_t = pair
    g_P, p_D = _inputs(d_j, 6, seed=7)
    kw = dict(mode="eps", eps_g=1e-5, eps_V=1e-5, check_every=10,
              iterations=iterations, restart=restart)
    res_j = jkernels.gpad_pallas_eps_dual(
        d_j, jnp.asarray(g_P), jnp.asarray(p_D), JConfig(**kw))
    syncs = dual_kernels.EPS_SYNCS
    res_t = dual_kernels.gpad_eps_dual(
        d_t, torch.from_numpy(g_P), torch.from_numpy(p_D), SolverConfig(**kw))
    # the last window ran ends at the largest reported iteration; one host
    # sync follows every window but the budget's last
    windows = -(-int(res_t.iterations.max()) // 10)
    assert dual_kernels.EPS_SYNCS - syncs == min(windows, -(-iterations // 10) - 1)
    np.testing.assert_array_equal(res_t.converged.numpy(),
                                  np.asarray(res_j.converged))
    assert np.abs(res_t.iterations.numpy()
                  - np.asarray(res_j.iterations)).max() <= 10
    np.testing.assert_allclose(res_t.u.numpy(), np.asarray(res_j.u),
                               atol=EPS_U_TOL, rtol=0)
    if restart and iterations == 60:
        assert res_t.converged.all()  # the eps test itself was exercised


@pytest.mark.parametrize("restart", [False, True], ids=["plain", "restart"])
def test_chunks_compose_to_whole_solve(pair, restart):
    """Chunks of 10 from k0 = 0, 10, ... reproduce one 100-iteration solve."""
    _, d_t = pair
    g_P, p_D = (torch.from_numpy(a) for a in _inputs(pair[0], 6, seed=8))
    z, y, w, _ = dual_kernels.gpad_fixed_dual(
        d_t, g_P, p_D, iterations=ITERS, restart=restart)
    c = dual_kernels.relu_offsets(d_t, g_P, p_D)
    state = (torch.zeros_like(y), torch.zeros_like(y),
             torch.zeros((6, d_t.m_half)), torch.ones((6, 2)))
    for k0 in range(0, ITERS, 10):
        *state, w_c = dual_kernels.gpad_dual_chunk(
            d_t, c, *state, k0=k0, chunk=10, restart=restart)
    s = state[2]
    z_c = -(s @ d_t.MG_T) - g_P
    for name, a, b in (("z", z, z_c), ("y", y, state[0]), ("w", w, w_c)):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=0, msg=name)


def test_recovery_weight_is_one(pair):
    """theta_0 = 1, so the weight of g_P in the recovered z is exactly 1
    for every budget, under restart too (the eps loop relies on it)."""
    _, d_t = pair
    assert d_t.theta[0].item() == 1.0
    for K in (1, 10, ITERS, ITERS + 50):
        assert dual_kernels.recovery_weight(d_t, K).item() == 1.0


def test_cpu_wrappers_do_not_count_launches(pair):
    _, d_t = pair
    before = (dual_kernels.DUAL_LAUNCHES, dual_kernels.DUAL_CHUNK_LAUNCHES)
    g_P = torch.zeros((3, d_t.n_z))
    p_D = torch.zeros((3, 2, d_t.m_half))
    dual_kernels.gpad_fixed_dual(d_t, g_P, p_D, iterations=5, restart=True)
    y = torch.zeros((3, 2, d_t.m_half))
    dual_kernels.gpad_dual_chunk(d_t, p_D, y, y, torch.zeros((3, d_t.m_half)),
                                 torch.ones((3, 2)), k0=0, chunk=5)
    assert (dual_kernels.DUAL_LAUNCHES,
            dual_kernels.DUAL_CHUNK_LAUNCHES) == before


def test_wrappers_reject_bad_inputs(pair):
    _, d_t = pair
    g_P = torch.zeros((3, d_t.n_z))
    p_D = torch.zeros((3, 2, d_t.m_half))
    with pytest.raises(ValueError, match="p_D"):
        dual_kernels.gpad_fixed_dual(d_t, g_P, p_D[:2], iterations=5)
    with pytest.raises(ValueError, match="float32"):
        dual_kernels.gpad_fixed_dual(d_t, g_P.double(), p_D, iterations=5)
    with pytest.raises(ValueError, match="exceed"):
        dual_kernels.gpad_fixed_dual(d_t, g_P, p_D, iterations=ITERS + 1)
    # restart ignores the schedule, so its budget may exceed it
    z, *_ = dual_kernels.gpad_fixed_dual(d_t, g_P, p_D, iterations=ITERS + 1,
                                         restart=True)
    assert torch.isfinite(z).all()
    y = torch.zeros((3, 2, d_t.m_half))
    s, mom = torch.zeros((3, d_t.m_half)), torch.ones((3, 2))
    with pytest.raises(ValueError, match="mom"):
        dual_kernels.gpad_dual_chunk(d_t, p_D, y, y, s, mom[:, :1], k0=0,
                                     chunk=5)
    with pytest.raises(ValueError, match="exceed"):
        dual_kernels.gpad_dual_chunk(d_t, p_D, y, y, s, mom, k0=ITERS - 5,
                                     chunk=10)
    dense = tpu_gpad_torch.dualize(
        tpu_gpad_torch.condense(tpu_gpad_torch.problems.battery(3, 4)),
        iterations=5, paired=False, device="cpu")
    with pytest.raises(ValueError, match="paired data with D"):
        dual_kernels.gpad_fixed_dual(dense, torch.zeros((1, dense.n_z)),
                                     torch.zeros((1, 2, 1)), iterations=5)


def test_shared_memory_guard():
    """The guard admits the headline and battery(5, 20) shapes and refuses
    the reference's 30x30 flagship, whose D alone is 13.4 MB."""
    def data(n, N):
        return tpu_gpad_torch.dualize(
            tpu_gpad_torch.condense(tpu_gpad_torch.problems.battery(n, N)),
            iterations=5, paired="auto", device="cpu")

    head, mid, flagship = data(3, 10), data(5, 20), data(30, 30)
    assert dual_kernels.dual_fits_smem(head) and dual_kernels.dual_fits_smem(mid)
    assert not dual_kernels.dual_fits_smem(flagship)
    assert dual_kernels._dual_plan(70, 4096).log2_tile == 4
    assert dual_kernels._dual_plan(70, 1).log2_tile == 0
    assert dual_kernels._dual_plan(70, 256).log2_tile == 1  # 128 blocks
    # 8 per block would hold 7 of a thread's elements in registers (at
    # most 6)
    wide = dual_kernels._dual_plan(220, 1024)
    assert wide.log2_tile == 2
    assert dual_kernels._dual_smem_bytes(220, wide) <= 227 * 1024
    assert dual_kernels._dual_plan(220, 1024, log2_tile=3) is None
    dense = tpu_gpad_torch.dualize(
        tpu_gpad_torch.condense(tpu_gpad_torch.problems.battery(3, 4)),
        iterations=5, paired=False, device="cpu")
    assert not dual_kernels.dual_fits_smem(dense)
