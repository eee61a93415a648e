"""The flat paired kernel's wrapper on CPU tensors (its plain torch
version) against ``tpu_gpad``'s Pallas kernel in interpret mode, on the
same g_P, p_D and y0. The CUDA kernel itself is held against the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_gpad
from tpu_gpad import problems as jp
from tpu_gpad.solver import kernels as jkernels
from tpu_gpad.solver.core import affine_params as j_affine_params

import tpu_gpad_torch
from tpu_gpad_torch.convert import gpad_data_from_numpy
from tpu_gpad_torch.solver import kernels
from tpu_gpad_torch.types import GPAD_META_FIELDS, GPAD_TENSOR_FIELDS

torch.set_num_threads(2)

ITERS = 100
TOL = 2e-5  # the bound tpu_gpad holds its pallas-vs-xla parity to


@pytest.fixture(scope="module")
def pair():
    d_j = tpu_gpad.dualize(
        tpu_gpad.condense(jp.battery(3, 10)), iterations=ITERS, paired="auto"
    )
    fields = {k: None if getattr(d_j, k) is None else np.asarray(getattr(d_j, k))
              for k in GPAD_TENSOR_FIELDS}
    d_t = gpad_data_from_numpy(
        fields, {k: getattr(d_j, k) for k in GPAD_META_FIELDS}, device="cpu")
    return d_j, d_t


def _inputs(d_j, B, seed=0):
    X0 = np.random.default_rng(seed).uniform(-0.4, 0.4, (B, d_j.n_x))
    g_P, p_D = j_affine_params(d_j, jnp.asarray(X0, dtype=jnp.float32))
    return np.array(g_P), np.array(p_D)  # writable copies for torch


def _run_both(d_j, d_t, g_P, p_D, y0=None, diagnostics=True):
    out_j = jkernels.gpad_pallas_fixed_paired_flat(
        d_j, jnp.asarray(g_P), jnp.asarray(p_D),
        None if y0 is None else jnp.asarray(y0),
        iterations=ITERS, interpret=True, diagnostics=diagnostics,
    )
    out_t = kernels.gpad_fixed_paired_flat(
        d_t, torch.from_numpy(g_P), torch.from_numpy(p_D),
        None if y0 is None else torch.from_numpy(np.ascontiguousarray(y0)),
        iterations=ITERS, diagnostics=diagnostics,
    )
    return out_j, out_t


def _assert_close(out_j, out_t):
    for name, a, b in zip(("z", "y", "w", "zhat"), out_j, out_t):
        if a is None:
            assert b is None, name
            continue
        assert tuple(b.shape) == tuple(a.shape), name
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL, rtol=0,
                                   err_msg=name)


def _warm_y0(d_j, B, seed):
    """A nonnegative dual near the cold solution's scale."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 0.5, (B, 2, d_j.m_half)).astype(np.float32)


@pytest.mark.parametrize(
    "case",
    ["cold", "warm_shared", "warm_one_row", "warm_per_scenario",
     "no_diagnostics", "soft", "B1", "B5"],
)
def test_plain_version_matches_pallas_interpret(pair, case):
    d_j, d_t = pair
    B = {"B1": 1, "B5": 5}.get(case, 6)
    g_P, p_D = _inputs(d_j, B, seed=B)
    y0 = None
    diagnostics = True
    if case == "warm_shared":
        y0 = _warm_y0(d_j, 1, 1)[0]  # (2, m_h)
    elif case == "warm_one_row":
        y0 = _warm_y0(d_j, 1, 2)  # (1, 2, m_h)
    elif case in ("warm_per_scenario", "B1", "B5"):
        y0 = _warm_y0(d_j, B, 3)  # (B, 2, m_h)
    elif case == "no_diagnostics":
        diagnostics = False
    elif case == "soft":
        damp = np.random.default_rng(4).uniform(0.0, 0.2, d_j.m_half)
        damp = damp.astype(np.float32)
        d_j = dataclasses.replace(d_j, soft_damp=jnp.asarray(damp))
        d_t = dataclasses.replace(d_t, soft_damp=torch.from_numpy(damp))
    out_j, out_t = _run_both(d_j, d_t, g_P, p_D, y0, diagnostics)
    _assert_close(out_j, out_t)
    if not diagnostics:
        assert out_t[2] is None and out_t[3] is None


def test_cpu_wrapper_does_not_count_launches(pair):
    _, d_t = pair
    before = kernels.PAIRED_FLAT_LAUNCHES
    g_P = torch.zeros((3, d_t.n_z))
    p_D = torch.zeros((3, 2, d_t.m_half))
    kernels.gpad_fixed_paired_flat(d_t, g_P, p_D, iterations=5)
    assert kernels.PAIRED_FLAT_LAUNCHES == before


def test_forced_cuda_engine_on_cpu_raises(pair):
    _, d_t = pair
    kernels.PAIRED_FLAT_LAUNCHES = 0
    X0 = np.zeros((4, d_t.n_x), np.float32)
    cfg = tpu_gpad_torch.SolverConfig(engine="cuda", form="mvp")
    with pytest.raises(ValueError, match="CUDA device"):
        tpu_gpad_torch.solve_batch(d_t, X0, cfg)
    assert kernels.PAIRED_FLAT_LAUNCHES == 0


def test_wrapper_rejects_bad_inputs(pair):
    _, d_t = pair
    g_P = torch.zeros((3, d_t.n_z))
    p_D = torch.zeros((3, 2, d_t.m_half))
    with pytest.raises(ValueError, match="p_D"):
        kernels.gpad_fixed_paired_flat(d_t, g_P, p_D[:2], iterations=5)
    with pytest.raises(ValueError, match="float32"):
        kernels.gpad_fixed_paired_flat(d_t, g_P.double(), p_D, iterations=5)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.gpad_fixed_paired_flat(
            d_t, g_P, p_D, torch.zeros((2, d_t.m_half)).t().contiguous().t(),
            iterations=5)
    with pytest.raises(ValueError, match="broadcast"):
        kernels.gpad_fixed_paired_flat(
            d_t, g_P, p_D, torch.zeros((2, 2, d_t.m_half)), iterations=5)
    with pytest.raises(ValueError, match="exceed"):
        kernels.gpad_fixed_paired_flat(d_t, g_P, p_D, iterations=ITERS + 1)
    dense = tpu_gpad_torch.dualize(
        tpu_gpad_torch.condense(tpu_gpad_torch.problems.battery(3, 4)),
        iterations=5, paired=False, device="cpu")
    with pytest.raises(ValueError, match="identity block"):
        kernels.gpad_fixed_paired_flat(
            dense, torch.zeros((1, dense.n_z)), torch.zeros((1, 2, 1)),
            iterations=5)


def test_shared_memory_guard():
    """The guard admits the headline and battery(5, 20) shapes and refuses
    the reference's 30x30 flagship, whose operands alone are 9.7 MB."""
    def data(n, N):
        return tpu_gpad_torch.dualize(
            tpu_gpad_torch.condense(tpu_gpad_torch.problems.battery(n, N)),
            iterations=5, paired="auto", device="cpu")

    head, mid = data(3, 10), data(5, 20)
    assert kernels.flat_fits_smem(head) and kernels.flat_fits_smem(mid)
    plan = kernels._paired_plan
    assert plan(70, 30, 40, 4096).log2_tile == kernels.PAIRED_MAX_LOG2_TILE
    assert plan(70, 30, 40, 3).log2_tile == 0  # 1 per block below 128 blocks
    assert plan(70, 30, 40, 1).log2_tile == 0
    # n5 N20 at B1024: 4 per block, where a thread's registers stop it
    assert plan(220, 100, 120, 1024).log2_tile == 2
    assert kernels._paired_smem_bytes(
        70, 30, 40, plan(70, 30, 40, 4096)) <= kernels.SMEM_LIMIT_BYTES
    assert not kernels.flat_fits_smem(data(30, 30))
    dense = tpu_gpad_torch.dualize(
        tpu_gpad_torch.condense(tpu_gpad_torch.problems.battery(3, 4)),
        iterations=5, paired=False, device="cpu")
    assert not kernels.flat_fits_smem(dense)
