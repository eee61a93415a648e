"""The dense and full paired kernels' wrappers on CPU tensors (their plain
torch versions) against ``tpu_gpad``'s Pallas kernels ``gpad_pallas_fixed``
and ``gpad_pallas_fixed_paired`` in interpret mode, on the same g_P, p_D
and y0; and ``core.cuda_kernel``'s routing. The CUDA kernels themselves
are held against the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_gpad
from tpu_gpad import problems as jp
from tpu_gpad.solver import kernels as jkernels
from tpu_gpad.solver.core import affine_params as j_affine_params

import tpu_gpad_torch as tg
from tpu_gpad_torch.convert import gpad_data_from_numpy
from tpu_gpad_torch.solver import SolverConfig, core, kernels
from tpu_gpad_torch.types import GPAD_META_FIELDS, GPAD_TENSOR_FIELDS

torch.set_num_threads(2)

ITERS = 40
TOL = 1e-5  # fp32 sums in another order over 40 iterations


def _pair(paired):
    d_j = tpu_gpad.dualize(tpu_gpad.condense(jp.battery(3, 4)),
                           iterations=ITERS, paired=paired)
    fields = {k: None if getattr(d_j, k) is None else np.asarray(getattr(d_j, k))
              for k in GPAD_TENSOR_FIELDS}
    d_t = gpad_data_from_numpy(
        fields, {k: getattr(d_j, k) for k in GPAD_META_FIELDS}, device="cpu")
    return d_j, d_t


@pytest.fixture(scope="module")
def dense():
    return _pair(False)


@pytest.fixture(scope="module")
def paired():
    return _pair("auto")


def _inputs(d_j, B, seed):
    X0 = np.random.default_rng(seed).uniform(-0.4, 0.4, (B, d_j.n_x))
    g_P, p_D = j_affine_params(d_j, jnp.asarray(X0, dtype=jnp.float32))
    return np.array(g_P), np.array(p_D)  # writable copies for torch


def _assert_close(out_j, out_t):
    for name, a, b in zip(("z", "y", "w", "zhat"), out_j, out_t):
        if a is None:
            assert b is None, name
            continue
        assert tuple(b.shape) == tuple(a.shape), name
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL, rtol=0,
                                   err_msg=name)


def _run(jfn, tfn, d_j, d_t, B, seed, y0=None, diagnostics=True):
    g_P, p_D = _inputs(d_j, B, seed)
    out_j = jfn(d_j, jnp.asarray(g_P), jnp.asarray(p_D),
                None if y0 is None else jnp.asarray(y0),
                iterations=ITERS, interpret=True, diagnostics=diagnostics)
    out_t = tfn(d_t, torch.from_numpy(g_P), torch.from_numpy(p_D),
                None if y0 is None else torch.from_numpy(np.ascontiguousarray(y0)),
                iterations=ITERS, diagnostics=diagnostics)
    _assert_close(out_j, out_t)
    return out_t


@pytest.mark.parametrize("case", ["cold", "warm_shared", "warm_per_scenario",
                                  "no_diagnostics", "B5"])
def test_dense_plain_matches_pallas_interpret(dense, case):
    d_j, d_t = dense
    B = 5 if case == "B5" else 6
    rng = np.random.default_rng(7)
    y0 = None
    if case == "warm_shared":
        y0 = rng.uniform(0.0, 0.5, (d_t.m,)).astype(np.float32)
    elif case in ("warm_per_scenario", "B5"):
        y0 = rng.uniform(0.0, 0.5, (B, d_t.m)).astype(np.float32)
    before = kernels.DENSE_LAUNCHES
    out = _run(jkernels.gpad_pallas_fixed, kernels.gpad_fixed_dense, d_j, d_t,
               B, seed=B, y0=y0, diagnostics=case != "no_diagnostics")
    assert kernels.DENSE_LAUNCHES == before  # CPU tensors: the plain version
    if case == "no_diagnostics":
        assert out[2] is None and out[3] is None


@pytest.mark.parametrize("case", ["cold", "warm_per_scenario", "no_diagnostics",
                                  "soft", "B5"])
def test_paired_plain_matches_pallas_interpret(paired, case):
    d_j, d_t = paired
    B = 5 if case == "B5" else 6
    rng = np.random.default_rng(8)
    y0 = None
    if case in ("warm_per_scenario", "B5"):
        y0 = rng.uniform(0.0, 0.5, (B, 2, d_t.m_half)).astype(np.float32)
    if case == "soft":
        damp = rng.uniform(0.0, 0.2, d_t.m_half).astype(np.float32)
        d_j = dataclasses.replace(d_j, soft_damp=jnp.asarray(damp))
        d_t = dataclasses.replace(d_t, soft_damp=torch.from_numpy(damp))
    before = kernels.PAIRED_LAUNCHES
    _run(jkernels.gpad_pallas_fixed_paired, kernels.gpad_fixed_paired, d_j, d_t,
         B, seed=B, y0=y0, diagnostics=case != "no_diagnostics")
    assert kernels.PAIRED_LAUNCHES == before


def test_wrappers_refuse_what_the_kernels_do_not_take(dense, paired):
    _, d_t = dense
    _, p_t = paired
    g_P = torch.zeros((3, d_t.n_z))
    with pytest.raises(ValueError, match="p_D"):
        kernels.gpad_fixed_dense(d_t, g_P, torch.zeros((3, 2, d_t.m)),
                                 iterations=5)
    with pytest.raises(ValueError, match="broadcast"):
        kernels.gpad_fixed_dense(d_t, g_P, torch.zeros((3, d_t.m)),
                                 torch.zeros((2, d_t.m)), iterations=5)
    with pytest.raises(ValueError, match="soft"):
        kernels.gpad_fixed_dense(
            dataclasses.replace(d_t, soft_damp=torch.zeros(d_t.m)), g_P,
            torch.zeros((3, d_t.m)), iterations=5)
    with pytest.raises(ValueError, match="unpaired"):
        kernels.gpad_fixed_dense(p_t, g_P, torch.zeros((3, 2, p_t.m_half)),
                                 iterations=5)
    with pytest.raises(ValueError, match="paired data"):
        kernels.gpad_fixed_paired(d_t, g_P, torch.zeros((3, 2, 1)), iterations=5)
    with pytest.raises(ValueError, match="exceed"):
        kernels.gpad_fixed_paired(p_t, g_P, torch.zeros((3, 2, p_t.m_half)),
                                  iterations=ITERS + 1)


def test_cuda_kernel_routing(dense, paired):
    """The kernel ``engine="auto"`` would launch on the card, by layout and
    configuration (the router reads shapes, not the device)."""
    _, d_t = dense
    _, p_t = paired
    soft = dataclasses.replace(d_t, soft_damp=torch.zeros(d_t.m))
    assert core.cuda_kernel(d_t, SolverConfig()) == "dense"
    assert core.cuda_kernel(d_t, SolverConfig(form="mvp")) == "dense"
    assert core.cuda_kernel(soft, SolverConfig()) is None
    assert core.cuda_kernel(d_t, SolverConfig(restart=True)) is None
    assert core.cuda_kernel(d_t, SolverConfig(mode="eps")) is None
    assert core.cuda_kernel(p_t, SolverConfig(form="mvp", flat="off")) == "paired"
    assert core.cuda_kernel(p_t, SolverConfig(form="mvp")) == "paired_flat"
    assert core.cuda_kernel(p_t, SolverConfig(form="mvp", restart=True)) is None
    no_block = dataclasses.replace(p_t, n_struct=None, D=None)
    assert core.cuda_kernel(no_block, SolverConfig()) == "paired"
    assert core.cuda_kernel(p_t, SolverConfig(form="dual")) == "dual"


def test_cuda_kernel_routing_past_shared_memory(dense, paired, monkeypatch):
    """Where the resident kernels' shared memory declines, the dense loop
    takes the tiled dense kernel and the full paired loop the flat tiled
    kernel at n_s = m_h, soft rows or not (the dense loop's soft rows,
    restart and eps still route nowhere)."""
    _, d_t = dense
    _, p_t = paired
    monkeypatch.setattr(kernels, "dense_fits_smem", lambda data: False)
    monkeypatch.setattr(kernels, "paired_fits_smem", lambda data: False)
    soft = dataclasses.replace(d_t, soft_damp=torch.zeros(d_t.m))
    for engine in ("auto", "cuda"):
        cfg = SolverConfig(engine=engine)
        assert core.cuda_kernel(d_t, cfg) == "dense_tiled"
        assert core.cuda_kernel(soft, cfg) is None
        assert core.cuda_kernel(d_t, SolverConfig(engine=engine,
                                                  restart=True)) is None
        assert core.cuda_kernel(d_t, SolverConfig(engine=engine,
                                                  mode="eps")) is None
        assert core.cuda_kernel(p_t, SolverConfig(
            engine=engine, form="mvp", flat="off")) == "paired_tiled"
        no_block = dataclasses.replace(p_t, n_struct=None, D=None)
        assert core.cuda_kernel(no_block, cfg) == "paired_tiled"
        assert core.cuda_kernel(dataclasses.replace(
            no_block, soft_damp=torch.zeros(p_t.m_half)),
            cfg) == "paired_tiled"
        # the flat routes are as they were
        assert core.cuda_kernel(p_t, SolverConfig(engine=engine,
                                                  form="mvp")) == "paired_flat"


def test_shared_memory_guards():
    """The dense guard admits battery n3 N10 and n3 N20 (n_z 60, m 280) at a
    tile of 16 and refuses the reference's 30x30 flagship; the full paired
    guard admits the headline shape. The dense tile shrinks at the serving
    batch so that the grid fills the card."""
    def data(n, N, paired):
        return tg.dualize(tg.condense(tg.problems.battery(n, N)), iterations=5,
                          paired=paired, device="cpu")

    n10, n20 = data(3, 10, False), data(3, 20, False)
    assert (n10.m, n10.n_z, n20.m, n20.n_z) == (140, 30, 280, 60)
    assert kernels.dense_fits_smem(n10) and kernels.dense_fits_smem(n20)
    near = kernels._dense_plan(280, 60, 4096)
    assert near.log2_tile == 4 and near.vec == 4
    assert kernels._dense_smem_bytes(280, 60, near) <= kernels.SMEM_LIMIT_BYTES
    assert kernels._dense_plan(140, 30, 4096).log2_tile == 4
    assert kernels._dense_plan(140, 30, 3).log2_tile == 0  # fills the card
    assert kernels._dense_plan(140, 30, 256).log2_tile == 1  # 128 blocks
    assert not kernels.dense_fits_smem(data(30, 30, False))
    head = data(3, 10, "auto")
    assert kernels.paired_fits_smem(head) and not kernels.dense_fits_smem(head)
    assert not kernels.paired_fits_smem(n10)
    assert not kernels.paired_fits_smem(data(30, 30, "auto"))
    # past them the tiled routes: battery n5 N20 dense (m 440) and n5 N30
    # paired (m_h 330), JAX's Pallas kernels' reach
    n5 = data(5, 20, False)
    assert not kernels.dense_fits_smem(n5) and kernels.dense_tiled_fits(n5)
    mid = data(5, 30, "auto")
    assert not kernels.paired_fits_smem(mid) and kernels.paired_tiled_fits(mid)
