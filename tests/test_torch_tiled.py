"""The tiled (streamed) kernels' wrappers on CPU tensors (their plain torch
versions) against ``tpu_gpad``'s streamed Pallas kernels in interpret mode,
with row chunks forced small so their multi-chunk grids run; the eps loop
on the tiled chunk kernel against ``tpu_gpad``'s; the routing table at the
reference's 30x30 flagship; and the guards. The CUDA kernels themselves are
held against the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_gpad
from tpu_gpad import problems as jp
from tpu_gpad.solver import SolverConfig as JConfig
from tpu_gpad.solver import kernels as jkernels
from tpu_gpad.solver import solve_batch as j_solve_batch
from tpu_gpad.solver.core import affine_params as j_affine_params

import tpu_gpad_torch
from tpu_gpad_torch.convert import gpad_data_from_numpy
from tpu_gpad_torch.solver import SolverConfig, core, dual_kernels, kernels
from tpu_gpad_torch.types import GPAD_META_FIELDS, GPAD_TENSOR_FIELDS

torch.set_num_threads(2)

ITERS = 60
TOL = 2e-5  # the bound tests/test_tiled.py and test_flat_tiled.py hold
EPS_U_TOL = 2e-4  # eps runs stop at different windows (tests/test_tiled.py)


def _carry(d_j):
    fields = {k: None if getattr(d_j, k) is None else np.asarray(getattr(d_j, k))
              for k in GPAD_TENSOR_FIELDS}
    return gpad_data_from_numpy(
        fields, {k: getattr(d_j, k) for k in GPAD_META_FIELDS}, device="cpu")


@pytest.fixture(scope="module")
def pair():
    d_j = tpu_gpad.dualize(
        tpu_gpad.condense(jp.battery(3, 10)), iterations=100, paired="auto")
    return d_j, _carry(d_j)


@pytest.fixture(scope="module")
def flagship():
    """battery(30, 30) on the CPU: n_z 900, m_h 1830, n_struct 930."""
    return tpu_gpad_torch.dualize(
        tpu_gpad_torch.condense(tpu_gpad_torch.problems.battery(30, 30)),
        iterations=100, paired="auto", device="cpu")


def _inputs(d_j, B, seed=0):
    X0 = np.random.default_rng(seed).uniform(-0.4, 0.4, (B, d_j.n_x))
    g_P, p_D = j_affine_params(d_j, jnp.asarray(X0, dtype=jnp.float32))
    return np.array(g_P), np.array(p_D)  # writable copies for torch


def _warm_y0(d_j, B, seed):
    return np.random.default_rng(seed).uniform(
        0.0, 0.5, (B, 2, d_j.m_half)).astype(np.float32)


def _y0(case, d_j, B):
    if case == "warm_shared":
        return _warm_y0(d_j, 1, 1)[0]  # (2, m_h)
    if case in ("warm", "restart_warm"):
        return _warm_y0(d_j, B, 2)  # (B, 2, m_h)
    return None


def _assert_outputs(out_j, out_t):
    for name, a, b in zip(("z", "y", "w", "zhat"), out_j, out_t):
        if a is None:
            assert b is None, name
            continue
        assert tuple(b.shape) == tuple(a.shape), name
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("row_tile", [8, 16])
@pytest.mark.parametrize(
    "case", ["cold", "warm", "warm_shared", "restart", "restart_warm",
             "no_diagnostics"])
def test_dual_tiled_matches_pallas_interpret(pair, case, row_tile):
    """m_h = 70 in row chunks of 8 or 16: D's row grid of 9 or 5 chunks."""
    d_j, d_t = pair
    g_P, p_D = _inputs(d_j, 6, seed=row_tile)
    y0 = _y0(case, d_j, 6)
    kw = dict(iterations=ITERS, restart=case.startswith("restart"),
              diagnostics=case != "no_diagnostics")
    out_j = jkernels.gpad_pallas_fixed_dual_tiled(
        d_j, jnp.asarray(g_P), jnp.asarray(p_D),
        None if y0 is None else jnp.asarray(y0), interpret=True,
        row_tile=row_tile, **kw)
    out_t = dual_kernels.gpad_fixed_dual_tiled(
        d_t, torch.from_numpy(g_P), torch.from_numpy(p_D),
        None if y0 is None else torch.from_numpy(y0), **kw)
    _assert_outputs(out_j, out_t)


@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("case", ["cold", "warm", "warm_shared",
                                  "no_diagnostics"])
def test_flat_tiled_matches_pallas_interpret(pair, case, tile):
    """n_s 40, n_z 30 in chunks of 8 or 16: MGf column and GLs row grids of
    several chunks each, box rows on the last."""
    d_j, d_t = pair
    g_P, p_D = _inputs(d_j, 6, seed=tile + 1)
    y0 = _y0(case, d_j, 6)
    kw = dict(iterations=ITERS, diagnostics=case != "no_diagnostics")
    out_j = jkernels.gpad_pallas_fixed_flat_tiled(
        d_j, jnp.asarray(g_P), jnp.asarray(p_D),
        None if y0 is None else jnp.asarray(y0), interpret=True, tile=tile,
        **kw)
    out_t = kernels.gpad_fixed_flat_tiled(
        d_t, torch.from_numpy(g_P), torch.from_numpy(p_D),
        None if y0 is None else torch.from_numpy(y0), **kw)
    _assert_outputs(out_j, out_t)


def test_flat_tiled_serving_mode_bit_identical(pair):
    """diagnostics=False drops w/zhat; z and y are bit-identical."""
    _, d_t = pair
    g_P, p_D = (torch.from_numpy(a) for a in _inputs(pair[0], 4, seed=5))
    z1, y1, w1, zh1 = kernels.gpad_fixed_flat_tiled(d_t, g_P, p_D,
                                                     iterations=50)
    z0, y0, w0, zh0 = kernels.gpad_fixed_flat_tiled(d_t, g_P, p_D,
                                                     iterations=50,
                                                     diagnostics=False)
    assert w0 is None and zh0 is None and w1 is not None
    assert torch.equal(z0, z1) and torch.equal(y0, y1)


@pytest.mark.parametrize("restart", [False, True], ids=["plain", "restart"])
def test_tiled_chunks_compose_to_whole_solve(pair, restart):
    """Windows of 10 on the tiled chunk wrapper reproduce one 100-iteration
    tiled solve (under restart the budget runs past the 100-entry schedule
    too)."""
    _, d_t = pair
    g_P, p_D = (torch.from_numpy(a) for a in _inputs(pair[0], 6, seed=8))
    iters = 120 if restart else 100
    z, y, w, _ = dual_kernels.gpad_fixed_dual_tiled(
        d_t, g_P, p_D, iterations=iters, restart=restart)
    c = dual_kernels.relu_offsets(d_t, g_P, p_D)
    state = (torch.zeros_like(y), torch.zeros_like(y),
             torch.zeros((6, d_t.m_half)), torch.ones((6, 2)))
    for k0 in range(0, iters, 10):
        *state, w_c = dual_kernels.gpad_dual_tiled_chunk(
            d_t, c, *state, k0=k0, chunk=10, restart=restart)
    z_c = -(state[2] @ d_t.MG_T) - g_P
    for name, a, b in (("z", z, z_c), ("y", y, state[0]), ("w", w, w_c)):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=0, msg=name)


@pytest.mark.parametrize("restart", [False, True], ids=["plain", "restart"])
def test_eps_loop_takes_tiled_chunks_when_smem_declines(pair, monkeypatch,
                                                        restart):
    """With the resident guard declining, the eps loop runs the tiled chunk
    kernel's op window by window, as tpu_gpad's eps loop runs its tiled
    chunk kernel when the whole-VMEM guard declines (tests/test_tiled.py)."""
    d_j, d_t = pair
    g_P, p_D = _inputs(d_j, 4, seed=13 + restart)
    monkeypatch.setattr(dual_kernels, "dual_fits_smem", lambda d: False)
    calls = []
    orig = dual_kernels.dual_tiled_chunk_op

    def spy(*a):
        calls.append(a[9])  # k0
        return orig(*a)

    monkeypatch.setattr(dual_kernels, "dual_tiled_chunk_op", spy)
    tol = 1e-5 if restart else 1e-4
    kw = dict(mode="eps", eps_g=tol, eps_V=tol, check_every=10,
              iterations=200 if restart else 100, restart=restart)
    res_t = dual_kernels.gpad_eps_dual(
        d_t, torch.from_numpy(g_P), torch.from_numpy(p_D), SolverConfig(**kw))
    assert calls and calls == list(range(0, 10 * len(calls), 10))
    with monkeypatch.context() as m:
        m.setattr(jkernels, "dual_fits_vmem",
                  lambda d, chunked=False, diagnostics=True: False)
        m.setattr(jkernels, "pick_lane_tile",
                  lambda B, S, n_arrays=26, extra_per_lane=0, mats=0: None)
        X0 = np.random.default_rng(13 + restart).uniform(-0.4, 0.4, (4, 3))
        res_j = j_solve_batch(d_j, jnp.asarray(X0, dtype=jnp.float32),
                              config=JConfig(engine="pallas", **kw))
    np.testing.assert_array_equal(res_t.converged.numpy(),
                                  np.asarray(res_j.converged))
    assert np.abs(res_t.iterations.numpy()
                  - np.asarray(res_j.iterations)).max() <= 10
    np.testing.assert_allclose(res_t.u.numpy(), np.asarray(res_j.u),
                               atol=EPS_U_TOL, rtol=0)
    if restart:
        assert res_t.converged.all()


# The routing at battery(30, 30), paired="auto", as the card runs it: the
# JAX package's routing on a TPU, with its XLA engine as the torch engine,
# but for the default fixed solve, which the flat tiled kernel serves (it
# beat the torch engine on an H100; PERF.md §5).
FLAGSHIP_ROUTES = [
    ("default", {}, "flat_tiled"),
    ("restart", dict(restart=True), "dual_tiled"),
    ("form_dual", dict(form="dual"), "dual_tiled"),
    ("forced", dict(engine="cuda"), "dual_tiled"),
    ("forced_mvp", dict(engine="cuda", form="mvp"), "flat_tiled"),
    ("eps", dict(mode="eps"), None),
    ("eps_flat_off", dict(mode="eps", flat="off"), "dual_tiled_chunk"),
    ("eps_forced", dict(mode="eps", engine="cuda"), "dual_tiled_chunk"),
    ("eps_restart_flat_off", dict(mode="eps", flat="off", restart=True),
     "dual_tiled_chunk"),
    ("mvp_restart", dict(form="mvp", restart=True), None),
    # the full paired loop past shared memory: the flat tiled kernel at
    # n_s = m_h, under auto too (it beat the torch engine at m_h 1830)
    ("mvp_flat_off", dict(form="mvp", flat="off"), "paired_tiled"),
    ("mvp_flat_off_forced", dict(engine="cuda", form="mvp", flat="off"),
     "paired_tiled"),
]


@pytest.mark.parametrize("kw,kernel", [r[1:] for r in FLAGSHIP_ROUTES],
                         ids=[r[0] for r in FLAGSHIP_ROUTES])
def test_flagship_routing_table(flagship, kw, kernel):
    cfg = SolverConfig(**kw)
    assert core.cuda_kernel(flagship, cfg) == kernel
    assert core.cuda_kernel(
        flagship, dataclasses.replace(cfg, diagnostics=False)) == kernel
    if cfg.engine != "cuda":  # CPU data: auto runs the torch engine
        assert core.resolve_engine(flagship, cfg) == "torch"


def test_flagship_soft_rows_route_nowhere(flagship):
    """Soft rows route nowhere the hard rows do not: every tiled kernel
    carries the damp column, so soft data at the flagship takes the hard
    routing table's kernel, the flat-on eps solve under auto none."""
    soft = dataclasses.replace(flagship, soft_damp=torch.full(
        (flagship.m_half,), 0.1))
    for _, kw, kernel in FLAGSHIP_ROUTES:
        assert core.cuda_kernel(soft, SolverConfig(**kw)) == kernel, kw


def test_tiled_guards():
    """Both guards admit the flagship and the m_h 1200 of mass_spring N100
    (tests/test_tiled.py), refuse what one block's shared memory cannot
    hold, and follow the kernels' carve-ups."""
    for m_h in (1830, 1200, 70):
        log2 = dual_kernels.pick_tiled_tiles(m_h)
        assert log2 == 0
        assert dual_kernels._dual_tiled_smem_bytes(m_h, log2) <= 227 * 1024
    assert kernels.pick_flat_tiled(1830, 900) == (0, 16, True)
    assert dual_kernels.pick_tiled_tiles(60000) is None
    assert kernels.pick_flat_tiled(60000, 30000) is None
    # both: the widest tile (at most 16 scenarios per cluster) the batch
    # fills, on clusters of 16 blocks up to 16 clusters, else of 8
    Bs = (1, 2, 3, 5, 9, 17, 256, 257, 1024)
    tiles = [dual_kernels.pick_tiled_tiles(1830, B) for B in Bs]
    assert tiles == [0, 1, 2, 3, 4, 4, 4, 4, 4]
    assert [dual_kernels.pick_tiled_cluster(t, B) for t, B in zip(tiles, Bs)
            ] == [16] * 7 + [8, 8]
    assert dual_kernels.pick_tiled_tiles(20000, 256) == 1  # 16 x wd too big
    assert [tuple(kernels.pick_flat_tiled(1830, 900, B))
            for B in (1, 33, 256, 300, 1024)] == [
        (0, 16, True), (4, 16, True), (4, 16, True), (4, 8, True),
        (4, 8, True)]
    # csrc carve-up by hand: wd of T scenarios (rows padded to 4), the row
    # groups' partial sums (1024 columns x T), 16 cluster partials per
    # scenario and 16 warp partials
    assert dual_kernels._dual_tiled_smem_bytes(1830, 2) == 4 * (
        4 * (1832 + 1024 + 16) + 16)
    assert dual_kernels._dual_tiled_smem_bytes(1830, 4) == 183872
    # the flat one: wd and zhat of T scenarios and the groups' scratch
    # (512 columns x T), or at one scenario wd and zhat alone
    assert kernels._flat_tiled_smem_bytes(1830, 900, 4) == 4 * 16 * 3242
    assert kernels._flat_tiled_smem_bytes(1830, 900, 0, False) == 4 * 2730


def test_tiled_launch_choices():
    """The tiled dual wrappers' tile and cluster: the picks, or overrides
    the kernels take (a tile up to 16 that fits, a cluster of 1 to 16
    blocks, a power of two)."""
    pick = dual_kernels._tiled_tile_or_raise
    assert pick(1830, 256, None, None) == (4, 16)
    assert pick(1830, 1024, None, None) == (4, 8)
    assert pick(1830, 1, None, 8) == (0, 8)
    assert pick(70, 33, 2, 1) == (2, 1)
    for tile, cluster, match in ((5, None, "log2_tile"), (0, 3, "cluster"),
                                 (0, 32, "cluster"), (-1, None, "log2_tile")):
        with pytest.raises(ValueError, match=match):
            pick(1830, 256, tile, cluster)
    with pytest.raises(ValueError, match="shared memory"):
        pick(20000, 256, 4, None)  # 16 scenarios' wd past 227 KB
    with pytest.raises(ValueError, match="engine='torch'"):
        pick(60000, 1, None, None)


def test_tiled_fits_refusals(pair, flagship):
    _, d_t = pair
    assert dual_kernels.dual_tiled_fits(d_t) and kernels.flat_tiled_fits(d_t)
    assert dual_kernels.dual_tiled_fits(flagship)
    assert kernels.flat_tiled_fits(flagship)
    assert not dual_kernels.dual_fits_smem(flagship)
    assert not kernels.flat_fits_smem(flagship)
    soft = dataclasses.replace(d_t, soft_damp=torch.zeros(d_t.m_half))
    assert dual_kernels.dual_tiled_fits(soft)  # soft rows are carried
    assert kernels.flat_tiled_fits(soft)
    assert not dual_kernels.dual_tiled_fits(dataclasses.replace(d_t, D=None))
    assert not kernels.flat_tiled_fits(dataclasses.replace(d_t, n_struct=0))
    assert not kernels.flat_tiled_fits(dataclasses.replace(d_t, n_struct=None))
    dense = tpu_gpad_torch.dualize(
        tpu_gpad_torch.condense(tpu_gpad_torch.problems.battery(3, 4)),
        iterations=5, paired=False, device="cpu")
    assert not dual_kernels.dual_tiled_fits(dense)
    assert not kernels.flat_tiled_fits(dense)


def test_tiled_wrappers_reject_bad_inputs(pair):
    _, d_t = pair
    g_P = torch.zeros((3, d_t.n_z))
    p_D = torch.zeros((3, 2, d_t.m_half))
    # soft rows are carried: each wrapper's plain version on soft data
    soft = dataclasses.replace(d_t, soft_damp=torch.full((d_t.m_half,), 0.2))
    g_s = torch.full((3, d_t.n_z), 0.1)
    p_s = torch.full((3, 2, d_t.m_half), -0.05)
    for tiled, plain in (
            (dual_kernels.gpad_fixed_dual_tiled,
             dual_kernels.gpad_fixed_dual_torch),
            (kernels.gpad_fixed_flat_tiled,
             kernels.gpad_fixed_paired_flat_torch)):
        for a, b in zip(tiled(soft, g_s, p_s, iterations=5),
                        plain(soft, g_s, p_s, iterations=5)):
            assert torch.equal(a, b)
    y, s, mom = p_D, torch.zeros((3, d_t.m_half)), torch.ones((3, 2))
    for a, b in zip(dual_kernels.gpad_dual_tiled_chunk(
            soft, p_s, y, y, s, mom, k0=0, chunk=5),
            dual_kernels.gpad_dual_chunk_torch(soft, p_s, y, y, s, mom, k0=0,
                                               chunk=5)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="p_D"):
        dual_kernels.gpad_fixed_dual_tiled(d_t, g_P, p_D[:2], iterations=5)
    with pytest.raises(ValueError, match="exceed"):
        dual_kernels.gpad_fixed_dual_tiled(d_t, g_P, p_D, iterations=101)
    with pytest.raises(ValueError, match="exceed"):
        kernels.gpad_fixed_flat_tiled(d_t, g_P, p_D, iterations=101)
    with pytest.raises(ValueError, match="non-empty"):
        kernels.gpad_fixed_flat_tiled(dataclasses.replace(d_t, n_struct=0),
                                      g_P, p_D, iterations=5)
    with pytest.raises(ValueError, match="mom"):
        dual_kernels.gpad_dual_tiled_chunk(d_t, p_D, y, y, s, mom[:, :1],
                                           k0=0, chunk=5)


def test_cpu_wrappers_do_not_count_launches(pair):
    _, d_t = pair
    before = (dual_kernels.DUAL_TILED_LAUNCHES,
              dual_kernels.DUAL_TILED_CHUNK_LAUNCHES, kernels.FLAT_TILED_LAUNCHES)
    g_P = torch.zeros((3, d_t.n_z))
    p_D = torch.zeros((3, 2, d_t.m_half))
    dual_kernels.gpad_fixed_dual_tiled(d_t, g_P, p_D, iterations=5, restart=True)
    kernels.gpad_fixed_flat_tiled(d_t, g_P, p_D, iterations=5)
    dual_kernels.gpad_dual_tiled_chunk(d_t, p_D, p_D, p_D,
                                       torch.zeros((3, d_t.m_half)),
                                       torch.ones((3, 2)), k0=0, chunk=5)
    assert (dual_kernels.DUAL_TILED_LAUNCHES,
            dual_kernels.DUAL_TILED_CHUNK_LAUNCHES,
            kernels.FLAT_TILED_LAUNCHES) == before
