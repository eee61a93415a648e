"""The resident stage-wise kernel's design on the CPU: its segmented chains
(``stagewise_kernel.chain_segmented``) against the sequential ones and
NumPy float64 products, the plain version run segment by segment as the
kernel runs (``stagewise_plain(warps=...)``) against the plain version and
against ``tpu_gpad.stagewise_kernel.solve_stagewise_pallas`` in interpret
mode, and the kernel's carve-up: every shape the earlier carve-up admitted
is admitted, and the launch picks."""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gpad import problems as jp
from tpu_gpad import stagewise as js
from tpu_gpad.stagewise_kernel import solve_stagewise_pallas

from tpu_gpad_torch import problems as tp
from tpu_gpad_torch import stagewise as ts
from tpu_gpad_torch import stagewise_kernel as sk
from tpu_gpad_torch.solver import kernels

torch.set_num_threads(2)

ITERS = 40
TOL = 1e-5  # plain version vs interpret-mode kernel, fixed budget
RESTART_TOL = 5e-5  # u and z under restart: tpu_gpad's pallas-vs-xla bound
F64_TOL = 1e-12  # segmented against sequential chains, float64
OUT = ("u0", "zu", "y", "residual", "gap")


def _mats(rng, L, n):
    """Step matrices of spectral radius below 1, as a stable closed loop's
    E blocks are: the chains stay of order 1."""
    return torch.as_tensor(rng.normal(0, 0.7 / np.sqrt(n), (L, n, n)))


@pytest.mark.parametrize("N,W", [(60, 16), (60, 8), (12, 16), (17, 8),
                                 (7, 16), (2, 8), (1, 16)])
def test_segment_products_match_numpy(N, W):
    """Each carried segment's product of step matrices, against NumPy's
    float64 products over the same stages."""
    rng = np.random.default_rng(N * 100 + W)
    n = 5
    for backward in (True, False):
        L = N - 1 if backward else N
        mats = _mats(rng, max(L, 1), n)
        Q = sk.segment_products(mats, N, W, backward)
        M = mats.numpy()
        for j, (k0, k1) in enumerate(sk.segment_bounds(N, W)):
            carried = k0 < k1 and not (k1 == N if backward else k0 == 0)
            assert (j in Q) == carried, (j, k0, k1)
            if not carried:
                continue
            want = np.eye(n)
            steps = (range(min(k1, N - 1) - 1, k0 - 1, -1) if backward
                     else range(k0, k1))
            for k in steps:
                want = want @ M[k]
            np.testing.assert_allclose(Q[j].numpy(), want, atol=F64_TOL,
                                       rtol=0)


@pytest.mark.parametrize("N,W", [(60, 16), (60, 8), (13, 16), (17, 8),
                                 (5, 8), (2, 16), (1, 8)])
def test_segmented_chain_matches_sequential(N, W):
    """Both chains, segmented over W warps (zero entries, carried entries,
    reruns), against the stage-by-stage chains, float64; N not a multiple
    of W, and N < W where most warps own no stage."""
    rng = np.random.default_rng(N + W)
    n, B = 6, 3
    a = torch.as_tensor(rng.normal(0, 1.0, (B, N, n)))
    x0 = torch.as_tensor(rng.normal(0, 1.0, (B, n)))
    for backward, L in ((True, N - 1), (False, N)):
        mats = _mats(rng, max(L, 1), n)
        seq = sk.chain_segmented(a.clone(), mats, None, backward, x0)
        seg = sk.chain_segmented(a.clone(), mats, W, backward, x0)
        torch.testing.assert_close(seg, seq, atol=F64_TOL, rtol=0)


def test_segment_bounds_cover_the_horizon():
    for N in (1, 2, 7, 16, 60, 61, 200):
        for W in (8, 16):
            b = sk.segment_bounds(N, W)
            assert b[0][0] == 0 and b[-1][1] == N and len(b) == W
            assert all(k1 == b[w + 1][0] for w, (_, k1) in enumerate(b[:-1]))
            assert max(k1 - k0 for k0, k1 in b) == -(-N // W)


def _pack64(d_t):
    pk = sk.pack_stagewise_constants(d_t)
    return sk.StagewisePack(**{f.name: getattr(pk, f.name).double()
                               for f in dataclasses.fields(pk)})


@pytest.mark.parametrize("n,N", [(8, 60), (3, 6), (8, 12), (3, 1), (3, 2),
                                 (5, 17)])
@pytest.mark.parametrize("restart", [False, True])
def test_segmented_plain_matches_plain_in_float64(n, N, restart):
    d_t = ts.build_stagewise(tp.battery(n, N), iterations=ITERS, device="cpu")
    pk = _pack64(d_t)
    x0 = torch.as_tensor(np.random.default_rng(n).uniform(-0.3, 0.3, (4, n)))
    ref = sk.stagewise_plain(pk, x0, iterations=ITERS, restart=restart)
    for W in sk._RES_WARPS:
        out = sk.stagewise_plain(pk, x0, iterations=ITERS, restart=restart,
                                 warps=W)
        for name, a, b in zip(OUT, out, ref):
            torch.testing.assert_close(a, b, atol=F64_TOL, rtol=0, msg=name)


def _problems(case):
    if case == "di":  # n_x 2, n_u 1
        return jp.double_integrator(horizon=9), tp.double_integrator(horizon=9)
    n, N = (int(v) for v in case[1:].split("N"))
    return jp.battery(n, N), tp.battery(n, N)


@pytest.mark.parametrize("case", ["n3N6", "n8N12", "n3N19", "n3N1", "n3N2",
                                  "di"])
@pytest.mark.parametrize("variant", ["cold", "warm", "restart"])
def test_segmented_plain_matches_interpret_kernel(case, variant):
    """The plain version with the resident kernel's segmented chains (16
    warps) against the TPU kernel in interpret mode: n3 N6 and n8 N12, N19
    (not a multiple of 16), N = 1, N = 2 and n_x != n_u."""
    p_j, p_t = _problems(case)
    d_j = js.build_stagewise(p_j, iterations=ITERS)
    d_t = ts.build_stagewise(p_t, iterations=ITERS, device="cpu")
    X0 = np.random.default_rng(7).uniform(
        -0.3, 0.3, (4, d_t.n_x)).astype(np.float32)
    y0 = None
    if variant == "warm":
        y0 = np.asarray(js.solve_stagewise(
            d_j, jnp.asarray(X0 * 0.8), iterations=ITERS, engine="xla",
            scan="sequential").y)
    restart = variant == "restart"
    out_j = solve_stagewise_pallas(
        d_j, jnp.asarray(X0), iterations=ITERS, restart=restart,
        interpret=True, y0=None if y0 is None else jnp.asarray(y0))
    out_t = sk.stagewise_plain(
        sk.pack_stagewise_constants(d_t), torch.as_tensor(X0),
        None if y0 is None else torch.as_tensor(y0), iterations=ITERS,
        restart=restart, warps=16)
    names = OUT[:2] if restart else OUT
    for name, a, b in zip(OUT, out_j, out_t):
        assert tuple(a.shape) == tuple(b.shape), name
        if name in names:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=RESTART_TOL if restart else TOL,
                                       err_msg=name)


def _old_floats(N, n, p, m_x, m_u):
    """The earlier resident carve-up at one scenario (8 warps, every slab
    in shared memory, kff a slab of its own), in floats."""
    up4 = lambda x: (x + 3) // 4 * 4
    m = m_x + m_u
    return (up4(m_x * (n | 1)) + up4(m_u * (p | 1)) + up4(n)
            + up4(8 * max(m, p)) + up4(16) + up4(3) + up4(N * n)
            + 3 * up4(N * p) + 2 * up4(N * m))


def test_guard_admits_every_shape_the_earlier_carve_up_did():
    """For every (n, p, m_x, m_u) of a grid (n, p <= 32, row counts 1 to
    233), the longest horizon the earlier guard admitted is admitted now,
    at one scenario, 8 warps and the chains in device memory; the carve-up
    grows with N, so every shorter horizon is admitted too."""
    limit = kernels.SMEM_LIMIT_BYTES // 4
    rows = (1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144, 233)
    checked = 0
    for n in range(1, 33):
        for p in range(1, 33):
            for m_x in rows:
                for m_u in rows:
                    per = n + 3 * p + 2 * (m_x + m_u)
                    N = max(1, (limit - _old_floats(0, n, p, m_x, m_u)) // per)
                    while N > 1 and _old_floats(N, n, p, m_x, m_u) > limit:
                        N -= 1
                    while _old_floats(N + 1, n, p, m_x, m_u) <= limit:
                        N += 1
                    if _old_floats(N, n, p, m_x, m_u) > limit:
                        continue  # not even N = 1 was admitted
                    assert sk._resident_floats((N, n, p, m_x, m_u), 1, 8,
                                               False) <= limit, (N, n, p, m_x, m_u)
                    checked += 1
    assert checked == 32 * 32 * len(rows) ** 2
    # the public guard on a few of them
    for n, p, m_x, m_u, N in ((8, 8, 16, 18, 1704), (32, 32, 1, 1, 427),
                              (1, 1, 233, 233, 61)):
        data = SimpleNamespace(horizon=N, n_x=n, n_u=p, m_x=m_x, m_u=m_u)
        assert sk.stagewise_fits_smem(data, 1) == (
            4 * _old_floats(N, n, p, m_x, m_u) <= kernels.SMEM_LIMIT_BYTES)


def test_launch_picks():
    """The resident launch at n8 N60: 16 warps; the narrowest tile whose
    grid runs in one wave, else the widest; the chains staged in shared
    memory where the stage constants do not fit the L1 the block leaves
    (8 scenarios, 221,136 bytes, one block per SM), else read from device
    memory; longer horizons stage two scenarios' chains, wider states read
    them from device memory. And the routing rule between the two kernels,
    at the shapes the H100 sweep measured."""
    d8 = ts.build_stagewise(tp.battery(8, 60), iterations=5, L=1.0,
                            device="cpu")
    dims = sk._dims(d8)
    # by hand: G blocks 144 + 164, x0 64, 16 scratch blocks of 34 x 8,
    # 2 x 16 x 8 partials, the segment products 2 x 16 x 64, 16 staging
    # blocks of 4 x 64, st, zu, ru 60 x 8 x 8 each, y, y_prev 60 x 34 x 8
    assert 4 * sk._resident_floats(dims, 8, 16, True) == 4 * (
        144 + 164 + 64 + 16 * 272 + 256 + 2048 + 4096 + 3 * 3840
        + 2 * 16320) == 221136
    picks = {B: sk.resident_layout(d8, B, 132) for B in (1, 64, 256, 1024,
                                                         4096)}
    assert {B: (lay.log2_tile, lay.warps, lay.chains_in_smem)
            for B, lay in picks.items()} == {
        1: (0, 16, False), 64: (0, 16, False), 256: (1, 16, False),
        1024: (3, 16, True), 4096: (3, 16, True)}
    assert sk.blocks_per_sm(picks[1024].smem, 16) == 1
    assert sk.blocks_per_sm(sk._smem_bytes(d8, 8, True)) == 2  # streamed
    # the placement: RT, HBT, MT take 2 x 60 x 16^2 floats (122,880 bytes);
    # 4 scenarios' block (98,896 bytes) leaves 162,224 of the SM's 256 KB,
    # 8 scenarios' (196,560) 64,560
    stage = {log2: sk._stage_chains(d8, sk.resident_layouts(d8, log2)[1])
             for log2 in range(4)}
    assert stage == {0: False, 1: False, 2: False, 3: True}
    # forced launches and what does not fit
    assert sk.resident_layout(d8, 1024, 132, warps=8).warps == 8
    assert sk.resident_layout(d8, 4096, 132, log2_tile=3,
                              chains_in_smem=False).smem < picks[4096].smem
    assert sk.resident_layout(d8, 256, 132, chains_in_smem=True) == \
        sk.resident_layouts(d8, 1)[0]
    # n8 N200: two scenarios per block still stage their chains; n24 N60:
    # the segment products alone (2 x 16 x 24 x 24 floats) would crowd the
    # slabs, so the chains read their matrices from device memory
    d200 = ts.build_stagewise(tp.battery(8, 200), iterations=5, L=1.0,
                              device="cpu")
    lay = sk.resident_layout(d200, 1024, 132)
    assert (lay.log2_tile, lay.warps, lay.chains_in_smem) == (1, 16, True)
    assert sk.resident_layouts(d200, 2) == []
    assert sk.resident_layout(d200, 64, 132, log2_tile=3) is None
    d24 = ts.build_stagewise(tp.battery(24, 60), iterations=5, L=1.0,
                             device="cpu")
    lay = sk.resident_layout(d24, 1024, 132)
    assert (lay.log2_tile, lay.warps, lay.chains_in_smem) == (1, 16, False)
    assert [(l.warps, l.chains_in_smem)
            for l in sk.resident_layouts(d24, 1)] == [(16, False), (8, False)]
    # the route: the resident kernel at n8 N60 at every batch (one wave
    # or 8 a block) and at n8 N200 in one wave; the streamed one past it
    # and wherever no tile stages its chains (n24 N60)
    routes = {(d.n_x, d.horizon, B): sk.resident_preferred(d, B, 132)
              for d in (d8, d200, d24) for B in (256, 1024, 4096)}
    assert routes == {
        (8, 60, 256): True, (8, 60, 1024): True, (8, 60, 4096): True,
        (8, 200, 256): True, (8, 200, 1024): False, (8, 200, 4096): False,
        (24, 60, 256): False, (24, 60, 1024): False, (24, 60, 4096): False}
