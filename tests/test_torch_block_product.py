"""The launch plans of the register-tiled dense and dual kernels, and a
Python mirror of their block product (csrc/block_product.cuh) and of their
carve-ups, on the CPU: the tiles the picks take by batch, the shapes the
shared-memory guards admit, the map of threads to outputs, and the
kernels' arithmetic in that order on padded arrays against the plain
versions."""

import dataclasses

import numpy as np
import pytest
import torch

import tpu_gpad_torch as tg
from tpu_gpad_torch.solver import dual_kernels, kernels

THREADS = kernels.BLOCK_THREADS
LIMIT_WORDS = kernels.SMEM_LIMIT_BYTES // 4


def _items(R, K, log2_tile, S):
    """The work items of block_product: thread -> (rows, scenarios, k
    range, part), in the kernel's order w = p NT + tile."""
    T = 1 << log2_tile
    ST = min(T, 4)
    per_row = T // ST
    NT = -(-R // 4) * per_row
    out = []
    for w in range(NT * S):
        tile, p = w % NT, w // NT
        r0, s0 = tile // per_row * 4, tile % per_row * ST
        out.append((w % THREADS, range(r0, r0 + 4), range(s0, s0 + ST),
                    range(p * K // S, (p + 1) * K // S), p))
    return out


@pytest.mark.parametrize("kernel,shape", [("dense", (140, 30)),
                                          ("dense", (280, 60)),
                                          ("dual", 70), ("dual", 220)])
@pytest.mark.parametrize("B", [1, 5, 256, 4096])
def test_plans_by_batch(kernel, shape, B):
    """The picks fill the card: the widest tile up to 16 that leaves 128
    blocks (one scenario per block below that), within shared memory, a
    thread's registers (dual) and one work item per thread where the
    product splits."""
    if kernel == "dense":
        m, n_z = shape
        plan = kernels._dense_plan(m, n_z, B)
        words = kernels._dense_smem_bytes(m, n_z, plan) // 4
        products = [(n_z, m, plan.split1), (m, n_z, plan.split2)]
    else:
        plan = dual_kernels._dual_plan(shape, B)
        words = dual_kernels._dual_smem_bytes(shape, plan) // 4
        products = [(shape, shape, plan.split)]
        assert shape << plan.log2_tile <= dual_kernels._MAX_ELEMENTS * THREADS
    T = 1 << plan.log2_tile
    assert words <= LIMIT_WORDS
    # 16 per block at B4096 but where a thread's dual registers stop it
    want = {1: 1, 5: 1, 256: 2, 4096: 4 if shape == 220 else 16}[B]
    assert T == want
    for R, K, S in products:
        NT = -(-R // 4) * (T // min(T, 4))
        assert S >= 1 and (S == 1 or NT * S <= THREADS)
        assert S <= -(-K // 4)  # no part shorter than 4 steps of k


def test_serving_and_headline_picks():
    """At battery n3 N10 the serving batch runs 2 scenarios per block (128
    blocks) and B4096 runs 16 (256 blocks), for every resident kernel."""
    assert kernels._dense_plan(140, 30, 256) == kernels.DensePlan(1, 4, 32, 7)
    assert kernels._dense_plan(140, 30, 4096) == kernels.DensePlan(4, 4, 8, 1)
    assert dual_kernels._dual_plan(70, 256) == dual_kernels.DualPlan(1, 14)
    assert dual_kernels._dual_plan(70, 4096) == dual_kernels.DualPlan(4, 3)
    # the flat and full paired kernels take the same grid
    P = kernels.PairedPlan
    assert kernels._paired_plan(70, 30, 40, 256) == P(1, 4, 8, 8)
    assert kernels._paired_plan(70, 30, 40, 4096) == P(4, 4, 4, 4)
    assert kernels._paired_plan(70, 30, 70, 256) == P(1, 4, 8, 8)
    assert kernels._paired_plan(70, 30, 70, 4096) == P(4, 4, 4, 3)


def test_dense_guard_admits_every_shape_it_admitted():
    """The first design's carve-up, 2 m n_z + 3 m + 3 n_z words at one
    scenario per block, is the unpadded plan's: for every n_z up to 400
    the largest m it admitted is still admitted and the next refused, and
    so are 2000 shapes drawn inside the bound."""
    def old_fits(m, n):
        return 2 * m * n + 3 * m + 3 * n <= LIMIT_WORDS

    for n in range(1, 401):
        m = (LIMIT_WORDS - 3 * n) // (2 * n + 3)
        assert old_fits(m, n) and not old_fits(m + 1, n)
        assert kernels._dense_plan(m, n, 1) is not None, (m, n)
        assert kernels._dense_plan(m + 1, n, 1) is None, (m + 1, n)
    rng = np.random.default_rng(0)
    for _ in range(2000):
        n = int(rng.integers(1, 300))
        m = int(rng.integers(1, (LIMIT_WORDS - 3 * n) // (2 * n + 3) + 1))
        plan = kernels._dense_plan(m, n, int(rng.integers(1, 5000)))
        assert plan is not None, (m, n)
        assert kernels._dense_smem_bytes(m, n, plan) <= kernels.SMEM_LIMIT_BYTES
    assert (kernels._dense_smem_bytes(98, 289, kernels.DensePlan(0, 1, 1, 1))
            == 4 * (2 * 98 * 289 + 3 * 98 + 3 * 289))


def test_dual_guard_admits_every_shape_it_admitted():
    """The first design admitted m_h with m_h^2 + 11 m_h + 8 words at one
    scenario per block (m_h <= 235); each still runs, at every batch."""
    for m_h in range(1, 300):
        if m_h * m_h + 11 * m_h + 8 <= LIMIT_WORDS:
            for B in (1, 256, 4096):
                assert dual_kernels._dual_plan(m_h, B) is not None, (m_h, B)
    assert dual_kernels._dual_plan(235, 1) is not None
    assert dual_kernels._dual_plan(260, 1) is None


@pytest.mark.parametrize("R,K,log2_tile,S", [(30, 140, 0, 32), (140, 30, 1, 7),
                                             (70, 70, 4, 3), (49, 49, 2, 5),
                                             (98, 21, 5, 1), (235, 235, 0, 4)])
def test_block_product_covers_each_output_once(R, K, log2_tile, S):
    """Each output (row < R, scenario) gets one partial per part, the
    parts cover k in [0, K) once each in ascending order, rows past R are
    only ever the padding of the last row tile, and a thread takes one
    item where NT S fits the block."""
    T = 1 << log2_tile
    seen = {}
    for tid, rows, scen, ks, p in _items(R, K, log2_tile, S):
        for r in rows:
            assert r < -(-R // 4) * 4
            for s in scen:
                assert s < T
                seen.setdefault((r, s), []).append((p, ks))
    assert set(seen) == {(r, s) for r in range(-(-R // 4) * 4) for s in range(T)}
    for (r, s), parts in seen.items():
        assert [p for p, _ in parts] == list(range(S))
        assert [k for _, ks in parts for k in ks] == list(range(K))
    tids = [tid for tid, *_ in _items(R, K, log2_tile, S)]
    assert len(tids) <= THREADS or S == 1


@pytest.mark.parametrize("m_h,log2_tile", [(70, 4), (70, 1), (49, 3), (235, 0),
                                           (220, 2)])
def test_dual_elements_keep_one_scenario_per_thread(m_h, log2_tile):
    """The dual epilogue's map: thread tid owns idx = tid + q 256 of the
    [row][scenario] layout, each output exactly once, every one of a
    thread's elements of scenario tid mod T; the lanes of a warp that
    share a scenario differ by multiples of T (the restart shuffles)."""
    T = 1 << log2_tile
    owner = {}
    for tid in range(THREADS):
        for q in range(dual_kernels._MAX_ELEMENTS):
            idx = tid + q * THREADS
            if idx < m_h * T:
                assert (idx & (T - 1)) == tid % T
                owner.setdefault(idx, []).append(tid)
    assert sorted(owner) == list(range(m_h * T))
    assert all(len(t) == 1 for t in owner.values())
    for lane in range(32):  # the xor butterfly over offsets T .. 16
        group, off = {lane}, T
        while off < 32:
            group |= {x ^ off for x in group}
            off <<= 1
        assert group == {x for x in range(32) if x % T == lane % T}


def _mirror_product(A, X, R, K, log2_tile, S):
    """block_product and sum_parts in float32, in the kernel's order, on
    A (K, Rp) and X (K, T) padded with zeros: out (Rp, T)."""
    T = 1 << log2_tile
    Rp = A.shape[1]
    part = np.zeros((S, Rp, T), dtype=np.float32)
    for _, rows, scen, ks, p in _items(R, K, log2_tile, S):
        for r in rows:
            for s in scen:
                acc = np.float32(0.0)
                for k in ks:
                    acc = np.float32(acc + np.float32(A[k, r] * X[k, s]))
                part[p, r, s] = acc
    out = part[0].copy()
    for p in range(1, S):
        out = (out + part[p]).astype(np.float32)
    return out


def _pad(a, rows, cols):
    out = np.zeros((rows, cols), dtype=np.float32)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def _dense_data():
    return tg.dualize(tg.condense(tg.problems.battery(2, 3)), iterations=8,
                      paired=False, device="cpu")


def test_dense_mirror_on_padded_rows_matches_plain():
    """The dense kernel's loop on its carve-up (rows padded to 4 with
    zeros, split-K partials in part order) against the plain version:
    within fp32 rounding, and every padded row still zero at the end."""
    d = _dense_data()
    m, n_z, B, iters = d.m, d.n_z, 2, 8
    assert m % 4 or n_z % 4  # a shape with padding
    plan = kernels._dense_plan(m, n_z, B, log2_tile=1)  # one block of 2
    T = 1 << plan.log2_tile
    mp, np_ = -(-m // 4) * 4, -(-n_z // 4) * 4
    rng = np.random.default_rng(1)
    g = rng.uniform(-0.2, 0.2, (B, n_z)).astype(np.float32)
    p = rng.uniform(-0.2, 0.2, (B, m)).astype(np.float32)
    MG = _pad(d.MG_T.numpy(), m, np_)
    GL = _pad(d.GL_T.numpy(), n_z, mp)
    th, be = d.theta.numpy(), d.beta.numpy()
    Y = np.zeros((mp, T), np.float32)
    W = np.zeros((mp, T), np.float32)
    P = _pad(p.T, mp, T)
    G = _pad(g.T, np_, T)
    Z = np.zeros((np_, T), np.float32)
    Zh = np.zeros((np_, T), np.float32)
    for k in range(iters):
        acc = _mirror_product(MG, W, n_z, m, plan.log2_tile, plan.split1)
        Zh[:n_z] = -acc[:n_z] - G[:n_z]
        Z[:n_z] = (1 - th[k]) * Z[:n_z] + th[k] * Zh[:n_z]
        q = _mirror_product(GL, Zh, m, n_z, plan.log2_tile, plan.split2)
        y = np.maximum(W[:m] + q[:m] + P[:m], 0).astype(np.float32)
        if k + 1 < iters:
            W[:m] = y + be[k + 1] * (y - Y[:m])
        Y[:m] = y
    assert not Y[m:].any() and not W[m:].any() and not Zh[n_z:].any()
    z, y, w, zh = kernels.gpad_fixed_dense_torch(
        d, torch.as_tensor(g), torch.as_tensor(p), iterations=iters)
    np.testing.assert_allclose(Z[:n_z, :B].T, z.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(Y[:m, :B].T, y.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(Zh[:n_z, :B].T, zh.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("restart", [False, True], ids=["plain", "restart"])
def test_dual_mirror_on_padded_rows_matches_plain(restart):
    """The dual kernels' loop on their carve-up (D's rows padded to 4, wd
    in shared memory with zero padded rows, the product in parts, w
    recomputed from y and y_prev, the restart decision per scenario from
    the summed rows) against the plain version, soft rows included."""
    d = tg.dualize(tg.condense(tg.problems.battery(2, 3)), iterations=12,
                   paired="auto", device="cpu")
    rng = np.random.default_rng(2)
    d = dataclasses.replace(d, soft_damp=torch.as_tensor(
        rng.uniform(0, 0.2, d.m_half), dtype=torch.float32))
    m_h, B, iters = d.m_half, 3, 12
    assert m_h % 4
    plan = dual_kernels._dual_plan(m_h, B, log2_tile=2)  # one block of 4
    T, mp = 1 << plan.log2_tile, -(-m_h // 4) * 4
    g = torch.as_tensor(rng.uniform(-0.2, 0.2, (B, d.n_z)), dtype=torch.float32)
    pD = torch.as_tensor(rng.uniform(-0.2, 0.2, (B, 2, m_h)), dtype=torch.float32)
    c = dual_kernels.relu_offsets(d, g, pD).numpy()
    Dp = _pad(d.D.numpy(), m_h, mp)
    od = 1 - d.soft_damp.numpy()
    yp, ym, ypp, ymp, s = (np.zeros((m_h, T), np.float32) for _ in range(5))
    cp, cm = _pad(c[:, 0].T, m_h, T), _pad(c[:, 1].T, m_h, T)
    th, thp = np.ones(T, np.float32), np.ones(T, np.float32)
    wd = np.zeros((mp, T), np.float32)
    for k in range(iters):
        b = th * (1 / thp - 1) if restart else np.full(T, d.beta[k].item())
        tk = th if restart else np.full(T, d.theta[k].item())
        wp, wm = yp + b * (yp - ypp), ym + b * (ym - ymp)
        wd[:m_h] = wp - wm
        acc = _mirror_product(Dp, wd, m_h, m_h, plan.log2_tile, plan.split)[:m_h]
        ypn = np.maximum(wp * od[:, None] - acc + cp, 0).astype(np.float32)
        ymn = np.maximum(wm * od[:, None] + acc + cm, 0).astype(np.float32)
        s = s + tk * (wd[:m_h] - s)
        r = ((wp - ypn) * (ypn - yp) + (wm - ymn) * (ymn - ym)).sum(0)
        ypp, ymp, yp, ym = yp, ym, ypn, ymn
        if restart:
            reset = r > 0
            nxt = th * (np.sqrt(th * th + 4) - th) * 0.5
            thp, th = np.where(reset, 1, th), np.where(reset, 1, nxt)
            ypp = np.where(reset, yp, ypp)
            ymp = np.where(reset, ym, ymp)
    assert not wd[m_h:].any()
    z, y, w, _ = dual_kernels.gpad_fixed_dual_torch(
        d, g, pD, iterations=iters, restart=restart)
    np.testing.assert_allclose(yp[:, :B].T, y[:, 0].numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ym[:, :B].T, y[:, 1].numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(wp[:, :B].T, w[:, 0].numpy(), atol=1e-5, rtol=0)
    z_m = -(s[:, :B].T @ d.MG_T.numpy()) - g.numpy()
    np.testing.assert_allclose(z_m, z.numpy(), atol=1e-5, rtol=0)
