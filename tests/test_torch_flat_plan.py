"""The launch plans of the flat and full paired kernels and of the flat
tiled kernel, and Python mirrors of their carve-ups, on the CPU: the tiles
the picks take by batch, the shapes the guards admit, the map of threads to
outputs and elements, and each kernel's arithmetic in the kernel's order
(padded rows and split-K parts; cluster slices and grouped sums) against
the plain version and ``tpu_gpad``'s Pallas kernel in interpret mode, on
the same numpy-seeded inputs."""

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
from tpu_gpad_torch.solver import kernels
from tpu_gpad_torch.types import GPAD_META_FIELDS, GPAD_TENSOR_FIELDS

torch.set_num_threads(2)

THREADS = kernels.BLOCK_THREADS
LIMIT_WORDS = kernels.SMEM_LIMIT_BYTES // 4
ITERS = 12
TOL = 1e-5  # fp32 sums in the kernel's order against torch's and XLA's


def _battery_shape(n, N):
    """(m_h, n_z, n_struct) of battery(n, N)'s flat paired data: n N
    inputs (the box rows), n N SoC rows and N sum rows."""
    return 2 * n * N + N, n * N, n * N + N


def _old_paired_words(m_h, n_z, n_s):
    """The first design's carve-up at one scenario per block: both
    operands, the od column, 7 dual-row and 3 primal-row arrays."""
    return m_h * n_z + n_z * n_s + 8 * m_h + 3 * n_z


@pytest.mark.parametrize("n,N", [(1, 5), (2, 7), (3, 10)])
def test_battery_shape_formula(n, N):
    d = tg.dualize(tg.condense(tg.problems.battery(n, N)), iterations=2,
                   paired="auto", device="cpu")
    assert (d.m_half, d.n_z, d.n_struct) == _battery_shape(n, N)


@pytest.mark.parametrize("full", [False, True], ids=["flat", "full"])
@pytest.mark.parametrize("B", [1, 5, 256, 4096])
def test_paired_plans_by_batch(full, B):
    """The picks fill the card at the headline shape: 2 per block at B256
    (128 blocks), 16 at B4096, one below; the block fits shared memory and
    a thread's registers, and a split product gives each work item a
    thread."""
    m_h, n_z, n_s = _battery_shape(3, 10)
    n_s = m_h if full else n_s
    plan = kernels._paired_plan(m_h, n_z, n_s, B)
    T = 1 << plan.log2_tile
    assert T == {1: 1, 5: 1, 256: 2, 4096: 16}[B]
    assert -(-B // T) >= min(B, kernels.PAIRED_MIN_BLOCKS)
    assert plan.vec == 4
    assert kernels._paired_smem_bytes(m_h, n_z, n_s, plan) <= \
        kernels.SMEM_LIMIT_BYTES
    assert m_h * T <= kernels._PAIRED_MAX_ELEMENTS * THREADS
    assert n_z * T <= kernels._PAIRED_MAX_PRIMAL * THREADS
    for R, K, S in ((n_z, m_h, plan.split1), (n_s, n_z, plan.split2)):
        NT = -(-R // 4) * (T // min(T, 4))
        assert 1 <= S <= kernels._paired_split_cap(plan.log2_tile)
        assert S == 1 or NT * S <= THREADS
        assert S <= -(-K // 4)


@pytest.mark.parametrize("full", [False, True], ids=["flat", "full"])
def test_paired_guards_admit_every_shape_they_admitted(full):
    """Every battery n1-n15 x N5-N30 the first design's carve-up admitted
    still runs at B 1, 256 and 4096; and for every n_z up to 400 the
    largest m_h it admitted still runs (the flat layout has m_h >= n_z)."""
    for n in range(1, 16):
        for N in range(5, 31):
            m_h, n_z, n_s = _battery_shape(n, N)
            n_s = m_h if full else n_s
            if _old_paired_words(m_h, n_z, n_s) <= LIMIT_WORDS:
                for B in (1, 256, 4096):
                    assert kernels._paired_plan(m_h, n_z, n_s, B), (n, N, B)
    assert kernels._paired_plan(*_battery_shape(5, 20), 1024)  # n5 N20
    for n_z in range(1, 401):
        m_h = n_z if not full else 1
        while _old_paired_words(m_h + 1, n_z,
                                m_h + 1 if full else m_h + 1 - n_z) \
                <= LIMIT_WORDS:
            m_h += 1
        n_s = m_h if full else m_h - n_z
        if _old_paired_words(m_h, n_z, n_s) > LIMIT_WORDS:
            continue  # not even m_h = n_z fitted
        plan = kernels._paired_plan(m_h, n_z, n_s, 1)
        assert plan is not None, (m_h, n_z)
        assert kernels._paired_smem_bytes(m_h, n_z, n_s, plan) <= \
            kernels.SMEM_LIMIT_BYTES


def test_flat_tiled_guard_admits_every_shape_it_admitted():
    """The first design took m_h + n_z words at one scenario per block:
    every such shape still runs (at one scenario, without the groups'
    scratch at the edge), the next is refused, and every battery up to
    n15 N30 takes grouped products."""
    for n_z in range(1, LIMIT_WORDS, 97):
        m_h = LIMIT_WORDS - n_z
        assert kernels.pick_flat_tiled(m_h, n_z) is not None, (m_h, n_z)
        assert kernels.pick_flat_tiled(m_h + 1, n_z) is None
    for n in range(1, 16):
        for N in range(5, 31):
            m_h, n_z, _ = _battery_shape(n, N)
            for B in (1, 256):
                plan = kernels.pick_flat_tiled(m_h, n_z, B)
                assert plan.grouped and kernels._flat_tiled_smem_bytes(
                    m_h, n_z, plan.log2_tile) <= kernels.SMEM_LIMIT_BYTES


def _items(R, K, log2_tile, S):
    """block_product's work items: thread -> (rows, scenarios, k range,
    part), in the kernel's order w = p NT + tile."""
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


@pytest.mark.parametrize("shape", [(3, 10), (5, 20), (1, 5)])
@pytest.mark.parametrize("B", [1, 256, 4096])
@pytest.mark.parametrize("full", [False, True], ids=["flat", "full"])
def test_paired_products_cover_each_output_once(shape, B, full):
    """Both products of each pick: every output (row < up4(R), scenario)
    gets one partial per part, the parts cover k in [0, K) once in
    ascending order."""
    m_h, n_z, n_s = _battery_shape(*shape)
    n_s = m_h if full else n_s
    plan = kernels._paired_plan(m_h, n_z, n_s, B)
    T = 1 << plan.log2_tile
    for R, K, S in ((n_z, m_h, plan.split1), (n_s, n_z, plan.split2)):
        seen = {}
        for _, rows, scen, ks, p in _items(R, K, plan.log2_tile, S):
            for r in rows:
                for s in scen:
                    seen.setdefault((r, s), []).append((p, list(ks)))
        assert set(seen) == {(r, s) for r in range(-(-R // 4) * 4)
                             for s in range(T)}
        for parts in seen.values():
            assert [p for p, _ in parts] == list(range(S))
            assert [k for _, ks in parts for k in ks] == list(range(K))


@pytest.mark.parametrize("m_h,log2_tile", [(70, 4), (70, 1), (220, 2),
                                           (1700, 0), (40, 0)])
def test_paired_elements_keep_one_scenario_per_thread(m_h, log2_tile):
    """The epilogues' map: thread tid owns idx = tid + q 256 of the
    [row][scenario] layout, in registers for q < 6 and in device memory
    past them; each element exactly once, all of a thread's elements of
    scenario tid mod T."""
    T = 1 << log2_tile
    owner, in_regs = {}, 0
    for tid in range(THREADS):
        for idx in range(tid, m_h * T, THREADS):
            assert idx % T == tid % T
            owner.setdefault(idx, []).append(tid)
            in_regs += idx < kernels._PAIRED_MAX_ELEMENTS * THREADS
    assert sorted(owner) == list(range(m_h * T))
    assert all(len(t) == 1 for t in owner.values())
    overflows = kernels._paired_overflows(m_h, log2_tile)
    assert overflows == (in_regs < m_h * T)


def _mirror_product(A, X, R, K, log2_tile, S):
    """block_product and sum_parts in float32, in the kernel's order, on
    A (K, Rp) and X (K, T) padded with zeros: out (Rp, T)."""
    T = 1 << log2_tile
    part = np.zeros((S, A.shape[1], T), dtype=np.float32)
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


@pytest.fixture(scope="module")
def pair():
    d_j = tpu_gpad.dualize(tpu_gpad.condense(jp.battery(2, 3)),
                           iterations=ITERS, paired="auto")
    fields = {k: None if getattr(d_j, k) is None else np.asarray(getattr(d_j, k))
              for k in GPAD_TENSOR_FIELDS}
    d_t = gpad_data_from_numpy(
        fields, {k: getattr(d_j, k) for k in GPAD_META_FIELDS}, device="cpu")
    return d_j, d_t


def _inputs(d_j, B, seed):
    X0 = np.random.default_rng(seed).uniform(-0.4, 0.4, (B, d_j.n_x))
    g_P, p_D = j_affine_params(d_j, jnp.asarray(X0, dtype=jnp.float32))
    y0 = np.random.default_rng(seed + 1).uniform(
        0.0, 0.3, (B, 2, d_j.m_half)).astype(np.float32)
    return np.array(g_P), np.array(p_D), y0


def _mirror_paired(d_t, g, p, y0, full):
    """The paired kernels' loop on their carve-up: operands with rows
    padded to 4, wd and zhat [row][scenario] with zero padded rows, both
    products in parts, the dual state per element (w recomputed from y
    and y_prev, the next wd formed in the projection)."""
    B, m_h, n_z = g.shape[0], d_t.m_half, d_t.n_z
    n_s = m_h if full else d_t.n_struct
    plan = kernels._paired_plan(m_h, n_z, n_s, B, log2_tile=2)  # one block
    T = 1 << plan.log2_tile
    assert B <= T and (full or n_s % 4)  # a shape with padding
    up4 = lambda n: -(-n // 4) * 4
    MG = _pad(d_t.MG_T.numpy(), m_h, up4(n_z))
    GL = _pad(d_t.GL_T.numpy()[:, :n_s], n_z, up4(n_s))
    th, be = d_t.theta.numpy(), d_t.beta.numpy()
    inv_L = np.float32(1.0) / d_t.L.numpy()
    yp, ym = _pad(y0[:, 0].T, m_h, T), _pad(y0[:, 1].T, m_h, T)
    ypp, ymp = yp.copy(), ym.copy()
    pp, pm = _pad(p[:, 0].T, m_h, T), _pad(p[:, 1].T, m_h, T)
    G = _pad(g.T, n_z, T)
    Z = np.zeros((n_z, T), np.float32)
    wd = np.zeros((up4(m_h), T), np.float32)
    wd[:m_h] = yp - ym
    for k in range(ITERS):
        acc = _mirror_product(MG, wd, n_z, m_h, plan.log2_tile, plan.split1)
        Zh = (-acc[:n_z] - G).astype(np.float32)
        Z = ((1 - th[k]) * Z + th[k] * Zh).astype(np.float32)
        q = np.empty((m_h, T), np.float32)
        q[:n_s] = _mirror_product(GL, Zh, n_s, n_z, plan.log2_tile,
                                  plan.split2)[:n_s]
        q[n_s:] = Zh[:m_h - n_s] * inv_L
        wp, wm = yp + be[k] * (yp - ypp), ym + be[k] * (ym - ymp)
        ypn = np.maximum(wp + q + pp, 0).astype(np.float32)
        ymn = np.maximum(wm - q + pm, 0).astype(np.float32)
        ypp, ymp, yp, ym = yp, ym, ypn, ymn
        if k + 1 < ITERS:
            bn = be[k + 1]
            wd[:m_h] = (yp + bn * (yp - ypp)) - (ym + bn * (ym - ymp))
    assert not wd[m_h:].any()
    y = np.stack([yp[:, :B].T, ym[:, :B].T], axis=1)
    w = np.stack([wp[:, :B].T, wm[:, :B].T], axis=1)
    return Z[:, :B].T, y, w, Zh[:, :B].T


@pytest.mark.parametrize("full", [False, True], ids=["flat", "full"])
def test_paired_mirror_matches_plain_and_pallas(pair, full):
    """The paired body's arithmetic in its carve-up's order against the
    plain version and tpu_gpad's Pallas kernel in interpret mode, on the
    same warm-started inputs, z, y, w and zhat within 1e-5."""
    d_j, d_t = pair
    g, p, y0 = _inputs(d_j, 3, seed=21 + full)
    mirror = _mirror_paired(d_t, g, p, y0, full)
    fn = kernels.gpad_fixed_paired if full else kernels.gpad_fixed_paired_flat
    plain = fn(d_t, torch.from_numpy(g), torch.from_numpy(p),
               torch.from_numpy(y0), iterations=ITERS)
    jfn = (jkernels.gpad_pallas_fixed_paired if full
           else jkernels.gpad_pallas_fixed_paired_flat)
    pallas = jfn(d_j, jnp.asarray(g), jnp.asarray(p), jnp.asarray(y0),
                 iterations=ITERS, interpret=True)
    for name, a, b, c in zip(("z", "y", "w", "zhat"), mirror, plain, pallas):
        np.testing.assert_allclose(a, b.numpy(), atol=TOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(a, np.asarray(c), atol=TOL, rtol=0,
                                   err_msg=name)


def _slices(m_h, n_z, n_s, C):
    """make_slice of csrc/gpad_flat_tiled.cu for each rank: structural
    rows, box rows and primal columns."""
    nb = m_h - n_s
    Ws, Wb, Wz = -(-n_s // C), -(-nb // C), -(-n_z // C)
    out = []
    for r in range(C):
        slo = min(n_s, r * Ws)
        zlo = min(n_z, r * Wz)
        out.append((range(slo, min(n_s, slo + Ws)),
                    range(n_s + min(nb, r * Wb), n_s + min(nb, r * Wb + Wb)),
                    range(zlo, min(n_z, zlo + Wz))))
    return out


def _mirror_grouped(A, X, cols, grouped=True):
    """The flat tiled product of one block's columns: G groups of threads
    (the fewest threads, from 32, whose 2 columns each cover the columns in
    one pass), group g summing its K / G rows in ascending order; slot h
    holds group h + group h + H (H = G / 2), the slots added in order."""
    K = A.shape[0]
    W = len(cols)
    tpg = 32 if grouped else 512
    while tpg < 512 and 2 * tpg < W:
        tpg *= 2
    G = 512 // tpg
    jr = -(-K // G)
    acc = []
    for g in range(G):
        lo, hi = min(K, g * jr), min(K, g * jr + jr)
        s = np.zeros((X.shape[1], W), np.float32)
        for j in range(lo, hi):
            s = (s + np.float32(1) * X[j][:, None] * A[j, cols][None, :]
                 ).astype(np.float32)
        acc.append(s)
    if G == 1:
        return acc[0]
    H = G // 2
    slots = [(acc[h] + acc[h + H]).astype(np.float32) for h in range(H)]
    out = slots[0]
    for h in range(1, H):
        out = (out + slots[h]).astype(np.float32)
    return out


@pytest.mark.parametrize("C", [1, 2, 4, 16])
def test_flat_tiled_mirror_matches_plain_and_pallas(pair, C):
    """The flat tiled kernel's loop as its clusters run it: each rank's
    slices of rows and columns (every row and column owned once), zhat and
    the next wd exchanged whole, the grouped sums in their order; against
    the plain version and tpu_gpad's streamed Pallas kernel in interpret
    mode, z, y, w and zhat within 1e-5."""
    d_j, d_t = pair
    g, p, y0 = _inputs(d_j, 3, seed=30 + C)
    B, m_h, n_z, n_s = g.shape[0], d_t.m_half, d_t.n_z, d_t.n_struct
    sl = _slices(m_h, n_z, n_s, C)
    assert sorted(i for s in sl for i in [*s[0], *s[1]]) == list(range(m_h))
    assert sorted(c for s in sl for c in s[2]) == list(range(n_z))
    MG, GL = d_t.MG_T.numpy(), d_t.GL_T.numpy()
    th, be = d_t.theta.numpy(), d_t.beta.numpy()
    inv_L = np.float32(1.0) / d_t.L.numpy()
    y, w = y0.copy(), y0.copy()
    z = np.zeros((B, n_z), np.float32)
    zh = np.zeros((n_z, B), np.float32)
    wd = (y[:, 0] - y[:, 1]).T.copy()  # [row][t]
    for k in range(ITERS):
        more = k + 1 < ITERS
        for _, _, cols in sl:
            if len(cols):
                v = (-_mirror_grouped(MG, wd, cols) - g[:, cols]).astype(
                    np.float32)
                z[:, cols] = (1 - th[k]) * z[:, cols] + th[k] * v
                zh[cols] = v.T
        wd_next = wd.copy()
        for srows, brows, _ in sl:
            q = {}
            if len(srows):
                for i, col in zip(srows, _mirror_grouped(GL, zh, srows).T):
                    q[i] = col
            for i in brows:
                q[i] = zh[i - n_s] * inv_L
            for i, qi in q.items():
                yp, ym = y[:, 0, i].copy(), y[:, 1, i].copy()
                y[:, 0, i] = np.maximum(w[:, 0, i] + qi + p[:, 0, i], 0)
                y[:, 1, i] = np.maximum(w[:, 1, i] - qi + p[:, 1, i], 0)
                if more:
                    w[:, 0, i] = y[:, 0, i] + be[k + 1] * (y[:, 0, i] - yp)
                    w[:, 1, i] = y[:, 1, i] + be[k + 1] * (y[:, 1, i] - ym)
                    wd_next[i] = w[:, 0, i] - w[:, 1, i]
        wd = wd_next
    mirror = (z, y, w, zh.T)
    plain = kernels.gpad_fixed_flat_tiled(
        d_t, torch.from_numpy(g), torch.from_numpy(p), torch.from_numpy(y0),
        iterations=ITERS)
    pallas = jkernels.gpad_pallas_fixed_flat_tiled(
        d_j, jnp.asarray(g), jnp.asarray(p), jnp.asarray(y0),
        iterations=ITERS, interpret=True, tile=8)
    for name, a, b, c in zip(("z", "y", "w", "zhat"), mirror, plain, pallas):
        np.testing.assert_allclose(a, b.numpy(), atol=TOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(a, np.asarray(c), atol=TOL, rtol=0,
                                   err_msg=name)


def test_flat_tiled_grouped_sums_cover_each_row_once():
    """At the flagship's widths the groups of each pick split K into
    disjoint ascending ranges that cover it, and the two rounds add every
    group once."""
    for W, K in ((57, 1830), (59, 900), (1100, 900), (3, 70)):
        tpg = 32
        while tpg < 512 and 2 * tpg < W:
            tpg *= 2
        G = 512 // tpg
        jr = -(-K // G)
        ranges = [range(min(K, g * jr), min(K, g * jr + jr)) for g in range(G)]
        assert [j for r in ranges for j in r] == list(range(K))
        if G > 1:
            H = G // 2
            assert sorted([h for h in range(H)] + [h + H for h in range(H)]
                          ) == list(range(G))
