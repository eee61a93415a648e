"""The precision tiers of the dense and tiled kernels (dense, tiled dual,
tiled dual chunk, flat tiled) on the CPU, where each kernel's op runs its
plain version: each plain version at each tier against ``tpu_gpad``'s
Pallas kernel at the same tier in interpret mode, on the same seeded inputs
(battery n3 N10, B6, 100 iterations); each tier's launch plan against
"highest"'s over the shapes around each kernel's guard; and each of the
four routes exported under a tier. The kernels themselves are held against
these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances, stated before the code was written (those of
tests/test_torch_kernel_tiers.py):

- "high" (3xTF32 here, bf16x3 in tpu_gpad): within ``TOL`` (2e-5) of
  tpu_gpad's "high" and of the port's own "highest", on every output.
- "bfloat16": u within ``BF16_U_TOL`` (5e-3) of tpu_gpad's bf16 u.
- "default": u within 5e-3 of tpu_gpad's "default" (which XLA:CPU computes
  in fp32), and not equal to the port's "highest": the tier took effect.
- The tiled dual loops run from the port's relu offsets: tpu_gpad computes
  e = g_P GL_T and the primal recovery at the tier, the port in fp32 (a
  stated departure), so they are held against tpu_gpad's tiled dual body
  (``_dual_tiled_call``, row tiles of 16, the body of
  ``gpad_pallas_fixed_dual_tiled``) run over the budget from the port's
  offsets, u recovered in fp32 on both sides. The window (the tiled chunk
  op) is held on its state, y, y_prev, s, mom and w, at the same bounds
  ("default" and "bfloat16" at 5e-3)."""

import dataclasses
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_gpad
from tpu_gpad import problems as jp
from tpu_gpad.solver import kernels as jkernels
from tpu_gpad.solver.core import affine_params as j_affine_params

from tpu_gpad_torch import aot
from tpu_gpad_torch.convert import gpad_data_from_numpy
from tpu_gpad_torch.solver import SolverConfig, core, dual_kernels, kernels
from tpu_gpad_torch.solver.core import solve_batch
from tpu_gpad_torch.types import GPAD_META_FIELDS, GPAD_TENSOR_FIELDS

torch.set_num_threads(2)

ITERS = 100
TOL = 2e-5
BF16_U_TOL = 5e-3
DEFAULT_U_TOL = 5e-3
TIERS = {"high": dict(precision="high"), "default": dict(precision="default"),
         "bfloat16": dict(matmul_dtype="bfloat16")}
B = 6
WINDOW = 10
ROW_TILE = 16  # tpu_gpad's tiled dual row chunk: several chunks at m_h 70
FLAT_TILE = 16  # tpu_gpad's flat tiled chunk width (interpret mode)
NAMES = ("z", "y", "w", "zhat")


def _pair(paired):
    d_j = tpu_gpad.dualize(tpu_gpad.condense(jp.battery(3, 10)),
                           iterations=ITERS, paired=paired)
    fields = {k: None if getattr(d_j, k) is None else np.asarray(getattr(d_j, k))
              for k in GPAD_TENSOR_FIELDS}
    d_t = gpad_data_from_numpy(
        fields, {k: getattr(d_j, k) for k in GPAD_META_FIELDS}, device="cpu")
    X0 = np.random.default_rng(11).uniform(-0.4, 0.4, (B, d_j.n_x))
    g_P, p_D = j_affine_params(d_j, jnp.asarray(X0, dtype=jnp.float32))
    return d_j, d_t, np.array(g_P), np.array(p_D)


@pytest.fixture(scope="module")
def pair():
    return _pair("auto")


@pytest.fixture(scope="module")
def dense_pair():
    return _pair(False)


def _held(out_j, out_t, highest, tier, n_u):
    """The criteria above on (z, y, w, zhat) or a window's state."""
    for a, b in zip(out_j, out_t):
        assert a.shape == b.shape and np.isfinite(b).all()
    if tier == "high":
        for name, a, b, h in zip(NAMES, out_j, out_t, highest):
            np.testing.assert_allclose(b, a, atol=TOL, rtol=0, err_msg=name)
            np.testing.assert_allclose(b, h, atol=TOL, rtol=0, err_msg=name)
        return
    tol = BF16_U_TOL if tier == "bfloat16" else DEFAULT_U_TOL
    np.testing.assert_allclose(out_t[0][:, :n_u], out_j[0][:, :n_u], atol=tol,
                               rtol=0)
    assert any(not np.array_equal(b, h) for b, h in zip(out_t, highest))


@pytest.mark.parametrize("tier", list(TIERS))
def test_dense_plain_version_at_a_tier_matches_pallas(dense_pair, tier):
    d_j, d_t, g_P, p_D = dense_pair
    out_j = [np.asarray(t) for t in jkernels.gpad_pallas_fixed(
        d_j, jnp.asarray(g_P), jnp.asarray(p_D), iterations=ITERS,
        interpret=True, **TIERS[tier])]
    g, p = torch.from_numpy(g_P), torch.from_numpy(p_D)
    out_t, highest = ([t.numpy() for t in kernels.gpad_fixed_dense(
        d_t, g, p, iterations=ITERS, tier=t)] for t in (tier, "highest"))
    _held(out_j, out_t, highest, tier, d_t.n_u)


def _jax_tiled_window(d_j, c, state, k0, tier_kw, chunk=WINDOW,
                      restart=False):
    """tpu_gpad's tiled dual body (``_dual_tiled_call``, interpret mode,
    row tiles of ROW_TILE) for ``chunk`` iterations from ``k0`` on the
    port's relu offsets and state (y, y_prev, s, mom), back in the port's
    layouts: (y, y_prev, s, mom, w)."""
    m_h = d_j.m_half
    B_t = jkernels.pick_tiled_tiles(m_h)[0]
    S = jkernels._round_up(m_h, max(ROW_TILE, jkernels.SUBLANE))
    B_p = jkernels._round_up(B, B_t)
    mm_dtype = jnp.dtype(tier_kw.get("matmul_dtype", "float32"))
    precision = tier_kw.get("precision", "highest")
    Dn = jkernels._prep_operand(jkernels._pad2(-d_j.D, S, S), mm_dtype,
                                precision)
    pad = lambda a: jkernels._pad2(jnp.asarray(a).T, S, B_p)  # noqa: E731
    y, y_prev, s, mom = (t.numpy() for t in state)
    call = jkernels._dual_tiled_call(
        d_j, pad(c[:, 0]), pad(c[:, 1]), Dn, d_j.theta, d_j.beta, S, B_p,
        B_t, ROW_TILE, mm_dtype,
        jkernels._kernel_precision(mm_dtype, precision), chunk, True,
        restart=restart)
    mom_p = jnp.ones((jkernels.SUBLANE, B_p), dtype=jnp.float32)
    mom_p = mom_p.at[:2, :B].set(jnp.asarray(mom).T)
    yp, ym, ypp, ymp, s, wp, wm, mo = call(
        k0, pad(y[:, 0]), pad(y[:, 1]), pad(y_prev[:, 0]), pad(y_prev[:, 1]),
        pad(s), mom_p)
    back = lambda a: np.asarray(a)[:m_h, :B].T  # noqa: E731
    return (np.stack([back(yp), back(ym)], 1),
            np.stack([back(ypp), back(ymp)], 1), back(s),
            np.asarray(mo)[:2, :B].T, np.stack([back(wp), back(wm)], 1))


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("restart", [False, True], ids=["fixed", "restart"])
def test_tiled_dual_plain_version_at_a_tier_matches_pallas(pair, restart,
                                                           tier):
    """The tiled dual op's plain version (the whole solve from the port's
    relu offsets) against tpu_gpad's tiled dual body over the budget, the
    primal recovered as the port recovers it (fp32)."""
    d_j, d_t, g_P, p_D = pair
    g, p = torch.from_numpy(g_P), torch.from_numpy(p_D)
    c = dual_kernels.relu_offsets(d_t, g, p)
    y, s, mom = dual_kernels._init_state(d_t, B, None, "cpu")
    y, _, s, _, w = (torch.from_numpy(np.ascontiguousarray(t)) for t in
                     _jax_tiled_window(d_j, c.numpy(), (y, y, s, mom), 0,
                                       TIERS[tier], ITERS, restart))
    z, zhat = dual_kernels._primal(d_t, g, s, w,
                                   dual_kernels.recovery_weight(d_t, ITERS))
    out_j = [t.numpy() for t in (z, y, w, zhat)]
    out_t, highest = ([t.numpy() for t in dual_kernels.gpad_fixed_dual_tiled(
        d_t, g, p, iterations=ITERS, restart=restart, tier=t)]
        for t in (tier, "highest"))
    _held(out_j, out_t, highest, tier, d_t.n_u)


@pytest.mark.parametrize("tier", list(TIERS))
def test_tiled_chunk_window_at_a_tier_matches_pallas(pair, tier):
    """Two windows of the tiled chunk op at ``tier`` (its plain version),
    from schedule offsets 0 and WINDOW, against tpu_gpad's tiled dual body
    on the same offsets and state: the window's state out, and each
    window's w."""
    d_j, d_t, g_P, p_D = pair
    c = dual_kernels.relu_offsets(d_t, torch.from_numpy(g_P),
                                  torch.from_numpy(p_D))
    y, s, mom = dual_kernels._init_state(d_t, B, None, "cpu")
    state = (y, y.clone(), s, mom)
    tol = TOL if tier == "high" else 5e-3
    for k0 in (0, WINDOW):
        want = _jax_tiled_window(d_j, c.numpy(), state, k0, TIERS[tier])
        got = dual_kernels.gpad_dual_tiled_chunk(d_t, c, *state, k0=k0,
                                                 chunk=WINDOW, tier=tier)
        plain = dual_kernels.gpad_dual_tiled_chunk(d_t, c, *state, k0=k0,
                                                   chunk=WINDOW)
        for name, a, b, h in zip(("y", "y_prev", "s", "mom", "w"), want, got,
                                 plain):
            np.testing.assert_allclose(b.numpy(), a, atol=tol, rtol=0,
                                       err_msg=f"{name} at k0 {k0}")
            if tier == "high":
                np.testing.assert_allclose(b.numpy(), h.numpy(), atol=TOL,
                                           rtol=0, err_msg=name)
        if tier != "high":
            assert not torch.equal(got[0], plain[0]), "the tier took no effect"
        state = tuple(got[:4])


@pytest.mark.parametrize("tier", list(TIERS))
def test_flat_tiled_plain_version_at_a_tier_matches_pallas(pair, tier):
    d_j, d_t, g_P, p_D = pair
    out_j = [np.asarray(t) for t in jkernels.gpad_pallas_fixed_flat_tiled(
        d_j, jnp.asarray(g_P), jnp.asarray(p_D), iterations=ITERS,
        interpret=True, tile=FLAT_TILE, **TIERS[tier])]
    g, p = torch.from_numpy(g_P), torch.from_numpy(p_D)
    out_t, highest = ([t.numpy() for t in kernels.gpad_fixed_flat_tiled(
        d_t, g, p, iterations=ITERS, tier=t)] for t in (tier, "highest"))
    _held(out_j, out_t, highest, tier, d_t.n_u)


# The shapes around the dense kernel's guard (dense_fits_smem: m 140 to
# about 280 at n_z 30, the V = 1 fallback past the padded layout) and the
# batches of the port's paths
PLAN_BATCHES = (1, 5, 256, 300, 4096)
DENSE_N_Z = (1, 5, 12, 30, 33, 60, 90, 120, 150)
DENSE_M = (1, 7, 16, 40, 70, 140, 141, 200, 260, 280, 281, 300, 330, 400,
           500, 600)


@pytest.mark.parametrize("tier", list(TIERS))
def test_dense_tier_plans_exist_where_highest_does(tier):
    """The dense kernel's plan at a tier: one wherever "highest" has one and
    none elsewhere, the same tile and layout (a tier changes only the
    parts), and its block within shared memory."""
    seen = {True: 0, False: 0}
    for n_z in DENSE_N_Z:
        for m in DENSE_M:
            for Bn in PLAN_BATCHES:
                want = kernels._dense_plan(m, n_z, Bn)
                got = kernels._dense_plan(m, n_z, Bn, tier=tier)
                assert (got is None) == (want is None), (m, n_z, Bn)
                seen[want is None] += 1
                if want is None:
                    continue
                assert (got.log2_tile, got.vec) == (want.log2_tile, want.vec)
                assert got.split1 >= 1 and got.split2 >= 1
                assert (kernels._dense_smem_bytes(m, n_z, got)
                        <= kernels.SMEM_LIMIT_BYTES), (m, n_z, Bn, got)
    assert seen[True] and seen[False]  # the band has both sides


def _strips_fit(W: int, T: int, grouped: bool, flat: bool) -> bool:
    """The tiled kernels' passes under a tier, in the CUDA sources'
    arithmetic (csrc/gpad_dual_tiled.cu, csrc/gpad_flat_tiled.cu): for a
    block's W columns, the groups' tpg threads (512 a block, kCols 2 a
    thread at "highest"; the flat kernel's grouped products at most 256
    under a tier) make passes of cpp columns; under a tier each warp of a
    group takes a strip of 64 of them. True when the strips cover every
    pass's columns exactly and every sum they store lands inside the
    groups' scratch that "highest" has (dual: [group][t][column], 1024
    columns a scenario; flat: two rounds of at least two groups in 512 a
    scenario), or, in the flat kernel's one-scenario plan without that
    scratch, goes from the fragments."""
    tpg = 32 if grouped else 512
    while tpg < (256 if flat and grouped else 512) and 2 * tpg < W:
        tpg *= 2
    groups, cpp = 512 // tpg, 2 * tpg
    if (tpg // 32) * 64 != cpp:
        return False
    if not grouped:
        return T == 1  # one group: the sums go from the fragments
    red = (512 if flat else 1024) * T
    slots = groups // 2 if flat else groups
    return slots >= 1 and (slots - 1) * T * cpp + (T - 1) * cpp + cpp - 1 < red


# The shapes around the tiled kernels' guards (dual_tiled_fits: m_h past
# the resident dual's, up to one scenario's wd in shared memory;
# flat_tiled_fits likewise for wd and zhat)
TILED_M_H = (71, 221, 330, 900, 1830, 4000, 12000, 40000, 57056, 57060)
TILED_N_Z = (12, 30, 150, 900, 3000)


def test_tiled_tier_plans_are_highest_plans():
    """The tiled kernels' launch plans take no tier (the wrappers' picks
    read the shape and the batch alone), and a tier's strips fit that plan
    wherever it exists: they cover each pass of each block's columns on
    every cluster the picks may choose, and their sums stay in the groups'
    scratch of the plan's shared memory, or with one group go straight to
    the epilogue."""
    import inspect

    for fn in (dual_kernels.pick_tiled_tiles, dual_kernels.pick_tiled_cluster,
               dual_kernels._dual_tiled_smem_bytes, kernels.pick_flat_tiled,
               kernels._flat_tiled_smem_bytes):
        assert "tier" not in inspect.signature(fn).parameters, fn
    seen = {True: 0, False: 0}
    for m_h in TILED_M_H:
        for Bn in PLAN_BATCHES:
            log2 = dual_kernels.pick_tiled_tiles(m_h, Bn)
            seen[log2 is None] += 1
            if log2 is None:
                continue
            for cl in (1, 2, 4, 8, 16):
                # a block's columns (make_slice): up4(ceil(up4(m_h) / C))
                W = kernels._up4(-(-kernels._up4(m_h) // cl))
                assert _strips_fit(min(W, m_h), 1 << log2, True, False)
            for n_z in TILED_N_Z:
                plan = kernels.pick_flat_tiled(m_h + n_z, n_z, Bn)
                if plan is None:
                    continue
                for cl in (1, 2, 4, 8, 16):
                    for K in (n_z, m_h):  # zhat's columns, then q's rows
                        assert _strips_fit(-(-K // cl), 1 << plan.log2_tile,
                                           plan.grouped, True), (m_h, n_z, cl)
    assert seen[True] and seen[False]


# each route on battery n3 N10, the resident kernels' guards stood down so
# that the dense and tiled kernels serve it, as past shared memory
ROUTES = {
    "dense": (False, dict()),
    "flat_tiled": ("auto", dict()),
    "dual_tiled": ("auto", dict(restart=True)),
    "dual_tiled_chunk": ("auto", dict(mode="eps", restart=True, flat="off",
                                      eps_g=1e-5, eps_V=1e-5)),
}


@pytest.mark.parametrize("route, tier", [
    ("dense", "bfloat16"), ("flat_tiled", "default"), ("dual_tiled", "high"),
    ("dual_tiled_chunk", "default")])
def test_tiled_route_exported_under_a_tier(pair, dense_pair, monkeypatch,
                                           route, tier):
    """A concrete batch exported by aot.py on a dense or tiled route under a
    tier: the graph calls the route's op with the tier, the record holds
    TF32 off, and the loaded call equals the live one bit for bit. On the
    CPU the route is taken by standing in the card's routing, its ops
    running their plain versions at the tier."""
    paired, kw = ROUTES[route]
    d_t = (dense_pair if paired is False else pair)[1]
    monkeypatch.setattr(core, "resolve_engine",
                        lambda data, config, batch=1: "cuda")
    monkeypatch.setattr(kernels, "flat_fits_smem", lambda data: False)
    monkeypatch.setattr(dual_kernels, "dual_fits_smem", lambda data: False)
    cfg = SolverConfig(iterations=ITERS // 2, **kw, **TIERS[tier])
    assert core.cuda_kernel(d_t, cfg) == route
    X0 = np.random.default_rng(3).uniform(-0.4, 0.4, (B, 3)).astype(np.float32)
    blob = aot.export_solver(d_t, cfg, batch_size=B)
    extra = {"gpad_tier.json": ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    rec = json.loads(extra["gpad_tier.json"])
    assert rec["tier"] == tier and rec["tf32"] is False
    calls = [n for m in program.graph_module.modules()
             if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes
             if str(n.target) == f"tpu_gpad_torch.{route}.default"]
    assert calls and all(n.args[-1] == tier for n in calls), calls
    out = aot.load_solver(blob)(X0)
    live = solve_batch(d_t, X0, cfg)
    highest = solve_batch(d_t, X0, dataclasses.replace(
        cfg, precision="highest", matmul_dtype="float32"))
    for k in ("u", "z", "y", "iterations", "residual", "gap", "converged"):
        assert torch.equal(out[k], getattr(live, k)), k
    assert not torch.equal(live.y, highest.y)
