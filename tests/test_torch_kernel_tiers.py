"""The precision tiers of the resident condensed kernels (paired flat,
paired, dual, dual chunk) on the CPU, where each kernel's op runs its plain
version: each plain version at each tier against ``tpu_gpad``'s Pallas
kernel at the same tier in interpret mode, on the same seeded inputs
(battery n3 N10, B6, 100 iterations); the tier's rounding helpers against
NumPy bit for bit; the tiers' launch plans against "highest"'s over the
shapes around the shared-memory guard; and a kernel route exported under a
tier. The kernels themselves are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances, stated before the code was written:

- "high" (3xTF32 here, bf16x3 in tpu_gpad): within ``TOL`` (2e-5,
  tests/test_torch_precision.py) of tpu_gpad's "high" and of the port's
  own "highest", on every output.
- "bfloat16": u within ``BF16_U_TOL`` (5e-3) of tpu_gpad's bf16 u.
- "default": u within 5e-3 of tpu_gpad's "default" (which XLA:CPU computes
  in fp32), and not equal to the port's "highest": the tier took effect.
- The dual kernels run from the same relu offsets as the port's: tpu_gpad
  computes e = g_P GL_T and the primal recovery at the tier, the port in
  fp32 (a stated departure), so the dual loops are held against
  tpu_gpad's dual body (its chunk kernel, the body of its whole-solve
  dual kernel too) run over the budget from the port's offsets, u
  recovered in fp32 on both sides. The window (the chunk op) is held on
  its state, y, y_prev, s, mom and w, at the same bounds ("default" and
  "bfloat16" at 5e-3)."""

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
LOOPS = ("flat", "full", "dual", "restart")
B = 6
WINDOW = 10


@pytest.fixture(scope="module")
def pair():
    d_j = tpu_gpad.dualize(tpu_gpad.condense(jp.battery(3, 10)),
                           iterations=ITERS, paired="auto")
    fields = {k: None if getattr(d_j, k) is None else np.asarray(getattr(d_j, k))
              for k in GPAD_TENSOR_FIELDS}
    d_t = gpad_data_from_numpy(
        fields, {k: getattr(d_j, k) for k in GPAD_META_FIELDS}, device="cpu")
    X0 = np.random.default_rng(11).uniform(-0.4, 0.4, (B, d_j.n_x))
    g_P, p_D = j_affine_params(d_j, jnp.asarray(X0, dtype=jnp.float32))
    return d_j, d_t, np.array(g_P), np.array(p_D)


def _pallas(d_j, d_t, loop, g_P, p_D, tier_kw):
    """tpu_gpad's Pallas kernel of ``loop`` in interpret mode; for the dual
    loops its dual body over the budget from the port's relu offsets, the
    primal recovered as the port recovers it (fp32)."""
    kw = dict(iterations=ITERS, interpret=True, **tier_kw)
    g, p = jnp.asarray(g_P), jnp.asarray(p_D)
    if loop == "flat":
        return jkernels.gpad_pallas_fixed_paired_flat(d_j, g, p, **kw)
    if loop == "full":
        return jkernels.gpad_pallas_fixed_paired(d_j, g, p, **kw)
    g, p = torch.from_numpy(g_P), torch.from_numpy(p_D)
    c = dual_kernels.relu_offsets(d_t, g, p)
    y, s, mom = dual_kernels._init_state(d_t, B, None, "cpu")
    y, _, s, _, w = (torch.from_numpy(np.ascontiguousarray(t)) for t in
                     _jax_window(d_j, c.numpy(), (y, y, s, mom), 0, tier_kw,
                                 ITERS, loop == "restart"))
    z, zhat = dual_kernels._primal(d_t, g, s, w,
                                   dual_kernels.recovery_weight(d_t, ITERS))
    return z, y, w, zhat


def _port(d_t, loop, g_P, p_D, tier):
    """The port's wrapper of ``loop`` on CPU tensors: its plain version at
    ``tier``."""
    g, p = torch.from_numpy(g_P), torch.from_numpy(p_D)
    kw = dict(iterations=ITERS, tier=tier)
    if loop == "flat":
        return kernels.gpad_fixed_paired_flat(d_t, g, p, **kw)
    if loop == "full":
        return kernels.gpad_fixed_paired(d_t, g, p, **kw)
    return dual_kernels.gpad_fixed_dual(d_t, g, p, restart=loop == "restart",
                                        **kw)


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("loop", LOOPS)
def test_plain_version_at_a_tier_matches_pallas(pair, loop, tier):
    d_j, d_t, g_P, p_D = pair
    out_j = [np.asarray(t) for t in _pallas(d_j, d_t, loop, g_P, p_D,
                                            TIERS[tier])]
    out_t = [t.numpy() for t in _port(d_t, loop, g_P, p_D, tier)]
    highest = [t.numpy() for t in _port(d_t, loop, g_P, p_D, "highest")]
    n_u = d_t.n_u
    for name, a, b in zip(("z", "y", "w", "zhat"), out_j, out_t):
        assert a.shape == b.shape and np.isfinite(b).all(), name
    if tier == "high":
        for name, a, b, h in zip(("z", "y", "w", "zhat"), out_j, out_t,
                                 highest):
            np.testing.assert_allclose(b, a, atol=TOL, rtol=0, err_msg=name)
            np.testing.assert_allclose(b, h, atol=TOL, rtol=0, err_msg=name)
        return
    tol = BF16_U_TOL if tier == "bfloat16" else DEFAULT_U_TOL
    np.testing.assert_allclose(out_t[0][:, :n_u], out_j[0][:, :n_u], atol=tol,
                               rtol=0)
    assert any(not np.array_equal(b, h) for b, h in zip(out_t, highest))


def _jax_window(d_j, c, state, k0, tier_kw, chunk=WINDOW, restart=False):
    """tpu_gpad's chunk kernel (``_dual_chunk_call``, interpret mode) for
    ``chunk`` iterations from ``k0`` on the port's relu offsets and state
    (y, y_prev, s, mom), back in the port's layouts: (y, y_prev, s, mom,
    w)."""
    m_h = d_j.m_half
    S = jkernels._round_up(m_h, jkernels.SUBLANE)
    B_t = jkernels.pick_lane_tile(B, S, jkernels.DUAL_CHUNK_ARRAYS,
                                  mats=4 * S * S)
    B_p = jkernels._round_up(B, B_t)
    mm_dtype = jnp.dtype(tier_kw.get("matmul_dtype", "float32"))
    precision = tier_kw.get("precision", "highest")
    Dn = jkernels._prep_operand(jkernels._pad2(-d_j.D, S, S), mm_dtype,
                                precision)
    pad = lambda a: jkernels._pad2(jnp.asarray(a).T, S, B_p)  # noqa: E731
    y, y_prev, s, mom = (t.numpy() for t in state)
    call = jkernels._dual_chunk_call(
        d_j, pad(c[:, 0]), pad(c[:, 1]), Dn, d_j.theta, d_j.beta, S, B_p,
        B_t, mm_dtype, jkernels._kernel_precision(mm_dtype, precision),
        chunk, True, restart=restart)
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
def test_chunk_window_at_a_tier_matches_pallas(pair, tier):
    """Two windows of the chunk op at ``tier`` (its plain version), from
    schedule offsets 0 and WINDOW, against tpu_gpad's chunk kernel on the
    same offsets and state: the window's state out, and each window's w.
    On the schedule's momentum: a restart decision taken where its test
    reads near 0 may differ between two orders of summation (the restart
    loops are held on the whole solve above)."""
    d_j, d_t, g_P, p_D = pair
    c = dual_kernels.relu_offsets(d_t, torch.from_numpy(g_P),
                                  torch.from_numpy(p_D))
    y, s, mom = dual_kernels._init_state(d_t, B, None, "cpu")
    state = (y, y.clone(), s, mom)
    tol = TOL if tier == "high" else 5e-3
    for k0 in (0, WINDOW):
        want = _jax_window(d_j, c.numpy(), state, k0, TIERS[tier],
                           restart=False)
        got = dual_kernels.gpad_dual_chunk(d_t, c, *state, k0=k0,
                                           chunk=WINDOW, tier=tier)
        plain = dual_kernels.gpad_dual_chunk(d_t, c, *state, k0=k0,
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


# The rounding helpers against an independent NumPy reference: each value
# as sign x m 2**e (np.frexp, float64), its significand rounded at the
# format's bits (TF32 11: half away from zero; bf16 8: half to even)
def _round_ref(x, bits, half_even):
    x = x.astype(np.float64)
    m, e = np.frexp(np.abs(x))
    q = m * 2.0 ** bits
    q = np.rint(q) if half_even else np.floor(q + 0.5)
    return (np.sign(x) * np.ldexp(q, e - bits)).astype(np.float32)


def _normals(rng, n):
    """Random normal float32 values over many binades, and ties of both
    formats (TF32: low 13 bits 0x1000; bf16: low 16 bits 0x8000 with an
    even and an odd bit 16), both signs."""
    x = (rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 6, n))
    bits = x.astype(np.float32).view(np.uint32)
    tf32_ties = (bits & ~np.uint32(0x1FFF)) | np.uint32(0x1000)
    bf16_ties = (bits & ~np.uint32(0x1FFFF)) | np.uint32(0x8000)
    bf16_odd = bf16_ties | np.uint32(0x10000)
    near = (bits & ~np.uint32(0x1FFF)) | np.uint32(0x0FFF)
    return np.concatenate([bits, tf32_ties, bf16_ties, bf16_odd,
                           near]).view(np.float32)


def test_rounding_helpers_are_bit_exact():
    x = _normals(np.random.default_rng(5), 4096)
    t = torch.from_numpy(x.copy())
    tf32 = core._round_tf32(t).numpy()
    assert np.array_equal(tf32.view(np.uint32),
                          _round_ref(x, 11, False).view(np.uint32))
    assert not (tf32.view(np.uint32) & 0x1FFF).any()
    bf16 = core._round_bf16(t).numpy()
    assert np.array_equal(bf16.view(np.uint32),
                          _round_ref(x, 8, True).view(np.uint32))
    hi, lo = (v.numpy() for v in core._split_tf32_rna(t))
    assert np.array_equal(hi.view(np.uint32), tf32.view(np.uint32))
    rest = (x.astype(np.float64) - hi).astype(np.float32)  # exact
    assert np.array_equal(lo.view(np.uint32),
                          _round_ref(rest, 11, False).view(np.uint32))
    # the pair carries a to 2^-22 of its magnitude
    err = np.abs(hi.astype(np.float64) + lo - x) / np.abs(x)
    assert err.max() <= 2.0 ** -22
    # ties go away from zero (TF32) and to even (bf16)
    one = np.float32(1.0).view(np.uint32)
    tie = np.array([one | 0x1000, (one | 0x1000) | 0x80000000],
                   dtype=np.uint32).view(np.float32)
    got = core._round_tf32(torch.from_numpy(tie)).numpy()
    assert list(got) == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]
    tie = np.array([one | 0x8000, one | 0x18000],
                   dtype=np.uint32).view(np.float32)
    got = core._round_bf16(torch.from_numpy(tie)).numpy()
    assert list(got) == [1.0, 1.0 + 2.0 ** -6]
    special = torch.tensor([float("inf"), -float("inf"), 0.0, -0.0])
    assert torch.equal(core._round_tf32(special), special)


# The shapes around the shared-memory guard (synthetic widths; the flat
# layout has m_h = n_s + n_z, the full one n_s = m_h) and the batches of
# the port's paths
PLAN_BATCHES = (1, 5, 256, 300, 4096)
PLAN_N_Z = (1, 2, 5, 12, 30, 33, 64, 90, 150, 151, 220, 260, 300)
PLAN_M_H = (1, 7, 16, 40, 70, 71, 110, 140, 220, 221, 330, 400, 600, 900,
            1200, 1830)


@pytest.mark.parametrize("tier", list(TIERS))
def test_tier_plans_exist_where_highest_does(tier):
    seen = {True: 0, False: 0}
    for n_z in PLAN_N_Z:
        for m_h in PLAN_M_H:
            shapes = [(m_h, n_z, m_h)]
            if m_h > n_z:
                shapes.append((m_h, n_z, m_h - n_z))
            for shape, B in ((s, b) for s in shapes for b in PLAN_BATCHES):
                want = kernels._paired_plan(*shape, B)
                got = kernels._paired_plan(*shape, B, tier=tier)
                assert (got is None) == (want is None), (shape, B)
                seen[want is None] += 1
                if want is None:
                    continue
                # a tier narrows the tile only where its registers, one
                # dual element fewer, do not hold the wider one
                assert got.log2_tile <= want.log2_tile, (shape, B, got, want)
                if got.log2_tile < want.log2_tile:
                    assert kernels._paired_overflows(shape[0], want.log2_tile,
                                                     tier)
                assert got.split1 >= 1 and got.split2 >= 1
                assert (kernels._paired_smem_bytes(*shape, got)
                        <= kernels.SMEM_LIMIT_BYTES)
    assert seen[True] and seen[False]  # the band has both sides
    seen = {True: 0, False: 0}
    for m_h in range(1, 320, 3):
        for B in PLAN_BATCHES:
            want = dual_kernels._dual_plan(m_h, B)
            got = dual_kernels._dual_plan(m_h, B, tier=tier)
            assert (got is None) == (want is None), (m_h, B)
            seen[want is None] += 1
            if want is not None:
                assert got.log2_tile == want.log2_tile and got.split >= 1
                assert (dual_kernels._dual_smem_bytes(m_h, got)
                        <= kernels.SMEM_LIMIT_BYTES)
    assert seen[True] and seen[False]


def test_tier_parts_count_warp_tiles():
    """Under a tier the split-K parts leave each warp one (tile, part): at
    the headline B4096 (16 scenarios a block) zhat's product of 30 rows
    has 2 x 2 warp tiles, so 2 parts; q's of 40 rows 3 x 2, so 1; the
    dual's of 70 rows 5 x 2, so 1."""
    plan = kernels._paired_plan(70, 30, 40, 4096, tier="default")
    assert plan == kernels.PairedPlan(4, 4, 2, 1)
    assert dual_kernels._dual_plan(70, 4096, tier="bfloat16").split == 1
    assert kernels.block_parts(30, 1, 70, tier="high") == 4  # 2 x 1 tiles


ROUTES = {
    "paired_flat": dict(),
    "paired": dict(form="mvp", flat="off"),
    "dual": dict(restart=True),
    "dual_chunk": dict(mode="eps", restart=True, eps_g=1e-5, eps_V=1e-5),
}


@pytest.mark.parametrize("tier", ["default", "bfloat16"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_kernel_route_exported_under_a_tier(pair, monkeypatch, route, tier):
    """A concrete batch exported by aot.py on a kernel route under a tier:
    the graph calls the route's op with the tier, the record holds TF32
    off (the ops around a launch run fp32), and the loaded call equals the
    live one bit for bit. On the CPU the route is taken by standing in the
    card's routing; its ops run their plain versions at the tier."""
    _, d_t, _, _ = pair
    monkeypatch.setattr(core, "resolve_engine",
                        lambda data, config, batch=1: "cuda")
    cfg = SolverConfig(iterations=ITERS // 2, **ROUTES[route], **TIERS[tier])
    assert core.cuda_kernel(d_t, cfg) == route
    X0 = np.random.default_rng(3).uniform(-0.4, 0.4, (B, 3)).astype(np.float32)
    blob = aot.export_solver(d_t, cfg, batch_size=B)
    extra = {"gpad_tier.json": ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    rec = json.loads(extra["gpad_tier.json"])
    assert rec["tier"] == tier and rec["tf32"] is False
    # the graph's calls of the op, those in the eps windows' loop bodies too
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
