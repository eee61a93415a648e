"""The dense and full paired loops past one block's shared memory on the
CPU, where each kernel's op runs its plain version: the tiled dense op
(``tpu_gpad_torch::dense_tiled``) against ``tpu_gpad``'s dense Pallas
kernel ``gpad_pallas_fixed`` in interpret mode at battery n5 N20 (m 440,
past the resident dense kernel's m 280), and the flat tiled op at n_s = m_h
(``gpad_fixed_paired_tiled``) against ``gpad_pallas_fixed_paired`` at
battery n5 N30 (m_h 330, past the resident paired kernel's 220), on the
same seeded g_P, p_D and y0, at fp32 "highest" and at each tier; the
routing of ``core.cuda_kernel`` over the shapes of both guards; and u* of
the "cuda" engine's entry on CPU tensors against the NumPy oracle. The
CUDA kernels themselves are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: "highest" within 1e-5 of the Pallas kernel on every output
(fp32 sums in another order over 40 iterations); a tier by
tests/test_torch_tiled_tiers.py's criteria: "high" within 2e-5 of the
port's "highest" on every output, and of the Pallas kernel's "high" within
that kernel's own distance from its "highest" plus 1e-5 (tpu_gpad's "high"
is bf16x3, which at these widths moves up to 4.3e-5 from fp32, the port's
3xTF32 2.4e-6); "default" and "bfloat16" u within 5e-3 of the Pallas
kernel's, and not equal to "highest"; u* within 1e-4 of the oracle
(bench.py's gate)."""

import dataclasses
import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_gpad
from tpu_gpad import problems as jp
from tpu_gpad.solver import kernels as jkernels
from tpu_gpad.solver.core import affine_params as j_affine_params
from tpu_gpad.solver.reference import gpad_solve_qp

from tpu_gpad_torch.convert import gpad_data_from_numpy
from tpu_gpad_torch.solver import SolverConfig, core, kernels
from tpu_gpad_torch.types import GPAD_META_FIELDS, GPAD_TENSOR_FIELDS

torch.set_num_threads(2)

ITERS = 40
TOL = 1e-5
TIER_TOL = 2e-5  # "high", as tests/test_torch_tiled_tiers.py
TIER_U_TOL = 5e-3  # "default" and "bfloat16" u
ORACLE_TOL = 1e-4
ORACLE_ITERS = 100
B = 3
TIERS = {"high": dict(precision="high"), "default": dict(precision="default"),
         "bfloat16": dict(matmul_dtype="bfloat16")}
NAMES = ("z", "y", "w", "zhat")


def _pair(n, N, paired, iterations=ITERS):
    qp = tpu_gpad.condense(jp.battery(n, N))
    d_j = tpu_gpad.dualize(qp, iterations=iterations, paired=paired)
    fields = {k: None if getattr(d_j, k) is None else np.asarray(getattr(d_j, k))
              for k in GPAD_TENSOR_FIELDS}
    d_t = gpad_data_from_numpy(
        fields, {k: getattr(d_j, k) for k in GPAD_META_FIELDS}, device="cpu")
    X0 = np.random.default_rng(n * 100 + N).uniform(-0.4, 0.4, (B, d_j.n_x))
    g_P, p_D = j_affine_params(d_j, jnp.asarray(X0, dtype=jnp.float32))
    return qp, d_j, d_t, X0, np.array(g_P), np.array(p_D)


@pytest.fixture(scope="module")
def dense():
    """battery n5 N20, dense layout: m 440, n_z 100."""
    return _pair(5, 20, False)


@pytest.fixture(scope="module")
def paired():
    """battery n5 N30, paired: m_h 330, n_z 150."""
    return _pair(5, 30, "auto")


def _y0(case, rows, seed=7):
    rng = np.random.default_rng(seed)
    if case == "warm_shared":
        return rng.uniform(0.0, 0.5, rows[1:]).astype(np.float32)
    if case in ("warm_per_scenario", "no_diagnostics"):
        return rng.uniform(0.0, 0.5, rows).astype(np.float32)
    return None


def _run(jfn, tfn, pair, case, **tier):
    _, d_j, d_t, _, g_P, p_D = pair
    y0 = _y0(case, p_D.shape)
    diagnostics = case != "no_diagnostics"
    out_j = jfn(d_j, jnp.asarray(g_P), jnp.asarray(p_D),
                None if y0 is None else jnp.asarray(y0), iterations=ITERS,
                interpret=True, diagnostics=diagnostics, **tier)
    out_t = tfn(d_t, torch.from_numpy(g_P), torch.from_numpy(p_D),
                None if y0 is None else torch.from_numpy(y0),
                iterations=ITERS, diagnostics=diagnostics)
    return out_j, out_t


def _assert_close(out_j, out_t, tol=TOL):
    for name, a, b in zip(NAMES, out_j, out_t):
        if a is None:
            assert b is None, name
            continue
        assert tuple(b.shape) == tuple(a.shape), name
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=tol, rtol=0,
                                   err_msg=name)


CASES = ["cold", "warm_shared", "warm_per_scenario", "no_diagnostics"]


@pytest.mark.parametrize("case", CASES)
def test_dense_tiled_plain_matches_pallas_interpret(dense, case):
    _, _, d_t, _, _, _ = dense
    assert not kernels.dense_fits_smem(d_t) and kernels.dense_tiled_fits(d_t)
    _assert_close(*_run(jkernels.gpad_pallas_fixed,
                        kernels.gpad_fixed_dense_tiled, dense, case))


@pytest.mark.parametrize("case", CASES)
def test_paired_tiled_plain_matches_pallas_interpret(paired, case):
    _, _, d_t, _, _, _ = paired
    assert not kernels.paired_fits_smem(d_t) and kernels.paired_tiled_fits(d_t)
    _assert_close(*_run(jkernels.gpad_pallas_fixed_paired,
                        kernels.gpad_fixed_paired_tiled, paired, case))


def test_paired_tiled_is_the_flat_tiled_op_at_every_row(paired, monkeypatch):
    """The full paired route launches the flat tiled op with n_s = m_h, and
    that op's plain version is then the full paired loop (no identity
    block's division)."""
    _, _, d_t, _, g_P, p_D = paired
    seen = []
    real = kernels.flat_tiled_op

    def spy(*args):
        seen.append(args[9])  # n_s
        return real(*args)

    monkeypatch.setattr(kernels, "flat_tiled_op", spy)
    g, p = torch.from_numpy(g_P), torch.from_numpy(p_D)
    out = kernels.gpad_fixed_paired_tiled(d_t, g, p, iterations=ITERS)
    full = kernels.gpad_fixed_paired_torch(d_t, g, p, iterations=ITERS)
    kernels.gpad_fixed_flat_tiled(d_t, g, p, iterations=ITERS)
    assert seen == [d_t.m_half, d_t.n_struct]
    for a, b in zip(out, full):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("route", ["dense_tiled", "paired_tiled"])
def test_tiled_routes_at_a_tier_match_pallas(dense, paired, route, tier):
    pair, jfn = ((dense, jkernels.gpad_pallas_fixed) if route == "dense_tiled"
                 else (paired, jkernels.gpad_pallas_fixed_paired))
    _, d_j, d_t, _, g_P, p_D = pair
    fn = getattr(kernels, f"gpad_fixed_{route}")
    out_j, j_highest = ([np.asarray(t) for t in jfn(
        d_j, jnp.asarray(g_P), jnp.asarray(p_D), iterations=ITERS,
        interpret=True, **kw)] for kw in (TIERS[tier], {}))
    g, p = torch.from_numpy(g_P), torch.from_numpy(p_D)
    out_t, highest = ([t.numpy() for t in fn(d_t, g, p, iterations=ITERS,
                                             tier=t)]
                      for t in (tier, "highest"))
    for a, b in zip(out_j, out_t):
        assert a.shape == b.shape and np.isfinite(b).all()
    if tier == "high":
        for name, a, b, h, jh in zip(NAMES, out_j, out_t, highest, j_highest):
            np.testing.assert_allclose(b, h, atol=TIER_TOL, rtol=0,
                                       err_msg=name)
            np.testing.assert_allclose(b, a, atol=np.abs(a - jh).max() + TOL,
                                       rtol=0, err_msg=name)
        return
    n_u = d_t.n_u
    np.testing.assert_allclose(out_t[0][:, :n_u], out_j[0][:, :n_u],
                               atol=TIER_U_TOL, rtol=0)
    assert any(not np.array_equal(b, h) for b, h in zip(out_t, highest))


# battery (n_cells, horizon) of the gap between the resident kernels'
# shared memory and tpu_gpad's VMEM guards: the dense layout's m and n_z,
# the paired layout's m_h
GAP = [(3, 20), (5, 20), (3, 50), (5, 30), (10, 20), (5, 50), (10, 30)]


@pytest.fixture(scope="module")
def gap():
    out = {}
    for n, N in GAP:
        qp = tpu_gpad.condense(jp.battery(n, N))
        for paired in (False, "auto"):
            d_j = tpu_gpad.dualize(qp, iterations=5, paired=paired)
            fields = {k: None if getattr(d_j, k) is None
                      else np.asarray(getattr(d_j, k))
                      for k in GPAD_TENSOR_FIELDS}
            out[n, N, paired] = gpad_data_from_numpy(
                fields, {k: getattr(d_j, k) for k in GPAD_META_FIELDS},
                device="cpu")
    return out


@pytest.mark.parametrize("shape", GAP, ids=[f"n{n}_N{N}" for n, N in GAP])
def test_routing_across_the_gap(gap, shape):
    """Resident below each guard, the tiled route above it (forced: wherever
    its plan fits; auto: where ``kernels.tiled_auto`` says the kernel was
    measured faster), the flat routes unchanged, soft paired rows on the
    route hard ones take, and no route for soft dense rows, a restart on
    dense data, or eps without the dual form."""
    dense, pair = gap[(*shape, False)], gap[(*shape, "auto")]
    m, m_h = dense.m, pair.m_half
    assert (m, m_h) == (2 * m_h, m_h)
    resident = kernels.dense_fits_smem(dense)
    assert resident == (m <= 280)
    tiled = "dense_tiled" if kernels.tiled_auto(dense) else None
    assert core.cuda_kernel(dense, SolverConfig()) == (
        "dense" if resident else tiled)
    assert core.cuda_kernel(dense, SolverConfig(engine="cuda")) == (
        "dense" if resident else "dense_tiled")
    off = dict(form="mvp", flat="off")
    resident = kernels.paired_fits_smem(pair)
    assert resident == (m_h <= 220)
    tiled = "paired_tiled" if kernels.tiled_auto(pair) else None
    assert core.cuda_kernel(pair, SolverConfig(**off)) == (
        "paired" if resident else tiled)
    assert core.cuda_kernel(pair, SolverConfig(engine="cuda", **off)) == (
        "paired" if resident else "paired_tiled")
    assert core.cuda_kernel(pair, SolverConfig(form="mvp")) == (
        "paired_flat" if kernels.flat_fits_smem(pair) else "flat_tiled")
    soft_dense = dataclasses.replace(dense, soft_damp=torch.zeros(m))
    soft_pair = dataclasses.replace(pair, soft_damp=torch.full((m_h,), 0.1))
    for cfg in (SolverConfig(), SolverConfig(engine="cuda")):
        assert core.cuda_kernel(soft_dense, cfg) is None
        assert core.cuda_kernel(dense, dataclasses.replace(
            cfg, restart=True)) is None
        assert core.cuda_kernel(dense, dataclasses.replace(
            cfg, mode="eps")) is None
    # every paired kernel carries soft rows: the route of the hard rows
    for engine in ("auto", "cuda"):
        cfg = SolverConfig(engine=engine, **off)
        assert core.cuda_kernel(soft_pair, cfg) == core.cuda_kernel(pair, cfg)
    assert core.cuda_kernel(soft_pair, SolverConfig(engine="cuda", **off)) == (
        "paired" if resident else "paired_tiled")
    # at B16384 the paired and flat tiled kernels lost at every gap shape:
    # auto keeps the resident kernels and the torch engine, a forced "cuda"
    # the tiled routes; the tiled dense kernel won at every shape there
    big = 16384
    assert core.cuda_kernel(dense, SolverConfig(), big) == (
        "dense" if m <= 280 else "dense_tiled")
    assert core.cuda_kernel(dense, SolverConfig(engine="cuda"), big) == (
        "dense" if m <= 280 else "dense_tiled")
    assert core.cuda_kernel(pair, SolverConfig(**off), big) == (
        "paired" if resident else None)
    assert core.cuda_kernel(pair, SolverConfig(engine="cuda", **off),
                            big) == ("paired" if resident else "paired_tiled")
    flat_resident = kernels.flat_fits_smem(pair)
    assert core.cuda_kernel(pair, SolverConfig(form="mvp"), big) == (
        "paired_flat" if flat_resident else None)
    assert core.cuda_kernel(pair, SolverConfig(engine="cuda", form="mvp"),
                            big) == ("paired_flat" if flat_resident
                                     else "flat_tiled")
    for diagnostics in (True, False):  # the flag never changes the route
        cfg = SolverConfig(engine="cuda", diagnostics=diagnostics)
        assert core.cuda_kernel(dense, cfg) == core.cuda_kernel(
            dense, SolverConfig(engine="cuda"))


def test_auto_edges_follow_the_measurement():
    """``engine="auto"`` takes the tiled routes up to the largest shape the
    kernel was measured at (dense m 3660, paired and flat m_h 1830) and up
    to the most work, rows a side x n_z x batch, at which it was measured
    faster (dense: the flagship m 3660 x n_z 900 x B16384, the largest
    measured; paired m_h 550 x n_z 250 x B4096; flat m_h 630 x n_z 300 x
    B4096), and the torch engine past either; a forced "cuda" takes them
    wherever they fit."""
    def at(paired, rows, n_z=1):
        return SimpleNamespace(paired=paired, m=rows, m_half=rows, n_z=n_z)

    for paired, flat, most_rows, most_work in (
            (False, False, kernels.DENSE_TILED_AUTO_MAX_M,
             kernels.DENSE_TILED_AUTO_MAX_WORK),
            (True, False, kernels.PAIRED_TILED_AUTO_MAX_M_HALF,
             kernels.PAIRED_TILED_AUTO_MAX_WORK),
            (True, True, kernels.FLAT_TILED_AUTO_MAX_M_HALF,
             kernels.FLAT_TILED_AUTO_MAX_WORK)):
        assert kernels.tiled_auto(at(paired, most_rows), flat=flat)
        assert not kernels.tiled_auto(at(paired, most_rows + 1), flat=flat)
        assert kernels.tiled_auto(at(paired, 100, 10), most_work // 1000,
                                  flat=flat)
        assert not kernels.tiled_auto(at(paired, 100, 10),
                                      most_work // 1000 + 1, flat=flat)
    assert (kernels.DENSE_TILED_AUTO_MAX_M, kernels.PAIRED_TILED_AUTO_MAX_M_HALF,
            kernels.FLAT_TILED_AUTO_MAX_M_HALF) == (3660, 1830, 1830)
    assert (kernels.DENSE_TILED_AUTO_MAX_WORK,
            kernels.PAIRED_TILED_AUTO_MAX_WORK,
            kernels.FLAT_TILED_AUTO_MAX_WORK) == (
                3660 * 900 * 16384, 550 * 250 * 4096, 630 * 300 * 4096)


# (layout, battery n, N, batch, was the kernel faster than the torch
# engine): the edges of chip_smoke.py --times routes on an H100 (PERF.md,
# section 5), each batch's last shape won and first shape lost ("dense":
# the tiled dense kernel won at the flagship, the last shape, at every
# batch; "flat": the flat tiled route, its left-out wins past the edge
# aside)
MEASURED_EDGES = [
    ("dense", 30, 30, 1, True), ("dense", 30, 30, 64, True),
    ("dense", 30, 30, 256, True), ("dense", 30, 30, 1024, True),
    ("dense", 30, 30, 4096, True), ("dense", 30, 30, 16384, True),
    ("paired", 30, 30, 1, True), ("paired", 30, 30, 256, True),
    ("paired", 15, 30, 1024, True), ("paired", 20, 30, 1024, False),
    ("paired", 5, 50, 4096, True), ("paired", 10, 30, 4096, False),
    ("paired", 5, 30, 16384, False),
    ("flat", 30, 30, 1, True), ("flat", 30, 30, 64, True),
    ("flat", 30, 30, 256, True), ("flat", 20, 30, 1024, True),
    ("flat", 10, 30, 4096, True), ("flat", 15, 30, 4096, False),
    ("flat", 5, 30, 16384, False),
]


@pytest.mark.parametrize(
    "layout,n,N,batch,faster", MEASURED_EDGES,
    ids=[f"{c[0]}_n{c[1]}_N{c[2]}_B{c[3]}" for c in MEASURED_EDGES])
def test_auto_edges_follow_the_batch(layout, n, N, batch, faster):
    """On each side of every batch's measured edge ``"auto"`` takes the
    tiled route where the kernel was faster and the torch engine where it
    lost."""
    qp = tpu_gpad.condense(jp.battery(n, N))
    paired = layout != "dense"
    rows = qp.m // 2 if paired else qp.m
    data = SimpleNamespace(paired=paired, m=qp.m, m_half=qp.m // 2,
                           n_z=qp.n_z)
    assert kernels.tiled_auto(data, batch, flat=layout == "flat") == faster
    assert rows > (220 if paired else 280)  # past the resident


def test_cli_info_routes_at_its_batch(capsys):
    """``info --batch`` reports the route a solve of that many scenarios
    takes: dense n5 N20 (m 440) on the tiled dense kernel at B1, B4096 and
    B16384, where the redesigned kernel beat the torch engine."""
    from tpu_gpad_torch import cli

    kernels_seen = []
    for batch in (1, 4096, 16384):
        assert cli.main(["info", "--cells", "5", "--horizon", "20",
                         "--paired", "off", "--batch", str(batch),
                         "--device", "cpu"]) == 0
        out = capsys.readouterr().out.strip().splitlines()[-1]
        kernels_seen.append(json.loads(out)["kernel"])
    assert kernels_seen == ["dense_tiled", "dense_tiled", "dense_tiled"]


def test_tiled_guards_and_plans(gap):
    """The dense route takes the tiled dense kernel's plan, whose shared
    memory is the staging ring's alone: at the 30x30 flagship's dense layout
    (m 3660, n_z 900) B256 tiles of 64 scenarios, m in 4 parts and n_z in
    one, 128 and 116 units, 8 stages of 26,624 bytes (213,120 a block with
    the barriers); at 128 scenarios 6 stages fit. The paired route keeps
    the flat tiled plan at its rows a side. The dense guard refuses soft
    rows, the paired one takes them, and each refuses the other layout."""
    plan = kernels.pick_dense_tiled(3660, 900, 256)
    assert plan[:3] == (64, 4, 1)
    assert (plan.units_a, plan.units_b) == (4 * 8 * 4, 4 * 29)
    assert plan.smem == kernels._dense_tiled_smem_bytes(64) == 128 + 8 * (
        4 * 32 * (128 + 64 + 16))
    assert kernels.dense_tiled_stages(128) == 6
    assert kernels.pick_flat_tiled(1830, 900, 256).log2_tile == 4
    dense, pair = gap[(10, 30, False)], gap[(10, 30, "auto")]
    assert kernels.dense_tiled_fits(dense) and not kernels.dense_tiled_fits(pair)
    assert kernels.paired_tiled_fits(pair) and not kernels.paired_tiled_fits(dense)
    assert not kernels.dense_tiled_fits(
        dataclasses.replace(dense, soft_damp=torch.zeros(dense.m)))
    assert kernels.paired_tiled_fits(
        dataclasses.replace(pair, soft_damp=torch.zeros(pair.m_half)))
    # a stack whose one scenario's wd and zhat pass a block's shared memory
    assert kernels.pick_flat_tiled(58_100, 100) is None
    assert kernels.pick_flat_tiled(58_000, 100).grouped is False


def test_dense_tiled_fits_past_the_cluster_guard(gap):
    """The cluster design held a scenario's w and zhat in each block's
    shared memory, which refused m 58,100 at n_z 100 (``pick_flat_tiled``,
    one scenario); the redesigned kernel keeps its state in device memory,
    so such a stack fits, with a plan at every batch."""
    dense = gap[(5, 20, False)]
    wide = SimpleNamespace(paired=False, soft_damp=None, m=58_100, n_z=100)
    assert kernels.pick_flat_tiled(wide.m, wide.n_z) is None
    assert kernels.dense_tiled_fits(wide) and kernels.dense_tiled_fits(dense)
    for B in (1, 256, 16384):
        plan = kernels.pick_dense_tiled(wide.m, wide.n_z, B)
        assert plan.smem <= kernels.SMEM_LIMIT_BYTES
        assert 1 <= plan.parts_a <= -(-wide.m // 32)
    assert not kernels.dense_tiled_fits(SimpleNamespace(
        paired=False, soft_damp=torch.zeros(3), m=58_100, n_z=100))


# (m, n_z) of the guard table: the smallest stack past the resident dense
# kernel, battery n5 N20, n10 N20, the widest n_z, odd widths and the
# flagship's dense layout
PLAN_SHAPES = [(281, 60), (440, 100), (840, 200), (1861, 450), (2461, 617),
               (3660, 900)]
PLAN_BATCHES = (1, 7, 64, 130, 256, 1024, 4096, 16384)


@pytest.mark.parametrize("tier", kernels.KERNEL_TIERS)
@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=[f"m{m}_nz{n}" for m, n in PLAN_SHAPES])
def test_pick_dense_tiled_guard_table(shape, tier):
    """``pick_dense_tiled`` over m 281-3660, n_z 60-900 and B 1-16384 at
    every tier: a plan wherever ``dense_tiled_fits`` admits (every unpaired
    hard stack); at most 232,448 bytes of shared memory a block; each
    phase's parts within its k-tiles and its units in one wave of the
    card's 132 SMs where it has parts, with as many parts as fit it, so
    that units > 132 - tiles wherever the k-tiles allow (a part more would
    start a second wave); the tile within the batch rounded up; the same
    plan at every tier."""
    m, n_z = shape
    sms = kernels.H100_SMS
    for B in PLAN_BATCHES:
        plan = kernels.pick_dense_tiled(m, n_z, B, tier)
        assert plan == kernels.pick_dense_tiled(m, n_z, B)
        assert plan.tile in kernels.DENSE_TILED_TILES
        assert plan.tile <= max(16, 1 << (B - 1).bit_length())
        assert plan.smem == kernels._dense_tiled_smem_bytes(plan.tile)
        assert plan.smem <= kernels.SMEM_LIMIT_BYTES == 232_448
        assert (plan.cols, plan.depth) == (128, 32)
        assert plan.stages == kernels.dense_tiled_stages(plan.tile) >= 6
        st = -(-B // plan.tile)
        for parts, units, k, cols in ((plan.parts_a, plan.units_a, m, n_z),
                                      (plan.parts_b, plan.units_b, n_z, m)):
            tiles, k_tiles = st * -(-cols // 128), -(-k // 32)
            assert 1 <= parts <= k_tiles
            assert units == tiles * parts
            if parts > 1:
                assert units <= sms
            assert parts == k_tiles or units > sms - tiles, (B, parts, units)
        floats = kernels._dense_tiled_scratch_floats(m, n_z, B, *plan[:3])
        assert floats >= -(-B // plan.tile) * plan.tile * 3 * (m + n_z)


def test_dense_tiled_fake_shapes_under_export(dense):
    """The op's fake implementation gives the kernel's output shapes
    (z, zhat (B, n_z); y, w (B, m); w and zhat empty without diagnostics),
    so ``torch.export`` traces a dense tiled solve at any plan."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    _, _, d_t, _, g_P, p_D = dense
    for diagnostics in (True, False):
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            args = [mode.from_tensor(t) for t in (
                d_t.MG_T, d_t.GL_T, torch.from_numpy(g_P),
                torch.from_numpy(p_D))]
            z, y, w, zhat = kernels.dense_tiled_op(
                *args, None, mode.from_tensor(d_t.theta),
                mode.from_tensor(d_t.beta), 5, 128, 8, 2, diagnostics,
                "highest")
        assert tuple(z.shape) == (B, d_t.n_z) and tuple(y.shape) == (B, d_t.m)
        want = ((B, d_t.m), (B, d_t.n_z)) if diagnostics else ((0,), (0,))
        assert (tuple(w.shape), tuple(zhat.shape)) == want

    class Solve(torch.nn.Module):
        def forward(self, g, p):
            return kernels.gpad_fixed_dense_tiled(d_t, g, p, iterations=5)[:2]

    g, p = torch.from_numpy(g_P), torch.from_numpy(p_D)
    program = torch.export.export(Solve(), (g, p))
    got = program.module()(g, p)
    assert "tpu_gpad_torch.dense_tiled.default" in {
        str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    for a, b in zip(got, Solve()(g, p)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("route", ["dense_tiled", "paired_tiled"])
def test_cuda_entry_on_cpu_tensors_matches_oracle(route):
    """``solve_batch``'s "cuda" entry (``kernels.solve_batch_cuda``) on CPU
    tensors routes to the tiled route and runs its plain version: u*
    against the NumPy oracle (tpu_gpad/solver/reference.py)."""
    n, N, paired, kw = ((5, 20, False, {}) if route == "dense_tiled"
                        else (5, 30, "auto", dict(form="mvp", flat="off")))
    qp, _, d_t, X0, _, _ = _pair(n, N, paired, iterations=ORACLE_ITERS)
    cfg = SolverConfig(engine="cuda", iterations=ORACLE_ITERS, **kw)
    assert core.cuda_kernel(d_t, cfg) == route
    x0 = torch.as_tensor(X0, dtype=torch.float32)
    g_P, p_D = core.affine_params(d_t, x0)
    res = kernels.solve_batch_cuda(d_t, g_P, p_D, cfg)
    plain = core.solve_batch(d_t, x0, dataclasses.replace(cfg, engine="torch"))
    for i in range(B):
        ref = gpad_solve_qp(qp, X0[i], iterations=ORACLE_ITERS)
        assert np.abs(res.u[i].numpy() - ref.u).max() < ORACLE_TOL
    assert (res.u - plain.u).abs().max().item() < ORACLE_TOL


@pytest.mark.parametrize("lead", [(), (5,), (2, 3)], ids=["one", "B5", "2x3"])
def test_the_solve_batch_reaches_the_routing(dense, lead, monkeypatch):
    """``solve_batch`` routes with its scenarios (every leading dim of x0,
    1 for one solve), and ``solve_batch_cuda`` with g_P's, so the edges of
    ``kernels.tiled_auto`` see the batch a solve runs."""
    _, _, d_t, _, _, _ = dense
    seen, route = [], core.cuda_kernel

    def record(data, config, batch=1):
        seen.append(batch)
        return route(data, config, batch)

    monkeypatch.setattr(core, "cuda_kernel", record)
    x0 = torch.zeros(lead + (d_t.n_x,))
    with pytest.raises(ValueError, match="CUDA device"):
        core.solve_batch(d_t, x0, SolverConfig(engine="cuda", iterations=5))
    g_P, p_D = core.affine_params(d_t, x0)
    res = kernels.solve_batch_cuda(d_t, g_P, p_D,
                                   SolverConfig(engine="cuda", iterations=5))
    n = int(np.prod(lead))
    assert seen == [n, n]
    assert tuple(res.u.shape[:-1]) == lead


def test_tiled_wrappers_refuse_and_cpu_counts_nothing(dense, paired):
    _, _, d_t, _, g_P, p_D = dense
    _, _, p_t, _, pg_P, pp_D = paired
    g, p = torch.from_numpy(g_P), torch.from_numpy(p_D)
    pg, pp = torch.from_numpy(pg_P), torch.from_numpy(pp_D)
    with pytest.raises(ValueError, match="unpaired"):
        kernels.gpad_fixed_dense_tiled(p_t, pg, pp, iterations=5)
    with pytest.raises(ValueError, match="soft"):
        kernels.gpad_fixed_dense_tiled(
            dataclasses.replace(d_t, soft_damp=torch.zeros(d_t.m)), g, p,
            iterations=5)
    with pytest.raises(ValueError, match="p_D"):
        kernels.gpad_fixed_dense_tiled(d_t, g, p[:2], iterations=5)
    with pytest.raises(ValueError, match="broadcast"):
        kernels.gpad_fixed_dense_tiled(d_t, g, p, torch.zeros((2, d_t.m)),
                                       iterations=5)
    with pytest.raises(ValueError, match="exceed"):
        kernels.gpad_fixed_dense_tiled(d_t, g, p, iterations=ITERS + 1)
    with pytest.raises(ValueError, match="paired data"):
        kernels.gpad_fixed_paired_tiled(d_t, g, p, iterations=5)
    before = (kernels.DENSE_TILED_LAUNCHES, kernels.PAIRED_TILED_LAUNCHES,
              kernels.FLAT_TILED_LAUNCHES)
    kernels.gpad_fixed_dense_tiled(d_t, g, p, iterations=5)
    kernels.gpad_fixed_paired_tiled(p_t, pg, pp, iterations=5)
    # soft rows are carried: the plain version of the full paired loop
    soft = dataclasses.replace(
        p_t, soft_damp=torch.linspace(0.0, 0.3, p_t.m_half))
    out = kernels.gpad_fixed_paired_tiled(soft, pg, pp, iterations=5)
    ref = kernels.gpad_fixed_paired_torch(soft, pg, pp, iterations=5)
    hard = kernels.gpad_fixed_paired_torch(p_t, pg, pp, iterations=5)
    assert (out[1] - hard[1]).abs().max() > 0  # the damp took effect
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert (kernels.DENSE_TILED_LAUNCHES, kernels.PAIRED_TILED_LAUNCHES,
            kernels.FLAT_TILED_LAUNCHES) == before
