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
    # at B16384 the kernel lost at every gap shape: auto keeps the resident
    # kernels and the torch engine, a forced "cuda" the tiled routes
    big = 16384
    assert core.cuda_kernel(dense, SolverConfig(), big) == (
        "dense" if m <= 280 else None)
    assert core.cuda_kernel(dense, SolverConfig(engine="cuda"), big) == (
        "dense" if m <= 280 else "dense_tiled")
    assert core.cuda_kernel(pair, SolverConfig(**off), big) == (
        "paired" if resident else None)
    assert core.cuda_kernel(pair, SolverConfig(engine="cuda", **off),
                            big) == ("paired" if resident else "paired_tiled")
    for diagnostics in (True, False):  # the flag never changes the route
        cfg = SolverConfig(engine="cuda", diagnostics=diagnostics)
        assert core.cuda_kernel(dense, cfg) == core.cuda_kernel(
            dense, SolverConfig(engine="cuda"))


def test_auto_edges_follow_the_measurement():
    """``engine="auto"`` takes the tiled routes up to the largest shape the
    kernel was measured at (dense m 3660, paired m_h 1830) and up to the
    most work, rows a side x n_z x batch, at which it was measured faster
    (dense m 700 x n_z 150 x B4096, paired m_h 550 x n_z 250 x B4096), and
    the torch engine past either; a forced "cuda" takes them wherever they
    fit."""
    def at(paired, rows, n_z=1):
        return SimpleNamespace(paired=paired, m=rows, m_half=rows, n_z=n_z)

    for paired, most_rows, most_work in (
            (False, kernels.DENSE_TILED_AUTO_MAX_M,
             kernels.DENSE_TILED_AUTO_MAX_WORK),
            (True, kernels.PAIRED_TILED_AUTO_MAX_M_HALF,
             kernels.PAIRED_TILED_AUTO_MAX_WORK)):
        assert kernels.tiled_auto(at(paired, most_rows))
        assert not kernels.tiled_auto(at(paired, most_rows + 1))
        assert kernels.tiled_auto(at(paired, 100, 10), most_work // 1000)
        assert not kernels.tiled_auto(at(paired, 100, 10),
                                      most_work // 1000 + 1)
    assert (kernels.DENSE_TILED_AUTO_MAX_M,
            kernels.PAIRED_TILED_AUTO_MAX_M_HALF) == (3660, 1830)
    assert (kernels.DENSE_TILED_AUTO_MAX_WORK,
            kernels.PAIRED_TILED_AUTO_MAX_WORK) == (700 * 150 * 4096,
                                                    550 * 250 * 4096)


# (layout, battery n, N, batch, was the kernel faster than the torch
# engine): the edges of chip_smoke.py --times routes on an H100 (PERF.md,
# section 5), each batch's last shape won and first shape lost
MEASURED_EDGES = [
    ("dense", 30, 30, 1, True), ("dense", 30, 30, 64, True),
    ("dense", 20, 30, 256, True), ("dense", 25, 30, 256, False),
    ("dense", 10, 30, 1024, True), ("dense", 15, 30, 1024, False),
    ("dense", 3, 50, 4096, True), ("dense", 10, 20, 4096, False),
    ("dense", 5, 20, 16384, False),
    ("paired", 30, 30, 1, True), ("paired", 30, 30, 256, True),
    ("paired", 15, 30, 1024, True), ("paired", 30, 30, 1024, False),
    ("paired", 5, 50, 4096, True), ("paired", 10, 30, 4096, False),
    ("paired", 5, 30, 16384, False),
]


@pytest.mark.parametrize(
    "layout,n,N,batch,faster", MEASURED_EDGES,
    ids=[f"{c[0]}_n{c[1]}_N{c[2]}_B{c[3]}" for c in MEASURED_EDGES])
def test_auto_edges_follow_the_batch(layout, n, N, batch, faster):
    """On each side of every batch's measured edge ``"auto"`` takes the
    tiled route where the kernel was faster and the torch engine where it
    lost."""
    qp = tpu_gpad.condense(jp.battery(n, N))
    rows = qp.m // 2 if layout == "paired" else qp.m
    data = SimpleNamespace(paired=layout == "paired", m=qp.m, m_half=qp.m // 2,
                           n_z=qp.n_z)
    assert kernels.tiled_auto(data, batch) == faster
    assert rows > (220 if layout == "paired" else 280)  # past the resident


def test_cli_info_routes_at_its_batch(capsys):
    """``info --batch`` reports the route a solve of that many scenarios
    takes: dense n5 N20 (m 440) on the tiled dense kernel at B1 and B4096,
    the torch engine at B16384, where the kernel lost."""
    from tpu_gpad_torch import cli

    kernels_seen = []
    for batch in (1, 4096, 16384):
        assert cli.main(["info", "--cells", "5", "--horizon", "20",
                         "--paired", "off", "--batch", str(batch),
                         "--device", "cpu"]) == 0
        out = capsys.readouterr().out.strip().splitlines()[-1]
        kernels_seen.append(json.loads(out)["kernel"])
    assert kernels_seen == ["dense_tiled", "dense_tiled", None]


def test_tiled_guards_and_plans(gap):
    """Both routes take the flat tiled plan at their rows a side: at the
    30x30 flagship's dense layout (m 3660, n_z 900) 8 scenarios a cluster
    at B256, 162 KB a block; the dense guard refuses soft rows, the paired
    one takes them, and each refuses the other layout."""
    assert kernels.pick_flat_tiled(3660, 900, 256).log2_tile == 3
    assert kernels._flat_tiled_smem_bytes(3660, 900, 3) == 4 * 8 * (
        3660 + 900 + 512)
    assert kernels._flat_tiled_smem_bytes(3660, 900, 4) > kernels.SMEM_LIMIT_BYTES
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
