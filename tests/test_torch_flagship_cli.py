"""The reference's 30x30 flagship on the port against ``tpu_gpad`` on the
same (converted) data; the CLI's ``closedloop`` and ``info`` against
``tpu_gpad.cli``; and the NumPy pieces they need (``solve_flops``,
``bounds.certify``, ``solver.qp``) against the JAX package's. The tiled
kernels' plain versions run here; the kernels themselves on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_gpad
from tpu_gpad import problems as jp
from tpu_gpad.bounds import certify as j_certify
from tpu_gpad.cli import main as jax_main
from tpu_gpad.solver import SolverConfig as JConfig
from tpu_gpad.solver.qp import solve_condensed_qp as j_solve_condensed_qp
from tpu_gpad.solver.qp import solve_qp_exact as j_solve_qp_exact
from tpu_gpad.solver.reference import gpad_solve_qp as j_oracle
from tpu_gpad.utils import solve_flops as j_solve_flops

import tpu_gpad_torch
from tpu_gpad_torch import bounds, closed_loop
from tpu_gpad_torch.cli import main as torch_main
from tpu_gpad_torch.convert import gpad_data_from_numpy
from tpu_gpad_torch.solver import SolverConfig, core, dual_kernels, kernels, qp
from tpu_gpad_torch.types import GPAD_META_FIELDS, GPAD_TENSOR_FIELDS
from tpu_gpad_torch.utils import solve_flops

torch.set_num_threads(2)

ORACLE_TOL = 1e-4  # |u* - NumPy oracle|: the gate of bench.py
EPS_U_TOL = 2e-4  # eps runs may stop one window apart (tests/test_tiled.py)


def _carry(d_j):
    fields = {k: None if getattr(d_j, k) is None else np.asarray(getattr(d_j, k))
              for k in GPAD_TENSOR_FIELDS}
    return gpad_data_from_numpy(
        fields, {k: getattr(d_j, k) for k in GPAD_META_FIELDS}, device="cpu")


@pytest.fixture(scope="module")
def flagship():
    """battery(30, 30) condensed by tpu_gpad, its data carried across, and
    two scenarios (B = 2) of the box the CLI samples from."""
    qp_j = tpu_gpad.condense(jp.battery(30, 30))
    d_j = tpu_gpad.dualize(qp_j, iterations=100, paired="auto")
    X0 = np.random.default_rng(0).uniform(-0.4, 0.4, (2, 30)).astype(np.float32)
    return qp_j, d_j, _carry(d_j), X0


def test_flagship_restart_matches_xla(flagship):
    """60 restart iterations: the torch engine and the tiled dual kernel's
    wrapper (its plain version on CPU tensors) against tpu_gpad's XLA
    engine."""
    _, d_j, d_t, X0 = flagship
    assert core.cuda_kernel(d_t, SolverConfig(restart=True)) == "dual_tiled"
    ref = tpu_gpad.solve_batch(d_j, jnp.asarray(X0), JConfig(
        iterations=60, restart=True, engine="xla"))
    res = tpu_gpad_torch.solve_batch(d_t, X0, SolverConfig(iterations=60,
                                                           restart=True))
    np.testing.assert_allclose(res.u.numpy(), np.asarray(ref.u),
                               atol=ORACLE_TOL, rtol=0)
    g_P, p_D = core.affine_params(d_t, torch.from_numpy(X0))
    z, *_ = dual_kernels.gpad_fixed_dual_tiled(d_t, g_P, p_D, iterations=60,
                                               restart=True)
    np.testing.assert_allclose(z[:, :d_t.n_u].numpy(), np.asarray(ref.u),
                               atol=ORACLE_TOL, rtol=0)


@pytest.mark.parametrize("kernel", ["dual_tiled", "flat_tiled"])
def test_flagship_fixed_matches_oracle(flagship, kernel):
    """100 fixed iterations on each tiled kernel's wrapper (plain version on
    CPU tensors) and through solve_batch: u* against the NumPy oracle."""
    qp_j, _, d_t, X0 = flagship
    g_P, p_D = core.affine_params(d_t, torch.from_numpy(X0))
    if kernel == "dual_tiled":
        z, *_ = dual_kernels.gpad_fixed_dual_tiled(d_t, g_P, p_D,
                                                   iterations=100)
        cfg = SolverConfig(form="dual")
    else:
        z, *_ = kernels.gpad_fixed_flat_tiled(d_t, g_P, p_D, iterations=100)
        cfg = SolverConfig(form="mvp", engine="torch")
    res = tpu_gpad_torch.solve_batch(d_t, X0, cfg)
    for i in range(2):
        oracle = j_oracle(qp_j, X0[i].astype(np.float64), 100).u
        assert np.abs(z[i, :d_t.n_u].numpy() - oracle).max() < ORACLE_TOL
        assert np.abs(res.u[i].numpy() - oracle).max() < ORACLE_TOL


def test_flagship_eps_flat_off_matches_xla(flagship):
    """solve_to_accuracy(tol=1e-4, flat="off") at the flagship: the torch
    engine, and the eps loop on the tiled chunk wrapper (the path the card
    takes), against tpu_gpad's; 400 iterations at most."""
    _, d_j, d_t, X0 = flagship
    kw = dict(tol=1e-4, max_iterations=400, flat="off")
    ref = tpu_gpad.solve_to_accuracy(d_j, jnp.asarray(X0), **kw)
    res = tpu_gpad_torch.solve_to_accuracy(d_t, X0, **kw)
    cfg = SolverConfig(mode="eps", eps_g=1e-4, eps_V=1e-4, check_every=10,
                       iterations=400, restart=True, flat="off")
    assert core.cuda_kernel(d_t, cfg) == "dual_tiled_chunk"
    g_P, p_D = core.affine_params(d_t, torch.from_numpy(X0))
    before = dual_kernels.EPS_SYNCS
    chunked = dual_kernels.gpad_eps_dual(d_t, g_P, p_D, cfg)
    assert dual_kernels.EPS_SYNCS > before
    for r in (res, chunked):
        np.testing.assert_array_equal(r.converged.numpy(),
                                      np.asarray(ref.converged))
        assert np.abs(r.iterations.numpy()
                      - np.asarray(ref.iterations)).max() <= 10
        np.testing.assert_allclose(r.u.numpy(), np.asarray(ref.u),
                                   atol=EPS_U_TOL, rtol=0)


def _last_json(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def test_closedloop_matches_jax_cli(capsys):
    argv = ["closedloop", "--restart", "--warm-start", "--steps", "20"]
    assert torch_main(argv + ["--device", "cpu"]) == 0
    out_t = _last_json(capsys)
    assert jax_main(argv) == 0
    out_j = _last_json(capsys)
    assert set(out_t) == set(out_j) | {"engine", "device"}
    assert out_t["engine"] == "torch" and out_t["device"] == "cpu"
    for key in ("problem", "steps", "warm_start", "mean_iterations"):
        assert out_t[key] == out_j[key], key
    np.testing.assert_allclose(out_t["final_state"], out_j["final_state"],
                               atol=1e-4, rtol=0)
    assert abs(out_t["max_residual"] - out_j["max_residual"]) < 1e-5


def test_closedloop_batch_and_plot(tmp_path, capsys):
    png = tmp_path / "loop.png"
    argv = ["closedloop", "--batch", "3", "--steps", "5", "--device", "cpu",
            "--plot", str(png)]
    assert torch_main(argv) == 0
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert len(lines[0]["final_state"]) == 3 and lines[1] == {"plot": str(png)}
    assert png.exists() and png.stat().st_size > 0


def test_plot_closed_loop_without_matplotlib(monkeypatch):
    res = tpu_gpad_torch.simulate(tpu_gpad_torch.problems.battery(3, 10),
                                  np.zeros(3), n_steps=2, device="cpu")
    assert closed_loop.plot_closed_loop(res) is not None
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert closed_loop.plot_closed_loop(res) is None


def test_info_matches_jax_cli_at_flagship(capsys):
    argv = ["info", "--cells", "30", "--horizon", "30"]
    assert torch_main(argv + ["--device", "cpu"]) == 0
    out_t = _last_json(capsys)
    assert jax_main(argv) == 0
    out_j = _last_json(capsys)
    assert set(out_t) == set(out_j) | {"kernel", "device"}
    assert out_t["resolved_engine"] == {"xla": "torch"}[out_j["resolved_engine"]]
    for key in sorted(set(out_j) - {"devices", "resolved_engine", "L"}):
        assert out_t[key] == out_j[key], key
    assert abs(out_t["L"] - out_j["L"]) <= 1e-6 * out_j["L"]
    # the kernel the default configuration takes on the card: the flat
    # tiled one (tpu_gpad's auto engine sends it to XLA on a TPU, but on an
    # H100 the kernel beat the torch engine; PERF.md §5)
    assert out_t["kernel"] == "flat_tiled" and out_t["devices"] == ["cpu"]


@pytest.mark.parametrize(
    "flags,kernel",
    [(["--restart"], "dual_tiled"), (["--form", "dual"], "dual_tiled"),
     (["--mode", "eps"], None),
     (["--mode", "eps", "--flat", "off"], "dual_tiled_chunk")],
    ids=["restart", "form_dual", "eps", "eps_flat_off"])
def test_info_reports_the_flagship_kernel(capsys, flags, kernel):
    assert torch_main(["info", "--cells", "30", "--horizon", "30",
                       "--device", "cpu", *flags]) == 0
    out = _last_json(capsys)
    assert out["kernel"] == kernel and out["resolved_engine"] == "torch"


def test_info_forced_cuda_needs_a_card():
    """A forced engine works or raises: on CPU data it raises."""
    with pytest.raises(ValueError, match="CUDA device"):
        torch_main(["info", "--cells", "3", "--horizon", "10", "--device",
                    "cpu", "--engine", "cuda"])


def test_info_bound_matches_jax_cli(capsys):
    argv = ["info", "--cells", "3", "--horizon", "4", "--bound",
            "--eps-v", "1e-3"]
    assert torch_main(argv + ["--device", "cpu"]) == 0
    out_t = _last_json(capsys)
    assert jax_main(argv) == 0
    out_j = _last_json(capsys)
    assert out_t["certified_iterations"] == out_j["certified_iterations"]
    assert out_t["dual_norm_bound"] == pytest.approx(out_j["dual_norm_bound"],
                                                     rel=1e-9)


def test_info_stagewise_matches_jax_cli(capsys):
    argv = ["info", "--engine", "stagewise", "--cells", "2", "--horizon", "10"]
    assert torch_main(argv + ["--device", "cpu"]) == 0
    out_t = _last_json(capsys)
    assert jax_main(argv) == 0
    out_j = _last_json(capsys)
    assert set(out_t) == set(out_j) | {"device"}
    for key in ("problem", "n_x", "n_u", "horizon", "engine", "m",
                "condensed_operand_mb"):
        assert out_t[key] == out_j[key], key


@pytest.mark.parametrize(
    "layout,form,flat",
    [("paired", "dual", False), ("paired", "mvp", False),
     ("paired", "mvp", True), ("dense", "mvp", False)])
def test_solve_flops_matches_jax(layout, form, flat):
    d_j = tpu_gpad.dualize(tpu_gpad.condense(jp.battery(3, 10)),
                           iterations=10, paired=layout == "paired")
    d_t = _carry(d_j)
    for iters in (1, 100):
        assert solve_flops(d_t, iters, form, flat=flat) == j_solve_flops(
            d_j, iters, form, flat=flat)


def _qps():
    qp_j = tpu_gpad.condense(jp.battery(3, 10))
    qp_t = tpu_gpad_torch.condense(tpu_gpad_torch.problems.battery(3, 10))
    return qp_j, qp_t


def test_certify_sampled_matches_jax():
    qp_j, qp_t = _qps()
    lo, hi = np.full(3, -0.32), np.full(3, 0.32)
    kw = dict(eps_g=1e-3, eps_V=1e-3, method="sampled", n_samples=20, seed=0)
    n_t, dn_t, L_t = bounds.certify(qp_t, lo, hi, **kw)
    n_j, dn_j, L_j = j_certify(qp_j, lo, hi, **kw)
    assert n_t == n_j and L_t == L_j
    assert dn_t.delta == pytest.approx(dn_j.delta, rel=1e-12)
    assert bounds.certified_budget(L_t, dn_t.delta, 1e-3, 1e-3) == n_t


def test_certify_milp_matches_jax():
    """The paper's eq.-(16) bound as a big-M MILP (scipy HiGHS)."""
    qp_j = tpu_gpad.condense(jp.battery(3, 4))
    qp_t = tpu_gpad_torch.condense(tpu_gpad_torch.problems.battery(3, 4))
    lo, hi = np.full(3, -0.4), np.full(3, 0.4)
    kw = dict(eps_g=1e-3, eps_V=1e-3, method="milp")
    n_t, dn_t, L_t = bounds.certify(qp_t, lo, hi, **kw)
    n_j, dn_j, L_j = j_certify(qp_j, lo, hi, **kw)
    assert n_t == n_j and L_t == L_j
    assert dn_t.delta == pytest.approx(dn_j.delta, rel=1e-9)


def test_solve_qp_exact_matches_jax():
    qp_j, qp_t = _qps()
    for seed in range(3):
        x0 = np.random.default_rng(seed).uniform(-0.4, 0.4, 3)
        sol_t = qp.solve_condensed_qp(qp_t, x0)
        sol_j = j_solve_condensed_qp(qp_j, x0)
        assert sol_t.status == sol_j.status
        np.testing.assert_array_equal(sol_t.z, sol_j.z)
        np.testing.assert_array_equal(sol_t.lam, sol_j.lam)
    H = np.array([[2.0, 0.5], [0.5, 1.0]])
    G = np.array([[1.0, 1.0], [-1.0, 0.0]])
    args = (H, np.array([-1.0, -1.0]), G, np.array([0.5, 0.0]))
    a, b = qp.solve_qp_exact(*args), j_solve_qp_exact(*args)
    np.testing.assert_array_equal(a.z, b.z)
    assert a.status == b.status
