"""The precision tiers of the torch engine (``SolverConfig.precision`` and
``matmul_dtype``) against ``tpu_gpad``'s XLA engine on the same seeded
inputs: battery n3 N10, paired and dense, B6, 100 iterations, for the mvp
(flat and dense), dual-form, restart and eps loops and for
``convergence_trace``; then the TF32 switch's scope, the routes of the
dense, tiled and resident kernels under a tier (each the kernel "highest"
takes), AOT artifacts exported under a tier and the CLI.

Tolerances, stated before the code was written:

- "highest", "high" and "default": ``tests/test_torch_solver.py``'s TOL.
  XLA:CPU computes all three in fp32; the port's CPU "high" is the 3xTF32
  split algebra in fp32, about 2^-22 relative from one fp32 product.
- "bfloat16": the port's u within 5e-3 of tpu_gpad's bf16 u, and each
  within 5e-3 of its own fp32 u (tests/test_solver.py's
  ``test_bf16_matmul_close``)."""

import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_gpad
from tpu_gpad import problems as jp
from tpu_gpad.analysis import convergence_trace as jax_trace
from tpu_gpad.cli import main as jax_main
from tpu_gpad.solver import SolverConfig as JConfig

import tpu_gpad_torch
from tpu_gpad_torch import aot
from tpu_gpad_torch.analysis import convergence_trace
from tpu_gpad_torch.convert import gpad_data_from_numpy, solve_result_to_numpy
from tpu_gpad_torch.solver import SolverConfig, core
from tpu_gpad_torch.types import GPAD_META_FIELDS, GPAD_TENSOR_FIELDS, GPADData

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
ITERS = 100
TOL = {"u": 2e-5, "z": 2e-5, "y": 2e-5, "residual": 2e-5, "gap": 2e-6}
BF16_U_TOL = 5e-3
TIERS = {"highest": {}, "high": dict(precision="high"),
         "default": dict(precision="default"),
         "bfloat16": dict(matmul_dtype="bfloat16")}
LOOPS = {
    "mvp_flat": ("paired", dict(form="mvp", flat="on")),
    "mvp_dense": ("dense", {}),
    "dual": ("paired", dict(form="dual")),
    "restart": ("paired", dict(restart=True)),
    "eps": ("paired", dict(mode="eps", restart=True, eps_g=1e-5, eps_V=1e-5)),
}


def _pair(paired):
    d_j = tpu_gpad.dualize(tpu_gpad.condense(jp.battery(3, 10)),
                           iterations=ITERS, paired=paired)
    fields = {k: None if getattr(d_j, k) is None else np.asarray(getattr(d_j, k))
              for k in GPAD_TENSOR_FIELDS}
    d_t = gpad_data_from_numpy(
        fields, {k: getattr(d_j, k) for k in GPAD_META_FIELDS}, device="cpu")
    return d_j, d_t


@pytest.fixture(scope="module")
def data():
    return {"paired": _pair("auto"), "dense": _pair(False)}


X0 = np.random.default_rng(1).uniform(-0.4, 0.4, (6, 3)).astype(np.float32)


def _solve_both(data, loop, tier_kw):
    layout, kw = LOOPS[loop]
    d_j, d_t = data[layout]
    res_j = tpu_gpad.solve_batch(d_j, jnp.asarray(X0), JConfig(
        engine="xla", iterations=ITERS, **kw, **tier_kw))
    res_t = tpu_gpad_torch.solve_batch(d_t, X0, SolverConfig(
        engine="torch", iterations=ITERS, **kw, **tier_kw))
    return res_j, solve_result_to_numpy(res_t)


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("loop", list(LOOPS))
def test_tier_matches_tpu_gpad(data, loop, tier):
    res_j, out = _solve_both(data, loop, TIERS[tier])
    if tier == "bfloat16":
        np.testing.assert_allclose(out["u"], np.asarray(res_j.u),
                                   atol=BF16_U_TOL, rtol=0)
        f32_j, f32_t = _solve_both(data, loop, {})
        np.testing.assert_allclose(out["u"], f32_t["u"], atol=BF16_U_TOL,
                                   rtol=0)
        np.testing.assert_allclose(np.asarray(res_j.u), np.asarray(f32_j.u),
                                   atol=BF16_U_TOL, rtol=0)
        return
    for name, tol in TOL.items():
        np.testing.assert_allclose(out[name], np.asarray(getattr(res_j, name)),
                                   atol=tol, rtol=0, err_msg=name)
    np.testing.assert_array_equal(out["iterations"],
                                  np.asarray(res_j.iterations))
    np.testing.assert_array_equal(out["converged"], np.asarray(res_j.converged))


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("restart", [False, True], ids=["fixed", "restart"])
def test_trace_tier_matches_tpu_gpad(data, restart, tier):
    d_j, d_t = data["paired"]
    cfg = dict(iterations=ITERS, restart=restart, **TIERS[tier])
    tr_j = jax_trace(d_j, X0, JConfig(**cfg))
    tr_t = convergence_trace(d_t, X0, SolverConfig(**cfg))
    assert tr_t.residual.shape == tr_t.gap.shape == (ITERS, 6)
    if tier == "bfloat16":
        np.testing.assert_allclose(tr_t.u, tr_j.u, atol=BF16_U_TOL, rtol=0)
        return
    np.testing.assert_allclose(tr_t.residual, tr_j.residual,
                               atol=TOL["residual"], rtol=0)
    np.testing.assert_allclose(tr_t.gap, tr_j.gap, atol=TOL["gap"], rtol=0)
    np.testing.assert_allclose(tr_t.u, tr_j.u, atol=TOL["u"], rtol=0)


def test_split_is_exact():
    """hi is exact in TF32 (its low 13 mantissa bits clear) and hi + lo is
    the operand bit for bit; the CPU 3-product sum is fp32-close."""
    a = torch.as_tensor(np.random.default_rng(0).standard_normal((7, 33)),
                        dtype=torch.float32)
    hi, lo = core._split_tf32(a)
    assert (hi.view(torch.int32) & ((1 << 13) - 1)).eq(0).all()
    assert torch.equal(hi + lo, a)
    b = torch.as_tensor(np.random.default_rng(1).standard_normal((33, 5)),
                        dtype=torch.float32)
    mm = core._Matmul(SolverConfig(precision="high"), device="cpu")
    exact = a.double() @ b.double()
    assert (mm(a, mm.prep(b)).double() - exact).abs().max() < 1e-5
    # bf16: operands rounded to bf16, products and sums in fp32
    mb = core._Matmul(SolverConfig(matmul_dtype="bfloat16"), device="cpu")
    want = a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()
    assert torch.equal(mb(a, mb.prep(b)), want)
    assert mb.route == "upcast"
    # paired state with a leading batch: (B, 2, m) @ (m, n)
    y = torch.ones((3, 2, 33))
    assert mm(y, mm.prep(b)).shape == (3, 2, 5)
    assert mb(y, mb.prep(b)).shape == (3, 2, 5)


@pytest.mark.parametrize("tier", ["highest", "high"])
def test_tf32_switch_restored_after_a_raise(data, monkeypatch, tier):
    """The solve runs under its tier's TF32 setting and leaves the caller's
    setting as it was, also when the solve raises inside the scope."""
    _, d_t = data["paired"]
    seen = []

    def boom(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        raise RuntimeError("boom")

    monkeypatch.setattr(core, "_solve_fixed_dual", boom)
    caller = torch.backends.cuda.matmul.allow_tf32
    for flag in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = flag
        try:
            with pytest.raises(RuntimeError, match="boom"):
                tpu_gpad_torch.solve_batch(d_t, X0, SolverConfig(
                    engine="torch", **TIERS[tier]))
            assert torch.backends.cuda.matmul.allow_tf32 is flag
        finally:
            torch.backends.cuda.matmul.allow_tf32 = caller
    assert seen == [tier == "high"] * 2


def test_highest_ignores_the_callers_tf32(data):
    _, d_t = data["paired"]
    cfg = SolverConfig(engine="torch")
    ref = tpu_gpad_torch.solve_batch(d_t, X0, cfg)
    caller = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = tpu_gpad_torch.solve_batch(d_t, X0, cfg)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = caller
    assert torch.equal(got.u, ref.u) and torch.equal(got.y, ref.y)


@pytest.mark.parametrize("kw", [dict(precision="high"),
                                dict(precision="default"),
                                dict(matmul_dtype="bfloat16")],
                         ids=["high", "default", "bfloat16"])
def test_kernel_route_under_a_tier_raises(data, monkeypatch, kw):
    """Whether a kernel route under a tier raises: none does. The dense
    route (``auto`` on unpaired n3 N10) and the tiled ones (the paired
    data with the resident kernels' guards stood down, as past shared
    memory: flat tiled, tiled dual under restart or the dual form, tiled
    chunk in eps mode) resolve to "cuda" under each tier, to the kernel
    "highest" takes. The card is stood in for by the data's device."""
    from tpu_gpad_torch.solver import dual_kernels, kernels

    monkeypatch.setattr(GPADData, "device",
                        property(lambda self: torch.device("cuda")))
    _, d_t = data["dense"]
    for route in (dict(), dict(engine="cuda")):
        cfg = SolverConfig(**route, **kw)
        assert core.resolve_engine(d_t, cfg) == "cuda"
        assert core.cuda_kernel(d_t, cfg) == "dense"
    monkeypatch.setattr(kernels, "flat_fits_smem", lambda data: False)
    monkeypatch.setattr(dual_kernels, "dual_fits_smem", lambda data: False)
    _, d_t = data["paired"]
    routes = {"flat_tiled": dict(), "dual_tiled": dict(restart=True),
              "dual_tiled_chunk": dict(mode="eps", restart=True, flat="off")}
    for kernel, route in routes.items():
        assert core.cuda_kernel(d_t, SolverConfig(**route, **kw)) == kernel
        for forms in (dict(), dict(engine="cuda")):
            cfg = SolverConfig(**route, **forms, **kw)
            assert core.resolve_engine(d_t, cfg) == "cuda", kernel
            assert (core.cuda_kernel(d_t, cfg)
                    == core.cuda_kernel(d_t, SolverConfig(**route, **forms)))
    assert core.cuda_kernel(d_t, SolverConfig(form="dual", **kw)) == "dual_tiled"
    assert core.resolve_engine(d_t, SolverConfig(engine="torch", **kw)) == "torch"


@pytest.mark.parametrize("kw", [dict(precision="high"),
                                dict(precision="default"),
                                dict(matmul_dtype="bfloat16")],
                         ids=["high", "default", "bfloat16"])
def test_resident_kernel_routes_take_a_tier(data, monkeypatch, kw):
    """The paired flat route (``auto`` at the headline) and the other
    resident condensed routes resolve to "cuda" under each tier, to the
    kernel "highest" takes. The card is stood in for by the data's
    device."""
    _, d_t = data["paired"]
    monkeypatch.setattr(GPADData, "device",
                        property(lambda self: torch.device("cuda")))
    assert core.resolve_engine(d_t, SolverConfig(**kw)) == "cuda"
    assert core.cuda_kernel(d_t, SolverConfig(**kw)) == "paired_flat"
    for route in (dict(form="mvp", flat="off"), dict(restart=True),
                  dict(mode="eps", restart=True), dict(engine="cuda")):
        assert core.resolve_engine(d_t, SolverConfig(**route, **kw)) == "cuda"
        assert (core.cuda_kernel(d_t, SolverConfig(**route, **kw))
                == core.cuda_kernel(d_t, SolverConfig(**route)))


@pytest.mark.parametrize("bad", [dict(precision="fastest"),
                                 dict(matmul_dtype="float16")])
def test_unknown_tier_raises(data, bad):
    _, d_t = data["paired"]
    with pytest.raises(ValueError, match="unknown"):
        tpu_gpad_torch.solve_batch(d_t, X0, SolverConfig(engine="torch", **bad))


@pytest.mark.parametrize("batch", [None, 6], ids=["symbolic", "concrete"])
@pytest.mark.parametrize("tier", ["high", "bfloat16"])
def test_aot_artifact_under_a_tier(data, tier, batch):
    """An artifact exported under a tier records it, loads, and equals the
    live call bit for bit; the loaded call runs under the tier's TF32
    scope and restores the caller's setting."""
    _, d_t = data["paired"]
    cfg = SolverConfig(iterations=ITERS, restart=True, **TIERS[tier])
    blob = aot.export_solver(d_t, cfg, batch_size=batch)
    extra = {"gpad_tier.json": ""}
    torch.export.load(io.BytesIO(blob), extra_files=extra)
    rec = json.loads(extra["gpad_tier.json"])
    assert rec["tier"] == tier and rec["tf32"] == (tier == "high")
    out = aot.load_solver(blob)(X0)
    live = tpu_gpad_torch.solve_batch(d_t, X0, dataclasses.replace(
        cfg, engine="torch"))
    for k in ("u", "z", "y", "iterations", "residual", "gap", "converged"):
        assert torch.equal(out[k], getattr(live, k)), k
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("flags", [["--precision", "high"],
                                   ["--dtype", "bfloat16"]],
                         ids=["high", "bfloat16"])
def test_cli_solve_under_a_tier(capsys, flags):
    argv = ["solve", "--batch", "16", *flags]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_gpad_torch", *argv, "--engine", "torch",
         "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    (out_t,) = [json.loads(ln) for ln in proc.stdout.strip().splitlines()]
    assert jax_main([*argv, "--engine", "xla"]) == 0
    (out_j,) = [json.loads(ln) for ln in
                capsys.readouterr().out.strip().splitlines()]
    assert out_t["engine"] == "torch"
    tol = BF16_U_TOL if "bfloat16" in flags else TOL["u"]
    np.testing.assert_allclose(out_t["u_star"], out_j["u_star"], atol=tol,
                               rtol=0)
    assert out_t["iterations"] == out_j["iterations"]
