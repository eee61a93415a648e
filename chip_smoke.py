#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``tpu_gpad_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernel from ``tpu_gpad_torch/csrc``, holds it
against its plain torch version on the card, drives the port's main path
(the batched condensed solve at the headline shape, then a warm-started
``Controller`` serving a fleet of plants) and checks that the path went
through the kernel, times kernel and plain engine with CUDA events, and
prints one JSON object per phase. Any failed check exits non-zero. The last
line is ``{"ok": true, "device": {...}}``. It imports neither jax nor
``tpu_gpad``. Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

HEADLINE = dict(n_cells=3, horizon=10)  # battery n3 N10: the benchmark shape
BATCH = 4096
ITERS = 100
KERNEL_TOL = 1e-4  # |kernel - plain|: fp32 sums in another order, 100 iters
ORACLE_TOL = 1e-4  # |u* - NumPy oracle|: the gate of bench.py
SERVE_STEPS = 50
SERVE_PLANTS = 256
DEVICE = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def max_err(a, b) -> float:
    """Max |a - b| over matching outputs (None pairs skipped)."""
    errs = [(x - y).abs().max().item() for x, y in zip(a, b) if x is not None]
    return max(errs)


def kernel_vs_plain(kernels, data, g_P, p_D, y0=None, diagnostics=True):
    """Run the kernel and its plain version on the same CUDA tensors."""
    import torch

    kw = dict(iterations=ITERS, diagnostics=diagnostics)
    out_k = kernels.gpad_fixed_paired_flat(data, g_P, p_D, y0, **kw)
    out_p = kernels.gpad_fixed_paired_flat_torch(data, g_P, p_D, y0, **kw)
    torch.cuda.synchronize()
    for t in out_k:
        if t is not None:
            check(bool(torch.isfinite(t).all()), "kernel output not finite")
    if not diagnostics:
        check(out_k[2] is None and out_k[3] is None,
              "diagnostics=False returned w/zhat")
    return max_err(out_k, out_p), out_k


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls are enabled")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi, name


def phase_build():
    from tpu_gpad_torch import cuda_build
    from tpu_gpad_torch.solver import kernels

    kernels._launch_fn()
    log = cuda_build.BUILD_LOG.get("gpad_paired_flat", "")
    emit({"phase": "build",
          "build_s": cuda_build.BUILD_SECONDS["gpad_paired_flat"],
          "ptxas": [ln.strip() for ln in log.splitlines() if "ptxas info" in ln]})


def phase_kernel_vs_plain(torch, tg, kernels, core):
    qp = tg.condense(tg.problems.battery(**HEADLINE))
    data = tg.dualize(qp, ITERS, paired="auto", device=DEVICE)
    rng = np.random.default_rng(0)
    X0 = torch.as_tensor(
        rng.uniform(-0.4, 0.4, (BATCH, qp.n_x)).astype(np.float32), device=DEVICE
    )
    g_P, p_D = core.affine_params(data, X0)
    cases = {}
    cases["cold"], (_, y_cold, _, _) = kernel_vs_plain(kernels, data, g_P, p_D)
    cases["warm_per_scenario"], _ = kernel_vs_plain(kernels, data, g_P, p_D, y_cold)
    cases["warm_shared"], _ = kernel_vs_plain(
        kernels, data, g_P, p_D, y_cold[0].contiguous())
    cases["no_diagnostics"], _ = kernel_vs_plain(
        kernels, data, g_P, p_D, y_cold, diagnostics=False)
    soft = dataclasses.replace(data, soft_damp=torch.as_tensor(
        rng.uniform(0.0, 0.2, data.m_half).astype(np.float32), device=DEVICE))
    cases["soft"], _ = kernel_vs_plain(kernels, soft, g_P, p_D)
    for B in (5, 1):  # ragged last tile, single scenario
        cases[f"B{B}"], _ = kernel_vs_plain(
            kernels, data, g_P[:B].contiguous(), p_D[:B].contiguous(),
            y_cold[:B].contiguous())
    worst = max(cases.values())
    emit({"phase": "kernel_vs_plain", "shape": [BATCH, data.n_z, data.m_half,
          data.n_struct], "max_abs_err": cases, "max_abs_y": y_cold.abs().max().item(),
          "tol": KERNEL_TOL})
    check(worst <= KERNEL_TOL, f"kernel disagrees with plain version: {cases}")
    return worst


def phase_main_path(torch, tg, kernels, core, reference):
    qp = tg.condense(tg.problems.battery(**HEADLINE))
    data = tg.dualize(qp, ITERS, paired="auto", device=DEVICE)
    rng = np.random.default_rng(1)
    X0np = rng.uniform(-0.4, 0.4, (BATCH, qp.n_x)).astype(np.float32)
    X0 = torch.as_tensor(X0np, device=DEVICE)
    cfg = tg.SolverConfig()
    before = kernels.PAIRED_FLAT_LAUNCHES
    res = tg.solve_batch(data, X0, cfg)
    torch.cuda.synchronize()
    routing = [core.resolve_engine(data, cfg), core.resolve_form(data, cfg),
               core.resolve_flat(data, cfg)]
    check(kernels.PAIRED_FLAT_LAUNCHES == before + 1,
          "solve_batch did not launch the kernel")
    check(routing == ["cuda", "mvp", True], f"routing {routing}")
    check(tuple(res.u.shape) == (BATCH, data.n_u)
          and tuple(res.y.shape) == (BATCH, 2, data.m_half), "result shapes")
    for name in ("u", "z", "y", "residual", "gap"):
        check(bool(torch.isfinite(getattr(res, name)).all()), f"{name} not finite")
    oracle = [np.abs(res.u[i].cpu().numpy()
                     - reference.gpad_solve_qp(qp, X0np[i].astype(np.float64),
                                               ITERS).u).max()
              for i in range(4)]
    plain = tg.solve_batch(data, X0, dataclasses.replace(cfg, engine="torch"))
    vs_torch = (res.u - plain.u).abs().max().item()
    emit({"phase": "main_path", "routing": routing, "batch": BATCH,
          "u_vs_oracle": [float(e) for e in oracle], "u_vs_torch_engine": vs_torch,
          "residual_max": res.residual.max().item(), "tol": ORACLE_TOL})
    check(oracle[0] < ORACLE_TOL, f"u* vs oracle {oracle[0]}")
    check(max(oracle) < ORACLE_TOL, f"u* vs oracle {oracle}")
    check(vs_torch < ORACLE_TOL, f"cuda vs torch engine {vs_torch}")


def phase_serving(torch, tg, kernels):
    problem = tg.problems.battery(**HEADLINE)
    ctl = tg.Controller(problem, iterations=ITERS, device=DEVICE)
    A = np.asarray(problem.A, dtype=np.float32)
    Bm = np.asarray(problem.B, dtype=np.float32)
    x = np.random.default_rng(2).uniform(
        -0.4, 0.4, (SERVE_PLANTS, problem.n_x)).astype(np.float32)
    spread0 = float(np.mean(x.max(1) - x.min(1)))
    before = kernels.PAIRED_FLAT_LAUNCHES
    u_max = sum_max = soc_max = 0.0
    step_ms = []
    for _ in range(SERVE_STEPS):
        t0 = time.perf_counter()
        u = ctl.step(x)  # returns host NumPy: the device work is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
        u_max = max(u_max, float(np.abs(u).max()))
        sum_max = max(sum_max, float(np.abs(u.sum(1)).max()))
        x = x @ A.T + u @ Bm.T
        soc_max = max(soc_max, float(np.abs(x).max()))
    spread = float(np.mean(x.max(1) - x.min(1)))
    launched = kernels.PAIRED_FLAT_LAUNCHES - before
    emit({"phase": "serving", "plants": SERVE_PLANTS, "steps": SERVE_STEPS,
          "launches": launched, "max_abs_u": u_max, "max_abs_sum_u": sum_max,
          "max_abs_soc": soc_max, "mean_spread": [spread0, spread],
          "step_ms_host_clock": {"median": float(np.median(step_ms[1:])),
                                 "max": float(np.max(step_ms[1:])),
                                 "first": step_ms[0]}})
    check(launched == SERVE_STEPS, f"Controller launched the kernel {launched}x")
    check(u_max <= 0.3 + 1e-2, f"|u| {u_max}")
    check(sum_max <= 1e-2, f"|sum u| {sum_max}")
    check(soc_max <= 0.5 + 1e-2, f"|SoC| {soc_max}")
    check(spread < spread0, f"SoC spread did not shrink: {spread0} -> {spread}")


def phase_near_limit(torch, tg, kernels, core):
    qp = tg.condense(tg.problems.battery(n_cells=5, horizon=20))
    data = tg.dualize(qp, ITERS, paired="auto", device=DEVICE)
    cfg = tg.SolverConfig()
    engine = core.resolve_engine(data, cfg)
    X0 = torch.as_tensor(np.random.default_rng(3).uniform(
        -0.4, 0.4, (1024, qp.n_x)).astype(np.float32), device=DEVICE)
    res = tg.solve_batch(data, X0, cfg)
    torch.cuda.synchronize()
    out = {"phase": "near_limit", "shape": [1024, data.n_z, data.m_half,
           data.n_struct], "engine": engine,
           "smem_bytes": kernels._smem_bytes(
               data.m_half, data.n_z, data.n_struct,
               kernels._pick_log2_tile(data.m_half, data.n_z, data.n_struct, 1024)),
           "residual_max": res.residual.max().item()}
    check(bool(torch.isfinite(res.u).all()), "near-limit u not finite")
    if engine == "cuda":
        g_P, p_D = core.affine_params(data, X0)
        out["max_abs_err"], _ = kernel_vs_plain(kernels, data, g_P, p_D)
        check(out["max_abs_err"] <= KERNEL_TOL, f"near-limit kernel {out}")
    emit(out)


def phase_timing(torch, tg, kernels, core, smi):
    from tpu_gpad_torch.utils import device_time_per_call

    qp = tg.condense(tg.problems.battery(**HEADLINE))
    data = tg.dualize(qp, ITERS, paired="auto", device=DEVICE)
    X0 = torch.as_tensor(np.random.default_rng(4).uniform(
        -0.4, 0.4, (BATCH, qp.n_x)).astype(np.float32), device=DEVICE)
    g_P, p_D = core.affine_params(data, X0)
    runs = {
        "kernel": lambda: kernels.gpad_fixed_paired_flat(
            data, g_P, p_D, iterations=ITERS),
        "plain": lambda: kernels.gpad_fixed_paired_flat_torch(
            data, g_P, p_D, iterations=ITERS),
        "solve_cuda": lambda: tg.solve_batch(data, X0, tg.SolverConfig()),
        "solve_torch": lambda: tg.solve_batch(
            data, X0, tg.SolverConfig(engine="torch", form="mvp")),
    }
    ms = {k: [] for k in runs}
    for order in (("plain", "kernel", "solve_torch", "solve_cuda"),
                  ("solve_cuda", "solve_torch", "kernel", "plain")):
        for k in order:
            ms[k].append(device_time_per_call(runs[k], warmup=3, repeats=20) * 1e3)
    med = {k: float(np.mean(v)) for k, v in ms.items()}
    emit({"phase": "timing", "gpu": smi, "batch": BATCH, "iterations": ITERS,
          "ms_median_of_20_per_turn": ms,
          "solves_per_s": {"cuda_engine": BATCH / med["solve_cuda"] * 1e3,
                           "torch_engine": BATCH / med["solve_torch"] * 1e3,
                           "kernel_only": BATCH / med["kernel"] * 1e3,
                           "plain_only": BATCH / med["plain"] * 1e3}})
    return med


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke FAILED: no CUDA device (torch.cuda."
                         "is_available() is False); nothing runs on the host")
    import tpu_gpad_torch as tg
    from tpu_gpad_torch.solver import core, kernels, reference

    smi, name = phase_device(torch)
    phase_build()
    worst = phase_kernel_vs_plain(torch, tg, kernels, core)
    kernels.PAIRED_FLAT_LAUNCHES = 0  # count the main path's launches only
    phase_main_path(torch, tg, kernels, core, reference)
    phase_serving(torch, tg, kernels)
    launches = kernels.PAIRED_FLAT_LAUNCHES
    check(launches == 1 + SERVE_STEPS, f"main path launched {launches}x")
    phase_near_limit(torch, tg, kernels, core)
    med = phase_timing(torch, tg, kernels, core, smi)
    emit({"kernels": [{
        "name": "gpad_paired_flat",
        "route": "cuda",
        "source": "tpu_gpad_torch/csrc/gpad_paired_flat.cu",
        "replaces": "tpu_gpad/solver/kernels.py:1493",
        "launches": launches,
        "max_abs_err": worst,
        "ms": med["kernel"],
        "plain_ms": med["plain"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
