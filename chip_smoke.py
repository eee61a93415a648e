#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``tpu_gpad_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``tpu_gpad_torch/csrc`` (one nvcc
per source, all at once), holds each against its plain torch version on
the card, drives the port's paths and checks, with the launch counters,
that each went through its kernel: the batched condensed solve at the
headline shape and a warm-started ``Controller`` serving a fleet of plants
(the flat kernel), the flagship example's restart serving loop (the dual
kernel), and ``solve_to_accuracy`` (the chunked dual kernel, one launch per
check window). It times kernels and plain versions with CUDA events and
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
# |kernel - plain| on u and z under restart: a restart decision near r = 0
# may differ and part the trajectories for a while; tpu_gpad's bound for
# its pallas-vs-xla restart parity (tests/test_restart.py)
RESTART_TOL = 5e-5
EPS_TOL = 1e-5  # solve_to_accuracy's tolerance
EPS_SLACK = 1e-6  # fp32 slack on the residual test
EPS_U_TOL = 2e-4  # |u| between engines that may stop one window apart
RESTART_ITERS = 60  # the flagship example's serving budget
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

    names = ["gpad_paired_flat", "gpad_dual"]
    cuda_build.load_all(names)  # both nvcc runs at once
    emit({"phase": "build",
          "build_s": {n: cuda_build.BUILD_SECONDS[n] for n in names},
          "ptxas": {n: [ln.strip() for ln in cuda_build.BUILD_LOG.get(n, "")
                        .splitlines() if "ptxas info" in ln] for n in names}})


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


def headline(tg):
    """The headline QP and its data on the card, 100-iteration schedule."""
    qp = tg.condense(tg.problems.battery(**HEADLINE))
    return qp, tg.dualize(qp, ITERS, paired="auto", device=DEVICE)


def reset_counters(kernels, dual_kernels):
    kernels.PAIRED_FLAT_LAUNCHES = 0
    dual_kernels.DUAL_LAUNCHES = dual_kernels.DUAL_CHUNK_LAUNCHES = 0
    dual_kernels.EPS_SYNCS = 0


def phase_dual_kernel_vs_plain(torch, tg, dual_kernels, core):
    _, data = headline(tg)
    rng = np.random.default_rng(5)
    X0 = torch.as_tensor(
        rng.uniform(-0.4, 0.4, (BATCH, data.n_x)).astype(np.float32), device=DEVICE)
    g_P, p_D = core.affine_params(data, X0)

    def run(d=data, B=BATCH, y0=None, restart=False, diagnostics=True):
        args = (d, g_P[:B].contiguous(), p_D[:B].contiguous(), y0)
        kw = dict(iterations=ITERS, restart=restart, diagnostics=diagnostics)
        out_k = dual_kernels.gpad_fixed_dual(*args, **kw)
        out_p = dual_kernels.gpad_fixed_dual_torch(*args, **kw)
        torch.cuda.synchronize()
        for t in out_k:
            if t is not None:
                check(bool(torch.isfinite(t).all()), "dual kernel output not finite")
        if not diagnostics:
            check(out_k[2] is None and out_k[3] is None,
                  "diagnostics=False returned w/zhat")
        y_err = (out_k[1] - out_p[1]).abs().max().item()
        if restart:  # u and z only (u is a slice of z)
            return max_err(out_k[:1], out_p[:1]), y_err, out_k
        return max_err(out_k, out_p), y_err, out_k

    cases, y_errs = {}, {}
    cases["cold"], y_errs["cold"], (_, y_cold, _, _) = run()
    soft = dataclasses.replace(data, soft_damp=torch.as_tensor(
        rng.uniform(0.0, 0.2, data.m_half).astype(np.float32), device=DEVICE))
    for name, kw in {
        "warm_per_scenario": dict(y0=y_cold),
        "warm_shared": dict(y0=y_cold[0].contiguous()),
        "no_diagnostics": dict(y0=y_cold, diagnostics=False),
        "soft": dict(d=soft),
        "B5": dict(B=5, y0=y_cold[:5].contiguous()),
        "B1": dict(B=1, y0=y_cold[:1].contiguous()),
        "restart_cold": dict(restart=True),
        "restart_warm": dict(restart=True, y0=y_cold),
    }.items():
        cases[name], y_errs[name], _ = run(**kw)
    plain = {k: v for k, v in cases.items() if not k.startswith("restart")}
    restart = {k: v for k, v in cases.items() if k.startswith("restart")}
    emit({"phase": "dual_kernel_vs_plain", "shape": [BATCH, data.m_half],
          "max_abs_err": cases, "max_abs_err_y": y_errs,
          "tol": KERNEL_TOL, "restart_tol_u_z": RESTART_TOL})
    check(max(plain.values()) <= KERNEL_TOL, f"dual kernel vs plain: {plain}")
    check(max(restart.values()) <= RESTART_TOL, f"restart u/z: {restart}")
    return max(max(plain.values()), max(restart.values()))


def phase_dual_chunk_vs_plain(torch, tg, dual_kernels, core):
    _, data = headline(tg)
    X0 = torch.as_tensor(np.random.default_rng(6).uniform(
        -0.4, 0.4, (BATCH, data.n_x)).astype(np.float32), device=DEVICE)
    g_P, p_D = core.affine_params(data, X0)
    c = dual_kernels.relu_offsets(data, g_P, p_D)
    zero = torch.zeros((BATCH, 2, data.m_half), device=DEVICE)
    s0 = torch.zeros((BATCH, data.m_half), device=DEVICE)
    mom0 = torch.ones((BATCH, 2), device=DEVICE)
    errs, y_errs = {}, {}
    for restart in (False, True):
        state = dual_kernels.gpad_dual_chunk_torch(
            data, c, zero, zero, s0, mom0, k0=0, chunk=30, restart=restart)[:4]
        out_k = dual_kernels.gpad_dual_chunk(data, c, *state, k0=30, chunk=10,
                                             restart=restart)
        out_p = dual_kernels.gpad_dual_chunk_torch(data, c, *state, k0=30,
                                                   chunk=10, restart=restart)
        torch.cuda.synchronize()
        for t in out_k:
            check(bool(torch.isfinite(t).all()), "chunk kernel output not finite")
        key = "restart" if restart else "plain"
        y_errs[key] = (out_k[0] - out_p[0]).abs().max().item()
        if restart:  # the recovered z, as for the whole-solve kernel
            errs[key] = ((out_k[2] - out_p[2]) @ data.MG_T).abs().max().item()
        else:
            errs[key] = max_err(out_k, out_p)
    # ten chunks of 10 against one 100-iteration launch, no restart
    state = (zero, zero, s0, mom0)
    for k0 in range(0, ITERS, 10):
        *state, w = dual_kernels.gpad_dual_chunk(data, c, *state, k0=k0, chunk=10)
    z_c = -(state[2] @ data.MG_T) - g_P
    z, y, w_f, _ = dual_kernels.gpad_fixed_dual(data, g_P, p_D, iterations=ITERS)
    torch.cuda.synchronize()
    errs["ten_chunks_vs_whole"] = max_err((z_c, state[0], w), (z, y, w_f))
    emit({"phase": "dual_chunk_vs_plain", "shape": [BATCH, data.m_half],
          "k0": 30, "chunk": 10, "max_abs_err": errs, "max_abs_err_y": y_errs,
          "tol": KERNEL_TOL, "restart_tol_z": RESTART_TOL})
    check(errs["plain"] <= KERNEL_TOL, f"chunk kernel vs plain {errs}")
    check(errs["restart"] <= RESTART_TOL, f"restart chunk z {errs}")
    check(errs["ten_chunks_vs_whole"] <= KERNEL_TOL, f"chunks vs whole {errs}")
    return max(errs["plain"], errs["restart"])


def phase_restart_serving(torch, tg, dual_kernels):
    """The flagship example's closed loop (examples/battery_balancing.py):
    60 restart iterations per sample, warm-started, on the card."""
    problem = tg.problems.battery(**HEADLINE)
    ctl = tg.Controller(problem, config=tg.SolverConfig(
        iterations=RESTART_ITERS, restart=True), device=DEVICE)
    A = np.asarray(problem.A, dtype=np.float32)
    Bm = np.asarray(problem.B, dtype=np.float32)
    x = np.random.default_rng(7).uniform(
        -0.4, 0.4, (SERVE_PLANTS, problem.n_x)).astype(np.float32)
    spread0 = float(np.mean(x.max(1) - x.min(1)))
    before = dual_kernels.DUAL_LAUNCHES
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
    launched = dual_kernels.DUAL_LAUNCHES - before
    emit({"phase": "restart_serving", "plants": SERVE_PLANTS,
          "steps": SERVE_STEPS, "iterations": RESTART_ITERS,
          "launches": launched, "max_abs_u": u_max, "max_abs_sum_u": sum_max,
          "max_abs_soc": soc_max, "mean_spread": [spread0, spread],
          "step_ms_host_clock": {"median": float(np.median(step_ms[1:])),
                                 "max": float(np.max(step_ms[1:])),
                                 "first": step_ms[0]}})
    check(launched == SERVE_STEPS, f"Controller launched the dual kernel {launched}x")
    check(u_max <= 0.3 + 1e-2, f"|u| {u_max}")
    check(sum_max <= 1e-2, f"|sum u| {sum_max}")
    check(soc_max <= 0.5 + 1e-2, f"|SoC| {soc_max}")
    check(spread < spread0, f"SoC spread did not shrink: {spread0} -> {spread}")


def phase_dual_forms(torch, tg, dual_kernels, core):
    """Fixed solves that ask for the dual form, or turn the flat block
    off, go through the dual kernel too."""
    _, data = headline(tg)
    X0 = torch.as_tensor(np.random.default_rng(10).uniform(
        -0.4, 0.4, (BATCH, data.n_x)).astype(np.float32), device=DEVICE)
    out = {"phase": "dual_forms", "batch": BATCH}
    for name, cfg in (("form_dual", tg.SolverConfig(form="dual")),
                      ("flat_off", tg.SolverConfig(flat="off"))):
        before = dual_kernels.DUAL_LAUNCHES
        res = tg.solve_batch(data, X0, cfg)
        torch.cuda.synchronize()
        launched = dual_kernels.DUAL_LAUNCHES - before
        plain = tg.solve_batch(data, X0, dataclasses.replace(cfg, engine="torch"))
        err = (res.u - plain.u).abs().max().item()
        out[name] = {"kernel": core.cuda_kernel(data, cfg), "launches": launched,
                     "u_vs_torch_engine": err}
        check(launched == 1, f"{name} launched the dual kernel {launched}x")
        check(bool(torch.isfinite(res.u).all()) and err < ORACLE_TOL,
              f"{name} u vs torch engine {err}")
    emit(out)


def phase_eps_path(torch, tg, dual_kernels, core, reference):
    qp, data = headline(tg)
    X0np = np.random.default_rng(8).uniform(
        -0.4, 0.4, (BATCH, qp.n_x)).astype(np.float32)
    X0 = torch.as_tensor(X0np, device=DEVICE)
    cfg = tg.SolverConfig(mode="eps", restart=True, iterations=2000)
    routing = core.resolve_engine(data, cfg)
    res = tg.solve_to_accuracy(data, X0, tol=EPS_TOL)
    torch.cuda.synchronize()
    launches, syncs = dual_kernels.DUAL_CHUNK_LAUNCHES, dual_kernels.EPS_SYNCS
    # windows of 10 up to the last scenario's convergence (or the budget)
    windows = -(-int(res.iterations.max()) // 10)
    for name in ("u", "z", "y", "residual", "gap"):
        check(bool(torch.isfinite(getattr(res, name)).all()), f"eps {name} not finite")
    oracle = [float(np.abs(res.u[i].cpu().numpy() - reference.gpad_solve_qp(
        qp, X0np[i].astype(np.float64), 300, restart=True).u).max())
        for i in range(4)]
    plain = tg.solve_to_accuracy(data, X0, tol=EPS_TOL, engine="torch")
    it_diff = (res.iterations - plain.iterations).abs().max().item()
    vs_torch = (res.u - plain.u).abs().max().item()
    emit({"phase": "eps_path", "routing": routing, "batch": BATCH,
          "tol": EPS_TOL, "iterations_max": int(res.iterations.max()),
          "iterations_torch_engine_max": int(plain.iterations.max()),
          "windows": windows, "host_syncs": syncs, "launches": launches,
          "converged_all": bool(res.converged.all()),
          "residual_max": res.residual.max().item(),
          "u_vs_oracle_restart_300": oracle, "iterations_vs_torch_engine": it_diff,
          "u_vs_torch_engine": vs_torch})
    check(routing == "cuda", f"eps routing {routing}")
    check(launches == windows > 0, f"chunk launches {launches} vs windows {windows}")
    check(bool(res.converged.all()), "not every scenario converged")
    check(res.residual.max().item() <= EPS_TOL + EPS_SLACK, "eps residual")
    check(max(oracle) < ORACLE_TOL, f"eps u vs oracle {oracle}")
    check(it_diff <= 10, f"iterations differ by {it_diff} from the torch engine")
    check(vs_torch < EPS_U_TOL, f"eps u vs torch engine {vs_torch}")
    return launches


def phase_dual_timing(torch, tg, dual_kernels, core, smi):
    from tpu_gpad_torch.utils import device_time_per_call

    _, data = headline(tg)
    X0 = torch.as_tensor(np.random.default_rng(9).uniform(
        -0.4, 0.4, (BATCH, data.n_x)).astype(np.float32), device=DEVICE)
    g_P, p_D = core.affine_params(data, X0)
    c = dual_kernels.relu_offsets(data, g_P, p_D)
    state = dual_kernels.gpad_dual_chunk_torch(
        data, c, torch.zeros((BATCH, 2, data.m_half), device=DEVICE),
        torch.zeros((BATCH, 2, data.m_half), device=DEVICE),
        torch.zeros((BATCH, data.m_half), device=DEVICE),
        torch.ones((BATCH, 2), device=DEVICE), k0=0, chunk=30, restart=True)[:4]
    chunk_kw = dict(k0=30, chunk=10, restart=True)
    runs = {
        "dual": lambda: dual_kernels.gpad_fixed_dual(
            data, g_P, p_D, iterations=ITERS, restart=True),
        "dual_plain": lambda: dual_kernels.gpad_fixed_dual_torch(
            data, g_P, p_D, iterations=ITERS, restart=True),
        "chunk": lambda: dual_kernels.gpad_dual_chunk(data, c, *state, **chunk_kw),
        "chunk_plain": lambda: dual_kernels.gpad_dual_chunk_torch(
            data, c, *state, **chunk_kw),
        "eps_auto": lambda: tg.solve_to_accuracy(data, X0, tol=EPS_TOL),
        "eps_torch": lambda: tg.solve_to_accuracy(data, X0, tol=EPS_TOL,
                                                  engine="torch"),
    }
    ms = {k: [] for k in runs}
    order = list(runs)
    for turn in (order, order[::-1]):
        for k in turn:
            ms[k].append(device_time_per_call(runs[k], warmup=3, repeats=20) * 1e3)
    med = {k: float(np.mean(v)) for k, v in ms.items()}
    emit({"phase": "dual_timing", "gpu": smi, "batch": BATCH,
          "iterations": ITERS, "chunk": 10,
          "ms_median_of_20_per_turn": ms,
          "note": "eps_* are CUDA-event times of whole solve_to_accuracy "
                  "calls, host syncs between windows included",
          "solves_per_s": {"dual_kernel_restart": BATCH / med["dual"] * 1e3,
                           "dual_plain_restart": BATCH / med["dual_plain"] * 1e3,
                           "eps_auto": BATCH / med["eps_auto"] * 1e3,
                           "eps_torch": BATCH / med["eps_torch"] * 1e3}})
    return med


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke FAILED: no CUDA device (torch.cuda."
                         "is_available() is False); nothing runs on the host")
    import tpu_gpad_torch as tg
    from tpu_gpad_torch.solver import core, dual_kernels, kernels, reference

    smi, name = phase_device(torch)
    phase_build()
    worst = phase_kernel_vs_plain(torch, tg, kernels, core)
    worst_dual = phase_dual_kernel_vs_plain(torch, tg, dual_kernels, core)
    worst_chunk = phase_dual_chunk_vs_plain(torch, tg, dual_kernels, core)
    # each path's launches are counted from 0, set just before it
    reset_counters(kernels, dual_kernels)
    phase_main_path(torch, tg, kernels, core, reference)
    phase_serving(torch, tg, kernels)
    launches = kernels.PAIRED_FLAT_LAUNCHES
    check(launches == 1 + SERVE_STEPS, f"main path launched {launches}x")
    reset_counters(kernels, dual_kernels)
    phase_restart_serving(torch, tg, dual_kernels)
    phase_dual_forms(torch, tg, dual_kernels, core)
    dual_launches = dual_kernels.DUAL_LAUNCHES
    check(dual_launches == SERVE_STEPS + 2, f"dual path launched {dual_launches}x")
    reset_counters(kernels, dual_kernels)
    chunk_launches = phase_eps_path(torch, tg, dual_kernels, core, reference)
    phase_near_limit(torch, tg, kernels, core)
    med = phase_timing(torch, tg, kernels, core, smi)
    dmed = phase_dual_timing(torch, tg, dual_kernels, core, smi)
    emit({"kernels": [{
        "name": "gpad_paired_flat",
        "route": "cuda",
        "source": "tpu_gpad_torch/csrc/gpad_paired_flat.cu",
        "replaces": "tpu_gpad/solver/kernels.py:1493",
        "launches": launches,
        "max_abs_err": worst,
        "ms": med["kernel"],
        "plain_ms": med["plain"],
    }, {
        "name": "gpad_dual",
        "route": "cuda",
        "source": "tpu_gpad_torch/csrc/gpad_dual.cu",
        "replaces": "tpu_gpad/solver/kernels.py:456",
        "launches": dual_launches,
        "max_abs_err": worst_dual,
        "ms": dmed["dual"],
        "plain_ms": dmed["dual_plain"],
    }, {
        "name": "gpad_dual_chunk",
        "route": "cuda",
        "source": "tpu_gpad_torch/csrc/gpad_dual.cu",
        "replaces": "tpu_gpad/solver/kernels.py:655",
        "launches": chunk_launches,
        "max_abs_err": worst_chunk,
        "ms": dmed["chunk"],
        "plain_ms": dmed["chunk_plain"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
