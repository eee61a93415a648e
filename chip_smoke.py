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
kernel), ``solve_to_accuracy`` (the chunked dual kernel, one launch per
check window), the reference's dense layout (the dense kernel): a dataset
written by ``export`` and solved by ``solve --dataset``, ``solve_multi``
over the reference's 28 plants, a dense ``Controller`` and a checkpointed
``run_sweep``; a paired mvp solve without the flat block (the full paired
kernel); the reference's 30x30 flagship (the tiled kernels): restart and
dual-form solves, a restart ``Controller``, ``solve_to_accuracy`` with the
flat block off, a forced flat solve, the default solve (the flat tiled
kernel too) and the CLI's ``closedloop`` and ``info``; the dense and full
paired loops past one block's shared memory (the tiled dense kernel and
the flat tiled kernel at n_s = m_h): ``auto`` on the dense n10 N20
layout, a dense ``Controller`` and ``solve_multi`` at n5 N20, a
``flat="off"`` solve at n10 N30 and the CLI's ``--paired off``; soft
(dual-damped) rows past shared memory, on battery n10 N30 and n5 N30
condensed on the card with a softened state box (``dualize_ltv_device``,
``soft_state``): the default, ``flat="off"``, restart and eps solves
through ``auto`` (the flat tiled kernel, the paired tiled route, the
tiled dual and chunk kernels), the flagship's forced soft routes, each
soft kernel against its plain version (every tier at n5 N30, a zero damp
against the hard launch bit for bit) and timed against its hard launch
and the torch engine; and the stage-wise O(N) engine at full width: ``auto_solver``
at battery n30 N200 B1024 (the streamed kernel) and n8 N60 B4096 and
B1024 (the resident kernel), a warm ``StagewiseController`` and the
long-horizon eps example (the torch engine); and the estimation and
robust stacks: a ``scenario_qp`` stack of three actuator realizations
served through ``Controller.from_qp`` (a fixed solve, warm restart steps
and ``solve_to_accuracy``: the flat, dual and chunk kernels), its
stage-wise twin (the resident and the streamed kernel), moving-horizon
estimation (a window of 180 on the tiled dual kernel, a stream at window
60 on the dual kernel, and a big-state window on the stage-wise torch
engine against a float64 host solve) and the offset-free controller (the
dual kernel); and the NMPC layer at tools/bench_nmpc_device.py's swing-up
(80 samples host-condensed, device-condensed and as one loop on the card,
a 64-plant ``plan_batch``: the dual kernel, its data condensed on the card
held against the plain version too), ``RobustNMPC`` at
tools/bench_robust_device.py's configuration (host and device), and a
short ``NMPC(engine="stagewise")`` leg (the resident stage-wise kernel;
its ``plan_batch`` on the torch engine), each leg's launches counted from
0; and implicit differentiation (``diff``): gradients through the flat and
the dual kernel at the headline against the torch engine's and the exact
QP's differences, Cholesky against CG, the weight-learning gradient
through ``dualize_ltv_device`` (the dual kernel), ``Controller.gain``, the
stage-wise gain (the resident kernel) against the condensed one and a VJP
at n30 N200 (the streamed kernel), then their times in turns; and the
sharded solves across processes (``tpu_gpad_torch.parallel`` through
``parallel.mp_worker``): one nccl rank at the headline, then two gloo
ranks sharing the card (DP fixed, restart, eps with the collective exit:
the flat paired, dual and chunk kernels; TP at the flagship and at an m
that 2 does not divide: the torch engine; 28 plants through
``solve_multi_sharded``: the dense kernel), with the sharded and
unsharded times in turns; and AOT export (``tpu_gpad_torch.aot``): every
kernel's route exported at a concrete batch and one symbolic artifact of
each solver, loaded in a fresh process, each loaded call launching the
live call's kernel as many times and equal to it; and the precision
tiers (``tiers_path``: on the torch engine each tier's u against fp32
"highest" at the headline and the flagship, the flagship's tiled route
refusing the tier, "highest" deaf to the caller's TF32 switch, each tier
shown to take effect at the flagship, the bf16 product fp32-accumulated;
on the flat, full paired, dual and chunk kernels at the headline and at
battery n5 N20, each route under each tier launching its kernel, its u
against "highest"'s, each tier shown to take effect, each kernel against
its plain version at the tier; a restart ``Controller`` and the CLI's
``solve`` under a tier) and the timing harness
(``timing_path``: ``interleaved_ab`` of the tiers and of ``auto`` against
the bare flat kernel op, ``matmul_peak_tflops`` of each tier, the headline
solve's ``device_time_stats`` and percentiles). It times kernels and
plain versions with CUDA events, computes each kernel's roofline bound
from its shapes, and prints one JSON object per phase. Any failed check exits
non-zero. The last line is ``{"ok": true, "device": {...}}``. It imports
neither jax nor ``tpu_gpad``. Without a CUDA device it exits non-zero and
prints no result.

    python3 chip_smoke.py --sweep [resident] [stagewise] [tiled]

builds the kernels and times, instead, the resident dense, dual, chunk,
flat and full paired kernels by tile and split-K parts at B 256 and 4096
(``resident``, or any of ``dense``, ``dual``, ``chunk``, ``flat``,
``paired`` alone), the stage-wise kernels by launch (the resident one by
tile x warps per block, hence chain segments, x the chains' placement;
the streamed one by tile) and the tiled kernels by tile and cluster size,
or the families named;

    python3 chip_smoke.py --times [resident] [stagewise] [tiers] [routes]

times the resident dense, dual, chunk and flat kernels at B 256 and 4096,
the full paired kernel at B4096, the flat tiled kernel and the default
fixed solve (flat tiled kernel against torch engine) at the flagship and
at n5 N30, and a warm flat, dense and restart ``Controller``
(``resident``); the resident stage-wise kernel at n8 N60 B1024 and B4096
and the streamed one at n30 N200 B1024 (``stagewise``); the flat, full
paired, dual and chunk kernels at each precision tier in turns with
"highest" at B 256 and 4096 (``tiers``); all three by default; and the
tiled dense and paired tiled routes against the torch engine over the
shapes past the resident kernels' shared memory, on to the flagship, and
the soft routes (flat tiled, paired tiled, tiled dual under restart) at
n5 N30, n10 N30 and the flagship at B 256, 1024 and 4096 against their
hard launch and the torch engine (``routes``: the measurement behind
``auto``'s edges).
Through public arguments only, so that a checkout of an earlier design
can be timed beside this one: copy this script into its root and run it
there;

    python3 chip_smoke.py --profile

builds the stage-wise kernels with cycle counters and prints where a
streamed solve spends its time by phase and a resident one by part.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import re
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
# the dense (unpaired) layout: battery n3 N10 (m 140) and n3 N20 (m 280,
# 134 KB of operands, near the shared-memory guard); the reference's 28
# inputs_manysets plants; a sweep of 4 chunks
DENSE_NEAR = dict(n_cells=3, horizon=20)
MULTI_PLANTS, MULTI_BATCH = 28, 256
SWEEP_BATCH, SWEEP_CHUNK = 16384, 4096
# The stage-wise engine at full width: battery n30 N200 (60 state and 62
# input rows per stage) routes to the streamed kernel; n8 N60, stage-wise
# at B >= 24 N, to the resident one at B4096 and at B1024; the eps leg is
# examples/long_horizon_stagewise.py's call, battery n30 N400.
SW_FULL, SW_FULL_BATCH, SW_FULL_ITERS = (30, 200), 1024, 200
SW_RES, SW_RES_BATCH, SW_RES_ITERS = (8, 60), 4096, 100
SW_CMP_BATCH = 64  # the streamed kernel against its plain version
SW_SMALL_BATCH = 256  # n8 N60 short of one wave: sweeps, torch executors
# the sweep's shapes beside n8 N60, which the resident kernel's routing
# weighs: a long horizon (two scenarios' chains still staged a block) and a
# wide state (the chains read from device memory)
SW_SWEEP_SHAPES = ((8, 200), (24, 60))
# Under restart, the share of scenarios (at least one) whose kernel run may
# part from the plain version's by a flipped restart decision (the plain
# version in float32 parts from its float64 run in the same way; the phase
# reports both counts)
SW_RESTART_PARTED_SHARE = 0.01
SW_SERVE_PLANTS, SW_SERVE_STEPS, SW_SERVE_ITERS = 64, 20, 100
SW_EPS = (30, 400)
SW_WAVE_BATCH = 1024  # n8 N60: one wave of resident blocks on 132 SMs
SW_SERVE_SETTLE = 10  # warm steps before the moves are held to the limits
SW_LIMIT_TOL = 1e-2  # settled moves: |u| <= 0.3 + tol, |sum u| <= tol
SW_RESIDUAL_TOL = 1e-4  # a plan's excess over the limits beyond its residual
# The reference's 30x30 flagship (battery n30 N30: n_z 900, m_h 1830,
# n_struct 930; D 13.4 MB) at AB_FLAGSHIP.json's batch, and battery n5 N30
# (m_h 330), just past the resident dual kernels' shared-memory guard
FLAGSHIP = dict(n_cells=30, horizon=30)
FLAG_BATCH = 256
TILED_MID = dict(n_cells=5, horizon=30)
FLAG_SERVE_STEPS, FLAG_SERVE_SETTLE = 20, 5
FLAG_EPS_TOL = 1e-4
FLAG_CLI_STEPS = 5
# The dense and full paired loops past one block's shared memory (the tiled
# dense kernel; the flat tiled kernel at n_s = m_h): battery n5 N20 (dense
# m 440, n_z 100, past the resident dense kernel's m 280), n10 N20 (m 840)
# and the flagship's dense layout (m 3660); battery n5 N30 (m_h 330, past
# the resident paired kernel's 220) and n10 N30 (m_h 630), all at B256; a
# dense Controller, solve_multi over a few plants
DENSE_MID = dict(n_cells=5, horizon=20)
DENSE_WIDE = dict(n_cells=10, horizon=20)
PAIRED_WIDE = dict(n_cells=10, horizon=30)
ROUTE_BATCH = 256
ROUTE_SERVE_STEPS, ROUTE_PLANTS = 10, 4
ROUTE_EDGE_BATCH = 16384  # past auto's flat tiled work edge at n10 N30
# the tiled dense kernel beside its plain version at the flagship's dense
# layout: a batch past one scenario tile of 128 that fills none, and one
# scenario (each at every tier too)
ROUTE_RAGGED_BATCH = 130
# --times routes: the tiled routes against the torch engine over the gap
# between the resident kernels' guards and tpu_gpad's VMEM guards, and the
# dense layout on to the flagship, where auto's edge lies (battery n, N)
ROUTE_GAP = ((5, 20), (3, 50), (5, 30), (10, 20), (5, 50), (10, 30))
ROUTE_DENSE_EDGE = ((15, 30), (20, 30), (25, 30), (30, 30))
ROUTE_PAIRED_EDGE = ((15, 30), (20, 30), (30, 30))
# ... at each of these batches (one solve, serving fleets, the sweep's
# chunk and past it): a batch's shapes in order of rows, cut after the
# kernel lost at ROUTE_LOSSES_TO_STOP in a row
ROUTE_BATCHES = (1, 64, 256, 1024, 4096, 16384)
ROUTE_LOSSES_TO_STOP = 2
# soft (dual-damped) rows past shared memory: the battery condensed on the
# card with its state box softened (dualize_ltv_device, soft_state), at n5
# N30, n10 N30 and the flagship, B256; the kernels' checks on a seeded
# damp in [0, SOFT_SEEDED_DAMP] (od in [0.5, 1]); p = [x0; 0], x0 within
# SOFT_X0_SPREAD of the reference's default_x0 and SOFT_X0_MAX of 0, so
# some cells start past the 0.5 state box and the soft rows hold active
# duals (about 10 at most: the duals, and fp32's spread, grow with x0)
SOFT_SHAPES = (TILED_MID, PAIRED_WIDE, FLAGSHIP)
SOFT_STATE, SOFT_SEEDED_DAMP = 1e3, 0.5
SOFT_SCHEDULE = 400  # the eps legs' budget; the fixed ones run ITERS
SOFT_X0_SPREAD, SOFT_X0_MAX = 0.5, 0.6
SOFT_ROUTE_BATCHES = (256, 1024, 4096)  # --times routes' soft points
# The robust stack: three actuator realizations (B x 0.8, 1.0, 1.2) of
# battery n3 N10 as one scenario_qp stack served to the 256 plants, its
# stage-wise twin at n3 N10 and n8 N60 (B256 x 200), converged at 2000
ROBUST = (3, 10)
ROBUST_SCALES = (0.8, 1.0, 1.2)
ROBUST_STEPS = 20
ROBUST_TWIN_ITERS, ROBUST_TWIN_CONVERGED = 200, 2000
ROBUST_TWIN_TOL = 1e-3  # converged first moves, twin against condensed
# MHE: the double integrator (dt 0.1) over MHE_STAGEWISE.json's window of
# 180 on 256 streams x 400 restart iterations, with state and disturbance
# boxes; a stream at window 60; tools/bench_mhe_stagewise.py's big-state
# plant past the 256 MB backstop (the stage-wise engine)
MHE_WINDOW, MHE_BATCH, MHE_ITERS = 180, 256, 400
MHE_KW = dict(W=np.diag([1e-4, 4e-3]), V=np.array([[1e-2]]),
              x_min=np.array([-1.2, -0.8]), x_max=np.array([1.2, 0.8]),
              w_min=np.full(2, -0.05), w_max=np.full(2, 0.05))
MHE_STREAM_WINDOW, MHE_STREAM_UPDATES = 60, 30
MHE_BIG = dict(n_x=30, n_u=8, n_y=15, window=120, batch=64, iterations=200)
MHE_REF_WINDOWS = 8
MHE_TOL = 1e-4  # |x_hat - reference| relative to the reference's scale
# examples/offset_free_mpc.py: bias 0.08, setpoint 1.5, 120 steps
OFFSET_STEPS, OFFSET_ITERS, OFFSET_BIAS, OFFSET_R, OFFSET_TOL = (
    120, 80, 0.08, 1.5, 1e-3)
# NMPC: tools/bench_nmpc_device.py's pendulum swing-up (rk4, dt 0.05,
# horizon 25, 200 restart iterations, 2 SQP passes a sample) for 80 samples
# on each leg, and one planning pass over a fleet of 64 plants
NMPC_KW = dict(n_x=2, n_u=1, horizon=25, Q=np.diag([10.0, 1.0]),
               R=np.diag([0.1]), u_min=np.array([-11.0]),
               u_max=np.array([11.0]), iterations=200, sqp_iters=2)
NMPC_X0 = np.array([2.07, 0.0], dtype=np.float32)
NMPC_SAMPLES, NMPC_FLEET = 80, 64
NMPC_SETTLE = 0.05  # |theta - pi| at the last sample: the tool's gate
NMPC_TRAJ_TOL = 5e-2  # legs' trajectories and the fleet's first moves
# a short stage-wise leg: the swing-up with tools/bench_robust_device.py's
# state box (the stage-wise kernels need state rows), 10 samples, and a
# plan_batch over 8 plants (each pass builds every plant's constants on the
# host, about 0.3 s a build)
NMPC_SW_SAMPLES, NMPC_SW_FLEET = 10, 8
NMPC_BOX = dict(x_min=np.array([-10.0, -12.0]), x_max=np.array([10.0, 12.0]))
# tools/bench_robust_device.py: three gravities, horizon 12, state boxes,
# 150 restart iterations, 60 samples against the g = 10.8 plant
ROBUST_NMPC_GS = (8.8, 9.81, 10.8)
ROBUST_NMPC_KW = dict(n_x=2, n_u=1, horizon=12, Q=np.diag([10.0, 1.0]),
                      R=0.1 * np.eye(1), u_min=np.array([-11.0]),
                      u_max=np.array([11.0]), iterations=150, sqp_iters=1,
                      **NMPC_BOX)
ROBUST_NMPC_X0 = np.array([2.2, 0.0], dtype=np.float32)
ROBUST_NMPC_SAMPLES = 60
# Implicit differentiation (diff_path): gradients of 0.5 |u*|^2 through
# make_differentiable_solver at the headline, fixed (the flat kernel) and
# under restart (the dual kernel), held against the same function on the
# torch engine within DIFF_GRAD_RTOL of the gradients' scale; DIFF_FD
# scenarios of the restart leg against central differences of the float64
# exact QP (tests/test_diff.py's bound); sensitivity by "chol" and "cg"
# on one dual, element by element (tests/test_diff.py's bound; CG exits at
# a 1e-5 residual reduction, and the batch's slowest scenario sets how many
# iterations all take)
DIFF_GRAD_RTOL = 1e-4
DIFF_FD, DIFF_FD_TOL, DIFF_FD_H = 8, 2e-3, 1e-5
DIFF_CG_RTOL, DIFF_CG_ATOL = 1e-4, 1e-5
# tests/test_diff_data.py's weight-learning composition: Q.grad through
# dualize_ltv_device against central differences
DIFF_Q_H, DIFF_Q_ABS, DIFF_Q_REL = 1e-3, 2e-3, 2e-2
# the stage-wise adjoint: the gain at n8 N60 B64 (the resident kernel),
# held at n3 N10 against the condensed sensitivity
# (tests/test_diff_stagewise.py's 5e-4), and one directional VJP at n30
# N200 B8 (the streamed kernel) against directional differences of the
# forward
DIFF_SW_ITERS, DIFF_SW_TOL = 400, 5e-4
DIFF_SW_RES, DIFF_SW_RES_BATCH = (8, 60), 64
# its states: uniform in +-0.1. From +-0.3 up, some scenarios' active sets
# hold more rows than the 480 inputs (up to 559 at +-0.4: every input of a
# stage on its box and the coupling row), the masked system is singular,
# and the adjoint's CG runs to its cap without converging (NaN), in the
# JAX package's algorithm as in the port's (PERF.md section 6, PR 13)
DIFF_SW_X0 = 0.1
DIFF_SW_CMP, DIFF_SW_CMP_BATCH = (3, 10), 8
DIFF_SW_STREAM, DIFF_SW_STREAM_BATCH, DIFF_SW_STREAM_ITERS = (30, 200), 8, 600
# the VJP's direction differences per scenario at two steps; within
# tests/test_diff_stagewise.py's 10% of max(0.5, |difference|) where smooth,
# and at least DIFF_SW_SMOOTH_MIN of the 8 scenarios smooth
DIFF_SW_FD_H, DIFF_SW_FD_REL, DIFF_SW_SMOOTH_MIN = (0.001, 0.002), 0.1, 6
# DIFF_BENCH.json's two configurations (100 restart iterations, fp32),
# timed with the headline's fixed solve; rounds of the timing in turns
DIFF_BENCH_CASES = (((3, 10), 4096), ((3, 50), 1024))
DIFF_ROUNDS = 5
# the backward's Cholesky against CG by m_h (battery n3 at these horizons)
DIFF_CROSS_HORIZONS, DIFF_CROSS_BATCHES = (10, 20, 30, 40, 50), (1024, 4096)
# H100 SXM peaks (NVIDIA's data sheet, 700 W): float32 outside the tensor
# cores, and HBM bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# the products' peak by precision tier: fp32 FFMA, TF32 and bf16 on the
# tensor cores (dense); "high" is three TF32 products
TIER_PEAK_FLOPS = {"highest": PEAK_FP32_FLOPS, "high": 495e12 / 3,
                   "default": 495e12, "bfloat16": 989e12}


def bound(flops: float, nbytes: float, tier: str = "highest") -> dict:
    """The least time the card could take: the larger of the operations
    over the tier's peak (fp32 for "highest") and the bytes (each input
    read once, each output written once) over the HBM rate."""
    t_ops = flops / TIER_PEAK_FLOPS[tier]
    t_bytes = nbytes / PEAK_HBM_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def max_err(a, b) -> float:
    """Max |a - b| over matching outputs (None pairs skipped)."""
    errs = [(x - y).abs().max().item() for x, y in zip(a, b) if x is not None]
    return max(errs)


def kernel_vs_plain(kernels, data, g_P, p_D, y0=None, diagnostics=True,
                    kernel="paired_flat"):
    """Run a whole-solve kernel of ``solver/kernels.py`` ("paired_flat",
    "paired" or "dense") and its plain version on the same CUDA tensors."""
    import torch

    kw = dict(iterations=ITERS, diagnostics=diagnostics)
    out_k = getattr(kernels, f"gpad_fixed_{kernel}")(data, g_P, p_D, y0, **kw)
    out_p = getattr(kernels, f"gpad_fixed_{kernel}_torch")(data, g_P, p_D, y0, **kw)
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


def instance_spills(log: str) -> dict:
    """ptxas's stack-frame and spill line of each kernel instance that
    keeps a frame or spills anything, keyed "name<T,NMAX>" (the tiled
    kernels' soft-row instances "name<T,tier,soft>"; or the mangled name
    where it has no such arguments)."""
    out, fn = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            fn = ln.rsplit(" ", 1)[-1]
            m = re.search(r"(gpad_[a-z_]+?_kernel)ILi(\d+)ELi(\d+)E(Lb1E)?",
                          fn)
            fn = (f"{m[1]}<{m[2]},{m[3]}{',soft' if m[4] else ''}>" if m
                  else fn)
        elif "bytes stack frame" in ln and any(
                int(v) for v in re.findall(r"(\d+) bytes", ln)):
            out[fn] = ln.strip()
    return out


# The most stack frame and spill stores (bytes; None: not checked) an
# instance may keep, by pattern over "source.cu: instance"; an instance no
# pattern names is not checked. The register-tiled kernels keep their
# tiles in registers: no spill. The resident stage-wise kernel at NMAX 8
# and 16 (n_x, n_u <= 16; n8 N60 runs <8,8>) keeps a frame of at most 32
# bytes (8-32 in the build timed in PERF.md section 6; an earlier build's
# 96-byte frame cost a third of its time). Not checked: its instances at
# NMAX 32 (200-488 bytes: a chain lane's two 32-wide matrix rows; n >= 17,
# which routes to the streamed kernel unless forced), the streamed
# kernel's (8-16 bytes, as its PR 6 design's) and the tiled dual kernels'
# at "highest" (8-16 bytes). The tiled kernels' tier instances ("<T,tier>",
# tier 1-3) keep at most 16 bytes of frame and of spill stores (8 in the
# build timed in PERF.md section 6; a strip of four tiles and the flat
# kernel's epilogue inlined at each fragment element spilled 40-192; the
# flat and dense body of csrc/tiled_mvp.cuh, its arguments in a struct,
# 80-88 at <16,1>), their soft-row instances ("<T,tier,soft>") too (the
# damp column in the epilogue of the hard instances kept 24-88 at <1,1-3>
# flat and <16,1> dual; instances of their own keep the hard frames).
SPILL_LIMITS = ((r"gpad_(dense|dual|paired_flat)\.cu", None, 0),
                (r"gpad_stagewise_resident_kernel<\d+,(8|16)>", 32, None),
                (r"gpad_(dual|flat|dense)_tiled\.cu: "
                 r"gpad_[a-z_]+_kernel<\d+,[123](,soft)?>", 16, 16))


def spills_past_limits(spills: dict) -> dict:
    """The lines of ``{source: instance_spills(...)}`` past SPILL_LIMITS."""
    bad = {}
    for name, lines in spills.items():
        for fn, ln in lines.items():
            frame, stores = (int(v) for v in re.findall(r"(\d+) bytes", ln)[:2])
            for pat, most_frame, most_stores in SPILL_LIMITS:
                if re.search(pat, f"{name}.cu: {fn}") and (
                        (most_frame is not None and frame > most_frame)
                        or (most_stores is not None and stores > most_stores)):
                    bad[f"{name}: {fn}"] = ln
    return bad


def phase_build():
    from tpu_gpad_torch import cuda_build

    names = ["gpad_paired_flat", "gpad_dense", "gpad_dual", "gpad_stagewise",
             "gpad_dual_tiled", "gpad_flat_tiled", "gpad_dense_tiled"]
    cuda_build.load_all(names)  # every nvcc run at once
    logs = {n: cuda_build.BUILD_LOG.get(n, "").splitlines() for n in names}
    spills = {n: instance_spills(cuda_build.BUILD_LOG.get(n, ""))
              for n in names}
    emit({"phase": "build",
          "build_s": {n: cuda_build.BUILD_SECONDS[n] for n in names},
          "ptxas": {n: [ln.strip() for ln in log if "ptxas info" in ln]
                    for n, log in logs.items()},
          "spills": {n: v for n, v in spills.items() if v}})
    bad = spills_past_limits(spills)
    check(not bad, f"a kernel instance spills past its limit: {bad}")


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
    # the serving batch (its own plan), a partial last tile, a few, one
    for B in (SERVE_PLANTS, 300, 5, 1):
        cases[f"B{B}"], _ = kernel_vs_plain(
            kernels, data, g_P[:B].contiguous(), p_D[:B].contiguous(),
            y_cold[:B].contiguous())
    B = SERVE_PLANTS
    cases[f"soft_B{B}"], _ = kernel_vs_plain(
        kernels, soft, g_P[:B].contiguous(), p_D[:B].contiguous(),
        y_cold[:B].contiguous())
    worst = max(cases.values())
    emit({"phase": "kernel_vs_plain", "shape": [BATCH, data.n_z, data.m_half,
          data.n_struct], "plans": {
              B: kernels._paired_plan(data.m_half, data.n_z, data.n_struct, B)
              for B in (BATCH, SERVE_PLANTS, 300, 5, 1)},
          "max_abs_err": cases, "max_abs_y": y_cold.abs().max().item(),
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


def phase_serving(torch, tg, kernels, paired="auto", counter="PAIRED_FLAT_LAUNCHES",
                  phase="serving"):
    """A warm ``Controller`` serving 256 plants for 50 steps, one launch of
    the kernel behind ``counter`` per step; the limits checked."""
    problem = tg.problems.battery(**HEADLINE)
    ctl = tg.Controller(problem, iterations=ITERS, paired=paired, device=DEVICE)
    A = np.asarray(problem.A, dtype=np.float32)
    Bm = np.asarray(problem.B, dtype=np.float32)
    x = np.random.default_rng(2).uniform(
        -0.4, 0.4, (SERVE_PLANTS, problem.n_x)).astype(np.float32)
    spread0 = float(np.mean(x.max(1) - x.min(1)))
    before = getattr(kernels, counter)
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
    launched = getattr(kernels, counter) - before
    emit({"phase": phase, "plants": SERVE_PLANTS, "steps": SERVE_STEPS,
          "launches": launched, "max_abs_u": u_max, "max_abs_sum_u": sum_max,
          "max_abs_soc": soc_max, "mean_spread": [spread0, spread],
          "step_ms_host_clock": {"median": float(np.median(step_ms[1:])),
                                 "max": float(np.max(step_ms[1:])),
                                 "first": step_ms[0]}})
    check(launched == SERVE_STEPS, f"{phase}: Controller launched {launched}x")
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
           "residual_max": res.residual.max().item()}
    check(bool(torch.isfinite(res.u).all()), "near-limit u not finite")
    if engine == "cuda":
        g_P, p_D = core.affine_params(data, X0)
        out["plans"], out["smem_bytes"], out["max_abs_err"] = {}, {}, {}
        for B in (1024, SERVE_PLANTS, 1):
            plan = kernels._paired_plan(data.m_half, data.n_z, data.n_struct, B)
            out["plans"][B] = plan
            out["smem_bytes"][B] = kernels._paired_smem_bytes(
                data.m_half, data.n_z, data.n_struct, plan)
            out["max_abs_err"][B], _ = kernel_vs_plain(
                kernels, data, g_P[:B].contiguous(), p_D[:B].contiguous())
        check(max(out["max_abs_err"].values()) <= KERNEL_TOL,
              f"near-limit kernel {out}")
    emit(out)


def phase_timing(torch, tg, kernels, dual_kernels, core, smi):
    """CUDA events, median of 20 calls per turn, two turns in opposite
    orders: the flat kernel at the serving batch (256) and at B4096 x 100,
    its plain version, and the solves through ``auto`` and the torch
    engine at B4096; then the kernel's device time from the profiler."""
    from tpu_gpad_torch.utils import device_time_per_call

    qp = tg.condense(tg.problems.battery(**HEADLINE))
    data = tg.dualize(qp, ITERS, paired="auto", device=DEVICE)
    X0 = torch.as_tensor(np.random.default_rng(4).uniform(
        -0.4, 0.4, (BATCH, qp.n_x)).astype(np.float32), device=DEVICE)
    runs, bounds = {}, {}
    for B in RESIDENT_BATCHES:
        r, b = resident_runs(torch, tg, kernels, dual_kernels, core, B,
                             seed=4, which=("flat",))
        runs.update(r)
        bounds.update(b)
    runs.update({
        "solve_cuda": lambda: tg.solve_batch(data, X0, tg.SolverConfig()),
        "solve_torch": lambda: tg.solve_batch(
            data, X0, tg.SolverConfig(engine="torch", form="mvp")),
    })
    ms = {k: [] for k in runs}
    order = list(runs)
    for turn in (order, order[::-1]):
        for k in turn:
            ms[k].append(device_time_per_call(runs[k], warmup=3, repeats=20) * 1e3)
    med = {k: float(np.mean(v)) for k, v in ms.items()}
    med["device"] = {k: profiled_ms(torch, runs[k], KERNEL_NAMES["flat"])
                     for k in runs if k.startswith("flat@")}
    med["bounds"] = bounds
    emit({"phase": "timing", "gpu": smi, "batches": RESIDENT_BATCHES,
          "iterations": ITERS,
          "plans": {B: kernels._paired_plan(data.m_half, data.n_z,
                                            data.n_struct, B)
                    for B in RESIDENT_BATCHES},
          "kernel_bounds": bounds, "ms_median_of_20_per_turn": ms,
          "device_ms_profiler": med["device"],
          "solves_per_s": {"cuda_engine": BATCH / med["solve_cuda"] * 1e3,
                           "torch_engine": BATCH / med["solve_torch"] * 1e3,
                           "kernel_only": BATCH / kernel_ms(med, "flat") * 1e3,
                           "plain_only": BATCH / med[f"flat_plain@{BATCH}"]
                           * 1e3}})
    return med


def headline(tg, shape=HEADLINE):
    """The headline QP (or a battery ``shape``'s) and its data on the card,
    100-iteration schedule."""
    qp = tg.condense(tg.problems.battery(**shape))
    return qp, tg.dualize(qp, ITERS, paired="auto", device=DEVICE)


def reset_counters(kernels, dual_kernels, sk, ss):
    kernels.PAIRED_FLAT_LAUNCHES = 0
    kernels.PAIRED_LAUNCHES = kernels.DENSE_LAUNCHES = 0
    kernels.FLAT_TILED_LAUNCHES = kernels.PAIRED_TILED_LAUNCHES = 0
    kernels.DENSE_TILED_LAUNCHES = 0
    dual_kernels.DUAL_LAUNCHES = dual_kernels.DUAL_CHUNK_LAUNCHES = 0
    dual_kernels.DUAL_TILED_LAUNCHES = dual_kernels.DUAL_TILED_CHUNK_LAUNCHES = 0
    dual_kernels.EPS_SYNCS = 0
    sk.STAGEWISE_LAUNCHES = ss.STAGEWISE_STREAM_LAUNCHES = 0


def launch_counts(kernels, dual_kernels, sk, ss) -> dict:
    """Every kernel's launches since the last ``reset_counters``, those
    that launched only."""
    counts = {
        "gpad_paired_flat": kernels.PAIRED_FLAT_LAUNCHES,
        "gpad_paired": kernels.PAIRED_LAUNCHES,
        "gpad_dense": kernels.DENSE_LAUNCHES,
        "gpad_flat_tiled": kernels.FLAT_TILED_LAUNCHES,
        # the flat tiled kernel at n_s = m_h: the full paired loop
        "gpad_paired_tiled": kernels.PAIRED_TILED_LAUNCHES,
        "gpad_dense_tiled": kernels.DENSE_TILED_LAUNCHES,
        "gpad_dual": dual_kernels.DUAL_LAUNCHES,
        "gpad_dual_chunk": dual_kernels.DUAL_CHUNK_LAUNCHES,
        "gpad_dual_tiled": dual_kernels.DUAL_TILED_LAUNCHES,
        "gpad_dual_tiled_chunk": dual_kernels.DUAL_TILED_CHUNK_LAUNCHES,
        "gpad_stagewise_resident": sk.STAGEWISE_LAUNCHES,
        "gpad_stagewise_stream": ss.STAGEWISE_STREAM_LAUNCHES,
    }
    return {k: v for k, v in counts.items() if v}


def counted(torch, ctr, fn, want, what):
    """Run ``fn`` with every launch count at 0 and return (its result, the
    launches it made); ``want`` is the launches it must make, or a function
    of the result that gives them. ``ctr`` = (kernels, dual_kernels, sk,
    ss)."""
    reset_counters(*ctr)
    res = fn()
    torch.cuda.synchronize()
    got = launch_counts(*ctr)
    want = want(res) if callable(want) else want
    check(got == want, f"{what}: launches {got}, expected {want}")
    return res, got


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
            return max_err(out_k[:1], out_p[:1]), y_err, out_k, out_p
        return max_err(out_k, out_p), y_err, out_k, out_p

    cases, y_errs = {}, {}
    cases["cold"], y_errs["cold"], (_, y_cold, _, _), _ = run()
    soft = dataclasses.replace(data, soft_damp=torch.as_tensor(
        rng.uniform(0.0, 0.2, data.m_half).astype(np.float32), device=DEVICE))
    for name, kw in {
        "warm_per_scenario": dict(y0=y_cold),
        "warm_shared": dict(y0=y_cold[0].contiguous()),
        "no_diagnostics": dict(y0=y_cold, diagnostics=False),
        "soft": dict(d=soft),
        "B256": dict(B=SERVE_PLANTS, y0=y_cold[:SERVE_PLANTS].contiguous()),
        "B5": dict(B=5, y0=y_cold[:5].contiguous()),
        "B1": dict(B=1, y0=y_cold[:1].contiguous()),
        "restart_cold": dict(restart=True),
        "restart_warm": dict(restart=True, y0=y_cold),
    }.items():
        cases[name], y_errs[name], _, _ = run(**kw)
    # the serving batch's tile with soft rows under restart, held per
    # scenario: at most 1% may part by a flipped restart decision
    B = SERVE_PLANTS
    _, y_errs["restart_B256_soft"], (z_k, *_), (z_p, *_) = run(
        restart=True, B=B, d=soft)
    parting = restart_parting(torch, soft, g_P[:B].contiguous(),
                              p_D[:B].contiguous(), None, z_k, z_p)
    cases["restart_B256_soft"] = parting["u_z"]
    plain = {k: v for k, v in cases.items() if not k.startswith("restart")}
    restart = {k: v for k, v in cases.items() if k.startswith("restart")}
    emit({"phase": "dual_kernel_vs_plain", "shape": [BATCH, data.m_half],
          "max_abs_err": cases, "max_abs_err_y": y_errs,
          "restart_B256_soft_parting": parting,
          "tol": KERNEL_TOL, "restart_tol_u_z": RESTART_TOL})
    check(parting["parted"] <= parting["parted_max"],
          f"restart parted {parting}")
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
    # B4096, the serving batch, a ragged few
    for B, restart in itertools.product((BATCH, SERVE_PLANTS, 5),
                                        (False, True)):
        cut = [t[:B].contiguous() for t in (c, zero, s0, mom0)]
        state = dual_kernels.gpad_dual_chunk_torch(
            data, cut[0], cut[1], cut[1], *cut[2:], k0=0, chunk=30,
            restart=restart)[:4]
        out_k = dual_kernels.gpad_dual_chunk(data, cut[0], *state, k0=30,
                                             chunk=10, restart=restart)
        out_p = dual_kernels.gpad_dual_chunk_torch(data, cut[0], *state, k0=30,
                                                   chunk=10, restart=restart)
        torch.cuda.synchronize()
        for t in out_k:
            check(bool(torch.isfinite(t).all()), "chunk kernel output not finite")
        key = ("restart" if restart else "plain") + (
            "" if B == BATCH else f"_B{B}")
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
    plain = [v for k, v in errs.items() if k.startswith("plain")]
    restart = [v for k, v in errs.items() if k.startswith("restart")]
    check(max(plain) <= KERNEL_TOL, f"chunk kernel vs plain {errs}")
    check(max(restart) <= RESTART_TOL, f"restart chunk z {errs}")
    check(errs["ten_chunks_vs_whole"] <= KERNEL_TOL, f"chunks vs whole {errs}")
    return max(plain + restart)


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


def phase_dual_timing(torch, tg, kernels, dual_kernels, core, smi):
    """CUDA events, median of 20 calls per turn, two turns in opposite
    orders: the dual kernel (100 restart iterations) and the chunk kernel
    (one 10-iteration restart window) at the serving batch (256) and at
    B4096, their plain versions, ``solve_to_accuracy`` and the torch
    engine's restart solve and 10-iteration restart solve at B4096; then
    the kernels' device time from the profiler."""
    from tpu_gpad_torch.utils import device_time_per_call

    _, data = headline(tg)
    X0 = torch.as_tensor(np.random.default_rng(9).uniform(
        -0.4, 0.4, (BATCH, data.n_x)).astype(np.float32), device=DEVICE)
    runs, bounds = {}, {}
    for B in RESIDENT_BATCHES:
        r, b = resident_runs(torch, tg, kernels, dual_kernels, core, B,
                             seed=9, which=("dual", "chunk"))
        runs.update(r)
        bounds.update(b)
    S = tg.SolverConfig
    runs.update({
        "eps_auto": lambda: tg.solve_to_accuracy(data, X0, tol=EPS_TOL),
        "eps_torch": lambda: tg.solve_to_accuracy(data, X0, tol=EPS_TOL,
                                                  engine="torch"),
        # the torch engine on the kernels' configurations at B4096: 100
        # restart iterations, and a window's 10
        "dual_torch_engine": lambda: tg.solve_batch(
            data, X0, S(restart=True, engine="torch")),
        "chunk_torch_engine": lambda: tg.solve_batch(
            data, X0, S(iterations=10, restart=True, form="dual",
                        engine="torch")),
    })
    ms = {k: [] for k in runs}
    order = list(runs)
    for turn in (order, order[::-1]):
        for k in turn:
            ms[k].append(device_time_per_call(runs[k], warmup=3, repeats=20) * 1e3)
    med = {k: float(np.mean(v)) for k, v in ms.items()}
    med["device"] = {
        k: profiled_ms(torch, runs[k], KERNEL_NAMES[k.split("@")[0]])
        for k in runs if k.split("@")[0] in ("dual", "chunk")}
    med["bounds"] = bounds
    emit({"phase": "dual_timing", "gpu": smi, "batches": RESIDENT_BATCHES,
          "iterations": ITERS, "chunk": 10,
          "dual_plans": {B: dual_kernels._dual_plan(data.m_half, B)
                         for B in RESIDENT_BATCHES},
          "bounds": bounds, "ms_median_of_20_per_turn": ms,
          "device_ms_profiler": med["device"],
          "note": "eps_* are CUDA-event times of whole solve_to_accuracy "
                  "calls, host syncs between windows included",
          "solves_per_s": {k: int(k.split("@")[1]) / med[k] * 1e3
                           for k in runs if k.startswith("dual") and "@" in k}
          | {k: BATCH / med[k] * 1e3 for k in ("eps_auto", "eps_torch",
                                               "dual_torch_engine")}})
    return med


# ---------------------------------------------------------------------------
# the resident dense and dual kernels by batch
# ---------------------------------------------------------------------------

# the serving batch (256 plants) and the headline batch
RESIDENT_BATCHES = (SERVE_PLANTS, BATCH)
# each kernel's name as the profiler lists it (a prefix of its instances)
KERNEL_NAMES = {"dense": "gpad_dense_kernel", "dual": "gpad_dual_kernel",
                "chunk": "gpad_dual_chunk_kernel", "flat": "gpad_paired_kernel",
                "paired": "gpad_paired_kernel",
                "flat_tiled": "gpad_flat_tiled_kernel",
                "dual_tiled": "gpad_dual_tiled_kernel",
                "tiled_chunk": "gpad_dual_tiled_chunk_kernel"}


def profiled_ms(torch, fn, name, calls=10):
    """Mean device time of one launch of the kernel whose name contains
    ``name``, over ``calls`` calls of ``fn`` (each launches it once), from
    ``torch.profiler``; None where it saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without kernels
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = count = 0
        for ev in prof.key_averages():
            if name in ev.key:
                total += getattr(ev, "device_time_total",
                                 getattr(ev, "cuda_time_total", 0.0))
                count += ev.count
        if count:
            return total / 1e3 / count
    return None


def resident_runs(torch, tg, kernels, dual_kernels, core, B, seed,
                  which=("dense", "dual", "chunk"), plan=None,
                  tier="highest", shape=HEADLINE):
    """Timed calls at battery n3 N10 (or ``shape``), batch B, keyed
    "<kernel>@<B>" and "<kernel>_plain@<B>": the dense kernel (100
    iterations), the dual kernel (100 restart iterations), the chunk kernel
    (a 10-iteration restart window from the state 30 iterations left), the
    flat and the full paired kernel (100 iterations); and each one's bound
    from these inputs. ``plan`` (log2_tile, split) overrides the launch;
    ``tier`` runs the kernels and their plain versions at a precision
    tier, each bound at the tier's peak. Only the wrappers' public
    arguments are used without either, so a checkout of an earlier design
    runs this too."""
    _, dense = dense_headline(tg)
    _, data = headline(tg, shape)
    X0 = torch.as_tensor(np.random.default_rng(seed).uniform(
        -0.4, 0.4, (B, data.n_x)).astype(np.float32), device=DEVICE)
    over = {} if plan is None else dict(log2_tile=plan[0], split=plan[1])
    tkw = {} if tier == "highest" else {"tier": tier}
    over.update(tkw)
    runs, bounds = {}, {}
    m, n_z, m_h = dense.m, dense.n_z, data.m_half
    if "dense" in which:
        gd, pd = core.affine_params(dense, X0)
        runs[f"dense@{B}"] = lambda: kernels.gpad_fixed_dense(
            dense, gd, pd, iterations=ITERS, **over)
        runs[f"dense_plain@{B}"] = lambda: kernels.gpad_fixed_dense_torch(
            dense, gd, pd, iterations=ITERS, **tkw)
        # two products per scenario and iteration, 2 (m n_z) + 2 (n_z m);
        # z, y, w, zhat written once
        bounds[f"dense@{B}"] = bound(
            B * ITERS * 4.0 * m * n_z,
            nbytes(dense.MG_T, dense.GL_T, gd, pd, dense.theta[:ITERS],
                   dense.beta[:ITERS]) + 4 * B * (2 * n_z + 2 * m), tier)
    g_P, p_D = core.affine_params(data, X0)
    if "dual" in which:
        kw = dict(iterations=ITERS, restart=True)
        runs[f"dual@{B}"] = lambda: dual_kernels.gpad_fixed_dual(
            data, g_P, p_D, **kw, **over)
        runs[f"dual_plain@{B}"] = lambda: dual_kernels.gpad_fixed_dual_torch(
            data, g_P, p_D, **kw, **tkw)
        # the product w D per scenario and iteration (2 m_h^2), the offsets
        # g_P GL_T and the recovery s MG_T once (fp32 at every tier); z, y,
        # w, zhat written once
        loop, around = B * ITERS * 2.0 * m_h * m_h, B * 4.0 * m_h * data.n_z
        bounds[f"dual@{B}"] = bound(
            loop + around * TIER_PEAK_FLOPS[tier] / PEAK_FP32_FLOPS,
            nbytes(data.D, data.GL_T, data.MG_T, g_P, p_D)
            + 4 * B * (2 * data.n_z + 4 * m_h), tier)
    for name in ("flat", "paired"):
        if name not in which:
            continue
        kernel = "paired_flat" if name == "flat" else "paired"
        fn = getattr(kernels, f"gpad_fixed_{kernel}")
        plain = getattr(kernels, f"gpad_fixed_{kernel}_torch")
        runs[f"{name}@{B}"] = lambda fn=fn: fn(data, g_P, p_D,
                                               iterations=ITERS, **over)
        runs[f"{name}_plain@{B}"] = lambda plain=plain: plain(
            data, g_P, p_D, iterations=ITERS, **tkw)
        bounds[f"{name}@{B}"] = paired_bound(data, g_P, p_D, B,
                                             full=name == "paired", tier=tier)
    if "chunk" in which:
        c = dual_kernels.relu_offsets(data, g_P, p_D)
        zero = torch.zeros((B, 2, m_h), device=DEVICE)
        state = dual_kernels.gpad_dual_chunk_torch(
            data, c, zero, zero, torch.zeros((B, m_h), device=DEVICE),
            torch.ones((B, 2), device=DEVICE), k0=0, chunk=30,
            restart=True, **tkw)[:4]
        win = dict(k0=30, chunk=10, restart=True)
        runs[f"chunk@{B}"] = lambda: dual_kernels.gpad_dual_chunk(
            data, c, *state, **win, **over)
        runs[f"chunk_plain@{B}"] = lambda: dual_kernels.gpad_dual_chunk_torch(
            data, c, *state, **win, **tkw)
        # the state in and back, and w
        bounds[f"chunk@{B}"] = bound(
            B * 10 * 2.0 * m_h * m_h,
            nbytes(data.D, c, *state) + nbytes(*state) + 4 * B * 2 * m_h,
            tier)
    return runs, bounds


def times_resident(torch, tg, kernels, dual_kernels, core, smi):
    """``python3 chip_smoke.py --times``: the resident dense, dual, chunk
    and flat kernels at B 256 and 4096 and the full paired kernel at B4096,
    CUDA events (median of 20 calls) and the profiler's device time, with
    each bound; the flat tiled kernel at the flagship and at n5 N30, B256,
    and the default fixed solve there on the torch engine and on the flat
    tiled kernel, in turns; and a warm flat, dense and restart
    ``Controller`` on the serving fleet.
    Public arguments only, so it also times an earlier design's checkout:
    copy this script into that checkout's root and run it there."""
    from tpu_gpad_torch.utils import device_time_per_call

    for B in RESIDENT_BATCHES:
        which = ("dense", "dual", "chunk", "flat") + (
            ("paired",) if B == BATCH else ())
        runs, bounds = resident_runs(torch, tg, kernels, dual_kernels, core,
                                     B, seed=61, which=which)
        kern = [k for k in runs if "_plain" not in k]
        emit({"phase": "resident_times", "gpu": smi, "batch": B,
              "ms_events": {k: device_time_per_call(runs[k], warmup=3,
                                                    repeats=20) * 1e3
                            for k in kern},
              "ms_device": {k: profiled_ms(torch, runs[k],
                                           KERNEL_NAMES[k.split("@")[0]])
                            for k in kern},
              "bound_ms": {k: v["bound_ms"] for k, v in bounds.items()}})
    for label, shape in (("flagship", FLAGSHIP), ("n5_N30", TILED_MID)):
        _, d = flagship(tg, shape)
        g, p = core.affine_params(d, flag_x0(torch, d.n_x, FLAG_BATCH,
                                             seed=63)[1])
        run = lambda: kernels.gpad_fixed_flat_tiled(d, g, p, iterations=ITERS)
        emit({"phase": "flat_tiled_times", "gpu": smi, "shape": label,
              "batch": FLAG_BATCH,
              "ms_events": device_time_per_call(run, warmup=1, repeats=5) * 1e3,
              "ms_device": profiled_ms(torch, run, KERNEL_NAMES["flat_tiled"],
                                       calls=5),
              "bound_ms": paired_bound(d, g, p, FLAG_BATCH)["bound_ms"]})
    # auto's route for flat stacks past shared memory: the default fixed
    # solve on the torch engine against the same solve on the flat tiled
    # kernel, in turns (torch, kernel, kernel, torch)
    for label, shape in (("flagship", FLAGSHIP), ("n5_N30", TILED_MID)):
        _, d = flagship(tg, shape)
        _, X0 = flag_x0(torch, d.n_x, FLAG_BATCH, seed=64)
        runs = {"torch_engine": tg.SolverConfig(engine="torch"),
                "flat_tiled": tg.SolverConfig(engine="cuda", form="mvp")}
        ms = {k: [] for k in runs}
        for k in ("torch_engine", "flat_tiled", "flat_tiled", "torch_engine"):
            ms[k].append(device_time_per_call(
                lambda: tg.solve_batch(d, X0, runs[k]), warmup=1,
                repeats=5) * 1e3)
        emit({"phase": "flat_route_times", "gpu": smi, "shape": label,
              "batch": FLAG_BATCH, "ms_events_by_turn": ms})
    emit({"phase": "resident_serving_times", "gpu": smi,
          "plants": SERVE_PLANTS, "steps": SERVE_STEPS,
          "step_ms_host_clock_median": {
              "flat": serve_ms(tg, tg.SolverConfig()),
              "dense": serve_ms(tg, tg.SolverConfig(), paired=False),
              "restart": serve_ms(tg, tg.SolverConfig(
                  iterations=RESTART_ITERS, restart=True))}})


def tiled_runs(torch, tg, kernels, dual_kernels, core, seed,
               tier="highest"):
    """Timed calls at the flagship B256, keyed "<kernel>@256" and
    "<kernel>_plain@256": the tiled dual kernel (100 restart iterations),
    the flat tiled kernel (100 iterations) and the tiled chunk kernel (a
    10-iteration restart window from the state 30 iterations left), with
    their plain versions, at ``tier``; each one's bound from these inputs
    at the tier's peak. Public arguments only at "highest"."""
    _, flag = flagship(tg)
    B = FLAG_BATCH
    _, X0 = flag_x0(torch, flag.n_x, B, seed=seed)
    g, p = core.affine_params(flag, X0)
    tkw = {} if tier == "highest" else {"tier": tier}
    c = dual_kernels.relu_offsets(flag, g, p)
    zero = torch.zeros((B, 2, flag.m_half), device=DEVICE)
    state = dual_kernels.gpad_dual_chunk_torch(
        flag, c, zero, zero, torch.zeros((B, flag.m_half), device=DEVICE),
        torch.ones((B, 2), device=DEVICE), k0=0, chunk=30, restart=True,
        **tkw)[:4]
    win = dict(k0=30, chunk=10, restart=True, **tkw)
    kw = dict(iterations=ITERS, **tkw)
    runs = {
        f"dual_tiled@{B}": lambda: dual_kernels.gpad_fixed_dual_tiled(
            flag, g, p, restart=True, **kw),
        f"dual_tiled_plain@{B}": lambda: dual_kernels.gpad_fixed_dual_torch(
            flag, g, p, restart=True, **kw),
        f"flat_tiled@{B}": lambda: kernels.gpad_fixed_flat_tiled(flag, g, p,
                                                                 **kw),
        f"flat_tiled_plain@{B}": lambda: kernels.gpad_fixed_paired_flat_torch(
            flag, g, p, **kw),
        f"tiled_chunk@{B}": lambda: dual_kernels.gpad_dual_tiled_chunk(
            flag, c, *state, **win),
        f"tiled_chunk_plain@{B}": lambda: dual_kernels.gpad_dual_chunk_torch(
            flag, c, *state, **win),
    }
    m_h, n_z = flag.m_half, flag.n_z
    # the product w D per scenario and iteration, the offsets and the
    # recovery once (fp32 at every tier); z, y, w, zhat written once
    loop, around = B * ITERS * 2.0 * m_h * m_h, B * 4.0 * m_h * n_z
    bounds = {
        f"dual_tiled@{B}": bound(
            loop + around * TIER_PEAK_FLOPS[tier] / PEAK_FP32_FLOPS,
            nbytes(flag.D, flag.GL_T, flag.MG_T, g, p)
            + 4 * B * (2 * n_z + 4 * m_h), tier),
        f"flat_tiled@{B}": paired_bound(flag, g, p, B, tier=tier),
        f"tiled_chunk@{B}": bound(
            B * 10 * 2.0 * m_h * m_h,
            nbytes(flag.D, c, *state) + nbytes(*state) + 4 * B * 2 * m_h,
            tier)}
    return runs, bounds


TIMED_TIER_KERNELS = ("flat", "paired", "dual", "chunk", "dense")
TIMED_TILED_TIER_KERNELS = ("dual_tiled", "flat_tiled", "tiled_chunk")


def tier_turns(torch, base, runs, bounds, names, B, tier) -> dict:
    """Each named kernel at ``tier`` in turns with "highest" (highest,
    tier, tier, highest; profiler device ms), with its bound and its plain
    version's ms at the tier (CUDA events)."""
    from tpu_gpad_torch.utils import device_time_per_call

    rows = {}
    for k in names:
        key = f"{k}@{B}"
        turns = [(t, profiled_ms(torch, fn, KERNEL_NAMES[k]))
                 for t, fn in (("highest", base[key]), (tier, runs[key]),
                               (tier, runs[key]), ("highest", base[key]))]
        rows[k] = {
            "ms": [ms for t, ms in turns if t == tier],
            "highest_ms": [ms for t, ms in turns if t == "highest"],
            "bound_ms": bounds[key]["bound_ms"],
            "bound_by": bounds[key]["bound_by"],
            "plain_ms": device_time_per_call(
                runs[f"{k}_plain@{B}"], warmup=1, repeats=3) * 1e3}
    return rows


def times_tiers(torch, tg, kernels, dual_kernels, core, smi):
    """``--times tiers``: the flat, full paired, dual, chunk and dense
    kernels at each precision tier beside "highest", at B 256 and 4096
    (battery n3 N10), and the tiled dual, flat tiled and tiled chunk
    kernels at the flagship B256: profiler device ms in turns (highest,
    tier, tier, highest), each with its bound at the tier's peak and its
    plain version's ms at the tier (CUDA events). A checkout whose kernels
    take no tier, or whose dense and tiled kernels take none, says so."""
    import inspect

    if not hasattr(kernels, "KERNEL_TIERS"):
        emit({"phase": "tier_times", "gpu": smi,
              "note": "this checkout's kernels take no tier"})
        return
    all_tiered = "tier" in inspect.signature(kernels.gpad_fixed_dense).parameters
    names = TIMED_TIER_KERNELS if all_tiered else TIMED_TIER_KERNELS[:4]
    for B in RESIDENT_BATCHES:
        base, base_bounds = resident_runs(torch, tg, kernels, dual_kernels,
                                          core, B, seed=66, which=names)
        rows = {}
        for tier in TIER_TOL:
            runs, bounds = resident_runs(torch, tg, kernels, dual_kernels,
                                         core, B, seed=66, which=names,
                                         tier=tier)
            for k, row in tier_turns(torch, base, runs, bounds, names, B,
                                     tier).items():
                rows.setdefault(k, {})[tier] = row
        emit({"phase": "tier_times", "gpu": smi, "batch": B,
              "highest_bound_ms": {k: base_bounds[f"{k}@{B}"]["bound_ms"]
                                   for k in names},
              "kernels": rows})
    if not all_tiered:
        emit({"phase": "tier_times", "gpu": smi, "shape": "flagship",
              "note": "this checkout's dense and tiled kernels take no tier"})
        return
    base, base_bounds = tiled_runs(torch, tg, kernels, dual_kernels, core,
                                   seed=67)
    rows = {}
    for tier in TIER_TOL:
        runs, bounds = tiled_runs(torch, tg, kernels, dual_kernels, core,
                                  seed=67, tier=tier)
        for k, row in tier_turns(torch, base, runs, bounds,
                                 TIMED_TILED_TIER_KERNELS, FLAG_BATCH,
                                 tier).items():
            rows.setdefault(k, {})[tier] = row
    emit({"phase": "tier_times", "gpu": smi, "batch": FLAG_BATCH,
          "shape": "flagship",
          "highest_bound_ms": {k: base_bounds[f"{k}@{FLAG_BATCH}"]["bound_ms"]
                               for k in TIMED_TILED_TIER_KERNELS},
          "kernels": rows})


def paired_bound(d, g, p, B, full=False, tier="highest") -> dict:
    """The paired loop's bound at B scenarios: its two products, MG_T over
    every row and GL_T's n_s struct columns (the full loop: all m_h), per
    scenario and iteration, at the tier's peak; z, y, w, zhat written
    once."""
    m_h, n_z = d.m_half, d.n_z
    n_s = m_h if full else d.n_struct
    return bound(B * ITERS * 2.0 * n_z * (m_h + n_s),
                 nbytes(d.MG_T, d.GL_T[:, :n_s], g, p, d.theta[:ITERS],
                        d.beta[:ITERS]) + 4 * B * (2 * n_z + 4 * m_h), tier)


def serve_ms(tg, config, paired="auto") -> float:
    """Median host-clock ms of a warm ``Controller.step`` on the serving
    fleet (battery n3 N10, 256 plants), over SERVE_STEPS steps after the
    first."""
    problem = tg.problems.battery(**HEADLINE)
    ctl = tg.Controller(problem, config=config, paired=paired, device=DEVICE)
    A = np.asarray(problem.A, dtype=np.float32)
    Bm = np.asarray(problem.B, dtype=np.float32)
    x = np.random.default_rng(2).uniform(
        -0.4, 0.4, (SERVE_PLANTS, problem.n_x)).astype(np.float32)
    step_ms = []
    for _ in range(SERVE_STEPS + 1):
        t0 = time.perf_counter()
        u = ctl.step(x)  # returns host NumPy: the device work is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
        x = x @ A.T + u @ Bm.T
    return float(np.median(step_ms[1:]))


RESIDENT_FAMILIES = ("dense", "dual", "chunk", "flat", "paired")


def resident_plan(kernels, dual_kernels, name, dense, data, B, log2=None,
                  cap=None):
    """A resident kernel's launch plan at battery n3 N10, batch B: the pick,
    or the plan a sweep's (log2_tile, split cap) gives."""
    if name == "dense":
        return kernels._dense_plan(dense.m, dense.n_z, B, log2, cap)
    if name in ("dual", "chunk"):
        return dual_kernels._dual_plan(data.m_half, B, log2, cap)
    n_s = data.n_struct if name == "flat" else data.m_half
    return kernels._paired_plan(data.m_half, data.n_z, n_s, B, log2, cap)


def sweep_resident(torch, tg, kernels, dual_kernels, core, smi,
                   names=RESIDENT_FAMILIES):
    """``--sweep``: the resident dense, dual, chunk, flat and full paired
    kernels' device time (profiler, mean of 5 calls) by scenarios per block
    (2**log2) and split-K cap at B 256 and 4096; each distinct launch
    once."""
    _, dense = dense_headline(tg)
    _, data = headline(tg)
    for B in RESIDENT_BATCHES:
        for name in names:
            row, seen = {}, set()
            top = 5 if name in ("dense", "dual", "chunk") else 4
            for log2 in range(top + 1):
                for cap in (None, 1, 2, 4, 8):
                    launch = resident_plan(kernels, dual_kernels, name, dense,
                                           data, B, log2, cap)
                    if launch is None or launch in seen:
                        continue
                    seen.add(launch)
                    runs, _ = resident_runs(torch, tg, kernels, dual_kernels,
                                            core, B, seed=62, which=(name,),
                                            plan=(log2, cap))
                    row["/".join(map(str, launch))] = profiled_ms(
                        torch, runs[f"{name}@{B}"], KERNEL_NAMES[name], calls=5)
            pick = resident_plan(kernels, dual_kernels, name, dense, data, B)
            emit({"phase": "resident_sweep", "gpu": smi, "kernel": name,
                  "batch": B, "default": "/".join(map(str, pick)),
                  "ms_device_by_plan": row})


# ---------------------------------------------------------------------------
# the dense (unpaired) layout and the full paired kernel
# ---------------------------------------------------------------------------


def dense_headline(tg, shape=HEADLINE):
    """A battery QP and its dense (unpaired) data on the card."""
    qp = tg.condense(tg.problems.battery(**shape))
    return qp, tg.dualize(qp, ITERS, paired=False, device=DEVICE)


def phase_dense_kernel_vs_plain(torch, tg, kernels, core):
    """The dense kernel against its plain version: cold, warm (per
    scenario and shared), diagnostics off, a ragged tile and one scenario
    at n3 N10 B4096; n3 N20 near the shared-memory guard."""
    _, data = dense_headline(tg)
    rng = np.random.default_rng(40)
    X0 = torch.as_tensor(
        rng.uniform(-0.4, 0.4, (BATCH, data.n_x)).astype(np.float32), device=DEVICE)
    g_P, p_D = core.affine_params(data, X0)
    run = lambda *a, **kw: kernel_vs_plain(kernels, *a, kernel="dense", **kw)
    cases = {}
    cases["cold"], (_, y_cold, _, _) = run(data, g_P, p_D)
    cases["warm_per_scenario"], _ = run(data, g_P, p_D, y_cold)
    cases["warm_shared"], _ = run(data, g_P, p_D, y_cold[0].contiguous())
    cases["no_diagnostics"], _ = run(data, g_P, p_D, y_cold, diagnostics=False)
    # ragged last tile, the serving batch (a tile of its own), a few, one
    for B in (4093, SERVE_PLANTS, 5, 1):
        cases[f"B{B}"], _ = run(data, g_P[:B].contiguous(), p_D[:B].contiguous(),
                                y_cold[:B].contiguous())
    _, near = dense_headline(tg, DENSE_NEAR)
    Xn = torch.as_tensor(
        rng.uniform(-0.4, 0.4, (BATCH, near.n_x)).astype(np.float32), device=DEVICE)
    cases["near_guard_n3_N20"], _ = run(near, *core.affine_params(near, Xn))
    plan = kernels._dense_plan(near.m, near.n_z, BATCH)
    worst = max(cases.values())
    emit({"phase": "dense_kernel_vs_plain", "shape": [BATCH, data.n_z, data.m],
          "plans": {B: kernels._dense_plan(data.m, data.n_z, B)
                    for B in (BATCH, SERVE_PLANTS, 1)},
          "near_guard": {"n_z": near.n_z, "m": near.m, "plan": plan,
                         "smem_bytes": kernels._dense_smem_bytes(near.m, near.n_z,
                                                                 plan)},
          "max_abs_err": cases, "max_abs_y": y_cold.abs().max().item(),
          "tol": KERNEL_TOL})
    check(plan.log2_tile == 4, f"n3 N20 dense plan {plan}, expected 16 per block")
    check(worst <= KERNEL_TOL, f"dense kernel disagrees with plain version: {cases}")
    return worst


def phase_paired_kernel_vs_plain(torch, tg, kernels, core):
    """The full paired kernel against its plain version at the headline
    paired shape: cold, warm, diagnostics off, soft rows, the serving
    batch, a partial last tile, a few scenarios and one."""
    _, data = headline(tg)
    rng = np.random.default_rng(41)
    X0 = torch.as_tensor(
        rng.uniform(-0.4, 0.4, (BATCH, data.n_x)).astype(np.float32), device=DEVICE)
    g_P, p_D = core.affine_params(data, X0)
    run = lambda *a, **kw: kernel_vs_plain(kernels, *a, kernel="paired", **kw)
    cases = {}
    cases["cold"], (_, y_cold, _, _) = run(data, g_P, p_D)
    cases["warm_per_scenario"], _ = run(data, g_P, p_D, y_cold)
    cases["no_diagnostics"], _ = run(data, g_P, p_D, y_cold, diagnostics=False)
    soft = dataclasses.replace(data, soft_damp=torch.as_tensor(
        rng.uniform(0.0, 0.2, data.m_half).astype(np.float32), device=DEVICE))
    cases["soft"], _ = run(soft, g_P, p_D)
    for B in (SERVE_PLANTS, 300, 5, 1):
        cases[f"B{B}"], _ = run(data, g_P[:B].contiguous(), p_D[:B].contiguous(),
                                y_cold[:B].contiguous())
    worst = max(cases.values())
    emit({"phase": "paired_kernel_vs_plain", "shape": [BATCH, data.n_z, data.m_half],
          "plans": {B: kernels._paired_plan(data.m_half, data.n_z, data.m_half, B)
                    for B in (BATCH, SERVE_PLANTS, 300, 5, 1)},
          "max_abs_err": cases, "tol": KERNEL_TOL})
    check(worst <= KERNEL_TOL, f"paired kernel disagrees with plain version: {cases}")
    return worst


def phase_dataset_path(torch, tg, kernels, reference):
    """The reference's dataset round: ``export`` writes battery n3 N10 in
    the reference's text format, ``solve --dataset`` solves it in process
    on the dense kernel; u* against the NumPy oracle on the file's own
    constants and schedule, and on the QP at the exported x0."""
    import contextlib
    import io as textio
    import tempfile

    from tpu_gpad_torch import cli, io

    def run(argv):
        buf = textio.StringIO()
        with contextlib.redirect_stdout(buf):
            check(cli.main(argv) == 0, f"cli {argv[0]} failed")
        return json.loads(buf.getvalue().strip().splitlines()[-1])

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/input_1.txt"
        before = kernels.DENSE_LAUNCHES
        exported = run(["export", "--out", path, "--cells", "3", "--horizon", "10",
                        "--device", DEVICE])
        out = run(["solve", "--dataset", path, "--device", DEVICE])
        launched = kernels.DENSE_LAUNCHES - before
        ds = io.read_solver_dataset(path)
    ref = reference.gpad_solve(ds.M_G, ds.g_P, ds.G_L, ds.p_D, ds.n_u,
                               iterations=ds.num_iterations, theta=ds.theta,
                               beta=ds.beta)
    qp = tg.condense(tg.problems.battery(**HEADLINE))
    ref_qp = reference.gpad_solve_qp(qp, np.asarray(exported["x0"]), ITERS)
    u = np.asarray(out["u_star"])
    errs = {"u_vs_oracle_on_file": float(np.abs(u - ref.u).max()),
            "u_vs_oracle_on_qp": float(np.abs(u - ref_qp.u).max())}
    emit({"phase": "dataset_path", "export": exported, "solve": out,
          "launches": launched, **errs, "tol": ORACLE_TOL})
    check(out["engine"] == "cuda" and out["device"].startswith("cuda"),
          f"solve --dataset ran on {out['engine']} / {out['device']}")
    check(launched == 1, f"solve --dataset launched the dense kernel {launched}x")
    check(max(errs.values()) < ORACLE_TOL, f"dataset u* vs oracle {errs}")


def phase_multi_path(torch, tg, kernels, reference):
    """``solve_multi`` over the reference's 28 plants (battery n3 N10, cell
    capacities and current limits differing), 256 scenarios each, dense
    layout: one dense-kernel launch per plant; each plant's first u*
    against the oracle on its own QP, every move within its own limit."""
    from tpu_gpad_torch.solver.multi import solve_multi

    caps = np.linspace(0.08, 0.15, MULTI_PLANTS)
    limits = np.linspace(0.2, 0.4, MULTI_PLANTS)
    qps = [tg.condense(tg.problems.battery(**HEADLINE, cell_capacity_ah=c,
                                           current_limit=lim))
           for c, lim in zip(caps, limits)]
    datas = [tg.dualize(qp, ITERS, paired=False, device=DEVICE) for qp in qps]
    X0np = np.random.default_rng(42).uniform(
        -0.4, 0.4, (MULTI_PLANTS, MULTI_BATCH, 3)).astype(np.float32)
    before = kernels.DENSE_LAUNCHES
    res = solve_multi(datas, X0np)
    torch.cuda.synchronize()
    launched = kernels.DENSE_LAUNCHES - before
    u = res.u.cpu().numpy()
    oracle = [float(np.abs(u[p, 0] - reference.gpad_solve_qp(
        qps[p], X0np[p, 0].astype(np.float64), ITERS).u).max())
        for p in range(MULTI_PLANTS)]
    over = [float(np.abs(u[p]).max() - limits[p]) for p in range(MULTI_PLANTS)]
    emit({"phase": "multi_path", "plants": MULTI_PLANTS, "batch": MULTI_BATCH,
          "launches": launched, "u_vs_oracle_max": max(oracle),
          "limit_excess_max": max(over),
          "residual_max": res.residual.max().item(), "tol": ORACLE_TOL})
    check(tuple(res.u.shape) == (MULTI_PLANTS, MULTI_BATCH, 3), "multi u shape")
    check(bool(torch.isfinite(res.z).all()), "multi z not finite")
    check(launched == MULTI_PLANTS, f"solve_multi launched {launched}x")
    check(max(oracle) < ORACLE_TOL, f"multi u* vs oracle {oracle}")
    check(max(over) <= 1e-2, f"multi moves beyond their limits {over}")


def phase_sweep_path(torch, tg, kernels):
    """``run_sweep`` over B 16384 in chunks of 4096 with a checkpoint,
    dense layout: 4 dense-kernel launches; a second run resumes from the
    finished checkpoint with none and identical arrays."""
    import tempfile

    from tpu_gpad_torch.sweep import run_sweep

    _, data = dense_headline(tg)
    X0 = np.random.default_rng(43).uniform(
        -0.4, 0.4, (SWEEP_BATCH, data.n_x)).astype(np.float32)
    cfg = tg.SolverConfig()
    with tempfile.TemporaryDirectory() as tmp:
        ck = f"{tmp}/sweep.npz"
        before = kernels.DENSE_LAUNCHES
        first = run_sweep(data, X0, cfg, chunk_size=SWEEP_CHUNK, checkpoint=ck)
        launched = kernels.DENSE_LAUNCHES - before
        before = kernels.DENSE_LAUNCHES
        again = run_sweep(data, X0, cfg, chunk_size=SWEEP_CHUNK, checkpoint=ck)
        resumed = kernels.DENSE_LAUNCHES - before
    same = all(np.array_equal(getattr(first, f), getattr(again, f))
               for f in ("U", "residual", "iterations", "converged"))
    plain = tg.solve_batch(data, X0[:SWEEP_CHUNK],
                           dataclasses.replace(cfg, engine="torch"))
    vs_torch = float(np.abs(first.U[:SWEEP_CHUNK] - plain.u.cpu().numpy()).max())
    emit({"phase": "sweep_path", "batch": SWEEP_BATCH, "chunk": SWEEP_CHUNK,
          "launches": launched, "resume_launches": resumed,
          "resumed_identical": same, "u_vs_torch_engine": vs_torch,
          "residual_max": float(first.residual.max()),
          "wall_s_host_clock": first.wall_s})
    check(launched == SWEEP_BATCH // SWEEP_CHUNK, f"sweep launched {launched}x")
    check(resumed == 0 and same, f"resume launched {resumed}x, identical {same}")
    check(np.isfinite(first.U).all() and vs_torch <= KERNEL_TOL,
          f"sweep u vs the torch engine {vs_torch}")
    return launched


def phase_paired_path(torch, tg, kernels, core, reference):
    """A paired mvp solve with the flat block off (``form="mvp"``,
    ``flat="off"``) at the headline shape: one launch of the full paired
    kernel; u* against the oracle and the torch engine."""
    qp, data = headline(tg)
    X0np = np.random.default_rng(44).uniform(
        -0.4, 0.4, (BATCH, qp.n_x)).astype(np.float32)
    X0 = torch.as_tensor(X0np, device=DEVICE)
    cfg = tg.SolverConfig(form="mvp", flat="off")
    before = kernels.PAIRED_LAUNCHES
    res = tg.solve_batch(data, X0, cfg)
    torch.cuda.synchronize()
    launched = kernels.PAIRED_LAUNCHES - before
    oracle = [float(np.abs(res.u[i].cpu().numpy() - reference.gpad_solve_qp(
        qp, X0np[i].astype(np.float64), ITERS).u).max()) for i in range(4)]
    plain = tg.solve_batch(data, X0, dataclasses.replace(cfg, engine="torch"))
    vs_torch = (res.u - plain.u).abs().max().item()
    emit({"phase": "paired_path", "kernel": core.cuda_kernel(data, cfg),
          "batch": BATCH, "launches": launched, "u_vs_oracle": oracle,
          "u_vs_torch_engine": vs_torch, "tol": ORACLE_TOL})
    check(launched == 1, f"paired mvp solve launched the paired kernel {launched}x")
    check(max(oracle) < ORACLE_TOL and vs_torch < ORACLE_TOL,
          f"paired u* vs oracle {oracle}, vs torch engine {vs_torch}")
    return launched


def phase_dense_timing(torch, tg, kernels, dual_kernels, core, smi):
    """CUDA events, median of 20 calls per turn, two turns in opposite
    orders: the dense and the full paired kernel at the serving batch
    (256) and at B4096 x 100, their plain versions, and the solves through
    ``auto`` and ``engine="torch"`` at B4096; then the kernels' device
    time from the profiler."""
    from tpu_gpad_torch.utils import device_time_per_call

    _, dense = dense_headline(tg)
    _, paired = headline(tg)
    X0 = torch.as_tensor(np.random.default_rng(45).uniform(
        -0.4, 0.4, (BATCH, dense.n_x)).astype(np.float32), device=DEVICE)
    mvp = tg.SolverConfig(form="mvp", flat="off")
    runs, bounds = {}, {}
    for B in RESIDENT_BATCHES:
        r, b = resident_runs(torch, tg, kernels, dual_kernels, core, B,
                             seed=45, which=("dense", "paired"))
        runs.update(r)
        bounds.update(b)
    runs.update({
        "dense_auto": lambda: tg.solve_batch(dense, X0),
        "dense_torch": lambda: tg.solve_batch(dense, X0,
                                              tg.SolverConfig(engine="torch")),
        "paired_auto": lambda: tg.solve_batch(paired, X0, mvp),
        "paired_torch": lambda: tg.solve_batch(
            paired, X0, dataclasses.replace(mvp, engine="torch")),
    })
    ms = {k: [] for k in runs}
    order = list(runs)
    for turn in (order, order[::-1]):
        for k in turn:
            ms[k].append(device_time_per_call(runs[k], warmup=3, repeats=20) * 1e3)
    med = {k: float(np.mean(v)) for k, v in ms.items()}
    med["device"] = {k: profiled_ms(torch, runs[k],
                                    KERNEL_NAMES[k.split("@")[0]])
                     for k in runs if k.split("@")[0] in ("dense", "paired")}
    n_z, m_h = paired.n_z, paired.m_half
    med["bounds"] = bounds
    emit({"phase": "dense_timing", "gpu": smi, "batches": RESIDENT_BATCHES,
          "iterations": ITERS, "dense_shape": [dense.n_z, dense.m],
          "paired_shape": [n_z, m_h],
          "dense_plans": {B: kernels._dense_plan(dense.m, dense.n_z, B)
                          for B in RESIDENT_BATCHES},
          "paired_plans": {B: kernels._paired_plan(m_h, n_z, m_h, B)
                           for B in RESIDENT_BATCHES},
          "bounds": bounds, "ms_median_of_20_per_turn": ms,
          "device_ms_profiler": med["device"],
          "solves_per_s": {k: BATCH / med[k] * 1e3 for k in runs
                           if "@" not in k}})
    return med


# ---------------------------------------------------------------------------
# the reference's 30x30 flagship and the tiled kernels
# ---------------------------------------------------------------------------

_FLAG = {}


def flagship(tg, shape=FLAGSHIP, paired="auto"):
    """A battery QP and its paired (or ``paired=False``: dense) data on the
    card (100-iteration schedule), built once per shape and layout."""
    key = (*shape.values(), paired)
    if key not in _FLAG:
        qp = tg.condense(tg.problems.battery(**shape))
        _FLAG[key] = qp, tg.dualize(qp, ITERS, paired=paired, device=DEVICE)
    return _FLAG[key]


def flag_x0(torch, n_x, B, seed):
    X0np = np.random.default_rng(seed).uniform(-0.4, 0.4, (B, n_x)).astype(
        np.float32)
    return X0np, torch.as_tensor(X0np, device=DEVICE)


def parted_max(B: int) -> int:
    """How many of B scenarios a flipped restart decision may part."""
    return max(1, int(SW_RESTART_PARTED_SHARE * B))


def restart_parting(torch, data, g_P, p_D, y0, z_k, z_p, iterations=ITERS):
    """A restart run of a dual kernel (z_k) against the plain version
    (z_p), per scenario, and both against the plain version in
    float64. A restart decision is the sign of a sum that float32 rounding
    may flip where it is near 0; a scenario whose decision flipped parts
    from the other run by far more than RESTART_TOL. At most
    SW_RESTART_PARTED_SHARE of the scenarios (at least one) may part;
    ``u_z`` is the largest error of those that did not."""
    from tpu_gpad_torch.solver import dual_kernels
    from tpu_gpad_torch.types import GPAD_TENSOR_FIELDS

    d64 = dataclasses.replace(data, **{
        f: getattr(data, f).double() for f in GPAD_TENSOR_FIELDS
        if getattr(data, f) is not None})
    y64 = (torch.zeros_like(p_D, dtype=torch.float64) if y0 is None
           else y0.double())
    z64 = dual_kernels.gpad_fixed_dual_torch(
        d64, g_P.double(), p_D.double(), y64, iterations=iterations,
        restart=True, diagnostics=False)[0]
    per = lambda a, b: (a.double() - b.double()).abs().amax(dim=1)
    e_k, e_k64, e_p64 = per(z_k, z_p), per(z_k, z64), per(z_p, z64)
    parted = e_k > RESTART_TOL
    return {"u_z": e_k[~parted].max().item() if not parted.all() else None,
            "parted": int(parted.sum()),
            "parted_max": parted_max(z_k.shape[0]),
            "u_z_parted_max": e_k.max().item(),
            "parted_vs_float64": int((e_k64 > RESTART_TOL).sum()),
            "plain_parted_vs_float64": int((e_p64 > RESTART_TOL).sum())}


def eps_agreement(res, ref) -> dict:
    """Two eps solves of one batch, scenario by scenario: a scenario whose
    restart decision flipped near r = 0 in one of them takes another path
    and stops at another point that meets the same tolerance, so only most
    scenarios agree to the fp32 sums of a path."""
    du = (res.u - ref.u).abs().amax(dim=-1)
    return {"agree": int((du < EPS_U_TOL).sum()), "batch": int(du.numel()),
            "same_window": int((res.iterations == ref.iterations).sum()),
            "u_max": du.max().item(),
            "iterations_max_diff": int((res.iterations - ref.iterations)
                                       .abs().max())}


def phase_tiled_kernels_vs_plain(torch, tg, kernels, dual_kernels, core):
    """Each tiled kernel against its plain version: the flagship at B 1, 5,
    33, 256 and 300 (a partial last tile; cold, warm per scenario and
    shared, restart, diagnostics off), battery n5 N30 (m_h 330) and n3 N10
    at the narrowest and widest tile (1 and 8 scenarios per cluster) and
    on clusters of 16, 1 and 2 blocks; the chunk kernel on a window of 10
    from k0 = 30, and ten windows against one whole launch."""
    _, flag = flagship(tg)
    _, mid = flagship(tg, TILED_MID)
    _, small = headline(tg)
    rng = np.random.default_rng(50)
    dual, restart, flat, chunk, bitwise = {}, {}, {}, {}, {}

    def warm(d, rows):
        return torch.as_tensor(rng.uniform(0.0, 0.5, (rows, 2, d.m_half)).astype(
            np.float32), device=DEVICE)

    def finite(out, diagnostics):
        for t in out:
            if t is not None:
                check(bool(torch.isfinite(t).all()), "tiled kernel output not finite")
        if not diagnostics:
            check(out[2] is None and out[3] is None,
                  "diagnostics=False returned w/zhat")

    def run(name, d, B, y0=None, rs=False, diagnostics=True, tile=None,
            kinds=("dual", "flat"), cluster=None):
        g, p = core.affine_params(d, flag_x0(torch, d.n_x, B, seed=B)[1])
        kw = dict(iterations=ITERS, diagnostics=diagnostics)
        outs = {}
        if "dual" in kinds:
            out_k = dual_kernels.gpad_fixed_dual_tiled(d, g, p, y0, restart=rs,
                                                       log2_tile=tile,
                                                       cluster=cluster, **kw)
            out_p = dual_kernels.gpad_fixed_dual_torch(d, g, p, y0, restart=rs,
                                                       **kw)
            torch.cuda.synchronize()
            finite(out_k, diagnostics)
            if rs:  # u and z only (u is a slice of z), scenario by scenario
                restart[name] = restart_parting(torch, d, g, p, y0, out_k[0],
                                                out_p[0])
            else:
                dual[name] = max_err(out_k, out_p)
            outs["dual"] = out_k
        if "flat" in kinds and not rs:
            out_k = kernels.gpad_fixed_flat_tiled(d, g, p, y0, log2_tile=tile,
                                                  cluster=cluster, **kw)
            out_p = kernels.gpad_fixed_paired_flat_torch(d, g, p, y0, **kw)
            torch.cuda.synchronize()
            finite(out_k, diagnostics)
            flat[name] = max_err(out_k, out_p)
            outs["flat"] = out_k
        return outs

    B = FLAG_BATCH
    y_warm = warm(flag, B)
    with_diag = run("warm_per_scenario", flag, B, y_warm)
    no_diag = run("no_diagnostics", flag, B, y_warm, diagnostics=False)
    for kind in ("dual", "flat"):  # the flag never changes the iterates
        bitwise[kind] = all(torch.equal(a, b) for a, b in
                            zip(with_diag[kind][:2], no_diag[kind][:2]))
    run("cold", flag, B)
    run("warm_shared", flag, B, warm(flag, 1))
    run("restart_cold", flag, B, rs=True)
    run("restart_warm", flag, B, y_warm, rs=True)
    for b in (33, 5, 1):
        run(f"B{b}", flag, b, warm(flag, b))
    run("restart_B5", flag, 5, rs=True)
    run("n5_N30", mid, B)
    run("restart_n5_N30", mid, B, warm(mid, B), rs=True)
    for tile in (0, 3):  # 1 and 8 scenarios per block
        run(f"n3_N10_tile{1 << tile}", small, 33, warm(small, 33), tile=tile)
        run(f"restart_n3_N10_tile{1 << tile}", small, 33, rs=True, tile=tile)
    # the clusters: 300 leaves a partial last tile; 16 scenarios on
    # clusters of 16 and 1 on clusters of 1 and 2
    run("B300", flag, 300, warm(flag, 300))
    run("restart_B300", flag, 300, rs=True, kinds=("dual",))
    for tile, cl in ((4, 16), (0, 1), (1, 2)):
        run(f"n3_N10_tile{1 << tile}_cluster{cl}", small, 33, warm(small, 33),
            tile=tile, cluster=cl)
        run(f"restart_n3_N10_tile{1 << tile}_cluster{cl}", small, 33, rs=True,
            tile=tile, cluster=cl, kinds=("dual",))
    # the chunk kernel: one window, and ten windows against a whole solve
    g, p = core.affine_params(flag, flag_x0(torch, flag.n_x, B, seed=51)[1])
    c = dual_kernels.relu_offsets(flag, g, p)
    zero = torch.zeros((B, 2, flag.m_half), device=DEVICE)
    start = (zero, zero, torch.zeros((B, flag.m_half), device=DEVICE),
             torch.ones((B, 2), device=DEVICE))
    for rs in (False, True):
        key = "restart" if rs else "plain"
        state = dual_kernels.gpad_dual_chunk_torch(flag, c, *start, k0=0,
                                                   chunk=30, restart=rs)[:4]
        out_k = dual_kernels.gpad_dual_tiled_chunk(flag, c, *state, k0=30,
                                                   chunk=10, restart=rs)
        out_p = dual_kernels.gpad_dual_chunk_torch(flag, c, *state, k0=30,
                                                   chunk=10, restart=rs)
        torch.cuda.synchronize()
        for t in out_k:
            check(bool(torch.isfinite(t).all()), "tiled chunk output not finite")
        # under restart the recovered z, as for the whole-solve kernel
        chunk[f"window_{key}"] = (
            ((out_k[2] - out_p[2]) @ flag.MG_T).abs().max().item() if rs
            else max_err(out_k, out_p))
        state = start
        for k0 in range(0, ITERS, 10):
            *state, w = dual_kernels.gpad_dual_tiled_chunk(
                flag, c, *state, k0=k0, chunk=10, restart=rs)
        z, y, w_f, _ = dual_kernels.gpad_fixed_dual_tiled(
            flag, g, p, iterations=ITERS, restart=rs)
        torch.cuda.synchronize()
        chunk[f"ten_windows_vs_whole_{key}"] = max_err(
            (-(state[2] @ flag.MG_T) - g, state[0], w), (z, y, w_f))
    kept = [float("inf") if v["u_z"] is None else v["u_z"]
            for v in restart.values()]
    worst = {"dual": max(max(dual.values()), max(kept)),
             "flat": max(flat.values()), "chunk": max(chunk.values())}
    emit({"phase": "tiled_kernels_vs_plain",
          "shapes": {"flagship": [flag.n_z, flag.m_half, flag.n_struct],
                     "n5_N30": [mid.n_z, mid.m_half, mid.n_struct],
                     "n3_N10": [small.n_z, small.m_half, small.n_struct]},
          "log2_tile": {"dual_B256": dual_kernels.pick_tiled_tiles(flag.m_half, B),
                        "flat_B256": kernels.pick_flat_tiled(
                            flag.m_half, flag.n_z, B)},
          "max_abs_err": {"dual": dual, "dual_restart_u_z": restart,
                          "flat": flat, "dual_chunk": chunk},
          "diagnostics_off_bit_identical": bitwise,
          "tol": KERNEL_TOL, "restart_tol_u_z": RESTART_TOL})
    check(max(dual.values()) <= KERNEL_TOL, f"tiled dual vs plain: {dual}")
    check(max(kept) <= RESTART_TOL
          and all(v["parted"] <= v["parted_max"] for v in restart.values()),
          f"tiled dual restart: {restart}")
    check(max(flat.values()) <= KERNEL_TOL, f"flat tiled vs plain: {flat}")
    check(chunk["window_plain"] <= KERNEL_TOL
          and chunk["window_restart"] <= RESTART_TOL
          and chunk["ten_windows_vs_whole_plain"] <= KERNEL_TOL
          and chunk["ten_windows_vs_whole_restart"] <= KERNEL_TOL,
          f"tiled chunk: {chunk}")
    check(all(bitwise.values()), f"diagnostics=False changed the iterates {bitwise}")
    return worst


def phase_flagship_path(torch, tg, kernels, dual_kernels, core, reference, sk, ss):
    """The reference's 30x30 flagship on the card, each leg counted from 0:
    restart and dual-form solves (the tiled dual kernel), a restart
    ``Controller`` serving 256 plants, ``solve_to_accuracy`` with the flat
    block off (the tiled chunk kernel, one launch per window), a forced
    flat solve and the default solve (both the flat tiled kernel), and the
    CLI's ``closedloop`` and ``info`` in process. Returns the launches."""
    import contextlib
    import io as textio

    from tpu_gpad_torch import cli

    qp, flag = flagship(tg)
    X0np, X0 = flag_x0(torch, flag.n_x, FLAG_BATCH, seed=52)
    out = {"phase": "flagship_path", "batch": FLAG_BATCH,
           "shape": [flag.n_z, flag.m_half, flag.n_struct]}
    total = {}

    def leg(name, fn, expect):
        """Run ``fn`` with every count at 0 (``counted``)."""
        res, got = counted(torch, (kernels, dual_kernels, sk, ss), fn, expect,
                           f"flagship {name}")
        out[name] = {"launches": got}
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        return res

    def oracle_err(res, n=4):
        return [float(np.abs(res.u[i].cpu().numpy() - reference.gpad_solve_qp(
            qp, X0np[i].astype(np.float64), ITERS).u).max()) for i in range(n)]

    cfg = tg.SolverConfig(restart=True)
    res = leg("restart", lambda: tg.solve_batch(flag, X0, cfg),
              {"gpad_dual_tiled": 1})
    ref = tg.solve_batch(flag, X0, dataclasses.replace(cfg, engine="torch"))
    du = (res.u - ref.u).abs().amax(dim=1)
    parted = du > RESTART_TOL  # a restart decision flipped near r = 0
    out["restart"].update(
        kernel=core.cuda_kernel(flag, cfg), residual_max=res.residual.max().item(),
        u_vs_torch_engine=du[~parted].max().item() if not parted.all() else None,
        parted=int(parted.sum()), u_parted_max=du.max().item())
    check(out["restart"]["parted"] <= parted_max(FLAG_BATCH)
          and bool(torch.isfinite(res.u).all()),
          f"flagship restart u vs torch engine {out['restart']}")

    cfg = tg.SolverConfig(form="dual")
    res = leg("form_dual", lambda: tg.solve_batch(flag, X0, cfg),
              {"gpad_dual_tiled": 1})
    out["form_dual"]["u_vs_oracle"] = oracle_err(res)
    check(max(out["form_dual"]["u_vs_oracle"]) < ORACLE_TOL,
          f"flagship dual u* vs oracle {out['form_dual']}")

    cfg = tg.SolverConfig(engine="cuda", form="mvp")
    res = leg("forced_mvp", lambda: tg.solve_batch(flag, X0, cfg),
              {"gpad_flat_tiled": 1})
    out["forced_mvp"].update(kernel=core.cuda_kernel(flag, cfg),
                             u_vs_oracle=oracle_err(res))
    check(max(out["forced_mvp"]["u_vs_oracle"]) < ORACLE_TOL,
          f"flagship flat u* vs oracle {out['forced_mvp']}")

    cfg = tg.SolverConfig()
    res = leg("default", lambda: tg.solve_batch(flag, X0, cfg),
              {"gpad_flat_tiled": 1})
    out["default"].update(
        engine=core.resolve_engine(flag, cfg), kernel=core.cuda_kernel(flag, cfg),
        form=core.resolve_form(flag, cfg), u_vs_oracle=oracle_err(res))
    check(out["default"]["engine"] == "cuda"
          and max(out["default"]["u_vs_oracle"]) < ORACLE_TOL,
          f"flagship default solve {out['default']}")

    # solve_to_accuracy with the flat block off: one launch per window of
    # 10, up to the last scenario's convergence
    res = leg("eps_flat_off", lambda: tg.solve_to_accuracy(
        flag, X0, tol=FLAG_EPS_TOL, flat="off"),
        lambda r: {"gpad_dual_tiled_chunk": -(-int(r.iterations.max()) // 10)})
    syncs = dual_kernels.EPS_SYNCS
    # the same eps loop on the plain version of the chunk kernel (the dual
    # algebra, cuBLAS sums), and the torch engine (the mvp algebra, as
    # tpu_gpad's XLA eps loop)
    cfg = tg.SolverConfig(mode="eps", eps_g=FLAG_EPS_TOL, eps_V=FLAG_EPS_TOL,
                          check_every=10, iterations=2000, restart=True,
                          flat="off")
    g, p = core.affine_params(flag, X0)
    plain = dual_kernels.gpad_eps_dual(
        flag, g, p, cfg, chunk_fn=dual_kernels.gpad_dual_chunk_torch)
    ref = tg.solve_to_accuracy(flag, X0, tol=FLAG_EPS_TOL, flat="off",
                               engine="torch")
    vs_plain, vs_torch = eps_agreement(res, plain), eps_agreement(res, ref)
    out["eps_flat_off"].update(
        iterations_max=int(res.iterations.max()),
        iterations_torch_engine_max=int(ref.iterations.max()),
        host_syncs=syncs, converged_all=bool(res.converged.all()),
        residual_max=res.residual.max().item(),
        u_vs_plain_chunk_loop=vs_plain, u_vs_torch_engine=vs_torch,
        tol=FLAG_EPS_TOL, u_tol=EPS_U_TOL)
    check(bool(res.converged.all()) and bool(plain.converged.all())
          and bool(ref.converged.all()),
          "flagship eps: not every scenario converged")
    check(res.residual.max().item() <= FLAG_EPS_TOL + EPS_SLACK,
          f"flagship eps residual {out['eps_flat_off']}")
    check(vs_plain["agree"] >= 0.9 * FLAG_BATCH,
          f"flagship eps u vs the plain chunk loop {vs_plain}")

    # a restart Controller serving 256 plants, 20 warm steps
    problem = tg.problems.battery(**FLAGSHIP)
    ctl = tg.Controller(problem, config=tg.SolverConfig(
        iterations=RESTART_ITERS, restart=True), device=DEVICE)
    A = np.asarray(problem.A, dtype=np.float32)
    Bm = np.asarray(problem.B, dtype=np.float32)
    x = X0np.copy()
    spread0 = float(np.mean(x.max(1) - x.min(1)))
    moves = {"max_abs_u": [], "max_abs_sum_u": [], "excess_over_residual": []}
    step_ms = []

    def serve():
        nonlocal x
        for _ in range(FLAG_SERVE_STEPS):
            t0 = time.perf_counter()
            u = ctl.step(x)  # returns host NumPy: the device work is done
            step_ms.append((time.perf_counter() - t0) * 1e3)
            residual = ctl.last_result.residual.cpu().numpy()
            excess = np.maximum(np.abs(u).max(1) - 0.3, np.abs(u.sum(1)))
            moves["max_abs_u"].append(float(np.abs(u).max()))
            moves["max_abs_sum_u"].append(float(np.abs(u.sum(1)).max()))
            moves["excess_over_residual"].append(float((excess - residual).max()))
            x = x @ A.T + u @ Bm.T

    leg("serving", serve, {"gpad_dual_tiled": FLAG_SERVE_STEPS})
    spread = float(np.mean(x.max(1) - x.min(1)))
    settled = moves["excess_over_residual"][FLAG_SERVE_SETTLE:]
    out["serving"].update(
        plants=FLAG_BATCH, steps=FLAG_SERVE_STEPS, iterations=RESTART_ITERS,
        **moves, mean_spread=[spread0, spread],
        step_ms_host_clock={"median": float(np.median(step_ms[1:])),
                            "max": float(np.max(step_ms[1:])),
                            "first": step_ms[0]})
    check(max(settled) <= SW_RESIDUAL_TOL,
          f"settled moves beyond their residual of the limits: {settled}")
    check(spread < spread0, f"SoC spread did not shrink: {spread0} -> {spread}")

    # the CLI in process
    def run_cli(argv):
        buf = textio.StringIO()
        with contextlib.redirect_stdout(buf):
            check(cli.main(argv) == 0, f"cli {argv[0]} failed")
        return json.loads(buf.getvalue().strip().splitlines()[-1])

    shape = ["--cells", "30", "--horizon", "30", "--device", DEVICE]
    loop = leg("closedloop", lambda: run_cli(
        ["closedloop", *shape, "--restart", "--warm-start", "--steps",
         str(FLAG_CLI_STEPS)]), {"gpad_dual_tiled": FLAG_CLI_STEPS})
    out["closedloop"].update(loop)
    check(loop["engine"] == "cuda" and np.isfinite(loop["final_state"]).all(),
          f"closedloop {loop}")
    info = leg("info", lambda: run_cli(["info", *shape]), {})
    info_restart = leg("info_restart", lambda: run_cli(
        ["info", *shape, "--restart"]), {})
    out["info"].update(info)
    out["info_restart"].update(info_restart)
    check((info["resolved_engine"], info["resolved_form"], info["kernel"])
          == ("cuda", "mvp+flat", "flat_tiled"), f"info routing {info}")
    check((info_restart["resolved_engine"], info_restart["resolved_form"],
           info_restart["kernel"]) == ("cuda", "dual", "dual_tiled"),
          f"info --restart routing {info_restart}")
    out["launches"] = total
    emit(out)
    return total


def phase_tiled_timing(torch, tg, kernels, dual_kernels, core, smi):
    """CUDA events, median of 5 calls per turn, two turns in opposite
    orders, at the flagship B256 x 100: each tiled kernel (the dual one
    fixed and under restart, and one 10-iteration restart window), its
    plain version, the torch engine on the same configuration, the solves
    through ``auto``, and ``solve_to_accuracy``."""
    from tpu_gpad_torch.utils import device_time_per_call

    _, flag = flagship(tg)
    B = FLAG_BATCH
    _, X0 = flag_x0(torch, flag.n_x, B, seed=53)
    g, p = core.affine_params(flag, X0)
    c = dual_kernels.relu_offsets(flag, g, p)
    zero = torch.zeros((B, 2, flag.m_half), device=DEVICE)
    state = dual_kernels.gpad_dual_chunk_torch(
        flag, c, zero, zero, torch.zeros((B, flag.m_half), device=DEVICE),
        torch.ones((B, 2), device=DEVICE), k0=0, chunk=30, restart=True)[:4]
    win = dict(k0=30, chunk=10, restart=True)
    S = tg.SolverConfig
    eps = dict(tol=FLAG_EPS_TOL, flat="off")
    runs = {
        "dual": lambda: dual_kernels.gpad_fixed_dual_tiled(flag, g, p,
                                                           iterations=ITERS),
        "dual_plain": lambda: dual_kernels.gpad_fixed_dual_torch(
            flag, g, p, iterations=ITERS),
        "dual_torch_engine": lambda: tg.solve_batch(
            flag, X0, S(form="dual", engine="torch")),
        "dual_restart": lambda: dual_kernels.gpad_fixed_dual_tiled(
            flag, g, p, iterations=ITERS, restart=True),
        "dual_restart_plain": lambda: dual_kernels.gpad_fixed_dual_torch(
            flag, g, p, iterations=ITERS, restart=True),
        "restart_auto": lambda: tg.solve_batch(flag, X0, S(restart=True)),
        "restart_torch_engine": lambda: tg.solve_batch(
            flag, X0, S(restart=True, engine="torch")),
        "flat": lambda: kernels.gpad_fixed_flat_tiled(flag, g, p,
                                                      iterations=ITERS),
        "flat_plain": lambda: kernels.gpad_fixed_paired_flat_torch(
            flag, g, p, iterations=ITERS),
        "forced_mvp": lambda: tg.solve_batch(flag, X0, S(engine="cuda",
                                                         form="mvp")),
        "default_auto": lambda: tg.solve_batch(flag, X0),
        "default_torch_engine": lambda: tg.solve_batch(flag, X0,
                                                       S(engine="torch")),
        "window": lambda: dual_kernels.gpad_dual_tiled_chunk(flag, c, *state,
                                                             **win),
        "window_plain": lambda: dual_kernels.gpad_dual_chunk_torch(
            flag, c, *state, **win),
        # the torch engine over a window's work: 10 restart iterations
        "window_torch_engine": lambda: tg.solve_batch(
            flag, X0, S(iterations=10, restart=True, form="dual",
                        engine="torch")),
        "eps_auto": lambda: tg.solve_to_accuracy(flag, X0, **eps),
        "eps_torch": lambda: tg.solve_to_accuracy(flag, X0, engine="torch",
                                                  **eps),
    }
    ms = {k: [] for k in runs}
    order = list(runs)
    for turn in (order, order[::-1]):
        for k in turn:
            ms[k].append(device_time_per_call(runs[k], warmup=1, repeats=5) * 1e3)
    med = {k: float(np.mean(v)) for k, v in ms.items()}
    m_h, n_z, n_s = flag.m_half, flag.n_z, flag.n_struct
    # the dual loop's product w D per scenario and iteration (2 m_h^2), plus
    # the offsets g_P GL_T and the recovery s MG_T once per solve; the flat
    # loop's two products, MG_T over every row and GL_T's n_s struct columns;
    # z, y, w, zhat written once
    dual_io = 4 * B * (2 * n_z + 4 * m_h)
    med["dual_bound"] = bound(
        B * (ITERS * 2.0 * m_h * m_h + 4.0 * m_h * n_z),
        nbytes(flag.D, flag.GL_T, flag.MG_T, g, p) + dual_io)
    med["flat_bound"] = paired_bound(flag, g, p, B)
    med["window_bound"] = bound(
        B * 10 * 2.0 * m_h * m_h,
        nbytes(flag.D, c, *state) + nbytes(*state) + 4 * B * 2 * m_h)
    emit({"phase": "tiled_timing", "gpu": smi, "batch": B, "iterations": ITERS,
          "window": 10, "shape": [n_z, m_h, n_s],
          "log2_tile": {"dual": dual_kernels.pick_tiled_tiles(m_h, B),
                        "flat": kernels.pick_flat_tiled(m_h, n_z, B)},
          "dual_cluster": dual_kernels.pick_tiled_cluster(
              dual_kernels.pick_tiled_tiles(m_h, B), B),
          "dual_bound": med["dual_bound"], "flat_bound": med["flat_bound"],
          "window_bound": med["window_bound"],
          "ms_median_of_5_per_turn": ms,
          "note": "eps_* are CUDA-event times of whole solve_to_accuracy "
                  "calls, host syncs between windows included; default_auto "
                  "runs the flat tiled kernel",
          "solves_per_s": {k: B / med[k] * 1e3 for k in runs
                           if not k.startswith("window")}})
    return med


def sweep_tiled(torch, tg, kernels, dual_kernels, core, smi):
    """``python3 chip_smoke.py --sweep``: each tiled kernel's time by tile
    and cluster, 100 fixed iterations: the dual kernel by scenarios per
    cluster (2**log2) and blocks per cluster at the flagship, B 1, 64, 256
    and 1024; the flat one likewise at the flagship, B 1, 256 and 1024, and
    at n5 N30, B256. CUDA events, median of 3 calls after one warm-up."""
    from tpu_gpad_torch.utils import device_time_per_call

    _, flag = flagship(tg)
    m_h = flag.m_half
    for B in (1, SW_SERVE_PLANTS, FLAG_BATCH, 1024):
        g, p = core.affine_params(flag, flag_x0(torch, flag.n_x, B, seed=54)[1])
        row = {}
        for log2 in range(dual_kernels.DUAL_TILED_MAX_LOG2_TILE + 1):
            if log2 and 1 << (log2 - 1) >= B:
                continue  # no scenario of the tile's upper half exists
            for cl in (4, 8, 16):
                row[f"{log2}/{cl}"] = device_time_per_call(
                    lambda: dual_kernels.gpad_fixed_dual_tiled(
                        flag, g, p, iterations=ITERS, log2_tile=log2,
                        cluster=cl), warmup=1, repeats=3) * 1e3
        pick = dual_kernels.pick_tiled_tiles(m_h, B)
        emit({"phase": "tiled_tile_sweep", "gpu": smi, "kernel": "dual_tiled",
              "batch": B, "iterations": ITERS,
              "default": f"{pick}/{dual_kernels.pick_tiled_cluster(pick, B)}",
              "ms_by_log2_tile_per_cluster": row})
    # the flat tiled kernel by scenarios per cluster (2**log2) and blocks
    # per cluster, at the flagship and at n5 N30
    for shape, label, batches in ((FLAGSHIP, "flagship", (1, FLAG_BATCH, 1024)),
                                  (TILED_MID, "n5_N30", (FLAG_BATCH,))):
        _, d = flagship(tg, shape)
        for B in batches:
            g, p = core.affine_params(d, flag_x0(torch, d.n_x, B, seed=55)[1])
            row = {}
            for log2 in range(kernels.FLAT_TILED_MAX_LOG2_TILE + 1):
                if log2 and 1 << (log2 - 1) >= B:
                    continue
                for cl in (4, 8, 16):
                    if kernels.pick_flat_tiled(d.m_half, d.n_z, B, log2,
                                               cl) is None:
                        continue
                    row[f"{log2}/{cl}"] = device_time_per_call(
                        lambda: kernels.gpad_fixed_flat_tiled(
                            d, g, p, iterations=ITERS, log2_tile=log2,
                            cluster=cl), warmup=1, repeats=3) * 1e3
            emit({"phase": "tiled_tile_sweep", "gpu": smi,
                  "kernel": "flat_tiled", "shape": label, "batch": B,
                  "iterations": ITERS,
                  "default": kernels.pick_flat_tiled(d.m_half, d.n_z, B),
                  "ms_by_log2_tile_per_cluster": row})


def sweep_dense_tiled(torch, tg, kernels, core, smi):
    """The tiled dense kernel by plan (``--sweep dense_tiled``, and with
    ``tiled``): at the flagship's dense layout B 1, 64, 256 and 1024 and at
    n5 N20 and n10 N20 B256, every scenario tile the batch fills, each with
    the pick's parts and with one part, half and twice the pick's in each
    phase (profiler device ms of 100 iterations); the measurement behind
    ``kernels.pick_dense_tiled``'s model."""
    cases = [(FLAGSHIP, B) for B in (1, 64, ROUTE_BATCH, 1024)] + [
        (DENSE_MID, ROUTE_BATCH), (DENSE_WIDE, ROUTE_BATCH)]
    for shape, B in cases:
        d = route_data(tg, "dense_tiled", shape)[1]
        g, p = core.affine_params(d, flag_x0(torch, d.n_x, B, seed=56)[1])
        kt_a, kt_b = -(-d.m // 32), -(-d.n_z // 32)
        pick = kernels.pick_dense_tiled(d.m, d.n_z, B)
        row = {}
        for tile in kernels.DENSE_TILED_TILES:
            if tile > max(16, 1 << max(B - 1, 0).bit_length()):
                continue
            own = kernels.pick_dense_tiled(d.m, d.n_z, B, tile=tile)
            pa, pb = own.parts_a, own.parts_b
            for parts in {(pa, pb), (1, 1), (max(1, pa // 2), pb),
                          (min(kt_a, 2 * pa), pb), (pa, max(1, pb // 2)),
                          (pa, min(kt_b, 2 * pb))}:
                row[f"{tile}/{parts[0]}/{parts[1]}"] = profiled_ms(
                    torch, lambda: kernels.gpad_fixed_dense_tiled(
                        d, g, p, iterations=ITERS, tile=tile,
                        parts_a=parts[0], parts_b=parts[1]),
                    ROUTE_FNS["dense_tiled"][2])
        emit({"phase": "dense_tiled_sweep", "gpu": smi,
              "shape": shape_label(shape), "m": d.m, "n_z": d.n_z,
              "batch": B, "iterations": ITERS, "pick": pick._asdict(),
              "ms_by_tile_parts_a_parts_b": row})


# ---------------------------------------------------------------------------
# the dense and full paired loops past one block's shared memory
# ---------------------------------------------------------------------------

ROUTE_FNS = {"dense_tiled": ("gpad_fixed_dense_tiled",
                             "gpad_fixed_dense_torch",
                             "gpad_dense_tiled_kernel"),
             "paired_tiled": ("gpad_fixed_paired_tiled",
                              "gpad_fixed_paired_torch",
                              "gpad_flat_tiled_kernel"),
             "flat_tiled": ("gpad_fixed_flat_tiled",
                            "gpad_fixed_paired_flat_torch",
                            "gpad_flat_tiled_kernel")}
# the configuration of each route's solve (auto, forced, the torch engine)
ROUTE_CFG = {"dense_tiled": {}, "paired_tiled": dict(form="mvp", flat="off"),
             "flat_tiled": {}}


def shape_label(shape) -> str:
    return "n{n_cells}_N{horizon}".format(**shape)


def route_data(tg, route, shape):
    """(qp, data) of a tiled route's battery ``shape`` on the card: dense
    layout for "dense_tiled", paired for "paired_tiled" and "flat_tiled"."""
    return flagship(tg, shape, paired=False if route == "dense_tiled"
                    else "auto")


def route_plan(kernels, route, d, B) -> dict:
    """A tiled route's launch plan at B scenarios: the tiled dense kernel's
    (``pick_dense_tiled``: tile, parts, units a phase), the flat tiled
    kernel's (``pick_flat_tiled``) for the paired route."""
    if route == "dense_tiled":
        return kernels.pick_dense_tiled(d.m, d.n_z, B)._asdict()
    return kernels.pick_flat_tiled(d.m_half, d.n_z, B)._asdict()


def dense_tiled_layout(torch, kernels, d, B) -> dict:
    """The tiled dense kernel's plan at B on this card, with the blocks an
    SM holds of its instance and the SMs its phases' units use, beside the
    plan of the cluster design it replaced (the flat tiled kernel's plan at
    m, ``pick_flat_tiled``) and the clusters of that plan the card holds at
    once (cudaOccupancyMaxActiveClusters, measured on the flat tiled
    kernel, whose blocks are that design's at the same shared memory)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = kernels.pick_dense_tiled(d.m, d.n_z, B, sms=sms)
    old = kernels.pick_flat_tiled(d.m, d.n_z, B)
    clusters = -(-B // (1 << old.log2_tile))
    return {"plan": plan._asdict(), "sms": sms,
            "blocks_per_sm": kernels.dense_tiled_blocks_per_sm(plan.tile),
            "sms_used": {"a": min(sms, plan.units_a), "b": min(sms, plan.units_b)},
            "cluster_design": {**old._asdict(), "clusters": clusters,
                               "blocks": clusters * old.cluster,
                               "max_active_clusters":
                                   kernels.flat_tiled_max_clusters(
                                       old, d.m, d.n_z)}}


def phase_tiled_routes_vs_plain(torch, tg, kernels, dual_kernels, core):
    """The tiled dense kernel against its plain version
    (``gpad_fixed_dense_torch``) at battery n5 N20 (m 440): B4096 cold,
    warm per scenario and shared, diagnostics off (the iterates bit for bit
    those with it on), then B256, a ragged B300 and B1 warm; at n10 N20
    B256 and at the flagship's dense layout B256, a ragged B130 and B1;
    two launches bit-equal at each shape; its plan, the SMs it uses and the
    cluster design's plan beside it (``dense_tiled_layout``) and its ptxas
    lines; the paired tiled route (the flat tiled kernel at n_s = m_h)
    against ``gpad_fixed_paired_torch`` at n5 N30 and n10 N30 B256, cold
    and warm, diagnostics off. Then each under every tier against its
    plain version at the tier (``tier_kernel_vs_plain``: one iteration and
    z within TIER_KERNEL_TOL, every output within TIER_SENSITIVITY x the
    plain version's own spread): the tiled dense kernel at n5 N20, n10 N20
    and the flagship B256, the flagship's B130 and n5 N20's B1; the paired
    tiled route at n5 N30 B256."""
    from tpu_gpad_torch import cuda_build

    t_phase = time.perf_counter()
    errs = {"dense_tiled": {}, "paired_tiled": {}}
    bitwise, plans, tiers, repeat = {}, {}, {}, {}

    def run(route, name, d, g, p, y0=None, diagnostics=True):
        fn, plain = (getattr(kernels, f) for f in ROUTE_FNS[route][:2])
        kw = dict(iterations=ITERS, diagnostics=diagnostics)
        out_k = fn(d, g, p, y0, **kw)
        out_p = plain(d, g, p, y0, **kw)
        torch.cuda.synchronize()
        for t in out_k:
            if t is not None:
                check(bool(torch.isfinite(t).all()),
                      f"{route} {name}: output not finite")
        if not diagnostics:
            check(out_k[2] is None and out_k[3] is None,
                  f"{route} {name}: diagnostics=False returned w/zhat")
        errs[route][name] = max_err(out_k, out_p)
        if route == "dense_tiled":  # a second launch, bit for bit
            again = fn(d, g, p, y0, **kw)
            repeat[name] = all(a is None or torch.equal(a, b)
                               for a, b in zip(out_k, again))
        return out_k

    for route, cases in (("dense_tiled", ((DENSE_MID, BATCH), (DENSE_WIDE,
                                           ROUTE_BATCH), (FLAGSHIP,
                                                          ROUTE_BATCH))),
                         ("paired_tiled", ((TILED_MID, ROUTE_BATCH),
                                           (PAIRED_WIDE, ROUTE_BATCH)))):
        for shape, B in cases:
            _, d = route_data(tg, route, shape)
            label = shape_label(shape)
            g, p = core.affine_params(d, flag_x0(torch, d.n_x, B, seed=70)[1])
            plans[f"{route}_{label}"] = route_plan(kernels, route, d, B)
            y = run(route, f"{label}_cold", d, g, p)[1]
            on = run(route, f"{label}_warm_per_scenario", d, g, p, y)
            off = run(route, f"{label}_no_diagnostics", d, g, p, y,
                      diagnostics=False)
            bitwise[f"{route}_{label}"] = (torch.equal(on[0], off[0])
                                           and torch.equal(on[1], off[1]))
            # the serving batch, a ragged last tile, one scenario
            extra = ((ROUTE_BATCH, 300, 1) if B == BATCH
                     else (ROUTE_RAGGED_BATCH, 1) if shape is FLAGSHIP else ())
            if B == BATCH:
                run(route, f"{label}_warm_shared", d, g, p, y[0].contiguous())
            for b in extra:
                plans[f"{route}_{label}_B{b}"] = route_plan(kernels, route,
                                                            d, b)
                run(route, f"{label}_B{b}", d, g[:b].contiguous(),
                    p[:b].contiguous(), y[:b].contiguous())
    layout = {}
    for shape, B in ((FLAGSHIP, ROUTE_BATCH), (FLAGSHIP, 1),
                     (DENSE_WIDE, ROUTE_BATCH), (DENSE_MID, ROUTE_BATCH)):
        d = route_data(tg, "dense_tiled", shape)[1]
        layout[f"{shape_label(shape)}_B{B}"] = dense_tiled_layout(
            torch, kernels, d, B)
    for route, shape, B in (("dense_tiled", DENSE_MID, ROUTE_BATCH),
                            ("dense_tiled", DENSE_WIDE, ROUTE_BATCH),
                            ("dense_tiled", FLAGSHIP, ROUTE_BATCH),
                            ("dense_tiled", FLAGSHIP, ROUTE_RAGGED_BATCH),
                            ("dense_tiled", DENSE_MID, 1),
                            ("paired_tiled", TILED_MID, ROUTE_BATCH)):
        _, d = route_data(tg, route, shape)
        g, p = core.affine_params(d, flag_x0(torch, d.n_x, B, seed=71)[1])
        tiers[f"{route}_{shape_label(shape)}_B{B}"] = {
            tier: tier_kernel_vs_plain(torch, kernels, dual_kernels, d, g, p,
                                       tier, (route,), None)
            for tier in TIER_KERNEL_TOL}
    worst = {route: max(e.values()) for route, e in errs.items()}
    emit({"phase": "tiled_routes_vs_plain", "plans": plans,
          "dense_tiled_layout": layout,
          "dense_tiled_ptxas": [
              ln.strip() for ln in cuda_build.BUILD_LOG.get(
                  "gpad_dense_tiled", "").splitlines()
              if "registers" in ln or "spill" in ln],
          "max_abs_err": errs, "diagnostics_off_bit_identical": bitwise,
          "dense_tiled_two_launches_bit_equal": repeat,
          "tiers": tiers, "tol": KERNEL_TOL,
          "phase_s": time.perf_counter() - t_phase})
    check(max(worst.values()) <= KERNEL_TOL,
          f"tiled routes disagree with their plain versions: {errs}")
    check(all(bitwise.values()),
          f"diagnostics=False changed the iterates {bitwise}")
    check(all(repeat.values()), f"two tiled dense launches differ {repeat}")
    # the plan PERF.md times at the flagship's dense layout B256
    flag = plans[f"dense_tiled_{shape_label(FLAGSHIP)}"]
    check((flag["tile"], flag["parts_a"], flag["parts_b"]) == (64, 4, 1),
          f"flagship dense plan {flag}, expected tiles of 64, parts 4 x 1")
    return worst


def phase_tiled_routes_path(torch, tg, kernels, core, reference, ctr):
    """The new routes through the entry points, each leg counted from 0:
    ``solve_batch(engine="auto")`` on the dense n10 N20 layout, B256 (one
    tiled dense launch, u* against the NumPy oracle); a dense
    ``Controller`` serving 256 plants at n5 N20 (one launch a step, moves
    within the limits up to the solve's residual); ``solve_multi`` over
    ROUTE_PLANTS dense n5 N20 plants (one launch a plant, each plant's
    first u* against the oracle on its QP); a ``flat="off"`` solve at n10
    N30 (the paired tiled route, one launch of the flat tiled kernel at
    n_s = m_h, u* against the oracle and the torch engine); the CLI's
    ``solve --paired off`` and ``info --paired off`` at n5 N20 in
    process; auto on the dense n10 N20 layout at B4096 (one launch); and
    the default (flat) solve at n10 N30 B ROUTE_EDGE_BATCH, past auto's
    flat tiled work edge (the torch engine, no launch). Returns the
    launches by leg."""
    import contextlib
    import io as textio

    from tpu_gpad_torch import cli
    from tpu_gpad_torch.solver.multi import solve_multi

    t_phase = time.perf_counter()
    out = {"phase": "tiled_routes_path"}
    legs = {}

    def leg(name, fn, expect):
        res, got = counted(torch, ctr, fn, expect, f"tiled routes {name}")
        legs[name] = got
        return res

    def oracle_err(qp, X0np, u, n=4):
        return [float(np.abs(u[i].cpu().numpy() - reference.gpad_solve_qp(
            qp, X0np[i].astype(np.float64), ITERS).u).max()) for i in range(n)]

    qp, dense = route_data(tg, "dense_tiled", DENSE_WIDE)
    X0np, X0 = flag_x0(torch, dense.n_x, ROUTE_BATCH, seed=72)
    cfg = tg.SolverConfig()
    res = leg("auto_dense_n10_N20", lambda: tg.solve_batch(dense, X0, cfg),
              {"gpad_dense_tiled": 1})
    out["auto_dense_n10_N20"] = {
        "engine": core.resolve_engine(dense, cfg, ROUTE_BATCH),
        "kernel": core.cuda_kernel(dense, cfg, ROUTE_BATCH), "m": dense.m,
        "u_vs_oracle": oracle_err(qp, X0np, res.u),
        "residual_max": res.residual.max().item()}
    check(out["auto_dense_n10_N20"]["kernel"] == "dense_tiled"
          and max(out["auto_dense_n10_N20"]["u_vs_oracle"]) < ORACLE_TOL,
          f"auto dense n10 N20 {out['auto_dense_n10_N20']}")
    # at B4096 too (the cluster design tied the torch engine there; the
    # redesigned kernel beat it at every measured batch)
    big = flag_x0(torch, dense.n_x, 4096, seed=72)[1]
    leg("auto_dense_n10_N20_B4096", lambda: tg.solve_batch(dense, big, cfg),
        {"gpad_dense_tiled": 1})

    problem = tg.problems.battery(**DENSE_MID)
    ctl = tg.Controller(problem, iterations=ITERS, paired=False, device=DEVICE)
    A = np.asarray(problem.A, dtype=np.float32)
    Bm = np.asarray(problem.B, dtype=np.float32)
    x = flag_x0(torch, problem.n_x, SERVE_PLANTS, seed=73)[0]
    moves = {"max_abs_u": 0.0, "max_abs_sum_u": 0.0,
             "excess_over_residual": -np.inf}
    step_ms = []

    def serve():
        nonlocal x
        for _ in range(ROUTE_SERVE_STEPS):
            t0 = time.perf_counter()
            u = ctl.step(x)  # returns host NumPy: the device work is done
            step_ms.append((time.perf_counter() - t0) * 1e3)
            residual = ctl.last_result.residual.cpu().numpy()
            excess = np.maximum(np.abs(u).max(1) - 0.3, np.abs(u.sum(1)))
            for k, v in (("max_abs_u", np.abs(u).max()),
                         ("max_abs_sum_u", np.abs(u.sum(1)).max()),
                         ("excess_over_residual", (excess - residual).max())):
                moves[k] = max(moves[k], float(v))
            x = x @ A.T + u @ Bm.T

    leg("dense_controller_n5_N20", serve,
        {"gpad_dense_tiled": ROUTE_SERVE_STEPS})
    out["dense_controller_n5_N20"] = dict(
        plants=SERVE_PLANTS, steps=ROUTE_SERVE_STEPS, **moves,
        step_ms_host_clock={"median": float(np.median(step_ms[1:])),
                            "first": step_ms[0]})
    # 100 fixed iterations leave a residual: each plant's moves past the
    # limits by no more than its solve's residual
    check(np.isfinite(x).all()
          and moves["excess_over_residual"] <= SW_RESIDUAL_TOL,
          f"dense Controller n5 N20 {out['dense_controller_n5_N20']}")

    caps = np.linspace(0.08, 0.15, ROUTE_PLANTS)
    qps = [tg.condense(tg.problems.battery(**DENSE_MID, cell_capacity_ah=c))
           for c in caps]
    datas = [tg.dualize(q, ITERS, paired=False, device=DEVICE) for q in qps]
    X0m = np.random.default_rng(74).uniform(
        -0.4, 0.4, (ROUTE_PLANTS, ROUTE_BATCH, qps[0].n_x)).astype(np.float32)
    res = leg("multi_n5_N20", lambda: solve_multi(datas, X0m),
              {"gpad_dense_tiled": ROUTE_PLANTS})
    oracle = [float(np.abs(res.u[p, 0].cpu().numpy() - reference.gpad_solve_qp(
        qps[p], X0m[p, 0].astype(np.float64), ITERS).u).max())
        for p in range(ROUTE_PLANTS)]
    out["multi_n5_N20"] = {"plants": ROUTE_PLANTS, "batch": ROUTE_BATCH,
                           "u_vs_oracle": oracle}
    check(bool(torch.isfinite(res.u).all()) and max(oracle) < ORACLE_TOL,
          f"solve_multi n5 N20 {out['multi_n5_N20']}")

    qp, wide = route_data(tg, "paired_tiled", PAIRED_WIDE)
    X0np, X0 = flag_x0(torch, wide.n_x, ROUTE_BATCH, seed=75)
    cfg = tg.SolverConfig(form="mvp", flat="off")
    res = leg("flat_off_n10_N30", lambda: tg.solve_batch(wide, X0, cfg),
              {"gpad_paired_tiled": 1})
    plain = tg.solve_batch(wide, X0, dataclasses.replace(cfg, engine="torch"))
    out["flat_off_n10_N30"] = {
        "kernel": core.cuda_kernel(wide, cfg, ROUTE_BATCH),
        "m_half": wide.m_half,
        "u_vs_oracle": oracle_err(qp, X0np, res.u),
        "u_vs_torch_engine": (res.u - plain.u).abs().max().item()}
    check(max(out["flat_off_n10_N30"]["u_vs_oracle"]) < ORACLE_TOL
          and out["flat_off_n10_N30"]["u_vs_torch_engine"] < ORACLE_TOL,
          f"flat off n10 N30 {out['flat_off_n10_N30']}")
    # the default (flat) solve past auto's flat tiled work edge runs the
    # torch engine: no launch
    big = flag_x0(torch, wide.n_x, ROUTE_EDGE_BATCH, seed=75)[1]
    leg("auto_flat_n10_N30_past_edge",
        lambda: tg.solve_batch(wide, big, tg.SolverConfig()), {})
    out["auto_flat_n10_N30_past_edge"] = {
        "batch": ROUTE_EDGE_BATCH,
        "kernel": core.cuda_kernel(wide, tg.SolverConfig(), ROUTE_EDGE_BATCH),
        "kernel_at_256": core.cuda_kernel(wide, tg.SolverConfig(),
                                          ROUTE_BATCH)}
    check(out["auto_flat_n10_N30_past_edge"] == {
        "batch": ROUTE_EDGE_BATCH, "kernel": None,
        "kernel_at_256": "flat_tiled"},
        f"auto flat n10 N30 past the edge {out}")

    def run_cli(argv):
        buf = textio.StringIO()
        with contextlib.redirect_stdout(buf):
            check(cli.main(argv) == 0, f"cli {argv[0]} failed")
        return json.loads(buf.getvalue().strip().splitlines()[-1])

    shape = ["--cells", "5", "--horizon", "20", "--paired", "off",
             "--device", DEVICE]
    solved = leg("cli_solve_paired_off", lambda: run_cli(
        ["solve", *shape, "--batch", str(ROUTE_BATCH)]),
        {"gpad_dense_tiled": 1})
    info = leg("cli_info_paired_off", lambda: run_cli(["info", *shape]), {})
    out["cli"] = {"solve_engine": solved["engine"],
                  "info_kernel": info["kernel"],
                  "info_engine": info["resolved_engine"]}
    check(solved["engine"] == "cuda" and info["kernel"] == "dense_tiled",
          f"cli --paired off {out['cli']}")
    out["launches"] = legs
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return legs


def route_bound(d, g, p, B, tier="highest", flat=False) -> dict:
    """A tiled route's bound at B scenarios: the dense loop's two products
    (2 m n_z each) or the full (or ``flat``) paired loop's
    (``paired_bound``), per scenario and iteration, at the tier's peak; z,
    y, w, zhat written once."""
    if d.paired:
        return paired_bound(d, g, p, B, full=not flat, tier=tier)
    return bound(B * ITERS * 4.0 * d.m * d.n_z,
                 nbytes(d.MG_T, d.GL_T, g, p, d.theta[:ITERS], d.beta[:ITERS])
                 + 4 * B * (2 * d.n_z + 2 * d.m), tier)


def route_runs(torch, tg, kernels, core, route, shape, B, seed):
    """(data, runs, bound) of a tiled route at battery ``shape``, B
    scenarios x 100: the kernel's wrapper, its plain version, and the
    solves through ``auto`` (its ``engine="cuda"`` route where auto takes
    the torch engine) and the torch engine on the same configuration."""
    _, d = route_data(tg, route, shape)
    X0 = flag_x0(torch, d.n_x, B, seed)[1]
    g, p = core.affine_params(d, X0)
    fn, plain = (getattr(kernels, f) for f in ROUTE_FNS[route][:2])
    S = tg.SolverConfig
    kw = ROUTE_CFG[route]
    return d, {
        "kernel": lambda: fn(d, g, p, iterations=ITERS),
        "plain": lambda: plain(d, g, p, iterations=ITERS),
        "auto": lambda: tg.solve_batch(d, X0, S(**kw)),
        "forced": lambda: tg.solve_batch(d, X0, S(engine="cuda", **kw)),
        "torch_engine": lambda: tg.solve_batch(d, X0, S(engine="torch", **kw)),
    }, route_bound(d, g, p, B, flat=route == "flat_tiled")


def two_products_ms(torch, d, B, flat=False, seed=78) -> float:
    """The yardstick of what the card's library does with an iteration's
    two products: ms of 100 x (w MG_T, zhat GL_T) as two ``torch.mm``
    calls with TF32 off, at the route's shapes (dense: w (B, m); paired:
    wd (B, m_h), GL_T's n_struct columns on the flat route, all m_h on the
    full paired one), CUDA events. The port never calls it."""
    from tpu_gpad_torch.utils import device_time_per_call

    rows = d.m_half if d.paired else d.m
    cols = d.n_struct if flat else rows
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    w = torch.rand((B, rows), device=DEVICE, generator=gen)
    zh = torch.rand((B, d.n_z), device=DEVICE, generator=gen)
    GL = d.GL_T[:, :cols].contiguous()
    out1 = torch.empty((B, d.n_z), device=DEVICE)
    out2 = torch.empty((B, cols), device=DEVICE)
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 is on")

    def run():
        for _ in range(ITERS):
            torch.mm(w, d.MG_T, out=out1)
            torch.mm(zh, GL, out=out2)

    return device_time_per_call(run, warmup=1, repeats=3) * 1e3


def route_times(torch, tg, kernels, core, route, shape, B, which, seed=76):
    """The named runs of ``route_runs`` in two turns of opposite order
    (CUDA events, median of 5 calls a turn), the kernel's device time from
    the profiler, and the bound."""
    from tpu_gpad_torch.utils import device_time_per_call

    d, runs, bnd = route_runs(torch, tg, kernels, core, route, shape, B, seed)
    ms = {k: [] for k in which}
    for turn in (list(which), list(which)[::-1]):
        for k in turn:
            ms[k].append(device_time_per_call(runs[k], warmup=1, repeats=5)
                         * 1e3)
    cfg = tg.SolverConfig(**ROUTE_CFG[route])
    return {"m": d.m_half if d.paired else d.m, "n_z": d.n_z, "batch": B,
            "auto_kernel": core.cuda_kernel(d, cfg, batch=B),
            "plan": route_plan(kernels, route, d, B),
            "device_ms": profiled_ms(torch, runs["kernel"],
                                     ROUTE_FNS[route][2]),
            "two_torch_mm_ms": two_products_ms(
                torch, d, B, flat=route == "flat_tiled"),
            "ms_median_of_5_per_turn": ms,
            "ms": {k: float(np.mean(v)) for k, v in ms.items()}, **bnd}


ROUTE_TIMED = (("dense_tiled", DENSE_MID), ("dense_tiled", DENSE_WIDE),
               ("dense_tiled", FLAGSHIP), ("paired_tiled", TILED_MID),
               ("paired_tiled", PAIRED_WIDE))


def phase_tiled_routes_timing(torch, tg, kernels, core, smi):
    """Each tiled route at B256 x 100 at ROUTE_TIMED's shapes: the
    kernel's device time (profiler), its wrapper, its plain version, the
    solve through ``auto`` and the torch engine on the same configuration
    (CUDA events, two turns), and the bound."""
    t_phase, out = time.perf_counter(), {}
    for route, shape in ROUTE_TIMED:
        key = f"{route}_{shape_label(shape)}"
        out[key] = route_times(torch, tg, kernels, core, route, shape,
                               ROUTE_BATCH, ("kernel", "plain", "auto",
                                             "torch_engine"))
    emit({"phase": "tiled_routes_timing", "gpu": smi, "iterations": ITERS,
          **out, "phase_s": time.perf_counter() - t_phase})
    return out


def times_routes(torch, tg, kernels, core, smi):
    """``python3 chip_smoke.py --times routes``: each tiled route against
    the torch engine x 100 over the gap between the resident kernels'
    guards and tpu_gpad's VMEM guards (ROUTE_GAP), and on to the flagship
    (ROUTE_DENSE_EDGE, ROUTE_PAIRED_EDGE), at each of ROUTE_BATCHES, where
    ``auto``'s edges lie: the kernel's device time (profiler), the solve on
    its route (``engine="cuda"``) and the torch engine in turns (CUDA
    events), with the route ``auto`` takes at that batch and the two
    products of an iteration as two ``torch.mm`` calls x 100
    (``two_products_ms``); the tiled dense route, the paired tiled route
    and the flat tiled route (the default solve past the flat kernel's
    shared memory); then each route under every tier
    (``route_tier_times``)."""
    for route, shapes in (("dense_tiled", ROUTE_GAP + ROUTE_DENSE_EDGE),
                          ("paired_tiled", ROUTE_GAP + ROUTE_PAIRED_EDGE),
                          ("flat_tiled", ROUTE_GAP + ROUTE_PAIRED_EDGE)):
        gap = []
        for n, N in shapes:
            _, d = route_data(tg, route, dict(n_cells=n, horizon=N))
            if (not kernels.dense_fits_smem(d) if route == "dense_tiled"
                    else not kernels.paired_fits_smem(d)
                    if route == "paired_tiled"
                    else kernels.flat_tiled_fits(d)
                    and not kernels.flat_fits_smem(d)):
                gap.append((d.m_half if d.paired else d.m, n, N))
        for B in ROUTE_BATCHES:
            lost = 0
            for rows, n, N in sorted(gap):
                if lost == ROUTE_LOSSES_TO_STOP:
                    emit({"phase": "times_routes", "route": route,
                          "batch": B, "stopped_before": [n, N], "m": rows})
                    break
                row = route_times(torch, tg, kernels, core, route,
                                  dict(n_cells=n, horizon=N), B,
                                  ("forced", "torch_engine"))
                row["kernel_faster"] = row["ms"]["forced"] < row["ms"][
                    "torch_engine"]
                lost = 0 if row["kernel_faster"] else lost + 1
                emit({"phase": "times_routes", "gpu": smi, "route": route,
                      "shape": [n, N], **row})
    route_tier_times(torch, tg, kernels, core, smi)


# --times dense: the tiled dense kernel at these (battery shape, batch)
DENSE_AB = ((FLAGSHIP, 1), (FLAGSHIP, 64), (FLAGSHIP, ROUTE_BATCH),
            (FLAGSHIP, 1024), (DENSE_WIDE, ROUTE_BATCH),
            (DENSE_MID, ROUTE_BATCH))


def times_dense(torch, tg, kernels, core, smi):
    """``python3 chip_smoke.py --times dense``: the tiled dense kernel's
    device time (profiler, 10 calls) x 100 at DENSE_AB through its public
    wrapper alone, its default plan, so that a copy of this script beside
    a checkout of an earlier commit times that commit's kernel (the
    cluster design of ``tiled_mvp.cuh`` before it); each row names the
    design it timed."""
    phases = hasattr(kernels, "pick_dense_tiled")
    for shape, B in DENSE_AB:
        d = tg.dualize(tg.condense(tg.problems.battery(**shape)), ITERS,
                       paired=False, device=DEVICE)
        g, p = core.affine_params(d, flag_x0(torch, d.n_x, B, seed=79)[1])
        ms = profiled_ms(torch, lambda: kernels.gpad_fixed_dense_tiled(
            d, g, p, iterations=ITERS), "gpad_dense_tiled_kernel")
        emit({"phase": "times_dense", "gpu": smi,
              "design": "phases" if phases else "clusters",
              "shape": shape_label(shape), "m": d.m, "n_z": d.n_z,
              "batch": B, "iterations": ITERS, "device_ms": ms,
              "plan": (kernels.pick_dense_tiled(d.m, d.n_z, B)[:3] if phases
                       else kernels.pick_flat_tiled(d.m, d.n_z, B))})


def route_tier_times(torch, tg, kernels, core, smi, B=ROUTE_BATCH):
    """Each tiled route (tiled dense at n10 N20 and the flagship's dense
    layout, paired tiled at n10 N30) at each tier beside "highest", B x 100: profiler device ms in turns
    (highest, tier, tier, highest), the bound at the tier's peak, and the
    plain version's ms at the tier (CUDA events)."""
    from tpu_gpad_torch.utils import device_time_per_call

    for route, shape in (("dense_tiled", DENSE_WIDE),
                         ("dense_tiled", FLAGSHIP),
                         ("paired_tiled", PAIRED_WIDE)):
        _, d = route_data(tg, route, shape)
        g, p = core.affine_params(d, flag_x0(torch, d.n_x, B, 77)[1])
        fn, plain = (getattr(kernels, f) for f in ROUTE_FNS[route][:2])
        name = ROUTE_FNS[route][2]

        def run(f, tier, d=d, g=g, p=p):
            return lambda: f(d, g, p, iterations=ITERS, tier=tier)

        rows = {}
        for tier in TIER_TOL:
            turns = [(t, profiled_ms(torch, run(fn, t), name))
                     for t in ("highest", tier, tier, "highest")]
            bnd = route_bound(d, g, p, B, tier)
            rows[tier] = {
                "ms": [ms for t, ms in turns if t == tier],
                "highest_ms": [ms for t, ms in turns if t == "highest"],
                "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
                "plain_ms": device_time_per_call(
                    run(plain, tier), warmup=1, repeats=3) * 1e3}
        emit({"phase": "route_tier_times", "gpu": smi, "route": route,
              "shape": shape_label(shape), "batch": B,
              "highest_bound_ms": route_bound(d, g, p, B)["bound_ms"],
              "tiers": rows})


# ---------------------------------------------------------------------------
# soft (dual-damped) rows through the tiled kernels
# ---------------------------------------------------------------------------

_SOFT = {}


def soft_data(torch, tg, shape):
    """battery ``shape`` condensed on the card with its state box softened
    (``dualize_ltv_device`` with K_u and soft_state=SOFT_STATE; a schedule
    of SOFT_SCHEDULE iterations), built once. Its parameters are p = [x0;
    r] (``n_x`` is their width)."""
    key = tuple(shape.values())
    if key not in _SOFT:
        from tpu_gpad_torch.device_condense import dualize_ltv_device

        prob = tg.problems.battery(**shape)
        N = prob.horizon
        stack = lambda M: torch.as_tensor(  # noqa: E731
            np.repeat(np.asarray(M, np.float32)[None], N, axis=0),
            device=DEVICE)
        _SOFT[key] = dualize_ltv_device(
            stack(prob.A), stack(prob.B),
            torch.zeros((N, prob.n_x), device=DEVICE), prob.Q, prob.R,
            prob.u_min, prob.u_max, SOFT_SCHEDULE, x_min=prob.x_min,
            x_max=prob.x_max, K_u=prob.K_u, soft_state=SOFT_STATE)
    return _SOFT[key]


def soft_p(torch, shape, B, seed):
    """B parameters p = [x0; 0] of battery ``shape``: x0 within
    SOFT_X0_SPREAD of the reference's default_x0, clipped to
    SOFT_X0_MAX."""
    from tpu_gpad_torch.problems.battery import default_x0

    n = shape["n_cells"]
    x0 = np.clip(default_x0(n, seed)[None] + np.random.default_rng(
        seed).uniform(-SOFT_X0_SPREAD, SOFT_X0_SPREAD, (B, n)),
        -SOFT_X0_MAX, SOFT_X0_MAX)
    P = np.concatenate([x0, np.zeros((B, n))], axis=1).astype(np.float32)
    return torch.as_tensor(P, device=DEVICE)


def seeded_damp(torch, data, seed):
    """``data`` with a seeded damp in [0, SOFT_SEEDED_DAMP] on every row."""
    damp = np.random.default_rng(seed).uniform(
        0.0, SOFT_SEEDED_DAMP, data.m_half).astype(np.float32)
    return dataclasses.replace(data,
                               soft_damp=torch.as_tensor(damp, device=DEVICE))


# the whole-solve kernels that carry soft rows past shared memory
# (``tier_fixed``'s names)
SOFT_FIXED = ("flat_tiled", "paired_tiled", "dual_tiled",
              "dual_tiled_restart")


def phase_tiled_soft_vs_plain(torch, tg, kernels, dual_kernels, core):
    """Soft rows through each tiled kernel against its plain version, on
    data condensed on the card with a seeded damp in [0, 0.5] (od in
    [0.5, 1]) at n5 N30, n10 N30 and the flagship, B256: the flat tiled
    kernel (n_s < m_h), the paired tiled route (n_s = m_h), the tiled dual
    solve cold, warm per scenario and under restart (per scenario,
    ``restart_parting``: 1% may part, or as many as part the plain
    version's own fp32 run from the float64 one), one tiled chunk window
    from k0 = 30 with restart and without; every output within
    KERNEL_TOL. Then soft_damp = 0 (od
    exactly 1) against the hard launch, bit for bit, each kernel at n10
    N30, and each kernel under every tier at n5 N30
    (``tier_kernel_vs_plain``)."""
    t_phase = time.perf_counter()
    B = ROUTE_BATCH
    errs, restart, zero, tiers = {}, {}, {}, {}
    rng = np.random.default_rng(80)

    def window(d, c, rs, k0=30):
        zero_y = torch.zeros((B, 2, d.m_half), device=DEVICE)
        state = dual_kernels.gpad_dual_chunk_torch(
            d, c, zero_y, zero_y, torch.zeros((B, d.m_half), device=DEVICE),
            torch.ones((B, 2), device=DEVICE), k0=0, chunk=k0, restart=rs)[:4]
        return (dual_kernels.gpad_dual_tiled_chunk(d, c, *state, k0=k0,
                                                   chunk=10, restart=rs),
                dual_kernels.gpad_dual_chunk_torch(d, c, *state, k0=k0,
                                                   chunk=10, restart=rs))

    for i, shape in enumerate(SOFT_SHAPES):
        label = shape_label(shape)
        d = seeded_damp(torch, soft_data(torch, tg, shape), 81 + i)
        g, p = core.affine_params(d, flag_x0(torch, d.n_x, B, seed=82 + i)[1])
        y_warm = torch.as_tensor(rng.uniform(0.0, 0.5, (B, 2, d.m_half)),
                                 dtype=torch.float32, device=DEVICE)
        for name, (fn, plain, kw) in tier_fixed(kernels, dual_kernels,
                                                SOFT_FIXED).items():
            starts = ((("cold", None), ("warm", y_warm))
                      if name == "dual_tiled" else (("cold", None),))
            for start, y0 in starts:
                out_k = fn(d, g, p, y0, iterations=ITERS, **kw)
                out_p = plain(d, g, p, y0, iterations=ITERS, **kw)
                torch.cuda.synchronize()
                check(all(bool(torch.isfinite(t).all()) for t in out_k),
                      f"soft {name} {label}: output not finite")
                if kw.get("restart"):
                    restart[label] = restart_parting(torch, d, g, p, y0,
                                                     out_k[0], out_p[0])
                else:
                    errs[f"{name}_{label}_{start}"] = max_err(out_k, out_p)
        c = dual_kernels.relu_offsets(d, g, p)
        for rs in (False, True):
            out_k, out_p = window(d, c, rs)
            torch.cuda.synchronize()
            check(all(bool(torch.isfinite(t).all()) for t in out_k),
                  f"soft tiled chunk {label}: output not finite")
            # under restart the recovered z, as for the whole solve
            errs[f"dual_tiled_chunk_{label}_{'restart' if rs else 'plain'}"] = (
                ((out_k[2] - out_p[2]) @ d.MG_T).abs().max().item() if rs
                else max_err(out_k, out_p))
        if shape is PAIRED_WIDE:  # od exactly 1 against the hard launch
            hard = dataclasses.replace(d, soft_damp=None)
            one = dataclasses.replace(d, soft_damp=torch.zeros_like(
                d.soft_damp))
            for name, (fn, _, kw) in tier_fixed(kernels, dual_kernels,
                                                SOFT_FIXED).items():
                zero[name] = all(torch.equal(a, b) for a, b in zip(
                    fn(one, g, p, y_warm, iterations=ITERS, **kw),
                    fn(hard, g, p, y_warm, iterations=ITERS, **kw)))
            for rs in (False, True):
                zero[f"dual_tiled_chunk{'_restart' if rs else ''}"] = all(
                    torch.equal(a, b) for a, b in zip(
                        window(one, c, rs)[0], window(hard, c, rs)[0]))
        if shape is TILED_MID:
            tiers = {tier: tier_kernel_vs_plain(
                torch, kernels, dual_kernels, d, g, p, tier, SOFT_FIXED,
                "dual_tiled_chunk")
                for tier in TIER_KERNEL_TOL}
    kept = [float("inf") if v["u_z"] is None else v["u_z"]
            for v in restart.values()]
    worst = {"flat_tiled": max(v for k, v in errs.items()
                               if k.startswith("flat_tiled")),
             "paired_tiled": max(v for k, v in errs.items()
                                 if k.startswith("paired_tiled")),
             "dual_tiled": max([v for k, v in errs.items()
                                if k.startswith("dual_tiled_n")] + kept),
             "dual_tiled_chunk": max(v for k, v in errs.items()
                                     if k.startswith("dual_tiled_chunk"))}
    emit({"phase": "tiled_soft_vs_plain", "batch": B,
          "shapes": {shape_label(s): [soft_data(torch, tg, s).n_z,
                                      soft_data(torch, tg, s).m_half]
                     for s in SOFT_SHAPES},
          "max_abs_err": errs, "restart_u_z": restart,
          "zero_damp_bit_equal_to_hard": zero, "tiers_n5_N30": tiers,
          "tol": KERNEL_TOL, "restart_tol_u_z": RESTART_TOL,
          "phase_s": time.perf_counter() - t_phase})
    check(max(v for k, v in errs.items() if "restart" not in k)
          <= KERNEL_TOL, f"soft tiled kernels vs plain: {errs}")
    # restart per scenario (restart_parting): at most 1% parted from the
    # plain version, or, where a damp on every row leaves many decisions
    # near r = 0 (the flagship), no more parted from the float64 run than
    # the plain version's own fp32 sums part from it
    check(max(v for k, v in errs.items() if k.endswith("restart"))
          <= RESTART_TOL and max(kept) <= RESTART_TOL
          and all(v["parted"] <= v["parted_max"]
                  or v["parted_vs_float64"] <= v["plain_parted_vs_float64"]
                  for v in restart.values()),
          f"soft tiled restart: {errs} {restart}")
    check(all(zero.values()), f"soft_damp = 0 is not the hard launch {zero}")
    return worst


# the soft path's configs: the route each takes through auto (B256)
SOFT_EPS = dict(mode="eps", eps_g=FLAG_EPS_TOL, eps_V=FLAG_EPS_TOL,
                check_every=10, iterations=SOFT_SCHEDULE)
SOFT_PATH = {
    "fixed": (dict(iterations=ITERS), "gpad_flat_tiled"),
    "flat_off": (dict(iterations=ITERS, form="mvp", flat="off"),
                 "gpad_paired_tiled"),
    "restart": (dict(iterations=ITERS, restart=True), "gpad_dual_tiled"),
    "eps_flat_off": (dict(SOFT_EPS, flat="off"), "gpad_dual_tiled_chunk"),
}


def phase_tiled_soft_path(torch, tg, core, ctr):
    """Soft rows through ``solve_batch(engine="auto")`` on data condensed
    on the card (``dualize_ltv_device`` with soft_state) at n10 N30 and n5
    N30, B256, each leg counted from 0: the default fixed solve (the flat
    tiled kernel), ``flat="off"`` (the paired tiled route), restart (the
    tiled dual kernel) and eps with ``flat="off"`` (the tiled chunk
    kernel, one launch a window); u against the torch engine on the card,
    within ORACLE_TOL (restart per scenario, 1% may part; eps within
    EPS_U_TOL, 1% may part), the soft rows' duals active; then the
    flagship's forced soft routes (flat tiled, paired tiled, tiled dual
    under restart, the tiled chunk), each launched and finite. Returns the
    launches by leg."""
    t_phase = time.perf_counter()
    out, legs = {"phase": "tiled_soft_path"}, {}
    B = ROUTE_BATCH
    for shape in (PAIRED_WIDE, TILED_MID):
        label = shape_label(shape)
        d = soft_data(torch, tg, shape)
        P = soft_p(torch, shape, B, seed=84)
        soft_rows = d.soft_damp > 0
        for name, (kw, kernel) in SOFT_PATH.items():
            cfg = tg.SolverConfig(**kw)
            route = core.cuda_kernel(d, cfg, B)
            check(f"gpad_{route}" == kernel,
                  f"soft {label} {name}: auto routes to {route}")
            leg = f"{name}_{label}"
            windows = lambda r: {kernel: -(-int(r.iterations.max())  # noqa
                                           // cfg.check_every)}
            res, got = counted(torch, ctr, lambda: tg.solve_batch(d, P, cfg),
                               windows if cfg.mode == "eps" else {kernel: 1},
                               f"soft path {leg}")
            legs[leg] = got
            ref = tg.solve_batch(d, P, dataclasses.replace(cfg,
                                                           engine="torch"))
            du = res.u - ref.u
            row = {"kernel": route, "launches": got,
                   "soft_rows_y_max": res.y[..., soft_rows].max().item()}
            if cfg.mode == "eps":
                row.update(eps_agreement(res, ref),
                           parted=tier_parted(du.reshape(B, -1), EPS_U_TOL),
                           converged=int(res.converged.sum()))
            else:
                row["u_vs_torch_engine"] = tier_parted(du.reshape(B, -1),
                                                       ORACLE_TOL)
                if not cfg.restart:
                    check(row["u_vs_torch_engine"]["max"] <= ORACLE_TOL,
                          f"soft path {leg}: {row}")
            check(bool(torch.isfinite(res.u).all())
                  and row.get("parted", row.get("u_vs_torch_engine"))["ok"]
                  and row["soft_rows_y_max"] > 0, f"soft path {leg}: {row}")
            out[leg] = row
    # the flagship's forced soft routes
    flag = soft_data(torch, tg, FLAGSHIP)
    P = soft_p(torch, FLAGSHIP, B, seed=85)
    for name, kw, kernel in (
            ("forced_mvp", dict(iterations=ITERS, form="mvp"),
             "gpad_flat_tiled"),
            ("forced_flat_off", dict(iterations=ITERS, form="mvp",
                                     flat="off"), "gpad_paired_tiled"),
            ("forced_restart", dict(iterations=ITERS, restart=True),
             "gpad_dual_tiled"),
            ("forced_eps", SOFT_EPS, "gpad_dual_tiled_chunk")):
        cfg = tg.SolverConfig(engine="cuda", **kw)
        leg = f"flagship_{name}"
        res, got = counted(
            torch, ctr, lambda: tg.solve_batch(flag, P, cfg),
            lambda r: {kernel: -(-int(r.iterations.max()) // 10)
                       if cfg.mode == "eps" else 1}, f"soft path {leg}")
        legs[leg] = got
        out[leg] = {"kernel": core.cuda_kernel(flag, cfg, B), "launches": got,
                    "finite": bool(torch.isfinite(res.u).all())}
        check(out[leg]["finite"], f"soft path {leg}: {out[leg]}")
    out["launches"] = legs
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return legs


def soft_runs(torch, tg, kernels, dual_kernels, core, shape, B, seed):
    """(data, runs, bounds) of the soft kernels at battery ``shape``, B x
    100: each soft kernel, the same kernel on the data's hard rows
    (soft_damp None), and the torch engine on the soft configuration; one
    10-iteration restart window soft and hard. Bound: the hard one plus
    the damp column's m_h floats."""
    d = soft_data(torch, tg, shape)
    hard = dataclasses.replace(d, soft_damp=None)
    P = soft_p(torch, shape, B, seed)
    g, p = core.affine_params(d, P)
    c = dual_kernels.relu_offsets(d, g, p)
    zero = torch.zeros((B, 2, d.m_half), device=DEVICE)
    state = dual_kernels.gpad_dual_chunk_torch(
        d, c, zero, zero, torch.zeros((B, d.m_half), device=DEVICE),
        torch.ones((B, 2), device=DEVICE), k0=0, chunk=30, restart=True)[:4]
    S = tg.SolverConfig
    runs, bounds = {}, {}
    for name, cfg in (("flat_tiled", S(iterations=ITERS, form="mvp")),
                      ("paired_tiled", S(iterations=ITERS, form="mvp",
                                         flat="off")),
                      ("dual_tiled_restart", S(iterations=ITERS,
                                               restart=True))):
        fn, _, kw = tier_fixed(kernels, dual_kernels, (name,))[name]
        runs[f"{name}_soft"] = lambda fn=fn, kw=kw: fn(d, g, p,
                                                       iterations=ITERS, **kw)
        runs[f"{name}_hard"] = lambda fn=fn, kw=kw: fn(hard, g, p,
                                                       iterations=ITERS, **kw)
        runs[f"{name}_torch_engine"] = lambda cfg=cfg: tg.solve_batch(
            d, P, dataclasses.replace(cfg, engine="torch"))
    win = dict(k0=30, chunk=10, restart=True)
    runs["dual_tiled_chunk_soft"] = lambda: dual_kernels.gpad_dual_tiled_chunk(
        d, c, *state, **win)
    runs["dual_tiled_chunk_hard"] = lambda: dual_kernels.gpad_dual_tiled_chunk(
        hard, c, *state, **win)
    od = 4 * d.m_half
    m_h, n_z = d.m_half, d.n_z
    for name, b in (
            ("flat_tiled", paired_bound(d, g, p, B)),
            ("paired_tiled", paired_bound(d, g, p, B, full=True)),
            ("dual_tiled_restart", bound(
                B * (ITERS * 2.0 * m_h * m_h + 4.0 * m_h * n_z),
                nbytes(d.D, d.GL_T, d.MG_T, g, p)
                + 4 * B * (2 * n_z + 4 * m_h))),
            ("dual_tiled_chunk", bound(
                B * 10 * 2.0 * m_h * m_h,
                nbytes(d.D, c, *state) + nbytes(*state) + 4 * B * 2 * m_h))):
        bounds[name] = bound(b["flops"], b["bytes"] + od)
    return d, runs, bounds


def phase_tiled_soft_timing(torch, tg, kernels, dual_kernels, core, smi):
    """The soft kernels at n5 N30, n10 N30 and the flagship, B256 x 100:
    each against the same kernel on the data's hard rows and the torch
    engine on the soft configuration (a restart window soft and hard at
    the flagship), CUDA events, median of 5 calls a turn, two turns of
    opposite order; the bound (the hard one plus od's m_h floats)."""
    from tpu_gpad_torch.utils import device_time_per_call

    t_phase, out = time.perf_counter(), {}
    for shape in SOFT_SHAPES:
        d, runs, bounds = soft_runs(torch, tg, kernels, dual_kernels, core,
                                    shape, ROUTE_BATCH, seed=86)
        if shape is not FLAGSHIP:
            runs = {k: v for k, v in runs.items()
                    if not k.startswith("dual_tiled_chunk")}
        ms = {k: [] for k in runs}
        for turn in (list(runs), list(runs)[::-1]):
            for k in turn:
                ms[k].append(device_time_per_call(runs[k], warmup=1,
                                                  repeats=5) * 1e3)
        med = {k: float(np.mean(v)) for k, v in ms.items()}
        rows = {}
        for name, bnd in bounds.items():
            if f"{name}_soft" not in med:
                continue
            rows[name] = {
                "ms": med[f"{name}_soft"], "hard_ms": med[f"{name}_hard"],
                "soft_over_hard": med[f"{name}_soft"] / med[f"{name}_hard"],
                "torch_engine_ms": med.get(f"{name}_torch_engine"),
                "ms_median_of_5_per_turn": {
                    k: v for k, v in ms.items() if k.startswith(name)},
                **bnd}
        out[shape_label(shape)] = {"m_h": d.m_half, "n_z": d.n_z,
                                   "batch": ROUTE_BATCH, **rows}
    emit({"phase": "tiled_soft_timing", "gpu": smi, "iterations": ITERS,
          **out, "phase_s": time.perf_counter() - t_phase})
    return out


def times_soft_routes(torch, tg, kernels, dual_kernels, core, smi):
    """``--times routes``' soft points: each soft route (the flat tiled
    kernel, the paired tiled route, the tiled dual kernel under restart)
    at n5 N30, n10 N30 and the flagship, at each of SOFT_ROUTE_BATCHES:
    the soft kernel, the same kernel on the hard rows and the torch engine
    on the soft configuration, in turns (CUDA events), with the kernel
    ``auto`` names for the soft data at that batch: where ``auto``'s soft
    edges lie beside the hard ones."""
    from tpu_gpad_torch.utils import device_time_per_call

    for shape in SOFT_SHAPES:
        for B in SOFT_ROUTE_BATCHES:
            d, runs, bounds = soft_runs(torch, tg, kernels, dual_kernels,
                                        core, shape, B, seed=87)
            runs = {k: v for k, v in runs.items()
                    if not k.startswith("dual_tiled_chunk")}
            ms = {k: [] for k in runs}
            for turn in (list(runs), list(runs)[::-1]):
                for k in turn:
                    ms[k].append(device_time_per_call(runs[k], warmup=1,
                                                      repeats=3) * 1e3)
            med = {k: float(np.mean(v)) for k, v in ms.items()}
            S = tg.SolverConfig
            auto = {name: core.cuda_kernel(d, cfg, B) for name, cfg in (
                ("flat_tiled", S()), ("paired_tiled", S(form="mvp",
                                                        flat="off")),
                ("dual_tiled_restart", S(restart=True)))}
            emit({"phase": "times_soft_routes", "gpu": smi,
                  "shape": shape_label(shape), "batch": B, "m_h": d.m_half,
                  "n_z": d.n_z, "auto_kernel": auto, "ms": med,
                  "kernel_faster": {
                      n: med[f"{n}_soft"] < med[f"{n}_torch_engine"]
                      for n in auto},
                  "hard_faster": {
                      n: med[f"{n}_hard"] < med[f"{n}_torch_engine"]
                      for n in auto},
                  "bound_ms": {n: b["bound_ms"] for n, b in bounds.items()}})


# ---------------------------------------------------------------------------
# the stage-wise O(N) engine
# ---------------------------------------------------------------------------

_SW_DATA = {}


def sw_data(tg, shape, iterations):
    """``build_stagewise`` of battery ``shape`` on the card, built once."""
    key = (shape, iterations)
    if key not in _SW_DATA:
        _SW_DATA[key] = tg.build_stagewise(tg.problems.battery(*shape),
                                           iterations=iterations, device=DEVICE)
    return _SW_DATA[key]


def sw_x0(torch, B, n, seed):
    return torch.as_tensor(np.random.default_rng(seed).uniform(
        -0.4, 0.4, (B, n)).astype(np.float32), device=DEVICE)


def sw_flops(data) -> float:
    """The kernels' packed products per stage, scenario and iteration:
    Gx' wx, Gu' wu, R [st; ru], HB [st; ru], M [x; kff], Gx x, Gu u."""
    n, p, m_x, m_u = data.n_x, data.n_u, data.m_x, data.m_u
    return 2.0 * (2 * m_x * n + 2 * m_u * p + (2 * n + 2 * p) * (n + p))


def sw_bound(sk, data, B, iterations):
    pack = sk.pack_stagewise_constants(data)
    N, n, p, m = data.horizon, data.n_x, data.n_u, data.m_x + data.m_u
    inputs = nbytes(*(getattr(pack, f.name) for f in dataclasses.fields(pack)))
    # x0 in; u0, zu, y, residual and gap out
    io = 4 * B * (n + p + N * p + N * m + 2)
    return bound(sw_flops(data) * N * B * iterations, inputs + io)


def sw_limits(zu):
    """(max |u|, max |sum of u over the cells| per stage) of plans
    (..., n_u)."""
    return zu.abs().max().item(), zu.sum(-1).abs().max().item()


def sw_compare(torch, sk, fn, data, x0, iterations, restart=False, y0=None):
    """A stage-wise kernel and the plain version on the same CUDA tensors:
    the largest errors on (u0, zu), on y and on (residual, gap)."""
    out_k = fn(data, x0, iterations, restart=restart, y0=y0)
    out_p = sk.stagewise_plain(sk.pack_stagewise_constants(data), x0, y0,
                               iterations=iterations, restart=restart)
    torch.cuda.synchronize()
    for t in out_k:
        check(bool(torch.isfinite(t).all()), "stage-wise kernel output not finite")
    return {"u_z": max_err(out_k[:2], out_p[:2]),
            "y": max_err(out_k[2:3], out_p[2:3]),
            "residual_gap": max_err(out_k[3:], out_p[3:])}


def sw_restart_compare(torch, sk, fn, data, x0, iterations):
    """Under restart, per scenario: the kernel against the plain version,
    and both against the plain version in float64. A restart decision is
    the sign of a sum that float32 rounding may flip where it is near 0;
    a scenario whose decision flipped parts from the other run by far more
    than RESTART_TOL. Returns the largest (u0, zu) error of the scenarios
    that did not part, and the counts of those that did."""
    out_k = fn(data, x0, iterations, restart=True)
    pack = sk.pack_stagewise_constants(data)
    out_p = sk.stagewise_plain(pack, x0, iterations=iterations, restart=True)
    pack64 = sk.StagewisePack(**{f.name: getattr(pack, f.name).double()
                                 for f in dataclasses.fields(pack)})
    out_64 = sk.stagewise_plain(pack64, x0.double(), iterations=iterations,
                                restart=True)
    torch.cuda.synchronize()
    for t in out_k:
        check(bool(torch.isfinite(t).all()), "stage-wise kernel output not finite")
    per = lambda a, b: (a[1].double() - b[1].double()).abs().amax(dim=(1, 2))
    e_k, e_k64, e_p64 = per(out_k, out_p), per(out_k, out_64), per(out_p, out_64)
    parted = e_k > RESTART_TOL
    return {"u_z": e_k[~parted].max().item() if not parted.all() else None,
            "parted": int(parted.sum()), "u_z_parted_max": e_k.max().item(),
            "parted_vs_float64": int((e_k64 > RESTART_TOL).sum()),
            "plain_parted_vs_float64": int((e_p64 > RESTART_TOL).sum()),
            "y": max_err(out_k[2:3], out_p[2:3])}


def phase_stagewise_kernels_vs_plain(torch, tg, sk, ss):
    """Each kernel against the plain version: cold, warm per-scenario y0,
    one y0 shared by every scenario, restart, affine offsets with a fixed
    reference, and a ragged tile (the resident kernel at its main-path
    batch, B1024); the streamed kernel also at its full batch against the
    torch engine."""
    affine = tg.build_stagewise(
        dataclasses.replace(tg.problems.battery(3, 7),
                            c=np.array([0.02, -0.01, 0.015])),
        iterations=SW_RES_ITERS, x_ref=np.full(3, 0.05), device=DEVICE)
    x_aff = sw_x0(torch, 64, 3, seed=12)
    worst = {}
    for name, fn, data, B, iters in (
            ("resident", sk.solve_stagewise_cuda, sw_data(tg, SW_RES, SW_RES_ITERS),
             SW_WAVE_BATCH, SW_RES_ITERS),
            ("stream", ss.solve_stagewise_stream,
             sw_data(tg, SW_FULL, SW_FULL_ITERS), SW_CMP_BATCH, SW_FULL_ITERS)):
        x0 = sw_x0(torch, B, data.n_x, seed=11)
        y_warm = fn(data, 0.9 * x0, iters)[2]
        cases = {
            "cold": sw_compare(torch, sk, fn, data, x0, iters),
            "warm": sw_compare(torch, sk, fn, data, x0, iters, y0=y_warm),
            "shared_y0": sw_compare(torch, sk, fn, data, x0, iters,
                                    y0=y_warm[0].contiguous()),
            "restart": sw_restart_compare(torch, sk, fn, data, x0, iters),
            "affine_x_ref": sw_compare(torch, sk, fn, affine, x_aff, SW_RES_ITERS),
            "B5": sw_compare(torch, sk, fn, data, x0[:5].contiguous(), iters,
                             y0=y_warm[:5].contiguous()),
        }
        fixed = max(v["u_z"] for k, v in cases.items() if k != "restart")
        emit({"phase": "stagewise_kernels_vs_plain", "kernel": name,
              "shape": {"n_x": data.n_x, "horizon": data.horizon, "batch": B,
                        "iterations": iters}, "max_abs_err": cases,
              "tol_u_z": KERNEL_TOL, "restart_tol_u_z": RESTART_TOL,
              "restart_parted_max": parted_max(B)})
        check(fixed <= KERNEL_TOL, f"{name} kernel vs plain: {cases}")
        rs = cases["restart"]
        check(rs["parted"] <= parted_max(B) and rs["u_z"] is not None
              and rs["u_z"] <= RESTART_TOL,
              f"{name} kernel vs plain under restart: {rs}")
        worst[name] = max(fixed, rs["u_z"])
    # the full width against the torch engine
    d30 = sw_data(tg, SW_FULL, SW_FULL_ITERS)
    X0 = sw_x0(torch, SW_FULL_BATCH, d30.n_x, seed=13)
    r_k = tg.solve_stagewise(d30, X0, engine="stream")
    r_t = tg.solve_stagewise(d30, X0, engine="torch")
    torch.cuda.synchronize()
    full = max_err((r_k.u, r_k.z), (r_t.u, r_t.z))
    emit({"phase": "stagewise_kernels_vs_plain", "kernel": "stream",
          "shape": {"n_x": d30.n_x, "horizon": d30.horizon,
                    "batch": SW_FULL_BATCH, "iterations": SW_FULL_ITERS},
          "u_z_vs_torch_engine": full,
          "y_vs_torch_engine": max_err((r_k.y,), (r_t.y,)), "tol": KERNEL_TOL})
    check(full <= KERNEL_TOL, f"streamed kernel vs torch engine {full}")
    return worst


def sw_limits_within_residual(torch, res, data):
    """The battery's input rows are |u_i| <= 0.3 and sum_i u_i = 0 at
    every stage: per scenario, the plan's worst excess over them, which
    the solve's own residual max(G z - h, 0) must cover."""
    z = res.z.reshape(-1, data.horizon, data.n_u)
    excess = torch.maximum(z.abs().amax(dim=(1, 2)) - 0.3,
                           z.sum(-1).abs().amax(dim=1))
    return (excess - res.residual.reshape(-1)).max().item()


def phase_stagewise_main_path(torch, tg, sk, ss, ts):
    """``auto_solver`` at full width: battery n30 N200 B1024 routes to the
    streamed kernel (past the resident kernel's shared memory); n8 N60
    (stage-wise at batch_hint 4096) to the resident kernel at B4096 and at
    B1024 (``resident_preferred``: at 8 scenarios a block it beat the
    streamed kernel at every batch measured)."""
    out = {"phase": "stagewise_main_path"}
    counters = {"stream": lambda: ss.STAGEWISE_STREAM_LAUNCHES,
                "cuda": lambda: sk.STAGEWISE_LAUNCHES}
    for shape, iters, hint, legs in (
            (SW_FULL, SW_FULL_ITERS, None, ((SW_FULL_BATCH, "stream"),)),
            (SW_RES, SW_RES_ITERS, SW_RES_BATCH,
             ((SW_RES_BATCH, "cuda"), (SW_WAVE_BATCH, "cuda")))):
        solve_fn, data, kind = tg.auto_solver(
            tg.problems.battery(*shape), iterations=iters, batch_hint=hint)
        check(kind == "stagewise", f"auto_solver at battery {shape}: {kind}")
        for B, expect in legs:
            X0 = sw_x0(torch, B, data.n_x, seed=21)
            route = ts.resolve_stagewise_engine(data, B)
            before = counters[expect]()
            res = solve_fn(X0)
            torch.cuda.synchronize()
            launched = counters[expect]() - before
            for f in ("u", "z", "y", "residual", "gap"):
                check(bool(torch.isfinite(getattr(res, f)).all()),
                      f"battery {shape} B{B} {f} not finite")
            ref = tg.solve_stagewise(data, X0, engine="torch")
            vs_torch = max_err((res.u, res.z), (ref.u, ref.z))
            u_max, sum_max = sw_limits(res.z.reshape(B, data.horizon, data.n_u))
            over = sw_limits_within_residual(torch, res, data)
            lay = sk.resident_layout(data, B, sk.sm_count(DEVICE))
            out[f"battery_n{shape[0]}_N{shape[1]}_B{B}"] = {
                "iterations": iters, "kind": kind, "route": route,
                "resident_launch": None if lay is None
                else dataclasses.asdict(lay),
                "launches": launched, "u_z_vs_torch_engine": vs_torch,
                "residual_max": res.residual.max().item(),
                "max_abs_u": u_max, "max_abs_sum_u": sum_max,
                "limit_excess_over_residual": over}
            check(route == expect and launched == 1,
                  f"battery {shape} B{B} routed to {route}, {launched} launches")
            check(vs_torch <= KERNEL_TOL, f"B{B} u/z vs torch engine {vs_torch}")
            check(over <= SW_RESIDUAL_TOL,
                  f"B{B}: the plan exceeds its limits by {over} beyond its residual")
    emit(out)


def phase_stagewise_serving(torch, tg, ss):
    """A warm ``StagewiseController`` at battery n30 N200 serving a fleet:
    one streamed-kernel launch per step. Every move stays within its
    solve's residual of the limits; once the warm start has settled, within
    the limits themselves."""
    problem = tg.problems.battery(*SW_FULL)
    ctl = tg.StagewiseController(problem, iterations=SW_SERVE_ITERS)
    A = np.asarray(problem.A, dtype=np.float32)
    Bm = np.asarray(problem.B, dtype=np.float32)
    x = np.random.default_rng(23).uniform(
        -0.4, 0.4, (SW_SERVE_PLANTS, problem.n_x)).astype(np.float32)
    spread0 = float(np.mean(x.max(1) - x.min(1)))
    before = ss.STAGEWISE_STREAM_LAUNCHES
    u_max, sum_max, over, soc_max = [], [], [], 0.0
    step_ms = []
    for _ in range(SW_SERVE_STEPS):
        t0 = time.perf_counter()
        u = ctl.step(x)  # returns host NumPy: the device work is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
        u_max.append(float(np.abs(u).max()))
        sum_max.append(float(np.abs(u.sum(1)).max()))
        over.append(sw_limits_within_residual(torch, ctl.last_result, ctl.data))
        x = x @ A.T + u @ Bm.T
        soc_max = max(soc_max, float(np.abs(x).max()))
    spread = float(np.mean(x.max(1) - x.min(1)))
    launched = ss.STAGEWISE_STREAM_LAUNCHES - before
    settled = slice(SW_SERVE_SETTLE, None)
    emit({"phase": "stagewise_serving", "battery": SW_FULL,
          "plants": SW_SERVE_PLANTS, "steps": SW_SERVE_STEPS,
          "iterations": SW_SERVE_ITERS, "launches": launched,
          "max_abs_u_per_step": u_max, "max_abs_sum_u_per_step": sum_max,
          "limit_excess_over_residual": max(over), "max_abs_soc": soc_max,
          "mean_spread": [spread0, spread],
          "step_ms_host_clock": {"median": float(np.median(step_ms[1:])),
                                 "max": float(np.max(step_ms[1:])),
                                 "first": step_ms[0]}})
    check(launched == SW_SERVE_STEPS,
          f"StagewiseController launched the streamed kernel {launched}x")
    check(max(over) <= SW_RESIDUAL_TOL, f"moves beyond their residual: {over}")
    check(max(u_max[settled]) <= 0.3 + SW_LIMIT_TOL, f"settled |u| {u_max}")
    check(max(sum_max[settled]) <= SW_LIMIT_TOL, f"settled |sum u| {sum_max}")
    check(soc_max <= 0.5 + SW_LIMIT_TOL, f"|SoC| {soc_max}")
    check(spread < spread0, f"SoC spread did not shrink: {spread0} -> {spread}")


def phase_stagewise_eps(torch, tg, sk, ss):
    """examples/long_horizon_stagewise.py's call past the condensation
    wall: battery n30 N400, 8 scenarios, eps 1e-4 with restart, a check
    every 20 iterations, at most 2000; eps mode runs the torch engine."""
    problem = tg.problems.battery(*SW_EPS)
    try:
        tg.condense(problem)
        raise SystemExit("chip_smoke FAILED: condense() took battery n30 N400")
    except ValueError as e:
        check("tpu_gpad_torch.stagewise" in str(e), f"condense wall: {e}")
    solve_fn, data, kind = tg.auto_solver(problem, iterations=2000)
    check(kind == "stagewise", f"auto_solver at battery {SW_EPS}: {kind}")
    X0 = torch.as_tensor(np.random.default_rng(0).uniform(
        -0.3, 0.3, (8, problem.n_x)).astype(np.float32), device=DEVICE)
    cfg = tg.SolverConfig(mode="eps", eps_g=1e-4, eps_V=1e-4, check_every=20,
                          restart=True, iterations=2000)
    before = (sk.STAGEWISE_LAUNCHES, ss.STAGEWISE_STREAM_LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve_fn(X0, config=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    iters = res.iterations.cpu().numpy()
    drift = sw_limits(res.z.reshape(8, SW_EPS[1], problem.n_u))[1]
    emit({"phase": "stagewise_eps", "battery": SW_EPS, "batch": 8,
          "engine": "torch", "iterations_mean": float(iters.mean()),
          "iterations_max": int(iters.max()),
          "converged": int(res.converged.sum()),
          "residual_max": res.residual.max().item(), "charge_drift": drift,
          "wall_s_host_clock": wall})
    check((sk.STAGEWISE_LAUNCHES, ss.STAGEWISE_STREAM_LAUNCHES) == before,
          "eps mode launched a stage-wise kernel")
    check(bool(res.converged.all()), "not every scenario converged")
    check(res.residual.max().item() < 1e-2, "eps residual")
    check(drift < 5e-3, f"charge-conservation drift {drift}")


def phase_stagewise_timing(torch, tg, sk, ss, ts, smi):
    """CUDA events, median of 5 calls per turn, turns kernel, plain, plain,
    kernel: each kernel at its main-path shape against its plain version,
    both kernels at n8 N60 B4096 and B1024 (the routing rule's two sides),
    and the torch engine at 10 iterations: at the full width, and at n8
    N60 B256 and B1024 with each of its executors (``scan="sequential"``
    and ``"associative"``)."""
    from tpu_gpad_torch.utils import device_time_per_call

    d30 = sw_data(tg, SW_FULL, SW_FULL_ITERS)
    d8 = sw_data(tg, SW_RES, SW_RES_ITERS)
    X30 = sw_x0(torch, SW_FULL_BATCH, d30.n_x, seed=31)
    X8 = sw_x0(torch, SW_RES_BATCH, d8.n_x, seed=32)
    X8w = X8[:SW_WAVE_BATCH].contiguous()
    p30, p8 = sk.pack_stagewise_constants(d30), sk.pack_stagewise_constants(d8)
    kernels = {
        "stream": lambda: ss.solve_stagewise_stream(d30, X30, SW_FULL_ITERS),
        "resident": lambda: sk.solve_stagewise_cuda(d8, X8w, SW_RES_ITERS),
        "stream_n8_B1024": lambda: ss.solve_stagewise_stream(
            d8, X8w, SW_RES_ITERS),
        "stream_n8_B4096": lambda: ss.solve_stagewise_stream(
            d8, X8, SW_RES_ITERS),
        "resident_n8_B4096": lambda: sk.solve_stagewise_cuda(
            d8, X8, SW_RES_ITERS),
    }
    plains = {
        "stream_plain": lambda: sk.stagewise_plain(p30, X30,
                                                   iterations=SW_FULL_ITERS),
        "resident_plain": lambda: sk.stagewise_plain(p8, X8w,
                                                     iterations=SW_RES_ITERS),
        "torch_engine_10_full": lambda: ts.solve_stagewise(
            d30, X30, iterations=10, engine="torch"),
    }
    for B in (SW_SMALL_BATCH, SW_WAVE_BATCH):
        for scan in ("sequential", "associative"):
            plains[f"torch_engine_10_n8_B{B}_{scan}"] = (
                lambda B=B, scan=scan: ts.solve_stagewise(
                    d8, X8[:B], iterations=10, engine="torch", scan=scan))
    runs = {**kernels, **plains}
    ms = {k: [] for k in runs}
    for order in (list(kernels) + list(plains), list(plains) + list(kernels)):
        for k in order:
            ms[k].append(device_time_per_call(runs[k], warmup=1, repeats=5) * 1e3)
    med = {k: float(np.mean(v)) for k, v in ms.items()}
    med["stream_bound"] = sw_bound(sk, d30, SW_FULL_BATCH, SW_FULL_ITERS)
    med["resident_bound"] = sw_bound(sk, d8, SW_WAVE_BATCH, SW_RES_ITERS)
    sms = sk.sm_count(DEVICE)
    emit({"phase": "stagewise_timing", "gpu": smi, "sms": sms,
          "shapes": {"stream": [SW_FULL, SW_FULL_BATCH, SW_FULL_ITERS],
                     "resident": [SW_RES, SW_WAVE_BATCH, SW_RES_ITERS]},
          "launches": {
              "stream": ss.stream_layout(d30, SW_FULL_BATCH, sms)[:2],
              "stream_n8_B4096": ss.stream_layout(d8, SW_RES_BATCH, sms)[:2],
              "resident_n8_B1024": dataclasses.asdict(
                  sk.resident_layout(d8, SW_WAVE_BATCH, sms)),
              "resident_n8_B4096": dataclasses.asdict(
                  sk.resident_layout(d8, SW_RES_BATCH, sms))},
          "torch_engine_scan_auto": {
              B: ts.resolve_scan(d8, B) for B in (SW_SMALL_BATCH,
                                                  SW_WAVE_BATCH)},
          "ms_median_of_5_per_turn": ms,
          "torch_engine_ms_per_iteration": {
              k[len("torch_engine_10_"):]: med[k] / 10
              for k in med if k.startswith("torch_engine_10_")},
          "stream_bound": med["stream_bound"],
          "resident_bound": med["resident_bound"]})
    return med


def times_stagewise(torch, tg, sk, ss, smi):
    """``python3 chip_smoke.py --times``: the resident kernel at n8 N60 x
    100, B1024 and B4096, and the streamed kernel at n30 N200 B1024 x 200:
    the profiler's device time of the launch (mean of 5) and CUDA events
    (median of 5), each with its bound. Public arguments only, so it also
    times an earlier design's checkout."""
    from tpu_gpad_torch.utils import device_time_per_call

    d8 = sw_data(tg, SW_RES, SW_RES_ITERS)
    d30 = sw_data(tg, SW_FULL, SW_FULL_ITERS)
    X8 = sw_x0(torch, SW_RES_BATCH, d8.n_x, seed=65)
    X30 = sw_x0(torch, SW_FULL_BATCH, d30.n_x, seed=66)
    cases = {f"resident_n8_B{B}": (
        "gpad_stagewise_resident_kernel", d8, B, SW_RES_ITERS,
        lambda B=B: sk.solve_stagewise_cuda(d8, X8[:B], SW_RES_ITERS))
        for B in (SW_WAVE_BATCH, SW_RES_BATCH)}
    cases["stream_n30_B1024"] = (
        "gpad_stagewise_stream_kernel", d30, SW_FULL_BATCH, SW_FULL_ITERS,
        lambda: ss.solve_stagewise_stream(d30, X30, SW_FULL_ITERS))
    for label, (name, data, B, iters, run) in cases.items():
        emit({"phase": "stagewise_times", "gpu": smi, "case": label,
              "ms_device": profiled_ms(torch, run, name, calls=5),
              "ms_events": device_time_per_call(run, warmup=1,
                                                repeats=5) * 1e3,
              "bound_ms": sw_bound(sk, data, B, iters)["bound_ms"]})


def sweep_stagewise(torch, tg, sk, ss, ts, smi):
    """``python3 chip_smoke.py --sweep``: each stage-wise kernel's time by
    launch at the shapes the routing rule weighs, CUDA events, median of 3
    calls after one warm-up: the resident kernel by tile (2**log2
    scenarios per block) x warps per block (W, hence W chain segments) x
    the chains' placement (matrices staged in shared memory or read from
    device memory), every launch that fits; the streamed kernel by tile
    (its slab placement as ``stream_layout`` picks it for that tile). n8
    N60 and the ``SW_SWEEP_SHAPES`` at B 256, 1024 and 4096, each with the
    route ``auto`` takes there."""
    from tpu_gpad_torch.utils import device_time_per_call

    d30 = sw_data(tg, SW_FULL, SW_FULL_ITERS)
    X30 = sw_x0(torch, SW_FULL_BATCH, d30.n_x, seed=31)
    sms = sk.sm_count(DEVICE)
    cases = [("stream", d30, X30, SW_FULL_ITERS),
             ("stream", d30, X30[:SW_SERVE_PLANTS].contiguous(), SW_SERVE_ITERS)]
    for shape in (SW_RES, *SW_SWEEP_SHAPES):
        data = sw_data(tg, shape, SW_RES_ITERS)
        X = sw_x0(torch, SW_RES_BATCH, data.n_x, seed=32)
        for B in (SW_RES_BATCH, SW_WAVE_BATCH, SW_SMALL_BATCH):
            for kernel in ("resident", "stream"):
                cases.append((kernel, data, X[:B].contiguous(), SW_RES_ITERS))
    for kernel, data, X, iters in cases:
        B = X.shape[0]
        row = {}
        for log2 in range(sk._MAX_LOG2_TILE + 1):
            if kernel == "stream":
                ms = device_time_per_call(
                    lambda: ss.solve_stagewise_stream(data, X, iters,
                                                      log2_tile=log2),
                    warmup=1, repeats=3)
                row[str(log2)] = {"ms": ms * 1e3, "slabs_in_smem":
                                  ss.stream_layout(data, B, sms, log2)[1]}
                continue
            for lay in sk.resident_layouts(data, log2):
                kw = dict(log2_tile=log2, warps=lay.warps,
                          chains_in_smem=lay.chains_in_smem)
                ms = device_time_per_call(
                    lambda: sk.solve_stagewise_cuda(data, X, iters, **kw),
                    warmup=1, repeats=3)
                row[f"{log2}/{lay.warps}/{int(lay.chains_in_smem)}"] = {
                    "ms": ms * 1e3, "smem": lay.smem}
        if kernel == "stream":
            pick = ss.stream_layout(data, B, sms)[0]
        else:
            lay = sk.resident_layout(data, B, sms)
            pick = f"{lay.log2_tile}/{lay.warps}/{int(lay.chains_in_smem)}"
        emit({"phase": "stagewise_tile_sweep", "gpu": smi, "kernel": kernel,
              "battery": [data.n_x, data.horizon], "batch": B,
              "iterations": iters, "default": pick,
              "route": ts.resolve_stagewise_engine(data, B),
              "key": "log2_tile" if kernel == "stream"
              else "log2_tile/warps/chains_in_smem", "ms_by_launch": row})


# the profile build's counters (csrc/gpad_stagewise.cu): the streamed
# kernel's phases between its block barriers (thread 0 of each block), and
# the resident kernel's parts (lane 0 of each warp; B1-B3 the waits at its
# three barriers, CB23 and CF23 a chain's carry and rerun)
SW_PHASES = ("decision", "P1", "P1b", "CB", "P3", "CF", "P4", "epilogue")
RES_PHASES = ("prologue", "decision", "P1", "P1b", "CB1", "B1", "CB23", "P3",
              "CF1", "B2", "CF23", "P4", "B3", "epilogue")


def profile_stagewise(torch, tg, sk, ss, smi):
    """``python3 chip_smoke.py --profile``: where a stage-wise kernel's time
    goes. A build with -DGPAD_SW_PROFILE sums clock64() cycles by part of
    the solve: the streamed kernel's per block between the barriers that
    end its phases, the resident kernel's per warp (its warps run their
    own stages between three barriers). Printed as each part's share and
    its cycles per block (streamed) or per warp (resident) and iteration,
    beside the launch's CUDA-event time (the marks cost a few per cent)."""
    import ctypes
    from tpu_gpad_torch import cuda_build

    lib = cuda_build.load("gpad_stagewise", ("GPAD_SW_PROFILE",))
    reads = {}
    for kernel, fn, names in (
            ("stream", lib.gpad_stagewise_profile_read, SW_PHASES),
            ("resident", lib.gpad_stagewise_resident_profile_read,
             RES_PHASES)):
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        reads[kernel] = (fn, names)
    plain_fns = sk._launch_fns
    sk._launch_fns = lambda: plain_fns(("GPAD_SW_PROFILE",))
    d30 = sw_data(tg, SW_FULL, SW_FULL_ITERS)
    d8 = sw_data(tg, SW_RES, SW_RES_ITERS)
    X30 = sw_x0(torch, SW_FULL_BATCH, d30.n_x, seed=31)
    X8 = sw_x0(torch, SW_RES_BATCH, d8.n_x, seed=32)
    sms = sk.sm_count(DEVICE)
    cases = [("stream", ss.solve_stagewise_stream, d30, X30, SW_FULL_ITERS),
             ("stream", ss.solve_stagewise_stream, d30,
              X30[:SW_SERVE_PLANTS].contiguous(), SW_SERVE_ITERS)]
    for B in (SW_WAVE_BATCH, SW_RES_BATCH):
        cases.append(("resident", sk.solve_stagewise_cuda, d8,
                      X8[:B].contiguous(), SW_RES_ITERS))
    try:
        for kernel, fn, data, X, iters in cases:
            B = X.shape[0]
            read, names = reads[kernel]
            fn(data, X, iters)  # warm-up
            torch.cuda.synchronize()
            out = (ctypes.c_ulonglong * len(names))()
            check(read(out) == 0, "profile read")
            start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
            start.record()
            fn(data, X, iters)
            end.record()
            torch.cuda.synchronize()
            check(read(out) == 0, "profile read")
            if kernel == "stream":
                log2, per = ss.stream_layout(data, B, sms)[0], 1
                launch = {"log2_tile": log2}
            else:
                lay = sk.resident_layout(data, B, sms)
                log2, per = lay.log2_tile, lay.warps
                launch = dataclasses.asdict(lay)
            blocks = -(-B // (1 << log2))
            cycles = dict(zip(names, out))
            total = max(sum(cycles.values()), 1)
            emit({"phase": "stagewise_profile", "gpu": smi, "kernel": kernel,
                  "battery": [data.n_x, data.horizon], "batch": B,
                  "iterations": iters, "launch": launch, "blocks": blocks,
                  "ms": start.elapsed_time(end),
                  "share": {k: c / total for k, c in cycles.items()},
                  ("cycles_per_block_iteration" if kernel == "stream" else
                   "cycles_per_warp_iteration"): {
                      k: c / (blocks * per * max(iters, 1))
                      for k, c in cycles.items()}})
    finally:
        sk._launch_fns = plain_fns


# ---------------------------------------------------------------------------
# the estimation and robust stacks
# ---------------------------------------------------------------------------


def rate(fn, per_call: int, repeats: int = 10) -> dict:
    """CUDA-event time of ``fn()`` after warm-up (median of ``repeats``),
    and the rate of ``per_call`` solves or windows a call."""
    from tpu_gpad_torch.utils import device_time_per_call

    s = device_time_per_call(fn, warmup=2, repeats=repeats)
    return {"ms": s * 1e3, "per_s": per_call / s}


def robust_variants(tg, shape):
    """Battery ``shape`` with three actuator realizations, B x 0.8, 1.0 and
    1.2 (``scenario_problem_variants``)."""
    nominal = tg.problems.battery(*shape)
    return tg.scenario_problem_variants(
        nominal, B_list=[np.asarray(nominal.B) * s for s in ROBUST_SCALES])


def phase_robust_path(torch, tg, ctr, reference, smi):
    """The robust scenario stack: ``scenario_qp`` of three actuator
    realizations of battery n3 N10 (n_z 84, paired, n_struct 118) served
    through ``Controller.from_qp`` to 256 plants, each leg counted from 0:
    a fixed solve (the flat kernel), 20 warm restart steps (the dual
    kernel) and ``solve_to_accuracy(1e-5)`` (the chunk kernel, one launch
    per window). Each against the torch engine on the same data (restart
    per scenario); every scenario's plan applies the shared first move.
    Returns the launches by leg."""
    from tpu_gpad_torch import robust
    from tpu_gpad_torch.solver import core

    variants = robust_variants(tg, ROBUST)
    S, (n_x, N) = len(variants), ROBUST
    qp = tg.scenario_qp([tg.condense(p) for p in variants])
    cfg_r = tg.SolverConfig(iterations=ITERS, restart=True)
    ctl = tg.Controller.from_qp(qp, config=cfg_r, device=DEVICE)
    data = ctl.data
    X0np = np.random.default_rng(61).uniform(
        -0.4, 0.4, (SERVE_PLANTS, n_x)).astype(np.float32)
    X0 = torch.as_tensor(X0np, device=DEVICE)
    out = {"phase": "robust_path", "scenarios": S, "plants": SERVE_PLANTS,
           "shape": {"n_z": data.n_z, "m_half": data.m_half,
                     "n_struct": data.n_struct}}
    launches = {}

    def shared_move(z, u) -> float:
        """max over scenarios of |scenario s's first planned move - u|."""
        u = u.cpu().numpy()
        return max(float(np.abs(robust.scenario_plan(z, s, n_x, N, S)[:, 0]
                                - u).max()) for s in range(S))

    cfg_f = tg.SolverConfig(iterations=ITERS)
    res, launches["fixed"] = counted(
        torch, ctr, lambda: tg.solve_batch(data, X0, cfg_f),
        {"gpad_paired_flat": 1}, "robust fixed solve")
    ref = tg.solve_batch(data, X0, dataclasses.replace(cfg_f, engine="torch"))
    oracle = [float(np.abs(res.u[i].cpu().numpy() - reference.gpad_solve_qp(
        qp, X0np[i].astype(np.float64), ITERS).u).max()) for i in range(4)]
    out["fixed"] = {"kernel": core.cuda_kernel(data, cfg_f),
                    "u_vs_torch_engine": (res.u - ref.u).abs().max().item(),
                    "u_vs_oracle": oracle,
                    "shared_move": shared_move(res.z, res.u)}
    check(bool(torch.isfinite(res.z).all())
          and out["fixed"]["u_vs_torch_engine"] <= ORACLE_TOL
          and max(oracle) < ORACLE_TOL, f"robust fixed solve {out['fixed']}")
    check(out["fixed"]["shared_move"] == 0.0,
          f"a scenario's plan left the shared move {out['fixed']}")

    A = np.asarray(variants[1].A, dtype=np.float32)  # the nominal plant
    Bm = np.asarray(variants[1].B, dtype=np.float32)

    def serve():
        x, steps, step_ms = X0np.copy(), [], []
        for _ in range(ROBUST_STEPS):
            y0 = ctl._y
            t0 = time.perf_counter()
            u = ctl.step(x)  # host NumPy: the device work is done
            step_ms.append((time.perf_counter() - t0) * 1e3)
            res = ctl.last_result
            ref = tg.solve_batch(data, x, dataclasses.replace(
                cfg_r, engine="torch"), y0=y0)
            du = (res.u - ref.u).abs().amax(dim=1)
            parted = du > RESTART_TOL  # a restart decision flipped near 0
            steps.append({
                "parted": int(parted.sum()),
                "u_vs_torch_engine": du[~parted].max().item()
                if not parted.all() else None,
                "shared_move": shared_move(res.z, res.u),
                "max_abs_u": float(np.abs(u).max()),
                "max_abs_sum_u": float(np.abs(u.sum(1)).max())})
            x = x @ A.T + u @ Bm.T
        return steps, step_ms

    (steps, step_ms), launches["restart_steps"] = counted(
        torch, ctr, serve, {"gpad_dual": ROBUST_STEPS}, "robust restart steps")
    worst = lambda k: max(s[k] for s in steps if s[k] is not None)
    out["restart_steps"] = {
        "steps": ROBUST_STEPS, "iterations": ITERS,
        "kernel": core.cuda_kernel(data, cfg_r),
        "parted_per_step": [s["parted"] for s in steps],
        "parted_max": parted_max(SERVE_PLANTS),
        "u_vs_torch_engine": worst("u_vs_torch_engine"),
        "shared_move": worst("shared_move"), "max_abs_u": worst("max_abs_u"),
        "max_abs_sum_u": worst("max_abs_sum_u"),
        "step_ms_host_clock": {"median": float(np.median(step_ms[1:])),
                               "first": step_ms[0]}}
    rs = out["restart_steps"]
    check(max(rs["parted_per_step"]) <= rs["parted_max"]
          and rs["u_vs_torch_engine"] <= RESTART_TOL,
          f"robust restart steps vs torch engine {rs}")
    check(rs["shared_move"] == 0.0 and rs["max_abs_u"] <= 0.3 + 1e-2
          and rs["max_abs_sum_u"] <= 1e-2, f"robust moves {rs}")

    res, launches["eps"] = counted(
        torch, ctr, lambda: tg.solve_to_accuracy(data, X0, tol=EPS_TOL),
        lambda r: {"gpad_dual_chunk": -(-int(r.iterations.max()) // 10)},
        "robust solve_to_accuracy")
    ref = tg.solve_to_accuracy(data, X0, tol=EPS_TOL, engine="torch")
    agree = eps_agreement(res, ref)
    out["eps"] = {"tol": EPS_TOL, "iterations_max": int(res.iterations.max()),
                  "converged_all": bool(res.converged.all()),
                  "residual_max": res.residual.max().item(),
                  "vs_torch_engine": agree}
    check(bool(res.converged.all())
          and res.residual.max().item() <= EPS_TOL + EPS_SLACK,
          f"robust eps {out['eps']}")
    check(agree["agree"] >= agree["batch"] - parted_max(agree["batch"]),
          f"robust eps vs torch engine {agree}")
    out["launches"] = launches
    # solves/s through the entry points, after warm-up (CUDA events)
    out["solves_per_s"] = {
        "gpu": smi, "batch": SERVE_PLANTS,
        "fixed": rate(lambda: tg.solve_batch(data, X0, cfg_f), SERVE_PLANTS),
        "restart": rate(lambda: tg.solve_batch(data, X0, cfg_r), SERVE_PLANTS),
        "solve_to_accuracy": rate(lambda: tg.solve_to_accuracy(
            data, X0, tol=EPS_TOL), SERVE_PLANTS, repeats=5)}
    emit(out)
    return launches


def phase_robust_stagewise_path(torch, tg, ts, ctr, smi):
    """The stage-wise twin of the robust stack (``scenario_stagewise_
    problem``: the three realizations as one block plant, the shared first
    move as equality rows at stage 0): at n3 N10 (n_x = n_u = 9, the
    resident kernel) and battery n8 N60 (n_x = n_u = 24, the streamed
    kernel), B256 x 200 fixed iterations, each against the torch engine.
    Once converged (2000 restart iterations, the same kernel), the
    non-anticipativity rows hold within KERNEL_TOL; at n3 N10 the first
    move also agrees with the condensed ``scenario_qp`` solve (the dual
    kernel). Returns the launches by leg."""
    from tpu_gpad_torch import robust

    out = {"phase": "robust_stagewise_path", "batch": SERVE_PLANTS,
           "iterations": ROBUST_TWIN_ITERS}
    launches, rates = {}, {"gpu": smi, "batch": SERVE_PLANTS}
    counter = {"cuda": "gpad_stagewise_resident",
               "stream": "gpad_stagewise_stream"}
    cfg = tg.SolverConfig(iterations=ROBUST_TWIN_CONVERGED, restart=True)

    def gap(z, S, n_u, N) -> float:
        """max over the batch and scenarios of |u^s_0 - u^1_0|."""
        plans = robust.scenario_stagewise_plans(z, S, n_u, N)
        return float(np.abs(plans[:, :, 0] - plans[:, :1, 0]).max())

    for shape, expect in ((ROBUST, "cuda"), (SW_RES, "stream")):
        variants = robust_variants(tg, shape)
        S, (n_u, N) = len(variants), shape
        data = tg.build_stagewise(robust.scenario_stagewise_problem(variants),
                                  iterations=ROBUST_TWIN_ITERS, device=DEVICE)
        X0np = np.random.default_rng(62).uniform(
            -0.4, 0.4, (SERVE_PLANTS, n_u)).astype(np.float32)
        X = torch.as_tensor(robust.scenario_stagewise_x0(X0np, S),
                            device=DEVICE)
        route = ts.resolve_stagewise_engine(data, SERVE_PLANTS)
        key = f"battery_n{shape[0]}_N{shape[1]}"
        res, launches[key] = counted(
            torch, ctr, lambda: tg.solve_stagewise(data, X),
            {counter[expect]: 1}, f"twin {key}")
        ref = tg.solve_stagewise(data, X, engine="torch")
        out[key] = {"n_x": data.n_x, "n_u": data.n_u, "m_x": data.m_x,
                    "m_u": data.m_u, "route": route,
                    "u_z_vs_torch_engine": max_err((res.u, res.z),
                                                   (ref.u, ref.z)),
                    "residual_max": res.residual.max().item(),
                    "non_anticipativity_max": gap(res.z, S, n_u, N)}
        check(route == expect, f"twin {key} routed to {route}")
        check(out[key]["u_z_vs_torch_engine"] <= KERNEL_TOL,
              f"twin {key} vs torch engine {out[key]}")
        rates[key] = rate(lambda: tg.solve_stagewise(data, X), SERVE_PLANTS)

        # converged: the shared first move holds; at n3 N10 it is the
        # condensed stack's first move
        leg, want, cond = f"{key}_converged", {counter[expect]: 1}, None
        if shape == ROBUST:
            qp = tg.scenario_qp([tg.condense(p) for p in variants])
            cond = tg.dualize(qp, ITERS, paired="auto", device=DEVICE)
            want["gpad_dual"] = 1
        both = lambda: (tg.solve_stagewise(data, X, config=cfg),
                        None if cond is None
                        else tg.solve_batch(cond, X0np, cfg))
        (tw, cd), launches[leg] = counted(torch, ctr, both, want,
                                          f"twin {key} converged")
        out[leg] = {"iterations": ROBUST_TWIN_CONVERGED,
                    "residual_max": tw.residual.max().item(),
                    "non_anticipativity_max": gap(tw.z, S, n_u, N)}
        if cd is not None:
            out[leg]["condensed_residual_max"] = cd.residual.max().item()
            out[leg]["first_move_vs_condensed"] = (
                tw.u[:, :n_u] - cd.u).abs().max().item()
        cv = out[leg]
        check(cv["non_anticipativity_max"] <= KERNEL_TOL
              and cv.get("first_move_vs_condensed", 0.0) <= ROBUST_TWIN_TOL,
              f"twin {key} converged {cv}")
    out["launches"] = launches
    out["solves_per_s"] = rates
    emit(out)
    return launches


def mhe_streams(A, B, C, batch, steps, seed):
    """``batch`` measurement streams of ``steps`` samples from the double
    integrator: a known input (a sine and a stabilizing feedback), process
    noise inside the w box, position measured with noise of std 0.1.
    Returns Y (batch, steps, 1), U (batch, steps, 1) and the states."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (batch, 2)) * [0.8, 0.2]
    phase = rng.uniform(0.0, 6.0, (batch, 1))
    ys, us, xs = [], [], []
    for k in range(steps):
        ys.append(x @ C.T + rng.normal(0.0, 0.1, (batch, 1)))
        xs.append(x)
        u = 0.4 * np.sin(0.11 * k + phase) - x @ np.array([[0.5], [1.0]])
        us.append(u)
        x = x @ A.T + u @ B.T + np.clip(
            rng.normal(0.0, [0.01, 0.063], (batch, 2)), -0.05, 0.05)
    return (np.stack(ys, 1).astype(np.float32),
            np.stack(us, 1).astype(np.float32), np.stack(xs, 1))


def mhe_big_plant():
    """tools/bench_mhe_stagewise.py's big-state plant and windows (its
    generator, seed 7): n_x 30, n_u 8, n_y 15, window 120, 64 windows."""
    n, p, q, T, B = (MHE_BIG[k] for k in ("n_x", "n_u", "n_y", "window",
                                          "batch"))
    rng = np.random.default_rng(7)
    A = rng.normal(0, 1.0, (n, n)) / np.sqrt(n)
    A *= 0.92 / max(abs(np.linalg.eigvals(A)))
    Bm = rng.normal(0, 0.3, (n, p))
    C = rng.normal(0, 1.0, (q, n)) / np.sqrt(n)
    kw = dict(W=np.eye(n) * 1e-2, V=np.eye(q) * 1e-2,
              x_min=-4.0 * np.ones(n), x_max=4.0 * np.ones(n),
              w_min=-0.4 * np.ones(n), w_max=0.4 * np.ones(n),
              iterations=MHE_BIG["iterations"])
    X = rng.uniform(-0.5, 0.5, (B, n))
    U = rng.uniform(-0.5, 0.5, (B, T - 1, p)).astype(np.float32)
    Ys = []
    x = X.copy()
    for k in range(T):
        Ys.append(x @ C.T + rng.normal(0, 0.05, (B, q)))
        if k < T - 1:
            w = np.clip(rng.normal(0, 0.05, (B, n)), -0.4, 0.4)
            x = x @ A.T + U[:, k] @ Bm.T + w
    Y = np.stack(Ys, axis=1).astype(np.float32)
    x_bar = (X + rng.normal(0, 0.1, (B, n))).astype(np.float32)
    return (A, Bm, C, kw), (x_bar, Y, U)


def phase_mhe_path(torch, tg, ctr, smi):
    """Moving-horizon estimation, each leg counted from 0. Condensed: the
    double integrator (n_x 2) over a window of 180 with state and
    disturbance boxes (n_z 360, m 1436), 256 windows x 400 restart
    iterations through ``solve_window`` (the tiled dual kernel), against
    the torch engine per window; then 30 streaming ``update`` calls on one
    stream at window 60 (the dual kernel at B1, warm across slides).
    Stage-wise: the big-state plant (n_x 30, window 120) where ``auto``
    takes the stage-wise engine, 64 windows x 200 iterations on the torch
    engine, 8 of them against the same solve in float64 on the host.
    Returns the launches by leg."""
    import copy

    from tpu_gpad_torch.solver import core
    from tpu_gpad_torch.stagewise import STAGEWISE_TENSOR_FIELDS

    di = tg.problems.double_integrator(dt=0.1)
    A, Bm, C = np.asarray(di.A), np.asarray(di.B), np.array([[1.0, 0.0]])
    out = {"phase": "mhe_path"}
    launches, rates = {}, {"gpu": smi}

    def torch_engine(est):
        """The same estimator on the torch engine."""
        ref = copy.copy(est)
        ref.config = dataclasses.replace(est.config, engine="torch")
        return ref

    def per_window(x_hat, x_ref, B):
        """x_hat against a reference per window, relative to its scale; a
        window whose restart decision flipped parts from it."""
        x_hat, x_ref = x_hat.double().cpu(), x_ref.double().cpu()
        scale = x_ref.abs().max().item()
        e = (x_hat - x_ref).abs().amax(dim=1)
        parted = e > MHE_TOL * scale
        return {"scale": scale, "parted": int(parted.sum()),
                "parted_max": parted_max(B),
                "rel_err": e[~parted].max().item() / scale
                if not parted.all() else None}

    def held(d):
        return (d["parted"] <= d["parted_max"] and d["rel_err"] is not None
                and d["rel_err"] <= MHE_TOL)

    # condensed, window 180 on 256 streams
    est = tg.MovingHorizonEstimator(A, Bm, C, MHE_WINDOW, **MHE_KW,
                                    iterations=MHE_ITERS, device=DEVICE)
    Y, U, X = mhe_streams(A, Bm, C, MHE_BATCH, MHE_WINDOW, seed=63)
    args = (X[:, 0] + np.random.default_rng(64).normal(0, 0.1, (MHE_BATCH, 2)),
            Y, U[:, :-1])
    (x_hat, res), launches["window_180"] = counted(
        torch, ctr, lambda: est.solve_window(*args), {"gpad_dual_tiled": 1},
        "MHE window 180")
    x_ref, _ = torch_engine(est).solve_window(*args)
    d = per_window(x_hat, x_ref, MHE_BATCH)
    out["window_180"] = {
        "engine": est.engine, "kernel": core.cuda_kernel(est.data, est.config),
        "n_z": est.data.n_z, "m": est.data.m, "batch": MHE_BATCH,
        "iterations": MHE_ITERS, "residual_max": res.residual.max().item(),
        "x_hat_vs_torch_engine": d,
        "x_hat_vs_true_state": float(np.abs(x_hat.cpu().numpy()
                                            - X[:, -1]).max())}
    check(est.engine == "condensed" and bool(torch.isfinite(x_hat).all()),
          f"MHE window 180 {out['window_180']}")
    check(held(d), f"MHE window 180 x_hat vs torch engine {d}")
    rates["condensed_window_180"] = rate(lambda: est.solve_window(*args),
                                         MHE_BATCH)

    # streaming at window 60: a Kalman fill, then one solve a sample
    T = MHE_STREAM_WINDOW
    kw = dict(**MHE_KW, iterations=MHE_ITERS, device=DEVICE)
    stream = tg.MovingHorizonEstimator(A, Bm, C, T, **kw)
    plain = tg.MovingHorizonEstimator(A, Bm, C, T, **kw, config=tg.SolverConfig(
        iterations=MHE_ITERS, restart=True, engine="torch"))
    Ys, Us, _ = mhe_streams(A, Bm, C, 1, T - 1 + MHE_STREAM_UPDATES, seed=65)
    feed = lambda est, k: est.update(Ys[0, k], Us[0, k - 1] if k else None)
    for k in range(T - 1):
        feed(stream, k)
        feed(plain, k)

    def updates():
        return [(feed(stream, k), feed(plain, k))
                for k in range(T - 1, T - 1 + MHE_STREAM_UPDATES)]

    pairs, launches["stream_60"] = counted(
        torch, ctr, updates, {"gpad_dual": MHE_STREAM_UPDATES},
        "MHE streaming updates")
    d = per_window(torch.as_tensor(np.stack([a for a, _ in pairs])),
                   torch.as_tensor(np.stack([b for _, b in pairs])),
                   MHE_STREAM_UPDATES)
    out["stream_60"] = {
        "updates": MHE_STREAM_UPDATES,
        "kernel": core.cuda_kernel(stream.data, stream.config),
        "warm_dual": None if stream._y0 is None else list(stream._y0.shape),
        "x_hat_vs_torch_engine": d}
    check(held(d) and stream._y0 is not None,
          f"MHE streaming updates {out['stream_60']}")

    # stage-wise: the big-state plant past the 256 MB backstop
    (Ab, Bb, Cb, kwb), argsb = mhe_big_plant()
    t0 = time.perf_counter()
    big = tg.MovingHorizonEstimator(Ab, Bb, Cb, MHE_BIG["window"], **kwb,
                                    device=DEVICE)
    build_s = time.perf_counter() - t0
    (xb, resb), launches["stagewise_120"] = counted(
        torch, ctr, lambda: big.solve_window(*argsb), {},
        "stage-wise MHE (the torch engine)")
    d64 = dataclasses.replace(big.data, **{
        f: getattr(big.data, f).double().cpu() for f in STAGEWISE_TENSOR_FIELDS})
    big64 = copy.copy(big)
    big64.data = d64
    big64.structure = dataclasses.replace(big.structure, data=d64)
    k = MHE_REF_WINDOWS
    x64, _ = big64.solve_window(*(a[:k] for a in argsb))
    d = per_window(xb[:k], x64, k)
    out["stagewise_120"] = {
        "engine": big.engine, "n_x": MHE_BIG["n_x"],
        "window": MHE_BIG["window"], "batch": MHE_BIG["batch"],
        "iterations": MHE_BIG["iterations"],
        "projected_condensed_mb": tg.mhe.condensed_window_mb(
            MHE_BIG["window"], MHE_BIG["n_x"]),
        "build_s_host_clock": build_s,
        "residual_max": resb.residual.max().item(),
        "x_hat_vs_float64_host": d}
    check(big.engine == "stagewise" and bool(torch.isfinite(xb).all()),
          f"stage-wise MHE {out['stagewise_120']}")
    check(held(d), f"stage-wise MHE vs float64 {d}")
    rates["stagewise_window_120"] = rate(lambda: big.solve_window(*argsb),
                                         MHE_BIG["batch"], repeats=3)
    out["launches"] = launches
    out["windows_per_s"] = rates
    emit(out)
    return launches


def phase_estimator_path(torch, tg, ctr):
    """examples/offset_free_mpc.py on the card: the double integrator N10,
    only the position measured, an unknown actuator bias of 0.08, setpoint
    1.5; ``OffsetFreeController`` (Kalman filter, steady-state target,
    restart ``Controller``, 80 iterations: the dual kernel) for 120 steps.
    Each step's solve against the torch engine on the same parameter and
    warm start (restart parting allowed in parted_max of the steps); the
    output settles on the setpoint and the bias is identified. Returns the
    launches."""
    from tpu_gpad_torch.solver import core

    problem = tg.problems.double_integrator(horizon=10)
    C = np.array([[1.0, 0.0]])
    cfg = tg.SolverConfig(iterations=OFFSET_ITERS, restart=True)
    off = tg.OffsetFreeController(problem, C, disturbance="input", config=cfg,
                                  device=DEVICE)
    ctl, cfg_t = off.controller, dataclasses.replace(cfg, engine="torch")
    A, Bm = np.asarray(problem.A), np.asarray(problem.B)
    r = np.array([OFFSET_R])
    f32 = lambda a: np.asarray(a, dtype=np.float32)

    def run():
        x, step_ms, du, active = np.zeros(2), [], [], 0
        for _ in range(OFFSET_STEPS):
            y0 = ctl._y
            t0 = time.perf_counter()
            u = off.step(C @ x, r)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            # the step's parameter: the estimate, the target and the
            # disturbance (input bias: Bd = B)
            x_ss, u_ss = off.last_target
            p = ctl._parameter(f32(off.x_hat)[None], f32(x_ss), f32(u_ss),
                               f32(Bm @ off.d_hat))
            ref = tg.solve_batch(ctl.data, p, cfg_t, y0=y0)
            du.append((ctl.last_result.u - ref.u).abs().max().item())
            active += bool((ctl.last_result.y > 0).any())
            x = A @ x + Bm @ (u.astype(np.float64) + OFFSET_BIAS)
        return x, step_ms, np.array(du), active

    (x, step_ms, du, active), launches = counted(
        torch, ctr, run, {"gpad_dual": OFFSET_STEPS}, "offset-free steps")
    parted = du > RESTART_TOL  # a restart decision flipped near 0
    out = {"phase": "estimator_path", "steps": OFFSET_STEPS,
           "kernel": core.cuda_kernel(ctl.data, cfg),
           "launches": launches,
           "u_vs_torch_engine": {
               "parted": int(parted.sum()),
               "parted_max": parted_max(OFFSET_STEPS),
               "max": float(du[~parted].max()) if not parted.all() else None},
           # steps whose solve left a constraint active (dual > 0)
           "dual_active_steps": active,
           "output_error": float(abs(C @ x - r)[0]),
           "d_hat": float(off.d_hat[0]), "bias": OFFSET_BIAS,
           "step_ms_host_clock": {"median": float(np.median(step_ms[1:])),
                                  "first": step_ms[0]}}
    emit(out)
    vs = out["u_vs_torch_engine"]
    check(vs["parted"] <= vs["parted_max"] and vs["max"] is not None
          and vs["max"] <= RESTART_TOL, f"offset-free steps vs torch engine {out}")
    check(out["output_error"] < OFFSET_TOL, f"offset-free output {out}")
    check(abs(out["d_hat"] - OFFSET_BIAS) < OFFSET_TOL,
          f"offset-free bias estimate {out}")
    return launches


def pendulum(tg):
    """tools/bench_nmpc_device.py's plant: the damped pendulum, rk4 at
    dt 0.05."""
    return tg.rk4(tg.problems.pendulum_dynamics(), 0.05)


def gravity_pendulum(torch, tg, g):
    """tools/bench_robust_device.py's model of gravity g."""
    def f_cont(x, u):
        return torch.stack([x[1], g * torch.sin(x[0]) - 0.1 * x[1] + u[0]])

    return tg.rk4(f_cont, 0.05)


def nmpc_fleet():
    """The fleet's states: the swing-up start plus U(-0.1, 0.1), seed 0."""
    rng = np.random.default_rng(0)
    return (NMPC_X0 + rng.uniform(-0.1, 0.1, (NMPC_FLEET, 2))).astype(
        np.float32)


def phase_nmpc_dual_vs_plain(torch, tg, dual_kernels, core):
    """The dual kernel against its plain version on data condensed and
    dualized on the card (``dualize_ltv_device``, ``dualize_scenario_device``:
    L, D and the maps come from the device), at the NMPC path's shapes:
    the swing-up's linearization at its start (m_h 25), one plant (B1) and
    the fleet's 64 parameters (B64), fixed and restart (held per scenario),
    and the robust stack of three models (m_h 106). Errors are relative to
    the largest plain output (the moves reach the 11 N m limit)."""
    from tpu_gpad_torch.device_condense import dualize_scenario_device
    from tpu_gpad_torch.problems.pendulum import UPRIGHT

    f = pendulum(tg)
    N, iters = NMPC_KW["horizon"], NMPC_KW["iterations"]
    x0 = torch.as_tensor(NMPC_X0, device=DEVICE)
    us = torch.zeros((N, 1), device=DEVICE)
    xs = tg.nonlinear.rollout(f, x0, us)
    A, B, c = tg.nonlinear.linearize(f, torch.cat([x0[None], xs[:-1]]), us)
    kw = {k: NMPC_KW[k] for k in ("Q", "R", "u_min", "u_max")}
    data = tg.dualize_ltv_device(A, B, c, iterations=iters, **kw)
    check(data.device.type == "cuda" and core.cuda_kernel(
        data, tg.SolverConfig(iterations=iters, restart=True)) == "dual",
        "device-condensed data is not served by the dual kernel")
    P = torch.as_tensor(np.concatenate(
        [nmpc_fleet(), np.tile(UPRIGHT, (NMPC_FLEET, 1))], axis=1),
        dtype=torch.float32, device=DEVICE)

    def run(d, B, restart=False, y0=None, iterations=iters):
        g_P, p_D = (t[:B].contiguous() for t in core.affine_params(d, P[:, :d.n_x]))
        kw = dict(iterations=iterations, restart=restart)
        out_k = dual_kernels.gpad_fixed_dual(d, g_P, p_D, y0, **kw)
        out_p = dual_kernels.gpad_fixed_dual_torch(d, g_P, p_D, y0, **kw)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t).all()) for t in out_k),
              "dual kernel output not finite on device-condensed data")
        scale = max(1.0, max(t.abs().max().item() for t in out_p))
        if restart:
            parting = restart_parting(torch, d, g_P, p_D, y0, out_k[0],
                                      out_p[0], iterations)
            return parting, out_k
        return max_err(out_k, out_p) / scale, out_k

    cases = {}
    cases["ltv_B1"], _ = run(data, 1)
    cases["ltv_B64"], (_, y64, _, _) = run(data, NMPC_FLEET)
    parting = {"ltv_B64_restart": run(data, NMPC_FLEET, restart=True)[0],
               "ltv_B64_restart_warm": run(data, NMPC_FLEET, restart=True,
                                           y0=y64)[0]}
    gs, rkw = ROBUST_NMPC_GS, ROBUST_NMPC_KW
    lins = []
    for g in gs:
        fg = gravity_pendulum(torch, tg, g)
        u0 = torch.zeros((rkw["horizon"], 1), device=DEVICE)
        x = torch.as_tensor(ROBUST_NMPC_X0, device=DEVICE)
        xs = tg.nonlinear.rollout(fg, x, u0)
        lins.append(tg.nonlinear.linearize(
            fg, torch.cat([x[None], xs[:-1]]), u0))
    A, B, c = (torch.stack(t) for t in zip(*lins))
    scen = dualize_scenario_device(
        A, B, c, rkw["Q"], rkw["R"], rkw["u_min"], rkw["u_max"],
        iterations=rkw["iterations"], x_min=rkw["x_min"], x_max=rkw["x_max"])
    cases["scenario_B1"], _ = run(scen, 1, iterations=rkw["iterations"])
    parting["scenario_B64_restart"] = run(scen, NMPC_FLEET, restart=True,
                                          iterations=rkw["iterations"])[0]
    emit({"phase": "nmpc_dual_kernel_vs_plain",
          "m_half": {"ltv": data.m_half, "scenario": scen.m_half},
          "L": {"ltv": data.L.item(), "scenario": scen.L.item()},
          "rel_err": cases, "restart_parting": parting,
          "tol": KERNEL_TOL, "restart_tol_u_z": RESTART_TOL})
    check(max(cases.values()) <= KERNEL_TOL,
          f"dual kernel vs plain on device-condensed data: {cases}")
    for name, p in parting.items():
        check(p["parted"] <= p["parted_max"] and p["u_z"] is not None
              and p["u_z"] <= RESTART_TOL, f"{name}: {p}")
    return max(max(cases.values()), max(p["u_z"] for p in parting.values()))


def timed(torch, fn):
    """(fn's result, its host-clock seconds up to a device sync)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def without_host_sync(torch, fn):
    """Run ``fn`` with PyTorch's sync debug mode at "error": any call that
    waits for the card on the host (a copy back, ``.item()``, a status
    read) raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def pass_breakdown(torch, tg, f, ctrls, x, us, p, y, rounds=21) -> dict:
    """Where one SQP pass of the swing-up spends its time, ms a call: the
    rollout, rollout and Jacobians, the device and the host condensation,
    the dual-kernel solve, and the whole device and host passes. Each is
    timed once a round (host clock between device syncs), the pieces in
    turns so that the host's drift spreads over all of them; the median
    of ``rounds`` after a warm-up round."""
    from tpu_gpad_torch.device_condense import dualize_ltv

    dev, host = ctrls["device"], ctrls["host"]

    A, B, c = tg.nonlinear.linearize(
        f, torch.cat([x[None], tg.nonlinear.rollout(f, x, us)[:-1]]), us)
    data = dualize_ltv(dev._consts, A, B, c)
    problem = host._linearized_problem(us, x)
    cfg = dev.config
    pieces = {
        "rollout": lambda: tg.nonlinear.rollout(f, x, us),
        "rollout_and_jacobians": lambda: tg.nonlinear._linearize_along(
            f, x, us),
        "device_condensation": lambda: dualize_ltv(dev._consts, A, B, c),
        "host_condensation": lambda: host._dualize(problem),
        "dual_kernel_solve": lambda: tg.solve_batch(
            data, p[None], config=cfg, y0=y[None]),
        "device_pass": lambda: dev._device_pass(x, us, p, y),
        "host_pass": lambda: tg.solve_batch(
            host._dualize(host._linearized_problem(us, x)), p[None],
            config=cfg, y0=None),
    }
    times = {name: [] for name in pieces}
    for r in range(rounds + 1):
        for name, fn in pieces.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if r:  # round 0 warms up
                times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: float(np.median(t)) for name, t in times.items()}


def phase_nmpc_path(torch, tg, ctr, smi):
    """The NMPC layer on the card at tools/bench_nmpc_device.py's
    configuration, each leg counted from 0 after a warm-up call: 80
    samples of the swing-up with host condensation (``NMPC``), with device
    condensation (``NMPC(device_condense=True)``) and as one loop on the
    card (``simulate_nonlinear_device``), each 2 dual-kernel launches a
    sample; then one ``plan_batch`` over 64 plants, host and device, 64
    launches a pass. Each leg settles upright, the legs' trajectories and
    the fleet's first moves agree. Returns the launches by leg."""
    from tpu_gpad_torch.problems.pendulum import UPRIGHT

    f = pendulum(tg)
    n, sqp = NMPC_SAMPLES, NMPC_KW["sqp_iters"]
    per_leg = {"gpad_dual": n * sqp}
    out = {"phase": "nmpc_path", "gpu": smi, "samples": n,
           "horizon": NMPC_KW["horizon"], "iterations": NMPC_KW["iterations"],
           "sqp_iters": sqp}
    launches, trajs = {}, {}
    ctrls = {"host": tg.NMPC(f, **NMPC_KW, device=DEVICE),
             "device": tg.NMPC(f, **NMPC_KW, device_condense=True,
                               device=DEVICE)}
    for label, ctrl in ctrls.items():
        ctrl.step(NMPC_X0, UPRIGHT)  # warm-up, then a fresh start
        ctrl.reset()
        ((X, U), secs), launches[label] = counted(
            torch, ctr, lambda: timed(torch, lambda: tg.simulate_nonlinear(
                f, ctrl, NMPC_X0, n, x_ref=UPRIGHT)), per_leg, f"nmpc {label}")
        trajs[label] = X
        out[label] = {"ms_per_sample": secs / n * 1e3,
                      "theta_err_final": float(abs(X[-1, 0] - np.pi)),
                      "max_abs_u": float(np.abs(U).max())}
    dev = ctrls["device"]
    # one device pass, single and for the fleet, with no host sync in it
    x = torch.as_tensor(NMPC_X0, device=DEVICE)
    us = torch.zeros((NMPC_KW["horizon"], 1), device=DEVICE)
    p = torch.cat([x, torch.as_tensor(UPRIGHT, dtype=torch.float32,
                                      device=DEVICE)])
    y = torch.zeros((2, dev._m_h), device=DEVICE)
    F = NMPC_FLEET

    def passes():
        dev._device_pass(x, us, p, y)
        dev._device_pass(x.expand(F, 2), us.expand(F, -1, -1),
                         p.expand(F, -1), y.expand(F, -1, -1))

    passes()  # the batched pass's first call outside the check
    torch.cuda.synchronize()
    without_host_sync(torch, passes)
    torch.cuda.synchronize()
    out["device_pass_host_syncs"] = 0
    out["pass_breakdown_ms"] = pass_breakdown(torch, tg, f, ctrls, x, us, p, y)
    tg.simulate_nonlinear_device(f, dev, NMPC_X0, 2, x_ref=UPRIGHT)  # warm-up
    ((X, U), secs), launches["scanned"] = counted(
        torch, ctr, lambda: timed(torch, lambda: tg.simulate_nonlinear_device(
            f, dev, NMPC_X0, n, x_ref=UPRIGHT)), per_leg, "nmpc scanned")
    trajs["scanned"] = X
    out["scanned"] = {"ms_per_sample": secs / n * 1e3,
                      "theta_err_final": float(abs(X[-1, 0] - np.pi)),
                      "max_abs_u": float(np.abs(U).max())}
    for a, b in (("host", "device"), ("device", "scanned"),
                 ("host", "scanned")):
        out[f"traj_max_abs_diff_{a}_vs_{b}"] = float(
            np.abs(trajs[a] - trajs[b]).max())

    X0 = nmpc_fleet()
    plans = {}
    out["plan_batch"] = {"plants": NMPC_FLEET}
    for label, ctrl in ctrls.items():
        ctrl.plan_batch(X0, UPRIGHT)  # warm-up, then a fresh start
        ctrl.reset()
        (U0, secs), launches[f"plan_batch_{label}"] = counted(
            torch, ctr, lambda: timed(torch, lambda: ctrl.plan_batch(
                X0, UPRIGHT)), {"gpad_dual": NMPC_FLEET * sqp},
            f"nmpc plan_batch {label}")
        plans[label] = U0[:, 0]
        out["plan_batch"][f"{label}_ms"] = secs * 1e3
    out["plan_batch"]["u0_max_abs_diff"] = float(
        np.abs(plans["host"] - plans["device"]).max())
    out["launches"] = launches
    emit(out)
    for label in ("host", "device", "scanned"):
        check(out[label]["theta_err_final"] < NMPC_SETTLE
              and out[label]["max_abs_u"] <= 11.0 + 1e-3,
              f"nmpc {label} leg {out[label]}")
    for key in ("traj_max_abs_diff_host_vs_device",
                "traj_max_abs_diff_device_vs_scanned"):
        check(out[key] < NMPC_TRAJ_TOL, f"nmpc {key} {out[key]}")
    check(out["plan_batch"]["u0_max_abs_diff"] < NMPC_TRAJ_TOL,
          f"nmpc plan_batch {out['plan_batch']}")
    return launches


def phase_robust_nmpc_path(torch, tg, ctr, smi):
    """``RobustNMPC`` at tools/bench_robust_device.py's configuration (three
    gravities, horizon 12, state boxes, 150 restart iterations) for 60
    samples against the g = 10.8 plant, host and device condensation, each
    leg counted from 0 after a warm-up step: one dual-kernel launch a
    sample. Both settle and follow the same trajectory, every scenario's
    plan keeps the shared first move. Returns the launches by leg."""
    models = [gravity_pendulum(torch, tg, g) for g in ROBUST_NMPC_GS]
    plant, n = models[-1], ROBUST_NMPC_SAMPLES
    ref = np.array([np.pi, 0.0], dtype=np.float32)
    out = {"phase": "robust_nmpc_path", "gpu": smi, "samples": n,
           "models": len(models), "horizon": ROBUST_NMPC_KW["horizon"],
           "iterations": ROBUST_NMPC_KW["iterations"]}
    launches, trajs = {}, {}
    for label, dev in (("host", False), ("device", True)):
        ctrl = tg.RobustNMPC(models, device_condense=dev, **ROBUST_NMPC_KW,
                             device=DEVICE)
        ctrl.step(ROBUST_NMPC_X0, ref)  # warm-up, then a fresh start
        ctrl.reset()
        if dev:  # one robust device pass, with no host sync in it
            x = torch.as_tensor(ROBUST_NMPC_X0, device=DEVICE)
            args = (x, torch.zeros((len(models), ROBUST_NMPC_KW["horizon"], 1),
                                   device=DEVICE),
                    torch.cat([x, torch.as_tensor(ref, device=DEVICE)]),
                    torch.zeros((2, ctrl._m_h), device=DEVICE))
            without_host_sync(torch, lambda: ctrl._device_pass(*args))
            torch.cuda.synchronize()
            out["device_pass_host_syncs"] = 0

        def loop():
            x, X, shared = torch.as_tensor(ROBUST_NMPC_X0, device=DEVICE), [], 0.0
            X.append(x.cpu().numpy())
            for _ in range(n):
                u = ctrl.step(X[-1], ref)
                shared = max(shared, float(np.ptp(ctrl.plans[:, 0])))
                x = plant(x, torch.as_tensor(u, device=DEVICE))
                X.append(x.cpu().numpy())
            return np.stack(X), shared

        ((X, shared), secs), launches[label] = counted(
            torch, ctr, lambda: timed(torch, loop), {"gpad_dual": n},
            f"robust nmpc {label}")
        trajs[label] = X
        out[label] = {"ms_per_sample": secs / n * 1e3,
                      "theta_err_final": float(abs(X[-1, 0] - np.pi)),
                      "shared_first_move_spread": shared}
    out["traj_max_abs_diff"] = float(np.abs(trajs["host"] - trajs["device"]).max())
    out["launches"] = launches
    emit(out)
    for label in ("host", "device"):
        check(out[label]["theta_err_final"] < NMPC_SETTLE
              and out[label]["shared_first_move_spread"] == 0.0,
              f"robust nmpc {label} {out[label]}")
    check(out["traj_max_abs_diff"] < NMPC_TRAJ_TOL,
          f"robust nmpc host vs device {out['traj_max_abs_diff']}")
    return launches


def phase_nmpc_stagewise_path(torch, tg, ts, ctr, smi):
    """``NMPC(engine="stagewise")`` on the swing-up with a state box, each
    leg counted from 0 after a warm-up: 10 samples, each pass built on the
    host and solved by ``solve_stagewise`` on the route ``auto`` takes at
    these shapes (recorded; the resident kernel at one scenario on 132
    SMs), against the condensed controller's loop; then ``plan_batch``
    through ``stack_stagewise`` + ``solve_stagewise_multi`` (the
    torch engine, no kernel) over the fleet's first 8 plants, against the
    condensed ``plan_batch``; and ``solve_stagewise_multi`` alone, timed
    at 8 and 64 plants."""
    from tpu_gpad_torch.problems.pendulum import UPRIGHT

    f = pendulum(tg)
    kw = dict(NMPC_KW, **NMPC_BOX)
    n, sqp = NMPC_SW_SAMPLES, kw["sqp_iters"]
    sw = tg.NMPC(f, engine="stagewise", **kw, device=DEVICE)
    cond = tg.NMPC(f, **kw, device=DEVICE)
    problem = sw._linearized_problem(
        torch.zeros((kw["horizon"], 1), device=DEVICE),
        torch.as_tensor(NMPC_X0, device=DEVICE))
    data = tg.build_stagewise(problem, iterations=kw["iterations"],
                              x_ref=UPRIGHT, device=DEVICE)
    route = ts.resolve_stagewise_engine(data, 1)
    check(route == "cuda", f"stage-wise NMPC route {route}")
    out = {"phase": "nmpc_stagewise_path", "gpu": smi, "samples": n,
           "route": route, "m": data.m_x + data.m_u}
    launches = {}
    for ctrl in (sw, cond):
        ctrl.step(NMPC_X0, UPRIGHT)
        ctrl.reset()
    ((X, U), secs), launches["plan"] = counted(
        torch, ctr, lambda: timed(torch, lambda: tg.simulate_nonlinear(
            f, sw, NMPC_X0, n, x_ref=UPRIGHT)),
        {"gpad_stagewise_resident": n * sqp}, "stage-wise nmpc")
    X_c, _ = tg.simulate_nonlinear(f, cond, NMPC_X0, n, x_ref=UPRIGHT)
    out["ms_per_sample"] = secs / n * 1e3
    out["traj_max_abs_diff_vs_condensed"] = float(np.abs(X - X_c).max())
    X0 = nmpc_fleet()[:NMPC_SW_FLEET]
    for ctrl in (sw, cond):
        ctrl.plan_batch(X0, UPRIGHT)
        ctrl.reset()
    (U_sw, secs), launches["plan_batch"] = counted(
        torch, ctr, lambda: timed(torch, lambda: sw.plan_batch(X0, UPRIGHT)),
        {}, "stage-wise nmpc plan_batch")
    U_c = cond.plan_batch(X0, UPRIGHT)
    out["plan_batch"] = {"plants": NMPC_SW_FLEET, "ms": secs * 1e3,
                         "u0_max_abs_diff_vs_condensed": float(
                             np.abs(U_sw[:, 0] - U_c[:, 0]).max())}
    # solve_stagewise_multi alone (the torch engine, CUDA events): the
    # swing-up's stage-wise build stacked for 8 and 64 plants, B1 each
    X_all = torch.as_tensor(nmpc_fleet(), device=DEVICE)
    out["solve_stagewise_multi"] = {}
    for P in (NMPC_SW_FLEET, NMPC_FLEET):
        stacked = tg.stack_stagewise([data] * P)
        out["solve_stagewise_multi"][str(P)] = rate(
            lambda: tg.solve_stagewise_multi(stacked, X_all[:P],
                                             config=sw.config), P, repeats=3)
    out["launches"] = launches
    emit(out)
    check(out["traj_max_abs_diff_vs_condensed"] < NMPC_TRAJ_TOL,
          f"stage-wise nmpc vs condensed {out}")
    check(out["plan_batch"]["u0_max_abs_diff_vs_condensed"] < NMPC_TRAJ_TOL,
          f"stage-wise nmpc plan_batch {out['plan_batch']}")
    return launches


def grad_of_loss(f, p):
    """(u*, the gradient of 0.5 |u*|^2 at ``p``) through the solver ``f``."""
    p = p.detach().clone().requires_grad_(True)
    u = f(p)
    (0.5 * (u * u).sum()).backward()
    return u.detach(), p.grad


def exact_loss_grad(qp, p, h=DIFF_FD_H):
    """Central differences of 0.5 |u*|^2 of the float64 exact QP at ``p``."""
    from tpu_gpad_torch.solver.qp import solve_condensed_qp

    def loss(x):
        sol = solve_condensed_qp(qp, x)
        check(sol.status == "optimal", f"exact QP at {x}: {sol.status}")
        return 0.5 * float(np.sum(sol.z[:qp.n_u] ** 2))

    p = np.asarray(p, np.float64)
    return np.array([(loss(p + h * e) - loss(p - h * e)) / (2 * h)
                     for e in np.eye(p.size)])


def in_turns(fns: dict, rounds=DIFF_ROUNDS, repeats=5) -> dict:
    """CUDA-event ms a call of each of ``fns``, in turns: every round times
    each function (median of ``repeats`` calls after one warm-up call), so
    that the card's drift spreads over all of them; the median over the
    rounds and the range."""
    from tpu_gpad_torch.utils import device_time_per_call

    ms = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            ms[k].append(device_time_per_call(fn, warmup=1, repeats=repeats)
                         * 1e3)
    return {k: {"ms": float(np.median(v)), "ms_min": min(v), "ms_max": max(v)}
            for k, v in ms.items()}


SW_KERNEL = {"cuda": "gpad_stagewise_resident", "stream": "gpad_stagewise_stream"}


def diff_condensed_legs(torch, tg, diff, ctr, out, launches):
    """The headline legs of ``phase_diff_path``: the fixed and restart
    gradients, the exact QP's differences, chol against cg."""
    qp, data = headline(tg)
    X0np, X0 = flag_x0(torch, data.n_x, BATCH, seed=31)
    legs = (("fixed", tg.SolverConfig(), "gpad_paired_flat"),
            ("restart", tg.SolverConfig(iterations=ITERS, restart=True),
             "gpad_dual"))
    grads, duals = {}, {}
    for leg, cfg, kernel in legs:
        f = tg.make_differentiable_solver(data, cfg)
        (u_k, g_k), launches[leg] = counted(
            torch, ctr, lambda: grad_of_loss(f, X0), {kernel: 1}, f"diff {leg}")
        plain = dataclasses.replace(cfg, engine="torch")
        u_t, g_t = grad_of_loss(tg.make_differentiable_solver(data, plain), X0)
        grads[leg] = g_k
        duals[leg] = y_k = tg.solve_batch(data, X0, cfg).y
        m_k = diff.active_signs(data, y_k)[0]
        m_t = diff.active_signs(data, tg.solve_batch(data, X0, plain).y)[0]
        scale = g_t.abs().max().item()
        err = (g_k - g_t).abs().amax(dim=-1)
        parted = (m_k != m_t).any(dim=-1) | (err > DIFF_GRAD_RTOL * scale)
        out[leg] = {
            "kernel": kernel, "batch": BATCH, "grad_scale": scale,
            "grad_max_err": err.max().item(),
            "mask_rows_differing": int((m_k != m_t).sum()),
            "active_rows": int(m_k.sum()),
            "scenarios_parted": int(parted.sum()),
            "parted_max": parted_max(BATCH),
            "grad_max_err_not_parted": None if parted.all()
            else err[~parted].max().item(),
            "u_max_err": (u_k - u_t).abs().max().item()}
    # the restart leg's (converged) first scenarios against the exact QP
    g = grads["restart"].cpu().numpy()
    out["restart"]["vs_exact_qp_fd"] = [
        float(np.abs(g[i] - exact_loss_grad(qp, X0np[i])).max())
        for i in range(DIFF_FD)]
    before = diff.CG_ITERATIONS
    K_ch = diff.sensitivity(data, duals["restart"], method="chol")[0]
    K_cg = diff.sensitivity(data, duals["restart"], method="cg")[0]
    outside = ((K_cg - K_ch).abs() - DIFF_CG_ATOL
               - DIFF_CG_RTOL * K_ch.abs()).amax(dim=(1, 2)) > 0
    out["sensitivity"] = {
        "auto": diff.resolve_method(data, BATCH), "batch": BATCH,
        "chol_finite": bool(torch.isfinite(K_ch).all()),
        "scale": K_ch.abs().max().item(),
        "chol_vs_cg_max_err": (K_cg - K_ch).abs().max().item(),
        "scenarios_outside_test_bound": int(outside.sum()),
        "cg_iterations": diff.CG_ITERATIONS - before,
        "test_bound": {"rtol": DIFF_CG_RTOL, "atol": DIFF_CG_ATOL}}


def diff_data_leg(torch, tg, ctr, out, launches):
    """tests/test_diff_data.py's weight-learning composition on the card:
    ``dualize_ltv_device`` with a tensor Q, then
    ``make_data_differentiable_solver`` under restart (the dual kernel);
    Q.grad against central differences."""
    N = 6
    A = torch.tensor([[[1.0, 0.1], [0.0, 0.95]]] * N, device=DEVICE)
    Bm = torch.tensor([[[0.005], [0.1]]] * N, device=DEVICE)
    c = torch.zeros((N, 2), device=DEVICE)
    P = torch.tensor([[1.2, -0.4, 0.0, 0.0], [0.6, 0.3, 0.0, 0.0]],
                     device=DEVICE)
    f = tg.make_data_differentiable_solver(
        tg.SolverConfig(iterations=250, restart=True))

    def loss(q):
        d = tg.dualize_ltv_device(A, Bm, c, torch.diag(q), 0.4 * np.eye(1),
                                  np.full(1, -0.5), np.full(1, 0.5),
                                  iterations=300)
        return 0.5 * (f(d, P) ** 2).sum()

    q0 = torch.tensor([1.0, 0.6], device=DEVICE)

    def grad():
        q = q0.clone().requires_grad_(True)
        loss(q).backward()
        return q.grad

    g, launches["data_path"] = counted(torch, ctr, grad, {"gpad_dual": 1},
                                       "diff data path")
    with torch.no_grad():
        fd = [(loss(q0 + DIFF_Q_H * e) - loss(q0 - DIFF_Q_H * e)).item()
              / (2 * DIFF_Q_H) for e in torch.eye(2, device=DEVICE)]
    g = g.cpu().tolist()
    out["data_path"] = {
        "q_grad": g, "q_grad_fd": fd,
        "excess_over_tol": max(abs(a - b) - max(DIFF_Q_ABS, DIFF_Q_REL * abs(b))
                               for a, b in zip(g, fd))}


def diff_gain_leg(torch, tg, diff, ctr, out, launches):
    """``Controller.gain`` after a restart step on 256 plants (one dual
    kernel launch, the gain none), against ``feedback_gain`` of the same
    dual in float64. Returns the controller for the timing."""
    from tpu_gpad_torch.types import GPAD_TENSOR_FIELDS

    ctrl = tg.Controller(tg.problems.battery(**HEADLINE), iterations=ITERS,
                         config=tg.SolverConfig(iterations=ITERS, restart=True),
                         device=DEVICE)
    X = flag_x0(torch, 3, SERVE_PLANTS, seed=33)[0]
    K, launches["controller_gain"] = counted(
        torch, ctr, lambda: (ctrl.step(X), ctrl.gain())[1], {"gpad_dual": 1},
        "diff Controller.gain")
    d64 = dataclasses.replace(ctrl.data, **{
        f: getattr(ctrl.data, f).double() for f in GPAD_TENSOR_FIELDS
        if getattr(ctrl.data, f) is not None})
    K64 = diff.feedback_gain(d64, ctrl.last_result).cpu().numpy()
    out["controller_gain"] = {
        "plants": SERVE_PLANTS, "shape": list(K.shape),
        "finite": bool(np.isfinite(K).all()),
        "max_err_vs_float64": float(np.abs(K - K64).max()),
        "scale": float(np.abs(K64).max())}
    return ctrl, X


def diff_stagewise_legs(torch, tg, diff, ts, ctr, out, launches):
    """The stage-wise adjoint legs of ``phase_diff_path``. Returns what the
    timing reuses."""
    from tpu_gpad_torch.condense import lipschitz_constant

    cfg = tg.SolverConfig(iterations=DIFF_SW_ITERS, restart=True)
    # the gain at n8 N60 B64: the resident kernel
    d8 = sw_data(tg, DIFF_SW_RES, SW_RES_ITERS)
    X8 = torch.as_tensor(np.random.default_rng(35).uniform(
        -DIFF_SW_X0, DIFF_SW_X0, (DIFF_SW_RES_BATCH, d8.n_x)).astype(
            np.float32), device=DEVICE)
    route = ts.resolve_stagewise_engine(d8, DIFF_SW_RES_BATCH)
    check(route == "cuda", f"diff stage-wise n8 N60 B64 routes to {route}")
    before = diff.CG_ITERATIONS
    (K8, secs), launches["stagewise_gain"] = counted(
        torch, ctr, lambda: timed(torch, lambda: diff.stagewise_feedback_gain(
            d8, X8, config=cfg)), {SW_KERNEL[route]: 1}, "diff stage-wise gain")
    out["stagewise_gain"] = {
        "shape": list(K8.shape), "route": route, "iterations": DIFF_SW_ITERS,
        "finite": bool(torch.isfinite(K8).all()),
        "cg_iterations": diff.CG_ITERATIONS - before,
        "cg_cap": d8.horizon * d8.n_u + 40, "first_call_s": secs}
    # the same adjoint against the condensed one at n3 N10
    prob = tg.problems.battery(*DIFF_SW_CMP)
    qp = tg.condense(prob)
    L = lipschitz_constant(qp)
    d3 = tg.build_stagewise(prob, iterations=DIFF_SW_ITERS, L=L, device=DEVICE)
    d3c = tg.dualize(qp, DIFF_SW_ITERS, paired="auto", L=L, device=DEVICE)
    X3 = 0.75 * sw_x0(torch, DIFF_SW_CMP_BATCH, 3, seed=37)
    route3 = ts.resolve_stagewise_engine(d3, DIFF_SW_CMP_BATCH)
    check(route3 in SW_KERNEL, f"diff stage-wise n3 N10 routes to {route3}")
    (K_s, K_c), launches["stagewise_vs_condensed"] = counted(
        torch, ctr, lambda: (
            diff.stagewise_feedback_gain(d3, X3, config=cfg),
            diff.sensitivity(d3c, tg.solve_batch(d3c, X3, cfg).y)[0]),
        {SW_KERNEL[route3]: 1, "gpad_dual": 1}, "diff stage-wise vs condensed")
    out["stagewise_vs_condensed"] = {
        "route": route3, "batch": DIFF_SW_CMP_BATCH,
        "max_err": (K_s - K_c).abs().max().item(), "tol": DIFF_SW_TOL}
    # one directional VJP at n30 N200 B8: the streamed kernel
    d30 = sw_data(tg, SW_FULL, SW_FULL_ITERS)
    f30 = diff.make_differentiable_stagewise_solver(d30, config=dataclasses.replace(
        cfg, iterations=DIFF_SW_STREAM_ITERS))
    x30 = torch.as_tensor(np.random.default_rng(4).uniform(
        -0.04, 0.04, (DIFF_SW_STREAM_BATCH, d30.n_x)).astype(np.float32),
        device=DEVICE)
    route30 = ts.resolve_stagewise_engine(d30, DIFF_SW_STREAM_BATCH)
    check(route30 == "stream", f"diff stage-wise n30 N200 routes to {route30}")
    loss = lambda x: (f30(x) ** 2).sum()

    def vjp():
        x = x30.clone().requires_grad_(True)
        loss(x).backward()
        return x.grad

    before = diff.CG_ITERATIONS
    (g30, secs30), launches["stagewise_stream_vjp"] = counted(
        torch, ctr, lambda: timed(torch, vjp), {"gpad_stagewise_stream": 1},
        "diff stage-wise stream VJP")
    cg30 = diff.CG_ITERATIONS - before
    # u*(x0) is piecewise affine with many facets here, and the loss is
    # quadratic on each: a scenario's central difference is its oracle where
    # it holds across two steps and the one-sided differences agree (no
    # facet at x0: there the mask picks one side's slope, by design)
    v = torch.as_tensor(np.random.default_rng(0).normal(
        size=tuple(x30.shape)).astype(np.float32), device=DEVICE)
    v = v / v.norm()
    per = lambda x: (f30(x) ** 2).sum(dim=-1)
    h1, h2 = DIFF_SW_FD_H
    with torch.no_grad():
        l0 = per(x30)
        lp = {h: per(x30 + h * v) for h in (h1, h2)}
        lm = {h: per(x30 - h * v) for h in (h1, h2)}
    c1, c2 = ((lp[h] - lm[h]) / (2 * h) for h in (h1, h2))
    one_sided = ((lp[h1] - l0) - (l0 - lm[h1])).abs() / h1
    room = DIFF_SW_FD_REL * torch.clamp_min(c1.abs(), 0.5)
    smooth = ((c1 - c2).abs() <= room) & (one_sided <= room)
    vjp_b = (g30 * v).sum(dim=-1)
    err = (vjp_b - c1).abs()
    out["stagewise_stream_vjp"] = {
        "route": route30, "batch": DIFF_SW_STREAM_BATCH,
        "iterations": DIFF_SW_STREAM_ITERS, "cg_iterations": cg30,
        "cg_cap": d30.horizon * d30.n_u + 40, "seconds": secs30,
        "vjp": vjp_b.tolist(), "fd_central": c1.tolist(),
        "fd_central_2h": c2.tolist(), "one_sided_gap": one_sided.tolist(),
        "smooth": smooth.tolist(),
        "max_rel_err_smooth": (err / torch.clamp_min(c1.abs(), 0.5))[
            smooth].max().item() if bool(smooth.any()) else None,
        "ok": bool((err <= room)[smooth].all())}
    return d8, X8, cfg


def phase_diff_path(torch, tg, ctr, smi):
    """Implicit differentiation (``tpu_gpad_torch.diff``) on the card, each
    leg counted from 0. At the headline B4096, gradients of 0.5 |u*|^2
    through ``make_differentiable_solver``, fixed (one flat kernel launch)
    and under restart (one dual kernel launch), each against the same
    function on the torch engine (fixed: the same active sets everywhere;
    restart: scenario by scenario, at most ``parted_max`` parted), the
    restart leg's first DIFF_FD scenarios against central differences of
    the float64 exact QP, and ``sensitivity`` by "chol" against "cg" on
    its dual; the weight-learning composition through ``dualize_ltv_device``
    (the dual kernel) against central differences; ``Controller.gain``
    after a restart step on 256 plants against a float64 gain; the
    stage-wise adjoint: the gain at n8 N60 B64 (the resident kernel), at
    n3 N10 against the condensed one, one VJP at n30 N200 B8 (the streamed
    kernel) against directional differences. Then the times, in turns
    (``diff_timing``). Returns the launches by leg."""
    from tpu_gpad_torch import diff
    from tpu_gpad_torch import stagewise as ts

    out = {"phase": "diff_path", "gpu": smi}
    launches = {}
    diff_condensed_legs(torch, tg, diff, ctr, out, launches)
    diff_data_leg(torch, tg, ctr, out, launches)
    ctrl, X = diff_gain_leg(torch, tg, diff, ctr, out, launches)
    d8, X8, sw_cfg = diff_stagewise_legs(torch, tg, diff, ts, ctr, out,
                                         launches)
    out["launches"] = launches
    emit(out)
    for leg in ("fixed", "restart"):
        r = out[leg]
        # fixed: the same active sets, gradients within DIFF_GRAD_RTOL of
        # their scale; restart: a flipped restart decision may part a
        # scenario's run, so at most parted_max of them
        check(r["scenarios_parted"] <= (0 if leg == "fixed" else r["parted_max"]),
              f"diff {leg}: {r}")
    check(max(out["restart"]["vs_exact_qp_fd"]) <= DIFF_FD_TOL,
          f"diff restart vs the exact QP {out['restart']['vs_exact_qp_fd']}")
    sens = out["sensitivity"]
    check(sens["chol_finite"] and sens["scenarios_outside_test_bound"] == 0,
          f"diff sensitivity chol vs cg {sens}")
    check(out["data_path"]["excess_over_tol"] <= 0,
          f"diff data path {out['data_path']}")
    cg = out["controller_gain"]
    check(cg["finite"] and cg["shape"] == [SERVE_PLANTS, 3, 3]
          and cg["max_err_vs_float64"] <= DIFF_GRAD_RTOL * cg["scale"],
          f"diff Controller.gain {cg}")
    swg = out["stagewise_gain"]
    check(swg["finite"] and swg["cg_iterations"] < swg["cg_cap"],
          f"diff stage-wise gain {swg}")
    sw = out["stagewise_vs_condensed"]
    check(sw["max_err"] <= DIFF_SW_TOL, f"diff stage-wise vs condensed {sw}")
    vj = out["stagewise_stream_vjp"]
    check(vj["ok"] and sum(vj["smooth"]) >= DIFF_SW_SMOOTH_MIN,
          f"diff stage-wise stream VJP {vj}")
    phase_diff_timing(torch, tg, diff, smi, ctrl, X, d8, X8, sw_cfg)
    return launches


def phase_diff_timing(torch, tg, diff, smi, ctrl, X, d8, X8, sw_cfg):
    """CUDA-event ms a call, in turns: at DIFF_BENCH.json's configurations
    (100 restart iterations) and the headline's fixed solve, the forward
    alone (the differentiable solver under no_grad), forward and backward
    with "chol" and with "cg", and ``sensitivity`` by each; the stage-wise
    forward against the gain at n8 N60 B64; a restart ``Controller.step``
    on 256 plants against ``Controller.gain``."""
    from tpu_gpad_torch.solver import core

    out = {"phase": "diff_timing", "gpu": smi}
    cases = [(shape, B, "restart", tg.SolverConfig(iterations=ITERS,
                                                   restart=True))
             for shape, B in DIFF_BENCH_CASES]
    cases.append(((HEADLINE["n_cells"], HEADLINE["horizon"]), BATCH, "fixed",
                  tg.SolverConfig()))
    for (n, N), B, label, cfg in cases:
        _, data = flagship(tg, dict(n_cells=n, horizon=N))
        Xb = flag_x0(torch, data.n_x, B, seed=39)[1]
        f = {m: tg.make_differentiable_solver(data, cfg, method=m)
             for m in ("chol", "cg")}
        y = tg.solve_batch(data, Xb, cfg).y

        def forward():
            with torch.no_grad():
                return f["chol"](Xb)

        t = in_turns({
            "forward": forward,
            "grad_chol": lambda: grad_of_loss(f["chol"], Xb),
            "grad_cg": lambda: grad_of_loss(f["cg"], Xb),
            "sensitivity_chol": lambda: diff.sensitivity(data, y, method="chol"),
            "sensitivity_cg": lambda: diff.sensitivity(data, y, method="cg")})
        fwd = t["forward"]["ms"]
        out[f"battery_n{n}_N{N}_B{B}_{label}"] = {
            "kernel": core.cuda_kernel(data, cfg), "m_half": data.m_half, **t,
            "grad_over_forward_chol": t["grad_chol"]["ms"] / fwd,
            "grad_over_forward_cg": t["grad_cg"]["ms"] / fwd}
    # where the backward's methods cross (diff.AUTO_CG_MIN_SYSTEM): battery
    # n3 N10-N50 (m_h 70-350) at two batches, 100 restart iterations
    cross = out["method_crossover"] = {}
    for N, B in itertools.product(DIFF_CROSS_HORIZONS, DIFF_CROSS_BATCHES):
        _, data = flagship(tg, dict(n_cells=3, horizon=N))
        cfg = tg.SolverConfig(iterations=ITERS, restart=True)
        Xb = flag_x0(torch, data.n_x, B, seed=39)[1]
        f = {m: tg.make_differentiable_solver(data, cfg, method=m)
             for m in ("chol", "cg")}
        t = in_turns({m: lambda m=m: grad_of_loss(f[m], Xb) for m in f},
                     rounds=3)
        cross[f"n3_N{N}_B{B}"] = {
            "m_half": data.m_half, "auto": diff.resolve_method(data, B),
            **{f"grad_{m}_ms": v["ms"] for m, v in t.items()}}
    out["stagewise_n8_N60_B64"] = in_turns({
        "forward": lambda: tg.solve_stagewise(d8, X8, config=sw_cfg),
        "gain": lambda: diff.stagewise_feedback_gain(d8, X8, config=sw_cfg)},
        rounds=3, repeats=2)
    out["controller_256"] = in_turns({"step": lambda: ctrl.step(X),
                                      "gain": ctrl.gain})
    emit(out)


PARALLEL_TP_TOL = 1e-4  # |u| of TP against the unsharded torch engine
PARALLEL_TIMEOUT = {1: 180.0, 2: 300.0}  # seconds a launch of n ranks may take


def parallel_launches(report) -> dict:
    """Each case's launches by kernel, summed over the ranks."""
    legs = {}
    for by_case in report["launches_by_rank"]:
        for case, got in by_case.items():
            leg = legs.setdefault(case, {})
            for kernel, n in got.items():
                leg[kernel] = leg.get(kernel, 0) + n
    return {case: got for case, got in legs.items() if got}


def phase_parallel_path(torch, smi):
    """The sharded solves (``tpu_gpad_torch.parallel``) across processes,
    one per rank, through ``mp_worker``: one rank on nccl at the headline
    (B4096; equal to ``solve_batch`` exactly, one flat paired launch),
    then two gloo ranks sharing the card: DP fixed (the flat paired kernel
    on each rank's 2048 rows, equal to ``solve_batch`` on them), with
    restart (the dual kernel, held by the restart parting rule), eps (the
    chunk kernel: each rank runs until the last scenario of both has
    converged, its iterations and u equal to its rows solved alone; the
    rows ordered so that one rank's own scenarios converge windows
    earlier) and
    eps with restart and a budget of 195; TP over 1x2 at the flagship and
    at a dense m of 165 (inert rows pad it; the torch engine) against the
    unsharded torch engine; ``solve_multi_sharded`` over the 28 plants (14
    dense launches a rank) equal to ``solve_multi``. Each rank checks a
    sample of its headline rows against the NumPy oracle. With two ranks
    on one card the times measure the collectives' cost, not a speed-up.
    Returns each case's launches, summed over the ranks."""
    from tpu_gpad_torch.parallel import mp_worker

    t0 = time.perf_counter()
    one, rep1 = mp_worker.run_multiprocess_check(
        1, "headline", "cuda", "nccl", timeout_s=PARALLEL_TIMEOUT[1])
    two, rep2 = mp_worker.run_multiprocess_check(
        2, "card", "cuda", "gloo", timeout_s=PARALLEL_TIMEOUT[2])
    wall_s = time.perf_counter() - t0
    B = mp_worker.HEADLINE_BATCH

    def equal(arrays, case, fields):
        return all(np.array_equal(arrays[f"{case}_{f}"],
                                  arrays[f"{case}_{f}_alone"]) for f in fields)

    def parted(case):
        e = np.abs(two[f"{case}_u"] - two[f"{case}_u_alone"]).max(axis=1)
        return int((e > RESTART_TOL).sum())

    per_rank = rep2["launches_by_rank"]
    own_windows = [int(np.ceil(it.max() / 10)) for it in np.split(
        two["dp_eps_iterations_alone"], len(per_rank))]
    got = {
        "one_rank_nccl_equal": equal(one, "dp_fixed", ("u", "y")),
        "one_rank_nccl_launches": rep1["launches_by_rank"][0]["dp_fixed"],
        "dp_fixed_equal": equal(two, "dp_fixed", ("u", "y")),
        "dp_restart_parted": parted("dp_restart"),
        "dp_eps_converged": int(two["dp_eps_converged"].sum()),
        "dp_eps_equal": equal(two, "dp_eps", ("u", "iterations")),
        # the collective exit: both ranks run the windows of the slower
        "dp_eps_windows_by_rank": [r["dp_eps"]["gpad_dual_chunk"]
                                   for r in per_rank],
        "dp_eps_own_windows_by_rank": own_windows,
        "dp_eps_restart_converged": int(two["dp_eps_restart_converged"].sum()),
        "dp_eps_restart_parted": parted("dp_eps_restart"),
        "parted_max": parted_max(B),
        "tp_flagship_u_err": float(np.abs(two["tp_u"]
                                          - two["tp_u_unsharded"]).max()),
        "tp_odd_u_err": float(np.abs(two["tp_odd_u"]
                                     - two["tp_odd_u_unsharded"]).max()),
        "tp_odd_y_shape": list(two["tp_odd_y"].shape),
        "multi_equal": bool(np.array_equal(two["multi_u"],
                                           two["multi_u_unsharded"])),
    }
    legs = {"one_rank_nccl": parallel_launches(rep1)["dp_fixed"],
            **parallel_launches(rep2)}
    emit({"phase": "parallel_path", "batch": B, **got, "launches": legs,
          "tol": {"restart": RESTART_TOL, "tp": PARALLEL_TP_TOL},
          "wall_s": wall_s, "nvidia_smi": smi,
          # CUDA events on rank 0, medians of sharded/unsharded in turns;
          # two ranks share the card: the collectives' cost, no speed-up
          "ms": rep2["ms"],
          "worker_s": [o.strip().splitlines()[-1] for o in rep1["outputs"]
                       + rep2["outputs"]]})
    check(got["one_rank_nccl_equal"], "one-rank nccl solve != solve_batch")
    check(got["one_rank_nccl_launches"] == {"gpad_paired_flat": 1},
          f"one-rank nccl launches {got['one_rank_nccl_launches']}")
    check(got["dp_fixed_equal"], "DP fixed != solve_batch on the rank's rows")
    check(got["dp_restart_parted"] <= got["parted_max"],
          f"DP restart parted {got['dp_restart_parted']} scenarios")
    check(got["dp_eps_converged"] == B, "DP eps left scenarios unconverged")
    check(got["dp_eps_equal"], "DP eps != its rows solved alone")
    check(len(set(got["dp_eps_windows_by_rank"])) == 1
          and got["dp_eps_windows_by_rank"][0] == max(own_windows),
          "DP eps ranks did not leave together")
    check(min(own_windows) < max(own_windows),
          f"DP eps rows did not part the ranks' own windows {own_windows}")
    check(got["dp_eps_restart_converged"] == B,
          "DP eps restart left scenarios unconverged")
    check(got["dp_eps_restart_parted"] <= got["parted_max"],
          f"DP eps restart parted {got['dp_eps_restart_parted']} scenarios")
    check(got["tp_flagship_u_err"] < PARALLEL_TP_TOL,
          f"TP flagship u err {got['tp_flagship_u_err']}")
    check(got["tp_odd_u_err"] < PARALLEL_TP_TOL,
          f"TP odd m u err {got['tp_odd_u_err']}")
    check(got["tp_odd_y_shape"] == [mp_worker.FLAG_BATCH, 165],
          f"TP odd m y shape {got['tp_odd_y_shape']}")
    check(got["multi_equal"], "solve_multi_sharded != solve_multi")
    for name in ("u", "y"):
        check(bool(np.isfinite(two[f"dp_fixed_{name}"]).all()),
              f"DP {name} not finite")
    for case, kernel in (("dp_fixed", "gpad_paired_flat"),
                         ("dp_restart", "gpad_dual"),
                         ("multi", "gpad_dense")):
        want = {"dp_fixed": 1, "dp_restart": 1,
                "multi": mp_worker.MULTI_PLANTS // 2}[case]
        check(all(r[case] == {kernel: want} for r in per_rank),
              f"{case} launches by rank {[r[case] for r in per_rank]}")
    check(all(r["dp_eps"].keys() == {"gpad_dual_chunk"} for r in per_rank),
          "DP eps did not run the chunk kernel")
    check(all(not r.get(c) for r in per_rank for c in ("tp", "tp_odd")),
          "TP launched a kernel")
    kernels_seen = {k for leg in legs.values() for k in leg}
    check({"gpad_paired_flat", "gpad_dual", "gpad_dual_chunk",
           "gpad_dense"} <= kernels_seen,
          f"the parallel path launched {kernels_seen}")
    return legs


# Each kernel's launch counter: (module, attribute), as a process that
# loaded artifacts reads it (the modules ``aot.load_solver`` imports)
COUNTERS = {
    "gpad_paired_flat": ("tpu_gpad_torch.solver.kernels", "PAIRED_FLAT_LAUNCHES"),
    "gpad_paired": ("tpu_gpad_torch.solver.kernels", "PAIRED_LAUNCHES"),
    "gpad_dense": ("tpu_gpad_torch.solver.kernels", "DENSE_LAUNCHES"),
    "gpad_flat_tiled": ("tpu_gpad_torch.solver.kernels", "FLAT_TILED_LAUNCHES"),
    "gpad_paired_tiled": ("tpu_gpad_torch.solver.kernels",
                          "PAIRED_TILED_LAUNCHES"),
    "gpad_dense_tiled": ("tpu_gpad_torch.solver.kernels",
                         "DENSE_TILED_LAUNCHES"),
    "gpad_dual": ("tpu_gpad_torch.solver.dual_kernels", "DUAL_LAUNCHES"),
    "gpad_dual_chunk": ("tpu_gpad_torch.solver.dual_kernels",
                        "DUAL_CHUNK_LAUNCHES"),
    "gpad_dual_tiled": ("tpu_gpad_torch.solver.dual_kernels",
                        "DUAL_TILED_LAUNCHES"),
    "gpad_dual_tiled_chunk": ("tpu_gpad_torch.solver.dual_kernels",
                              "DUAL_TILED_CHUNK_LAUNCHES"),
    "gpad_stagewise_resident": ("tpu_gpad_torch.stagewise_kernel",
                                "STAGEWISE_LAUNCHES"),
    "gpad_stagewise_stream": ("tpu_gpad_torch.stagewise_stream",
                              "STAGEWISE_STREAM_LAUNCHES"),
}
# the symbolic artifacts' batches, and the rounds of loaded against live
AOT_SYMBOLIC_BATCHES = (1, 37, BATCH)
AOT_ROUNDS, AOT_REPEATS = 3, 2
AOT_FIELDS = ("u", "z", "y", "iterations", "residual", "gap", "converged")

# A process that imports torch and tpu_gpad_torch.aot only, loads each
# artifact the parent saved, runs it on the parent's x0 and saves what it
# returns, with the launches each leg made (counters read from the modules
# load_solver imported)
AOT_CHILD = r"""
import json, pathlib, sys
import torch
from tpu_gpad_torch import aot
tmp = pathlib.Path(sys.argv[1])
plan = json.loads((tmp / "legs.json").read_text())
launches = {}
for name, batches in plan["legs"].items():
    solve = aot.load_solver(tmp / f"{name}.pt2")
    counters = {k: (sys.modules[m], a) for k, (m, a) in plan["counters"].items()}
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    for B in batches:
        out = solve(torch.load(tmp / f"{name}.x0.{B}.pt"))
        torch.cuda.synchronize()
        torch.save({k: v.cpu() for k, v in out.items()},
                   tmp / f"{name}.out.{B}.pt")
    launches[name] = {k: getattr(mod, attr)
                      for k, (mod, attr) in counters.items()
                      if getattr(mod, attr)}
print(json.dumps({"launches": launches, "tpu_gpad_torch_imports": sorted(
    m for m in sys.modules if m.startswith("tpu_gpad_torch"))}))
"""


def aot_legs(torch, tg):
    """The artifacts of the AOT phase, each at a shape the earlier phases
    drive: name -> (kernel or None, export function, data, config, batches,
    x0 seed). Concrete legs route as the live call; the symbolic ones pin
    the torch engine."""
    _, head = headline(tg)
    dense = tg.dualize(tg.condense(tg.problems.battery(**HEADLINE)), ITERS,
                       paired=False, device=DEVICE)
    _, flag = flagship(tg)
    from tpu_gpad_torch import aot

    ex, ex_sw = aot.export_solver, aot.export_stagewise_solver
    eps = dict(mode="eps", check_every=10, iterations=2000, restart=True)
    return {
        "paired_flat": ("gpad_paired_flat", ex, head,
                        tg.SolverConfig(iterations=ITERS), (BATCH,), 61),
        "dual": ("gpad_dual", ex, head,
                 tg.SolverConfig(iterations=ITERS, restart=True),
                 (SERVE_PLANTS,), 62),
        # phase_eps_path's solve_to_accuracy
        "dual_chunk": ("gpad_dual_chunk", ex, head, tg.SolverConfig(
            eps_g=EPS_TOL, eps_V=EPS_TOL, **eps), (BATCH,), 8),
        "dual_tiled": ("gpad_dual_tiled", ex, flag,
                       tg.SolverConfig(iterations=ITERS, restart=True),
                       (FLAG_BATCH,), 52),
        # the flagship path's solve_to_accuracy(flat="off")
        "dual_tiled_chunk": ("gpad_dual_tiled_chunk", ex, flag,
                             tg.SolverConfig(eps_g=FLAG_EPS_TOL,
                                             eps_V=FLAG_EPS_TOL, flat="off",
                                             **eps), (FLAG_BATCH,), 52),
        "flat_tiled": ("gpad_flat_tiled", ex, flag,
                       tg.SolverConfig(iterations=ITERS, form="mvp"),
                       (FLAG_BATCH,), 53),
        "paired": ("gpad_paired", ex, head,
                   tg.SolverConfig(iterations=ITERS, form="mvp", flat="off"),
                   (BATCH,), 63),
        "dense": ("gpad_dense", ex, dense, tg.SolverConfig(iterations=ITERS),
                  (BATCH,), 64),
        "stagewise_resident": (
            "gpad_stagewise_resident", ex_sw,
            sw_data(tg, SW_RES, SW_RES_ITERS),
            tg.SolverConfig(iterations=SW_RES_ITERS), (SW_WAVE_BATCH,), 21),
        "stagewise_stream": (
            "gpad_stagewise_stream", ex_sw,
            sw_data(tg, SW_FULL, SW_FULL_ITERS),
            tg.SolverConfig(iterations=SW_FULL_ITERS), (SW_FULL_BATCH,), 21),
        # the routes past shared memory (phase_tiled_routes_path)
        "dense_tiled": ("gpad_dense_tiled", ex,
                        route_data(tg, "dense_tiled", DENSE_WIDE)[1],
                        tg.SolverConfig(iterations=ITERS), (ROUTE_BATCH,), 72),
        "paired_tiled": ("gpad_paired_tiled", ex,
                         route_data(tg, "paired_tiled", PAIRED_WIDE)[1],
                         tg.SolverConfig(iterations=ITERS, form="mvp",
                                         flat="off"), (ROUTE_BATCH,), 75),
        # soft rows past shared memory (phase_tiled_soft_path's restart)
        "dual_tiled_soft": ("gpad_dual_tiled", ex,
                            soft_data(torch, tg, PAIRED_WIDE),
                            tg.SolverConfig(iterations=ITERS, restart=True),
                            (ROUTE_BATCH,), 84),
        "symbolic": (None, ex, head, tg.SolverConfig(iterations=ITERS),
                     AOT_SYMBOLIC_BATCHES, 65),
        # the robust twin's stage-wise shape (robust_stagewise_path)
        "symbolic_stagewise": (None, ex_sw, sw_data(tg, ROBUST, ITERS),
                               tg.SolverConfig(iterations=ITERS),
                               AOT_SYMBOLIC_BATCHES, 66),
    }


def aot_live(tg, kernel, export, data, config, x0):
    """The live call an artifact is held to: the solve as a user calls it,
    or for a symbolic artifact (``kernel`` None) the torch engine it
    pins."""
    from tpu_gpad_torch import aot

    if export is aot.export_stagewise_solver:
        kw = {} if kernel else dict(engine="torch", scan="sequential")
        return tg.solve_stagewise(data, x0, config=config, **kw)
    if not kernel:
        config = dataclasses.replace(config, engine="torch")
    return tg.solve_batch(data, x0, config)


def aot_graph_ops(blob) -> tuple:
    """(nodes of the artifact's graphs, nested ones included; the ops of
    the tpu_gpad_torch namespace it calls)."""
    import io

    import torch

    program = torch.export.load(io.BytesIO(blob))
    graphs = [m.graph for m in program.graph_module.modules()
              if isinstance(m, torch.fx.GraphModule)]
    ops = sorted({str(n.target) for g in graphs for n in g.nodes
                  if str(n.target).startswith("tpu_gpad_torch.")})
    return sum(len(g.nodes) for g in graphs), ops


def phase_aot_path(torch, tg, ctr, smi):
    """AOT export (``tpu_gpad_torch.aot``): each kernel's route exported at
    a concrete batch on the card (the headline B4096 on the flat kernel,
    restart B256 on the dual one, phase_eps_path's eps solve on the chunk
    kernel, the flagship's restart, eps and mvp solves on the tiled ones,
    the full paired and the dense kernel at B4096, the stage-wise n8 N60
    B1024 and n30 N200 B1024 on the resident and the streamed one) and one
    symbolic artifact of each solver (the torch engine), saved to a
    temporary directory and loaded in a fresh process that imports torch
    and ``tpu_gpad_torch.aot`` alone. Each loaded call must launch the live
    call's kernel as many times, nothing else, and equal the live call bit
    for bit (a kernel whose live call does not repeat itself bit for bit
    is held to its *_vs_plain tolerance instead, and the phase says so);
    eps legs their iterations and converged flags. Then loaded against
    live ms, CUDA events, in turns."""
    import shutil
    import tempfile
    from pathlib import Path

    from tpu_gpad_torch import aot

    t_phase = time.perf_counter()
    legs = aot_legs(torch, tg)
    out = {"phase": "aot_path", "smi": smi}
    tmp = Path(tempfile.mkdtemp(prefix="gpad_aot_"))
    try:
        live, solves = {}, {}
        for name, (kernel, export, data, cfg, batches, seed) in legs.items():
            X0 = {B: sw_x0(torch, B, data.n_x, seed) for B in batches}
            runs = []
            for _ in range(2):  # does the live call repeat itself?
                reset_counters(*ctr)
                runs.append({B: aot_live(tg, kernel, export, data, cfg,
                                         X0[B]) for B in batches})
                torch.cuda.synchronize()
                launched = launch_counts(*ctr)
            live[name] = runs[0], launched, all(
                torch.equal(getattr(runs[0][B], f), getattr(runs[1][B], f))
                for B in batches for f in AOT_FIELDS)
            reset_counters(*ctr)
            t0 = time.perf_counter()
            blob = export(data, cfg, batch_size=batches[0] if kernel else None,
                          path=tmp / f"{name}.pt2")
            export_s = time.perf_counter() - t0
            check(launch_counts(*ctr) == {}, f"aot {name}: export launched")
            nodes, ops = aot_graph_ops(blob)
            for B in batches:
                torch.save(X0[B].cpu(), tmp / f"{name}.x0.{B}.pt")
            solves[name] = aot.load_solver(blob), X0
            out[name] = {"kernel": kernel, "batches": list(batches),
                         "export_s": export_s, "bytes": len(blob),
                         "nodes": nodes, "graph_ops": ops,
                         "live_launches": launched,
                         "deterministic": live[name][2]}
            check(launched == ({kernel: launched.get(kernel, 0)} if kernel
                               else {}) and (kernel is None
                                             or launched[kernel] >= 1),
                  f"aot {name}: live call launched {launched}")
        (tmp / "legs.json").write_text(json.dumps({
            "counters": COUNTERS,
            "legs": {n: list(leg[4]) for n, leg in legs.items()}}))
        t_child = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", AOT_CHILD, str(tmp)],
                              cwd=str(Path(__file__).resolve().parent),
                              capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"aot child failed: {proc.stderr[-3000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        out["child_s"] = time.perf_counter() - t_child
        out["child_imports"] = len(child["tpu_gpad_torch_imports"])
        for name, (kernel, _, data, cfg, batches, _) in legs.items():
            runs, launched, deterministic = live[name]
            loaded = child["launches"][name]
            leg = out[name]
            leg["loaded_launches"] = loaded
            check(loaded == launched, f"aot {name}: loaded artifact launched "
                  f"{loaded}, the live call {launched}")
            errs, same = {}, True
            for B in batches:
                got = torch.load(tmp / f"{name}.out.{B}.pt")
                ref = runs[B]
                for f in AOT_FIELDS:
                    a, b = got[f], getattr(ref, f).cpu()
                    same &= torch.equal(a, b)
                    if a.dtype.is_floating_point:
                        errs[f] = max(errs.get(f, 0.0),
                                      (a - b).abs().max().item())
                    else:
                        check(torch.equal(a, b), f"aot {name} B{B}: {f} "
                              "differs from the live call")
            leg.update(bit_equal=same, max_abs_err=errs)
            if deterministic:
                check(same, f"aot {name}: loaded differs from the live call "
                      f"({errs})")
            else:
                tol = RESTART_TOL if cfg.restart else KERNEL_TOL
                leg["held_to"] = tol
                check(errs["u"] <= tol, f"aot {name}: u off by {errs['u']} "
                      "(a kernel that does not repeat itself bit for bit)")
        for name, (kernel, export, data, cfg, batches, _) in legs.items():
            solve, X0 = solves[name]
            x0 = X0[batches[-1]]
            t = in_turns({"live": lambda: aot_live(tg, kernel, export, data,
                                                   cfg, x0),
                          "loaded": lambda: solve(x0)},
                         rounds=AOT_ROUNDS, repeats=AOT_REPEATS)
            out[name].update(timed_batch=batches[-1],
                             live_ms=t["live"], loaded_ms=t["loaded"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return {name: out[name]["loaded_launches"] for name in legs
            if legs[name][0]}


# The precision tiers of the torch engine (SolverConfig.precision and
# matmul_dtype), each one's max |u - u(highest)| allowed at the headline,
# B4096 x 100 (tests/test_pallas.py's bounds for "high" and bf16)
TIER_KW = {"highest": {}, "high": dict(precision="high"),
           "default": dict(precision="default"),
           "bfloat16": dict(matmul_dtype="bfloat16")}
TIER_TOL = {"high": 5e-4, "default": 5e-3, "bfloat16": 5e-2}
# at the flagship, where one TF32 product moves u visibly, each tier must
# show that it took effect: "high" within TIER_HIGH_FLAGSHIP of "highest"
# (one TF32 product reads about 1e-4 there), "default" and bf16 at least
# TIER_APART times as far off as "high" (an fp32 product reads 0)
TIER_HIGH_FLAGSHIP = 1e-5
TIER_APART = 10.0
# the bf16 product's error over the largest |entry| of the exact product of
# the bf16-rounded operands: fp32 accumulation and output, where a bf16
# output would round at 2^-9
BF16_PRODUCT_TOL = 2e-4
# interleaved A/B of the tiers (the torch engine, 20-100 ms a call): short
# windows of 1 and 4 calls; the headline against the bare kernel op
TIER_AB = dict(rounds=5, k_small=1, k_large=4, min_window_s=0.05)
AUTO_AB = dict(rounds=8)
PEAK_SIZE = 4096


def tier_shapes(torch, tg, seed):
    """(name, qp, data, x0) at the headline B4096 and the flagship B256."""
    for name, (qp, data), B in (("headline", headline(tg), BATCH),
                                ("flagship", flagship(tg), FLAG_BATCH)):
        yield name, qp, data, flag_x0(torch, qp.n_x, B, seed)[1]


# The resident condensed kernels under each tier (csrc/mma_product.cuh), at
# the headline and at battery n5 N20 (m_h 220, the paired guard's top), both
# B4096: each route through ``auto`` (the flat and the full paired kernel,
# the dual kernel under restart, the chunk kernel in ``solve_to_accuracy``)
TIER_KERNEL_SHAPES = (("headline", HEADLINE),
                      ("n5_N20", dict(n_cells=5, horizon=20)))
TIER_ROUTES = {"paired_flat": {}, "paired": dict(form="mvp", flat="off"),
               "dual": dict(restart=True), "dual_chunk": None}
# where each tier shows that it took effect, free of restart decisions and
# of where an eps solve stops: the fixed dual form (the dual kernel) and an
# eps solve that no scenario meets (ten windows of the chunk kernel)
TIER_EFFECT = {"dual": dict(form="dual"),
               "dual_chunk": dict(mode="eps", eps_g=0.0, eps_V=0.0)}
# the dense kernel under each tier on the headline's unpaired stack, at the
# headline and the serving batch (route "dense_B256": the same kernel)
TIER_DENSE_BATCHES = {"dense": BATCH, "dense_B256": SERVE_PLANTS}
# the tiled kernels under each tier at the flagship B256: the default solve
# (flat tiled), restart (tiled dual), solve_to_accuracy with the flat block
# off (tiled chunk); their effects on the fixed dual form and an eps solve
# that no scenario meets, the flat block off (ten tiled windows)
TIER_TILED_ROUTES = {"flat_tiled": {}, "dual_tiled": dict(restart=True),
                     "dual_tiled_chunk": None}
TIER_TILED_EFFECT = {"dual_tiled": dict(form="dual"),
                     "dual_tiled_chunk": dict(mode="eps", eps_g=0.0,
                                              eps_V=0.0, flat="off")}
# the routes whose u is held on its max (the rest per scenario)
TIER_FIXED_ROUTES = ("paired_flat", "paired", "dense", "dense_B256",
                     "flat_tiled")
# each kernel against its plain version at the tier: a tenth of TIER_TOL on
# z (u's source; under restart, where a decision near r = 0 may part a
# scenario, as below) and on every output over one iteration, where a
# rounding mode that differs would show. Past one iteration a tier's
# roundings amplify any fp32 difference: the plain version moves as far
# when its products are summed in float64 (``tier_mm_fp64``) or its input
# moves by one fp32 unit (the larger of the two is its spread), so every
# output over the budget is held to TIER_SENSITIVITY times that spread
TIER_KERNEL_TOL = {"high": 1e-4, "default": 5e-4, "bfloat16": 5e-3}
# a tensor core's mma sums inside it without IEEE round-to-nearest (its
# aligned addends are truncated), a bias that the plain version's fp32 or
# fp64 sums do not share: measured on an H100 at up to 3.0 times that
# spread (a 10-iteration window at "default"); no such excess over one
# iteration, where every output meets TIER_KERNEL_TOL
TIER_SENSITIVITY = 4.0
TIER_SERVE_STEPS = 3


def one_ulp(torch, t):
    """``t`` with every entry moved up by one float32 unit."""
    return torch.nextafter(t, torch.full_like(t, float("inf")))


def tier_mm_fp64(a, b, tier):
    """``kernels._tier_mm`` with its products summed in float64: the same
    rounded operands, another summation (the plain version's spread)."""
    from tpu_gpad_torch.solver import core

    d = lambda t: t.double()  # noqa: E731
    if tier == "high":
        (a_hi, a_lo), (b_hi, b_lo) = core._split_tf32_rna(a), b
        return ((d(a_lo) @ d(b_hi) + d(a_hi) @ d(b_lo))
                + d(a_hi) @ d(b_hi)).float()
    rnd = core._round_tf32 if tier == "default" else core._round_bf16
    return (d(rnd(a)) @ d(b)).float()


def summed_in_fp64(kernels, fn):
    """``fn()`` with the plain versions' products summed in float64."""
    mm = kernels._tier_mm
    kernels._tier_mm = tier_mm_fp64
    try:
        return fn()
    finally:
        kernels._tier_mm = mm


def tier_fixed(kernels, dual_kernels, names) -> dict:
    """(wrapper, plain version, keywords) of each named fixed-budget kernel
    ("dual_restart", "dual_tiled_restart": under restart)."""
    table = {
        "paired_flat": (kernels.gpad_fixed_paired_flat,
                        kernels.gpad_fixed_paired_flat_torch, {}),
        "paired": (kernels.gpad_fixed_paired, kernels.gpad_fixed_paired_torch,
                   {}),
        "dense": (kernels.gpad_fixed_dense, kernels.gpad_fixed_dense_torch,
                  {}),
        "flat_tiled": (kernels.gpad_fixed_flat_tiled,
                       kernels.gpad_fixed_paired_flat_torch, {}),
        "dense_tiled": (kernels.gpad_fixed_dense_tiled,
                        kernels.gpad_fixed_dense_torch, {}),
        "paired_tiled": (kernels.gpad_fixed_paired_tiled,
                         kernels.gpad_fixed_paired_torch, {}),
    }
    for name, fn in (("dual", dual_kernels.gpad_fixed_dual),
                     ("dual_tiled", dual_kernels.gpad_fixed_dual_tiled)):
        table[name] = (fn, dual_kernels.gpad_fixed_dual_torch, {})
        table[f"{name}_restart"] = (fn, dual_kernels.gpad_fixed_dual_torch,
                                    dict(restart=True))
    return {n: table[n] for n in names}


def tier_kernel_vs_plain(torch, kernels, dual_kernels, data, g_P, p_D, tier,
                         names=("paired_flat", "paired", "dual",
                                "dual_restart"), chunk="dual_chunk"):
    """Each named kernel at ``tier`` against its plain version at it, on
    the card: per kernel the errors over one iteration from a warm state
    (every output), over 100 iterations cold (per output: z, y, w, zhat;
    the chunk kernel, ``chunk`` ("dual_chunk", "dual_tiled_chunk" or None),
    a 10-iteration window from the state 30 left, its outputs y, y_prev, s,
    mom, w and the recovered z), and the plain version's own spread: its
    move when p_D (the chunk: c) moves by one fp32 unit, and when its
    products are summed in float64. Checked against TIER_KERNEL_TOL and
    TIER_SENSITIVITY."""
    tol = TIER_KERNEL_TOL[tier]
    B = g_P.shape[0]
    y_warm = (kernels.gpad_fixed_dense_torch if not data.paired
              else kernels.gpad_fixed_paired_flat_torch)(
                  data, g_P, p_D, iterations=30)[1]
    errs = lambda a, b: [(x - y).abs().max().item()  # noqa: E731
                         for x, y in zip(a, b) if x is not None]
    out = {}
    for name, (fn, plain, kw) in tier_fixed(kernels, dual_kernels,
                                            names).items():
        kw = dict(kw, tier=tier)
        one = errs(fn(data, g_P, p_D, y_warm, iterations=1, **kw),
                   plain(data, g_P, p_D, y_warm, iterations=1, **kw))
        ref = plain(data, g_P, p_D, iterations=ITERS, **kw)
        full = errs(fn(data, g_P, p_D, iterations=ITERS, **kw), ref)
        moved = errs(plain(data, g_P, one_ulp(torch, p_D), iterations=ITERS,
                           **kw), ref)
        fp64 = errs(summed_in_fp64(kernels, lambda: plain(
            data, g_P, p_D, iterations=ITERS, **kw)), ref)
        if name.endswith("restart"):  # z only, as at "highest"
            full, moved, fp64 = full[:1], moved[:1], fp64[:1]
        out[name] = {"one_iteration": one, "iterations_100": full,
                     "plain_one_ulp": moved, "plain_fp64_products": fp64}
    if chunk is not None:
        m_h = data.m_half
        fn = getattr(dual_kernels, f"gpad_{chunk}")
        plain = dual_kernels.gpad_dual_chunk_torch
        c = dual_kernels.relu_offsets(data, g_P, p_D)
        zero = torch.zeros((B, 2, m_h), device=DEVICE)
        state = plain(data, c, zero, zero, torch.zeros((B, m_h), device=DEVICE),
                      torch.ones((B, 2), device=DEVICE), k0=0, chunk=30,
                      tier=tier)[:4]
        win = dict(k0=30, tier=tier)
        one = errs(fn(data, c, *state, chunk=1, **win),
                   plain(data, c, *state, chunk=1, **win))
        got = fn(data, c, *state, chunk=10, **win)
        ref = plain(data, c, *state, chunk=10, **win)
        moved = errs(plain(data, one_ulp(torch, c), *state, chunk=10, **win),
                     ref)
        fp64 = errs(summed_in_fp64(kernels, lambda: plain(
            data, c, *state, chunk=10, **win)), ref)
        z_err = ((got[2] - ref[2]) @ data.MG_T).abs().max().item()
        out[chunk] = {"one_iteration": one, "iterations_10": errs(got, ref),
                      "plain_one_ulp": moved, "plain_fp64_products": fp64,
                      "z": z_err}
    torch.cuda.synchronize()
    for name, e in out.items():
        check(max(e["one_iteration"]) <= tol, f"tiers {tier} {name}: one "
              f"iteration off its plain version by {e['one_iteration']}")
        full = e.get("iterations_100", e.get("iterations_10"))
        z = e.get("z", full[0])
        # under restart a decision near r = 0 may flip and part a scenario:
        # its z is held to the plain version's own one-unit move alone
        check(name.endswith("restart") or z <= tol,
              f"tiers {tier} {name}: z off by {z} (> {tol})")
        spread = [max(a, b) for a, b in zip(e["plain_one_ulp"],
                                            e["plain_fp64_products"])]
        for got_e, spread_e in zip(full, spread):
            check(got_e <= max(tol, TIER_SENSITIVITY * spread_e),
                  f"tiers {tier} {name}: {full} against the plain version's "
                  f"own spread {spread}")
    return out


def tier_parted(du, tol) -> dict:
    """Per-scenario |du| against ``tol``: a restart decision near r = 0, or
    an eps solve's stopping window, may part a scenario; at most
    SW_RESTART_PARTED_SHARE of them (at least one) may be past ``tol``."""
    per = du.abs().amax(dim=1)
    if not per.numel():
        return {"max": 0.0, "p99": 0.0, "parted": 0, "parted_max": 0,
                "ok": True}
    parted = int((per > tol).sum())
    return {"max": per.max().item(), "p99": per.quantile(0.99).item(),
            "parted": parted, "parted_max": parted_max(per.shape[0]),
            "ok": parted <= parted_max(per.shape[0])}


def tier_route_legs(torch, tg, ctr, name, legs, effects, eps_tol, eps_kw,
                    flagship=False):
    """Routes under each tier, each through ``auto``, launches counted from
    0 a leg: ``legs`` maps a route (its kernel's name, "gpad_" left out) to
    (data, x0, config keywords; None: ``solve_to_accuracy(tol=eps_tol,
    **eps_kw)``), ``effects`` a route to the keywords of its effect leg.
    |u - u(highest)| is held to TIER_TOL (TIER_FIXED_ROUTES on their max;
    the restart and eps routes per scenario, TIER_TOL past 1% at most), and
    each tier shows its effect (TIER_APART: "default" and bf16 at least
    that many times as far off as "high", above 0) on the fixed routes and
    the effect legs; at the flagship "high" there stays within
    TIER_HIGH_FLAGSHIP. On its eps route (tolerance 1e-4, where two fp32
    summation orders already stop in other windows) a scenario that
    converged in both solves, in another window than "highest"'s, meets
    the tolerance at another point and is not held to TIER_TOL; one whose
    solve under the tier does not converge within the budget (the tier's
    floor is above the tolerance: its dual iterates wander about the
    optimum as far as the tier's rounding moves them) is held to TIER_TOL
    against the plain version's eps loop at the tier, the same algorithm
    and rounding, and its distance from "highest" is reported. Returns
    (leg, launches, by_tier)."""
    from tpu_gpad_torch.solver import core

    dual_kernels = ctr[1]
    leg, launches, by_tier, u, stops, plain_u = {}, {}, {}, {}, {}, {}
    runs = {**legs, **{f"{r}_effect": (legs[r][0], legs[r][1], e)
                       for r, e in effects.items()}}
    for tier, kw in TIER_KW.items():
        for route, (data, X0, rkw) in runs.items():
            kernel = "gpad_" + route.removesuffix("_effect").removesuffix(
                "_B256")
            if rkw is None:  # the eps route: one launch a window
                fn = lambda data=data, X0=X0, kw=kw: tg.solve_to_accuracy(  # noqa: E731
                    data, X0, tol=eps_tol, **eps_kw, **kw)
                want = lambda res, k=kernel: {  # noqa: E731
                    k: -(-int(res.iterations.max()) // 10)}
            else:
                cfg = tg.SolverConfig(**rkw, **kw)
                fn = lambda data=data, X0=X0, cfg=cfg: tg.solve_batch(  # noqa: E731
                    data, X0, cfg)
                want = {kernel: ITERS // 10 if rkw.get("mode") == "eps"
                        else 1}
            res, got = counted(torch, ctr, fn, want, f"tiers {name} {tier} "
                               f"{route}")
            check(bool(torch.isfinite(res.u).all()),
                  f"tiers {name} {tier} {route}: u not finite")
            if route.endswith("chunk_effect"):
                check(not bool(res.converged.any()), f"tiers {name} {tier}: "
                      "the eps solve of no scenario converged")
            u[tier, route] = res.u
            stops[tier, route] = (res.iterations, res.converged)
            if flagship and rkw is None and not bool(res.converged.all()):
                cfg = tg.SolverConfig(mode="eps", eps_g=eps_tol, eps_V=eps_tol,
                                      check_every=10, iterations=2000,
                                      restart=True, **eps_kw, **kw)
                plain_u[tier, route] = dual_kernels.gpad_eps_dual(
                    data, *core.affine_params(data, X0), cfg,
                    chunk_fn=dual_kernels.gpad_dual_chunk_torch).u
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
                by_tier.setdefault(k, {})[tier] = (
                    by_tier.get(k, {}).get(tier, 0) + n)
            if rkw is None:
                leg.setdefault("eps_converged", {})[tier] = int(
                    res.converged.sum())
    for route in legs:
        fixed = route in TIER_FIXED_ROUTES
        effect = route if fixed else f"{route}_effect"
        du = {t: (u[t, route] - u["highest", route]) for t in TIER_TOL}
        eff = {t: (u[t, effect] - u["highest", effect]).abs().max().item()
               for t in TIER_TOL}
        row = leg.setdefault("routes", {}).setdefault(route, {})
        row["effect_max_du"] = eff
        for tier, tol in TIER_TOL.items():
            if fixed:
                row[f"max_du_{tier}"] = du[tier].abs().max().item()
                check(row[f"max_du_{tier}"] <= tol, f"tiers {name} {route}: "
                      f"{tier} |du| {row[f'max_du_{tier}']} > {tol}")
            elif flagship and legs[route][2] is None:
                (it, conv), (it_h, conv_h) = (stops[tier, route],
                                              stops["highest", route])
                apart = (it != it_h) & conv & conv_h
                row[f"du_{tier}"] = part = tier_parted(
                    du[tier][conv & ~apart], tol)
                part["converged_in_another_window"] = int(apart.sum())
                part["unconverged"] = floor = int((~conv).sum())
                if floor:
                    off = du[tier][~conv].abs().amax(dim=1)
                    part["unconverged_vs_highest"] = {
                        "max": off.max().item(),
                        "past_tol": int((off > tol).sum())}
                    part["unconverged_vs_plain"] = tier_parted(
                        (u[tier, route] - plain_u[tier, route])[~conv], tol)
                ok = part["ok"] and (not floor
                                     or part["unconverged_vs_plain"]["ok"])
                check(ok, f"tiers {name} {route}: {tier} {part}")
            else:
                row[f"du_{tier}"] = part = tier_parted(du[tier], tol)
                check(part["ok"], f"tiers {name} {route}: {tier} {part}")
        if flagship:
            check(eff["high"] <= TIER_HIGH_FLAGSHIP, f"tiers {name} {route}: "
                  f"high |du| {eff['high']} > {TIER_HIGH_FLAGSHIP}")
        for tier in ("default", "bfloat16"):
            check(eff[tier] > 0 and eff[tier] >= TIER_APART * eff["high"],
                  f"tiers {name} {route}: {tier} |du| {eff[tier]} is not "
                  f"{TIER_APART}x high's {eff['high']} (no effect)")
    return leg, launches, by_tier


def tier_kernel_legs(torch, tg, core, kernels, dual_kernels, ctr, name, shape):
    """The resident routes of one shape under each tier at B4096
    (``tier_route_legs``), and at the headline the dense kernel on its
    unpaired stack at B4096 and B256; each kernel held against its plain
    version at the tier (``tier_kernel_vs_plain``)."""
    qp, data = headline(tg, shape)
    X0 = flag_x0(torch, qp.n_x, BATCH, seed=18)[1]
    g_P, p_D = core.affine_params(data, X0)
    legs = {r: (data, X0, kw) for r, kw in TIER_ROUTES.items()}
    plans = {tier: {"paired_flat": kernels._paired_plan(
                        data.m_half, data.n_z, data.n_struct, BATCH,
                        tier=tier),
                    "dual": dual_kernels._dual_plan(data.m_half, BATCH,
                                                    tier=tier)}
             for tier in TIER_KW}
    dense = None
    if name == "headline":
        _, dense = dense_headline(tg)
        Xd = flag_x0(torch, dense.n_x, BATCH, seed=18)[1]
        for route, B in TIER_DENSE_BATCHES.items():
            legs[route] = (dense, Xd[:B], {})
            for tier in TIER_KW:
                plans[tier][route] = kernels._dense_plan(dense.m, dense.n_z, B,
                                                         tier=tier)
    leg, launches, by_tier = tier_route_legs(torch, tg, ctr, name, legs,
                                             TIER_EFFECT, EPS_TOL, {})
    leg.update(batch=BATCH, m_half=data.m_half, plans=plans)
    leg["kernel_vs_plain"] = {
        tier: tier_kernel_vs_plain(torch, kernels, dual_kernels, data, g_P,
                                   p_D, tier) for tier in TIER_KERNEL_TOL}
    if dense is not None:
        leg["dense_vs_plain"] = {}
        for route, B in TIER_DENSE_BATCHES.items():
            gd, pd = core.affine_params(dense, Xd[:B])
            leg["dense_vs_plain"][route] = {
                tier: tier_kernel_vs_plain(torch, kernels, dual_kernels,
                                           dense, gd, pd, tier, ("dense",),
                                           None)
                for tier in TIER_KERNEL_TOL}
    leg["launches"] = launches
    return leg, launches, by_tier


def tier_tiled_legs(torch, tg, core, kernels, dual_kernels, ctr):
    """The tiled kernels under each tier at the flagship B256
    (``tier_route_legs``: TIER_TILED_ROUTES and TIER_TILED_EFFECT, the eps
    route at FLAG_EPS_TOL with the flat block off), each held against its
    plain version at the tier (the tiled dual kernel fixed and under
    restart, the flat tiled kernel, a tiled chunk window)."""
    qp, flag = flagship(tg)
    X0 = flag_x0(torch, qp.n_x, FLAG_BATCH, seed=20)[1]
    legs = {r: (flag, X0, kw) for r, kw in TIER_TILED_ROUTES.items()}
    leg, launches, by_tier = tier_route_legs(
        torch, tg, ctr, "flagship", legs, TIER_TILED_EFFECT, FLAG_EPS_TOL,
        dict(flat="off"), flagship=True)
    leg.update(batch=FLAG_BATCH, m_half=flag.m_half,
               log2_tile=dual_kernels.pick_tiled_tiles(flag.m_half,
                                                       FLAG_BATCH),
               flat_plan=kernels.pick_flat_tiled(flag.m_half, flag.n_z,
                                                 FLAG_BATCH))
    g_P, p_D = core.affine_params(flag, X0)
    leg["kernel_vs_plain"] = {
        tier: tier_kernel_vs_plain(
            torch, kernels, dual_kernels, flag, g_P, p_D, tier,
            ("dual_tiled", "dual_tiled_restart", "flat_tiled"),
            "dual_tiled_chunk") for tier in TIER_KERNEL_TOL}
    leg["launches"] = launches
    return leg, launches, by_tier


def tier_serving(torch, tg, ctr, smi):
    """A restart ``Controller`` on the serving fleet under each tier
    (TIER_SERVE_STEPS steps, one dual launch each), and the CLI's ``solve``
    under ``--precision default`` and ``--dtype bfloat16`` in process (one
    flat launch each), and at the flagship under ``--precision default``
    (one flat tiled launch)."""
    import contextlib
    import io as textio

    from tpu_gpad_torch import cli

    problem = tg.problems.battery(**HEADLINE)
    A = np.asarray(problem.A, dtype=np.float32)
    Bm = np.asarray(problem.B, dtype=np.float32)
    out, launches, by_tier = {}, {}, {}
    x0 = np.random.default_rng(19).uniform(
        -0.4, 0.4, (SERVE_PLANTS, problem.n_x)).astype(np.float32)
    for tier, kw in TIER_KW.items():
        ctl = tg.Controller(problem, config=tg.SolverConfig(
            iterations=RESTART_ITERS, restart=True, **kw), device=DEVICE)

        def serve(ctl=ctl):
            x, us = x0, []
            for _ in range(TIER_SERVE_STEPS):
                us.append(ctl.step(x))  # host NumPy: the device work done
                x = x @ A.T + us[-1] @ Bm.T
            return us

        us, got = counted(torch, ctr, serve, {"gpad_dual": TIER_SERVE_STEPS},
                          f"tiers serving {tier}")
        by_tier.setdefault("gpad_dual", {})[tier] = TIER_SERVE_STEPS
        out[f"controller_{tier}_max_abs_u"] = float(np.abs(us[-1]).max())
        check(np.isfinite(us[-1]).all() and np.abs(us[-1]).max() <= 0.3 + 1e-2,
              f"tiers serving {tier}: u {np.abs(us[-1]).max()}")
        launches[f"controller_{tier}"] = got
    flag_shape = ["--cells", str(FLAGSHIP["n_cells"]), "--horizon",
                  str(FLAGSHIP["horizon"])]
    for key, flags, kernel in (
            ("default", ["--batch", str(BATCH), "--precision", "default"],
             "gpad_paired_flat"),
            ("bfloat16", ["--batch", str(BATCH), "--dtype", "bfloat16"],
             "gpad_paired_flat"),
            ("flagship_default", [*flag_shape, "--batch", str(FLAG_BATCH),
                                  "--precision", "default"],
             "gpad_flat_tiled")):
        def run(flags=flags):
            buf = textio.StringIO()
            with contextlib.redirect_stdout(buf):
                check(cli.main(["solve", "--device", DEVICE, *flags]) == 0,
                      f"cli solve {flags}")
            return json.loads(buf.getvalue().strip().splitlines()[-1])

        res, got = counted(torch, ctr, run, {kernel: 1}, f"tiers cli {flags}")
        tier = flags[-1]
        row = by_tier.setdefault(kernel, {})
        row[tier] = row.get(tier, 0) + 1
        check(res.get("engine") == "cuda" and np.isfinite(res["u_star"]).all(),
              f"tiers cli {flags}: {res}")
        out[f"cli_{key}_engine"] = res["engine"]
        launches[f"cli_{key}"] = got
    out["launches"] = launches
    return out, launches, by_tier


def phase_tiers_path(torch, tg, core, ctr, smi):
    """The precision tiers. On the torch engine at the headline and the
    flagship: each tier's max |u - u(highest)| (held to TIER_TOL at both,
    finite everywhere), "highest" with the caller's TF32 switch on equal
    to the solve with it off bit for bit (the switch as the caller left
    it); at the flagship each tier shows that it took effect
    (TIER_HIGH_FLAGSHIP, TIER_APART), and ``auto`` under each tier
    launches one flat tiled kernel, under restart one tiled dual kernel.
    The bf16 product is ``mm(out_dtype=float32)``, fp32-accumulated
    (BF16_PRODUCT_TOL). On the kernels under each tier: the resident
    condensed ones at the headline and at n5 N20 and the dense one at the
    headline (``tier_kernel_legs``), the tiled ones at the flagship
    (``tier_tiled_legs``); a restart ``Controller`` and the CLI under a
    tier (``tier_serving``). Each leg's launches counted from 0."""
    kernels, dual_kernels = ctr[:2]
    t0 = time.perf_counter()
    out = {"phase": "tiers_path", "smi": smi}
    mb = core._Matmul(tg.SolverConfig(matmul_dtype="bfloat16"), device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(16)
    a, b = (torch.randn(shape, generator=gen, device=DEVICE)
            for shape in ((256, 1024), (1024, 256)))
    got = mb(a, mb.prep(b))
    exact = a.bfloat16().double() @ b.bfloat16().double()
    rel = ((got.double() - exact).abs().max() / exact.abs().max()).item()
    out.update(bf16_product=mb.route, bf16_product_rel_err=rel)
    check(mb.route == "out_dtype" and got.dtype == torch.float32,
          f"tiers: the bf16 product is {mb.route} -> {got.dtype}")
    check(rel <= BF16_PRODUCT_TOL, f"tiers: the bf16 product is off by "
          f"{rel} of its largest entry (> {BF16_PRODUCT_TOL})")
    launches, tier_launches = {}, {}
    for name, qp, data, X0 in tier_shapes(torch, tg, seed=16):
        kernel = core.cuda_kernel(data, tg.SolverConfig())
        reset_counters(*ctr)
        auto = tg.solve_batch(data, X0, tg.SolverConfig())
        torch.cuda.synchronize()
        launches[name] = launch_counts(*ctr)
        check(launches[name] == {f"gpad_{kernel}": 1},
              f"tiers {name}: auto launched {launches[name]}")
        leg = {"batch": int(X0.shape[0]), "auto_kernel": kernel}
        u = {}
        for tier, kw in TIER_KW.items():
            if name == "flagship":  # auto takes the kernel at every tier
                for rkw, k in (({}, kernel), (dict(restart=True),
                                              "dual_tiled")):
                    counted(torch, ctr, lambda rkw=rkw, kw=kw: tg.solve_batch(
                        data, X0, tg.SolverConfig(**rkw, **kw)),
                        {f"gpad_{k}": 1}, f"tiers {name} {tier} {rkw}")
                    for row, key in ((launches.setdefault(
                            f"{name}_auto", {}), f"gpad_{k}"),
                            (tier_launches.setdefault(f"gpad_{k}", {}), tier)):
                        row[key] = row.get(key, 0) + 1
            reset_counters(*ctr)
            u[tier] = tg.solve_batch(data, X0, tg.SolverConfig(
                engine="torch", **kw)).u
            torch.cuda.synchronize()
            check(launch_counts(*ctr) == {}, f"tiers {name} {tier}: the "
                  "torch engine launched a kernel")
            check(bool(torch.isfinite(u[tier]).all()),
                  f"tiers {name} {tier}: u not finite")
        for tier, tol in TIER_TOL.items():
            du = (u[tier] - u["highest"]).abs().max().item()
            leg[f"max_du_{tier}"] = du
            check(du <= tol, f"tiers {name}: {tier} |du| {du} > {tol}")
        if name == "flagship":
            high = leg["max_du_high"]
            check(high <= TIER_HIGH_FLAGSHIP, f"tiers {name}: high |du| "
                  f"{high} > {TIER_HIGH_FLAGSHIP} (3xTF32 not in effect)")
            for tier in ("default", "bfloat16"):
                du = leg[f"max_du_{tier}"]
                check(du > 0 and du >= TIER_APART * high,
                      f"tiers {name}: {tier} |du| {du} is not {TIER_APART}x "
                      f"high's {high} (the tier took no effect)")
        leg["max_du_auto_kernel_vs_torch"] = (
            auto.u - u["highest"]).abs().max().item()
        caller = torch.backends.cuda.matmul.allow_tf32
        try:
            runs = {}
            for flag in (True, False):
                torch.backends.cuda.matmul.allow_tf32 = flag
                runs[flag] = tg.solve_batch(data, X0, tg.SolverConfig(
                    engine="torch"))
                check(torch.backends.cuda.matmul.allow_tf32 is flag,
                      f"tiers {name}: the caller's TF32 switch was changed")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = caller
        same = all(torch.equal(getattr(runs[True], f), getattr(runs[False], f))
                   for f in AOT_FIELDS)
        check(same, f"tiers {name}: highest differs with the caller's TF32 on")
        leg["highest_ignores_callers_tf32"] = same
        out[name] = leg
    def add(by_tier):
        for k, tiers in by_tier.items():
            for tier, n in tiers.items():
                row = tier_launches.setdefault(k, {})
                row[tier] = row.get(tier, 0) + n

    for name, shape in TIER_KERNEL_SHAPES:
        leg, got, by_tier = tier_kernel_legs(torch, tg, core, kernels,
                                             dual_kernels, ctr, name, shape)
        out[f"kernels_{name}"] = leg
        launches[f"kernels_{name}"] = got
        add(by_tier)
    leg, got, by_tier = tier_tiled_legs(torch, tg, core, kernels, dual_kernels,
                                        ctr)
    out["kernels_flagship"] = leg
    launches["kernels_flagship"] = got
    add(by_tier)
    out["serving"], serving, by_tier = tier_serving(torch, tg, ctr, smi)
    add(by_tier)
    for leg_name, got in serving.items():
        launches[f"serving_{leg_name}"] = got
    out["tier_launches"] = tier_launches
    out["phase_s"] = time.perf_counter() - t0
    emit(out)
    return launches, tier_launches


def phase_timing_path(torch, tg, core, kernels, ctr, smi):
    """``tpu_gpad_torch.utils.timing`` on the card: ``interleaved_ab`` of
    "highest" against each tier on the torch engine at the flagship B256
    and the headline B4096; of the bare ``tpu_gpad_torch::paired_flat`` op
    against ``solve_batch(engine="auto")`` at the headline (the same
    kernel and plan; the solve adds x0's affine maps, the wrapper's checks
    and the residuals); ``matmul_peak_tflops`` of the four tiers at 4096;
    ``device_time_stats`` and ``device_time_percentiles`` of the headline
    solve. Ratios are B over A."""
    from tpu_gpad_torch.utils import (device_time_percentiles,
                                      device_time_stats, interleaved_ab,
                                      matmul_peak_tflops)

    keys = ("ratio_b_over_a_median", "ratio_b_over_a_iqr", "t_a_median_s",
            "t_b_median_s", "rounds", "rejected_rounds", "unstable")
    t_phase = time.perf_counter()
    out = {"phase": "timing_path", "smi": smi}
    for name, qp, data, X0 in tier_shapes(torch, tg, seed=17):
        def solve(kw, data=data, X0=X0):
            cfg = tg.SolverConfig(engine="torch", **kw)
            return lambda: tg.solve_batch(data, X0, cfg).u

        out[name] = {}
        for tier in TIER_TOL:
            ab = interleaved_ab(solve({}), solve(TIER_KW[tier]), **TIER_AB)
            out[name][f"highest_vs_{tier}"] = {k: ab[k] for k in keys}
            check(ab["rounds"] > 0, f"timing {name} {tier}: no valid round")
    qp, data = headline(tg)
    _, X0 = flag_x0(torch, qp.n_x, BATCH, seed=17)
    g_P, p_D = core.affine_params(data, X0)
    plan = kernels._paired_plan(data.m_half, data.n_z, data.n_struct, BATCH)
    args = (data.MG_T, data.GL_T, g_P, p_D, None, kernels._od(data),
            data.theta, data.beta, data.L, data.n_struct, ITERS, *plan, True)
    bare = lambda: torch.ops.tpu_gpad_torch.paired_flat(*args)[0]
    auto = lambda: tg.solve_batch(data, X0, tg.SolverConfig()).u
    du = (bare()[:, :data.n_u] - auto()).abs().max().item()
    check(du <= KERNEL_TOL, f"timing: the bare op and the auto solve differ "
          f"by {du}")
    out["headline_kernel_op_vs_auto_max_du"] = du
    launches = {}
    reset_counters(*ctr)
    ab = interleaved_ab(bare, auto, **AUTO_AB)
    torch.cuda.synchronize()
    launches["auto_vs_kernel"] = launch_counts(*ctr)
    check(set(launches["auto_vs_kernel"]) == {"gpad_paired_flat"},
          f"timing: auto against the op launched {launches['auto_vs_kernel']}")
    out["headline_kernel_op_vs_auto"] = {k: ab[k] for k in keys}
    check(ab["rounds"] > 0, "timing: auto against the op, no valid round")
    reset_counters(*ctr)
    stats = device_time_stats(auto, n=9)
    pct = device_time_percentiles(auto, n=100)
    torch.cuda.synchronize()
    launches["stats"] = launch_counts(*ctr)
    out["headline_auto_stats"] = {k: stats[k] for k in (
        "median_s", "iqr_s", "n", "rejected", "window_calls")}
    out["headline_auto_percentiles"] = pct
    out["matmul_peak_tflops"] = {
        tier: matmul_peak_tflops(kw.get("matmul_dtype", "float32"),
                                 kw.get("precision", "highest"),
                                 size=PEAK_SIZE)
        for tier, kw in TIER_KW.items()}
    check(all(np.isfinite(v) and v > 0
              for v in out["matmul_peak_tflops"].values()),
          f"timing: matmul_peak_tflops {out['matmul_peak_tflops']}")
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return launches


def kernel_ms(med, kernel, B=BATCH) -> float:
    """A resident kernel's time at batch B: the profiler's device time of
    its launch, or where the profiler saw none, the CUDA-event time of its
    wrapper (which holds the host's work around the launch too)."""
    device = med["device"][f"{kernel}@{B}"]
    return med[f"{kernel}@{B}"] if device is None else device


def by_batch(med, kernel, launches) -> dict:
    """A resident kernel's entries of the kernels line per batch: its
    main-path launches at each batch, and at each timed batch its time
    (``kernel_ms``), its wrapper's CUDA-event time, its plain version's
    and its bound."""
    timed = RESIDENT_BATCHES
    return {"launches_by_batch": {str(B): n for B, n in launches.items()},
            "ms_by_batch": {str(B): kernel_ms(med, kernel, B) for B in timed},
            "wrapper_ms_by_batch": {str(B): med[f"{kernel}@{B}"]
                                    for B in timed},
            "plain_ms_by_batch": {str(B): med[f"{kernel}_plain@{B}"]
                                  for B in timed},
            "bound_ms_by_batch": {str(B): med["bounds"][f"{kernel}@{B}"][
                "bound_ms"] for B in timed}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke FAILED: no CUDA device (torch.cuda."
                         "is_available() is False); nothing runs on the host")
    import tpu_gpad_torch as tg
    from tpu_gpad_torch import stagewise as ts
    from tpu_gpad_torch import stagewise_kernel as sk
    from tpu_gpad_torch import stagewise_stream as ss
    from tpu_gpad_torch.solver import core, dual_kernels, kernels, reference

    smi, name = phase_device(torch)
    if sys.argv[1:] == ["--profile"]:
        profile_stagewise(torch, tg, sk, ss, smi)
        return 0
    if sys.argv[1:2] == ["--times"]:  # builds only what it launches
        families = sys.argv[2:] or ["resident", "stagewise", "tiers"]
        if "resident" in families:
            times_resident(torch, tg, kernels, dual_kernels, core, smi)
        if "stagewise" in families:
            times_stagewise(torch, tg, sk, ss, smi)
        if "tiers" in families:
            times_tiers(torch, tg, kernels, dual_kernels, core, smi)
        if "dense" in families:
            times_dense(torch, tg, kernels, core, smi)
        if "routes" in families:
            times_routes(torch, tg, kernels, core, smi)
            times_soft_routes(torch, tg, kernels, dual_kernels, core, smi)
        return 0
    phase_build()
    if sys.argv[1:2] == ["--sweep"]:
        families = sys.argv[2:] or ["resident", "stagewise", "tiled"]
        resident = [n for n in RESIDENT_FAMILIES
                    if "resident" in families or n in families]
        if resident:
            sweep_resident(torch, tg, kernels, dual_kernels, core, smi,
                           resident)
        if "stagewise" in families:
            sweep_stagewise(torch, tg, sk, ss, ts, smi)
        if "tiled" in families:
            sweep_tiled(torch, tg, kernels, dual_kernels, core, smi)
        if "tiled" in families or "dense_tiled" in families:
            sweep_dense_tiled(torch, tg, kernels, core, smi)
        return 0
    worst = phase_kernel_vs_plain(torch, tg, kernels, core)
    worst_dual = phase_dual_kernel_vs_plain(torch, tg, dual_kernels, core)
    worst_chunk = phase_dual_chunk_vs_plain(torch, tg, dual_kernels, core)
    worst_sw = phase_stagewise_kernels_vs_plain(torch, tg, sk, ss)
    worst_dense = phase_dense_kernel_vs_plain(torch, tg, kernels, core)
    worst_paired = phase_paired_kernel_vs_plain(torch, tg, kernels, core)
    worst_tiled = phase_tiled_kernels_vs_plain(torch, tg, kernels, dual_kernels,
                                               core)
    worst_routes = phase_tiled_routes_vs_plain(torch, tg, kernels,
                                               dual_kernels, core)
    worst_soft = phase_tiled_soft_vs_plain(torch, tg, kernels, dual_kernels,
                                           core)
    worst_nmpc = phase_nmpc_dual_vs_plain(torch, tg, dual_kernels, core)
    # each path's launches are counted from 0, set just before it
    reset_counters(kernels, dual_kernels, sk, ss)
    phase_main_path(torch, tg, kernels, core, reference)
    flat_by_batch = {BATCH: kernels.PAIRED_FLAT_LAUNCHES}
    phase_serving(torch, tg, kernels)
    launches = kernels.PAIRED_FLAT_LAUNCHES
    flat_by_batch[SERVE_PLANTS] = launches - flat_by_batch[BATCH]
    check(launches == 1 + SERVE_STEPS, f"main path launched {launches}x")
    reset_counters(kernels, dual_kernels, sk, ss)
    phase_restart_serving(torch, tg, dual_kernels)
    # launches by batch: 256 plants served, then the forms at B4096
    dual_by_batch = {SERVE_PLANTS: dual_kernels.DUAL_LAUNCHES}
    phase_dual_forms(torch, tg, dual_kernels, core)
    dual_launches = dual_kernels.DUAL_LAUNCHES
    dual_by_batch[BATCH] = dual_launches - dual_by_batch[SERVE_PLANTS]
    check(dual_launches == SERVE_STEPS + 2, f"dual path launched {dual_launches}x")
    reset_counters(kernels, dual_kernels, sk, ss)
    chunk_launches = phase_eps_path(torch, tg, dual_kernels, core, reference)
    chunk_by_batch = {BATCH: chunk_launches}
    reset_counters(kernels, dual_kernels, sk, ss)
    phase_dataset_path(torch, tg, kernels, reference)
    dense_by_batch = {1: kernels.DENSE_LAUNCHES}
    phase_multi_path(torch, tg, kernels, reference)
    phase_serving(torch, tg, kernels, paired=False, counter="DENSE_LAUNCHES",
                  phase="dense_serving")
    dense_by_batch[SERVE_PLANTS] = kernels.DENSE_LAUNCHES - dense_by_batch[1]
    sweep_launches = phase_sweep_path(torch, tg, kernels)
    dense_by_batch[SWEEP_CHUNK] = sweep_launches
    dense_launches = kernels.DENSE_LAUNCHES
    check(dense_launches == 1 + MULTI_PLANTS + SERVE_STEPS + sweep_launches,
          f"dense path launched {dense_launches}x")
    check(kernels.PAIRED_FLAT_LAUNCHES == kernels.PAIRED_LAUNCHES == 0,
          "the dense path launched a paired kernel")
    reset_counters(kernels, dual_kernels, sk, ss)
    paired_launches = phase_paired_path(torch, tg, kernels, core, reference)
    check(kernels.PAIRED_LAUNCHES == paired_launches == 1,
          f"paired path launched {kernels.PAIRED_LAUNCHES}x")
    # each leg of the flagship path counts from 0 (phase_flagship_path)
    tiled_launches = phase_flagship_path(torch, tg, kernels, dual_kernels, core,
                                         reference, sk, ss)
    check(set(tiled_launches) == {"gpad_dual_tiled", "gpad_dual_tiled_chunk",
                                  "gpad_flat_tiled"},
          f"flagship path launches {tiled_launches}")
    # the routes past shared memory, each leg counted from 0
    route_legs = phase_tiled_routes_path(torch, tg, kernels, core, reference,
                                         (kernels, dual_kernels, sk, ss))
    # soft rows past shared memory through auto, each leg counted from 0
    soft_legs = phase_tiled_soft_path(torch, tg, core,
                                      (kernels, dual_kernels, sk, ss))
    reset_counters(kernels, dual_kernels, sk, ss)
    phase_stagewise_main_path(torch, tg, sk, ss, ts)
    phase_stagewise_serving(torch, tg, ss)
    sw_launches = {"resident": sk.STAGEWISE_LAUNCHES,
                   "stream": ss.STAGEWISE_STREAM_LAUNCHES}
    check(sw_launches == {"resident": 2, "stream": 1 + SW_SERVE_STEPS},
          f"stage-wise path launches {sw_launches}")
    phase_stagewise_eps(torch, tg, sk, ss)
    phase_near_limit(torch, tg, kernels, core)
    # the estimation and robust stacks, each leg counted from 0
    ctr = (kernels, dual_kernels, sk, ss)
    stacks = {
        "robust_path": phase_robust_path(torch, tg, ctr, reference, smi),
        "robust_stagewise_path": phase_robust_stagewise_path(torch, tg, ts,
                                                             ctr, smi),
        "mhe_path": phase_mhe_path(torch, tg, ctr, smi),
        "estimator_path": {"offset_free": phase_estimator_path(torch, tg,
                                                               ctr)},
        # the NMPC layer (pendulum swing-up, fleet, robust, stage-wise)
        "nmpc_path": phase_nmpc_path(torch, tg, ctr, smi),
        "robust_nmpc_path": phase_robust_nmpc_path(torch, tg, ctr, smi),
        "nmpc_stagewise_path": phase_nmpc_stagewise_path(torch, tg, ts, ctr,
                                                         smi),
        # implicit differentiation through the solves (and its times)
        "diff_path": phase_diff_path(torch, tg, ctr, smi),
        # the sharded solves across processes (tpu_gpad_torch.parallel)
        "parallel": phase_parallel_path(torch, smi),
    }
    # AOT artifacts, every kernel's route loaded in a fresh process
    aot_launches = phase_aot_path(torch, tg, ctr, smi)
    # the precision tiers on the torch engine, then the timing harness
    tiers_launches, tier_launches = phase_tiers_path(torch, tg, core, ctr, smi)
    late = {"tiers_path": tiers_launches,
            "timing_path": phase_timing_path(torch, tg, core, kernels, ctr,
                                             smi)}
    med = phase_timing(torch, tg, kernels, dual_kernels, core, smi)
    dmed = phase_dual_timing(torch, tg, kernels, dual_kernels, core, smi)
    smed = phase_stagewise_timing(torch, tg, sk, ss, ts, smi)
    dnmed = phase_dense_timing(torch, tg, kernels, dual_kernels, core, smi)
    tmed = phase_tiled_timing(torch, tg, kernels, dual_kernels, core, smi)
    rmed = phase_tiled_routes_timing(torch, tg, kernels, core, smi)
    smed_soft = phase_tiled_soft_timing(torch, tg, kernels, dual_kernels,
                                        core, smi)
    soft_row = lambda name: {  # noqa: E731
        label: {k: v for k, v in rows[name].items()
                if k != "ms_median_of_5_per_turn"}
        for label, rows in smed_soft.items() if name in rows}
    route_row = lambda r: {  # noqa: E731
        "ms": r["ms"]["kernel"] if r["device_ms"] is None else r["device_ms"],
        "wrapper_ms": r["ms"]["kernel"], "plain_ms": r["ms"]["plain"],
        "torch_engine_ms": r["ms"]["torch_engine"],
        "auto_solve_ms": r["ms"]["auto"], "auto_kernel": r["auto_kernel"],
        "m": r["m"], "n_z": r["n_z"], "batch": r["batch"],
        "two_torch_mm_ms": r["two_torch_mm_ms"],
        **{k: r[k] for k in ("bound_ms", "bound_by", "flops", "bytes")}}
    routes = {k: route_row(r) for k, r in rmed.items()}
    # no single PyTorch call computes a GPAD solve loop
    no_library = {"library_ms": None}
    line = [{
        "name": "gpad_paired_flat",
        "route": "cuda",
        "source": "tpu_gpad_torch/csrc/gpad_paired_flat.cu",
        "replaces": "tpu_gpad/solver/kernels.py:1493",
        "launches": launches,
        "max_abs_err": worst,
        "ms": kernel_ms(med, "flat"),
        "plain_ms": med[f"flat_plain@{BATCH}"],
        "torch_engine_ms": med["solve_torch"],
        **med["bounds"][f"flat@{BATCH}"], **no_library,
        **by_batch(med, "flat", flat_by_batch),
    }, {
        "name": "gpad_dual",
        "route": "cuda",
        "source": "tpu_gpad_torch/csrc/gpad_dual.cu",
        "replaces": "tpu_gpad/solver/kernels.py:456",
        "launches": dual_launches,
        "max_abs_err": worst_dual,
        # on data condensed on the card (relative to the output's scale)
        "max_err_device_condensed": worst_nmpc,
        "ms": kernel_ms(dmed, "dual"),
        "plain_ms": dmed[f"dual_plain@{BATCH}"],
        "torch_engine_ms": dmed["dual_torch_engine"],
        **dmed["bounds"][f"dual@{BATCH}"], **no_library,
        **by_batch(dmed, "dual", dual_by_batch),
    }, {
        "name": "gpad_dual_chunk",
        "route": "cuda",
        "source": "tpu_gpad_torch/csrc/gpad_dual.cu",
        "replaces": "tpu_gpad/solver/kernels.py:655",
        "launches": chunk_launches,
        "max_abs_err": worst_chunk,
        "ms": kernel_ms(dmed, "chunk"),
        "plain_ms": dmed[f"chunk_plain@{BATCH}"],
        # 10 restart iterations on the torch engine
        "torch_engine_ms": dmed["chunk_torch_engine"],
        **dmed["bounds"][f"chunk@{BATCH}"], **no_library,
        **by_batch(dmed, "chunk", chunk_by_batch),
    }, {
        "name": "gpad_stagewise_resident",
        "route": "cuda",
        "source": "tpu_gpad_torch/csrc/gpad_stagewise.cu",
        "replaces": "tpu_gpad/stagewise_kernel.py:148",
        "launches": sw_launches["resident"],
        "max_abs_err": worst_sw["resident"],
        "ms": smed["resident"],
        "plain_ms": smed["resident_plain"],
        "ms_n8_B4096": smed["resident_n8_B4096"],
        # the torch engine on the same configuration, 10 iterations
        "torch_engine_10_iterations_ms":
            smed[f"torch_engine_10_n8_B{SW_WAVE_BATCH}_sequential"],
        **smed["resident_bound"], **no_library,
    }, {
        "name": "gpad_stagewise_stream",
        "route": "cuda",
        "source": "tpu_gpad_torch/csrc/gpad_stagewise.cu",
        "replaces": "tpu_gpad/stagewise_stream.py:112",
        "launches": sw_launches["stream"],
        "max_abs_err": worst_sw["stream"],
        "ms": smed["stream"],
        "plain_ms": smed["stream_plain"],
        "torch_engine_10_iterations_ms": smed["torch_engine_10_full"],
        **smed["stream_bound"], **no_library,
    }, {
        "name": "gpad_dense",
        "route": "cuda",
        "source": "tpu_gpad_torch/csrc/gpad_dense.cu",
        "replaces": "tpu_gpad/solver/kernels.py:336",
        "launches": dense_launches,
        "max_abs_err": worst_dense,
        "ms": kernel_ms(dnmed, "dense"),
        "plain_ms": dnmed[f"dense_plain@{BATCH}"],
        **dnmed["bounds"][f"dense@{BATCH}"], **no_library,
        **by_batch(dnmed, "dense", dense_by_batch),
    }, {
        "name": "gpad_paired",
        "route": "cuda",
        "source": "tpu_gpad_torch/csrc/gpad_paired_flat.cu",
        "replaces": "tpu_gpad/solver/kernels.py:1271",
        "launches": paired_launches,
        "max_abs_err": worst_paired,
        "ms": kernel_ms(dnmed, "paired"),
        "plain_ms": dnmed[f"paired_plain@{BATCH}"],
        "torch_engine_ms": dnmed["paired_torch"],
        **dnmed["bounds"][f"paired@{BATCH}"], **no_library,
        **by_batch(dnmed, "paired", {BATCH: paired_launches}),
    }, {
        # the flagship's main path runs it under restart
        "name": "gpad_dual_tiled",
        "route": "cuda",
        "source": "tpu_gpad_torch/csrc/gpad_dual_tiled.cu",
        "replaces": "tpu_gpad/solver/kernels.py:771",
        "launches": tiled_launches["gpad_dual_tiled"],
        "max_abs_err": worst_tiled["dual"],
        "ms": tmed["dual_restart"],
        "plain_ms": tmed["dual_restart_plain"],
        "torch_engine_ms": tmed["restart_torch_engine"],
        **tmed["dual_bound"], **no_library,
        # soft rows under restart, soft against hard and the torch engine
        "max_abs_err_soft": worst_soft["dual_tiled"],
        "soft_by_shape": soft_row("dual_tiled_restart"),
    }, {
        "name": "gpad_dual_tiled_chunk",
        "route": "cuda",
        "source": "tpu_gpad_torch/csrc/gpad_dual_tiled.cu",
        "replaces": "tpu_gpad/solver/kernels.py:929",
        "launches": tiled_launches["gpad_dual_tiled_chunk"],
        "max_abs_err": worst_tiled["chunk"],
        "ms": tmed["window"],
        "plain_ms": tmed["window_plain"],
        # 10 restart iterations on the torch engine, and the whole eps solve
        "torch_engine_ms": tmed["window_torch_engine"],
        "eps_solve_ms": tmed["eps_auto"],
        "eps_solve_torch_engine_ms": tmed["eps_torch"],
        **tmed["window_bound"], **no_library,
        # soft rows: a restart window at the flagship, soft against hard
        "max_abs_err_soft": worst_soft["dual_tiled_chunk"],
        "soft_by_shape": soft_row("dual_tiled_chunk"),
    }, {
        "name": "gpad_flat_tiled",
        "route": "cuda",
        "source": "tpu_gpad_torch/csrc/gpad_flat_tiled.cu",
        "replaces": "tpu_gpad/solver/kernels.py:1730",
        "launches": tiled_launches["gpad_flat_tiled"],
        "max_abs_err": worst_tiled["flat"],
        "ms": tmed["flat"],
        "plain_ms": tmed["flat_plain"],
        # the torch engine on the same configuration, and auto's solve
        "torch_engine_ms": tmed["default_torch_engine"],
        "auto_solve_ms": tmed["default_auto"],
        **tmed["flat_bound"], **no_library,
        # at n_s = m_h, the full paired loop past shared memory
        "max_abs_err_paired_tiled": worst_routes["paired_tiled"],
        "paired_tiled_by_shape": {k: v for k, v in routes.items()
                                  if k.startswith("paired_tiled")},
        # soft rows: the flat loop and the paired tiled route
        "max_abs_err_soft": worst_soft["flat_tiled"],
        "max_abs_err_paired_tiled_soft": worst_soft["paired_tiled"],
        "soft_by_shape": soft_row("flat_tiled"),
        "paired_tiled_soft_by_shape": soft_row("paired_tiled"),
    }, {
        # the dense loop past one block's shared memory, at the auto path's
        # shape (dense n10 N20, B256)
        "name": "gpad_dense_tiled",
        "route": "cuda",
        "source": "tpu_gpad_torch/csrc/gpad_dense_tiled.cu",
        "design": "one persistent cooperative launch, two card-wide product "
                  "phases an iteration on operand and state tiles staged "
                  "by bulk copies into a ring of up to 8 shared-memory "
                  "stages on mbarriers; fp32 FFMA register tiles at "
                  "highest, mma.sync under a tier",
        "replaces": "tpu_gpad/solver/kernels.py:336",
        "launches": 0,
        "max_abs_err": worst_routes["dense_tiled"],
        **routes["dense_tiled_n10_N20"], **no_library,
        "by_shape": {k: v for k, v in routes.items()
                     if k.startswith("dense_tiled")},
    }]
    # each kernel's launches: its earlier paths, then the legs of the
    # estimation and robust stacks that launched it
    by_kernel = {}

    def fold(kernel, path, n):
        """A leg's launches of a kernel; the paired tiled route's are the
        flat tiled kernel's."""
        if kernel == "gpad_paired_tiled":
            kernel, path = "gpad_flat_tiled", f"{path}.paired_tiled"
        row = by_kernel.setdefault(kernel, {})
        row[path] = row.get(path, 0) + n

    for phase, legs in stacks.items():
        for leg, got in legs.items():
            for kernel, n in got.items():
                fold(kernel, f"{phase}.{leg}", n)
    check(set(by_kernel) == {"gpad_paired_flat", "gpad_dual", "gpad_dual_chunk",
                             "gpad_dual_tiled", "gpad_stagewise_resident",
                             "gpad_stagewise_stream", "gpad_dense"},
          f"the stacks and the parallel path launched {by_kernel}")
    # the routes past shared memory
    for leg, got in route_legs.items():
        for kernel, n in got.items():
            fold(kernel, f"tiled_routes_path.{leg}", n)
    for leg, got in soft_legs.items():
        for kernel, n in got.items():
            fold(kernel, f"tiled_soft_path.{leg}", n)
    # and the launches of the loaded artifacts (phase_aot_path)
    for got in aot_launches.values():
        for kernel, n in got.items():
            fold(kernel, "aot", n)
    check(all("aot" in by_kernel.get(k["name"], {}) for k in line)
          and "aot.paired_tiled" in by_kernel["gpad_flat_tiled"],
          f"the AOT path launched {aot_launches}")
    # and the legs of the tiers and timing paths
    for phase, legs in late.items():
        for leg, got in legs.items():
            for kernel, n in got.items():
                fold(kernel, f"{phase}.{leg}", n)
    for k in line:
        legs = by_kernel.get(k["name"], {})
        k["launches_by_path"] = {"earlier_paths": k["launches"], **legs}
        k["launches"] += sum(legs.values())
        # the precision tiers it ran on, with their launches in tiers_path
        # (the other paths run "highest")
        k["tiers"] = {"highest": k["launches"] - sum(
            n for t, n in tier_launches.get(k["name"], {}).items()
            if t != "highest"), **{t: n for t, n in tier_launches.get(
                k["name"], {}).items() if t != "highest"}}
    soft_paths = {"gpad_flat_tiled": ("tiled_soft_path.fixed_n10_N30",
                                      "tiled_soft_path.flat_off_n10_N30"
                                      ".paired_tiled"),
                  "gpad_dual_tiled": ("tiled_soft_path.restart_n10_N30",),
                  "gpad_dual_tiled_chunk": (
                      "tiled_soft_path.eps_flat_off_n10_N30",)}
    check(all(k["launches"] > 0 for k in line)
          and "tiled_routes_path.flat_off_n10_N30.paired_tiled"
          in by_kernel["gpad_flat_tiled"]
          and all(p in by_kernel[k] for k, ps in soft_paths.items()
                  for p in ps),
          f"a kernel no path launched: {[k['name'] for k in line]}")
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
