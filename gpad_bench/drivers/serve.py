"""Serving traffic: a closed loop of ``Controller.step`` on a fleet of plants.

The mix's file gives ``plants`` (states a step, one batch), ``x0_low`` /
``x0_high`` (each plant's initial SoC drawn uniform in between from the
seed), ``disturbance`` (each cell's SoC pushed by a seeded uniform(-d, d)
after every step), ``warm_steps`` (steps in set-up, then ``reset``),
``check_plants`` (plants, drawn from the seed, whose every step is
checked), ``median_steps`` (see below) and ``solver`` (the mix's
options, e.g. restart). The plant is the harness's own, the reference's
x+ = A x + B u + w, stepped on the host with the move ``step`` returned.

End to end: ``step_ms_p95`` (95th percentile of the host-clock latency
of every step in the window; a step ends when u* is on the host) and
``step_ms_mean`` (the window's time over its steps, the plant's update
included). Checked: every step's u of the drawn plants against the plain
reference's own closed loop from the same states and disturbances, its
warm starts its own: ``u_gap``, the widest gap of any move, and
``u_gap_median``, the median gap over the checked moves of the window's
first ``median_steps`` steps (the cold start, every cell at full current,
the same stretch however many steps the window holds), which restart
decisions that flip under rounding leave alone.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gpad_bench import harness, work
from gpad_bench.reference.gpad import Gpad
from gpad_bench.trace import Tracer


def run(r: harness.Run) -> None:
    import tpu_gpad_torch as tg
    from tpu_gpad_torch.solver import core

    t, cfg, dev = r.traffic, r.cell.config, r.device
    iterations = cfg["solver"]["iterations"]
    problem = harness.program_problem(tg, cfg)
    config = harness.solver_config(tg, cfg, t)
    t0 = time.perf_counter()  # the controller condenses and dualizes
    ctrl = tg.Controller(problem, iterations=iterations, config=config,
                         warm_start=True, paired=cfg["solver"]["paired"],
                         device=dev)
    r.readings["dualize_s"] = time.perf_counter() - t0
    plant_ref, plant, qp = harness.reference_qp(cfg)
    n = t["plants"]
    x0 = harness.seeded(r.seed, 0).uniform(
        t["x0_low"], t["x0_high"], (n, plant.A.shape[0]))
    drawn = np.sort(harness.seeded(r.seed, 1).choice(
        n, size=min(t["check_plants"], n), replace=False))
    push = harness.seeded(r.seed, 2)
    d = t["disturbance"]
    tracer = Tracer(r.trace, r.seconds, dev)
    tracer.warm_up()
    w0 = time.perf_counter()
    for i in range(t["warm_steps"]):
        ctrl.step(x0)
        if i == 0:
            r.info["first_call_s"] = time.perf_counter() - w0
    ctrl.reset()
    r.info["warm_up_s"] = time.perf_counter() - w0
    before = harness.launch_counts()

    x, lat, U, W = x0.copy(), [], [], []
    t_first = r.window_start = time.perf_counter()
    while (now := time.perf_counter()) - t_first < r.seconds:
        tracer.tick(now - t_first)
        s0 = time.perf_counter()
        u = ctrl.step(x)
        lat.append(time.perf_counter() - s0)
        w = push.uniform(-d, d, x.shape)
        U.append(u[drawn])
        W.append(w[drawn])
        x = x @ plant.A.T + u @ plant.B.T + w
    t_end = time.perf_counter()
    tracer.stop()
    steps = len(lat)
    r.memory_peak_bytes = harness.memory_peak(dev)
    r.attempted = steps
    r.e2e["step_ms_p95"] = 1e3 * harness.quantile(lat, 0.95)
    r.e2e["step_ms_mean"] = 1e3 * (t_end - t_first) / steps
    r.info.update(
        route=core.cuda_kernel(ctrl.data, ctrl.config, batch=n),
        launches=harness.launches_since(before), steps=steps, plants=n,
        step_ms_p50=1e3 * harness.quantile(lat, 0.5),
        step_ms_p99=1e3 * harness.quantile(lat, 0.99),
        step_ms_max=1e3 * max(lat), window_s=t_end - t_first)
    r.readings["trace"] = tr = tracer.result
    if tr is not None:
        r.info["traced_ms_per_step"] = 1e3 * tr["host_s"] / max(tr["units"], 1)
    del ctrl
    harness.release(dev)

    # the reference's own closed loop, once the window has closed
    c0 = time.perf_counter()
    ref = Gpad(qp, iterations, dev)
    f64 = dict(dtype=torch.float64, device=dev)
    A, Bm = (torch.tensor(a, **f64) for a in (plant.A, plant.B))
    U = torch.tensor(np.stack(U), **f64)
    W = torch.tensor(np.stack(W), **f64)
    xr = torch.tensor(x0[drawn], **f64)
    y = torch.zeros((len(drawn), qp.G.shape[0]), **f64)  # a cold start
    solve = ref.replayed(len(drawn), config.restart, dev)
    gaps = torch.empty_like(U)
    for k in range(steps):
        z, y = solve(xr, y)
        u_ref = z[:, :plant.B.shape[1]]
        gaps[k] = (U[k] - u_ref).abs()
        xr = xr @ A.T + u_ref @ Bm.T + W[k]
    gaps = torch.where(torch.isfinite(gaps), gaps, torch.inf)
    widest = gaps.amax(dim=(1, 2))
    r.check("u_gap", float(widest.max()))
    r.check("u_gap_median", float(gaps[:t["median_steps"]].median()))
    r.info["checked_plants"] = drawn.tolist()
    r.info["u_gap_step"] = int(widest.argmax())
    r.info["reference_s"] = time.perf_counter() - c0

    bound = work.bound_seconds(*work.call_work(plant_ref.shape(qp), n,
                                                iterations, warm_start=True))
    r.readings["bound_s_per_unit"] = bound
    r.info["bound_ms_per_step"] = 1e3 * bound
