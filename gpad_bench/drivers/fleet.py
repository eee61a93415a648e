"""Fleet traffic: ``solve_batch`` calls back to back on a seeded pool of states.

The mix's file gives ``batch`` (scenarios a call), ``pool`` (distinct
state batches, made on the device from the seed and used in turn),
``x0_low``/``x0_high`` (each initial SoC drawn uniform in between),
``in_flight`` (the host waits on a call's CUDA event only once that many
newer calls are queued), ``keep_calls`` (calls whose answers are checked,
drawn from the seed over the window) and ``solver`` (options of the
mix, on top of the configuration's precision).

End to end: ``solves_per_s``, every scenario of every call dispatched in
the window over the time from its first dispatch to its last call's
completion. Checked: each kept call's z against the plain reference's,
every scenario, after the window.
"""

from __future__ import annotations

import time
from collections import deque

import torch

from gpad_bench import harness, work
from gpad_bench.reference.gpad import Gpad
from gpad_bench.trace import Tracer

CHECK_ROWS = 4096  # scenarios the reference takes at once


class _Done:
    """A point in the device's queue that the host can wait for."""

    def __init__(self, device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def run(r: harness.Run) -> None:
    import tpu_gpad_torch as tg
    from tpu_gpad_torch.solver import core

    t, cfg, dev = r.traffic, r.cell.config, r.device
    iterations = cfg["solver"]["iterations"]
    problem = harness.program_problem(tg, cfg)
    t0 = time.perf_counter()
    data = tg.dualize(tg.condense(problem), iterations=iterations,
                      paired=cfg["solver"]["paired"], device=dev)
    r.readings["dualize_s"] = time.perf_counter() - t0
    config = harness.solver_config(tg, cfg, t)
    B, P, depth, K = t["batch"], t["pool"], t["in_flight"], t["keep_calls"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(harness.seeded(r.seed, 0).integers(2**63)))
    pool = t["x0_low"] + (t["x0_high"] - t["x0_low"]) * torch.rand(
        (P, B, data.n_x), generator=gen, device=dev)
    tracer = Tracer(r.trace, r.seconds, dev)
    tracer.warm_up()
    w0 = time.perf_counter()
    # warm up the one shape the window runs, holding as many answers at
    # once as the window does, so that the allocator has their blocks
    held = [tg.solve_batch(data, pool[0], config)]
    harness.sync(dev)
    r.info["first_call_s"] = time.perf_counter() - w0
    held += [tg.solve_batch(data, pool[i % P], config)
             for i in range(1, depth + K + 2)]
    harness.sync(dev)
    del held
    r.info["warm_up_s"] = time.perf_counter() - w0
    before = harness.launch_counts()

    keep, pick = [], harness.seeded(r.seed, 1)
    ring, host_s = deque(), []
    calls = 0
    t_first = r.window_start = time.perf_counter()
    while (now := time.perf_counter()) - t_first < r.seconds:
        tracer.tick(now - t_first)
        c0 = time.perf_counter()
        res = tg.solve_batch(data, pool[calls % P], config)
        c1 = time.perf_counter()
        if not tracer.inside():
            host_s.append(c1 - c0)
        ring.append(_Done(dev))
        # a uniform sample of K calls of the window (reservoir sampling)
        if len(keep) < K:
            keep.append((calls, res.z))
        elif (j := int(pick.integers(calls + 1))) < K:
            keep[j] = (calls, res.z)
        del res
        calls += 1
        if len(ring) > depth:
            ring.popleft().wait()
    harness.sync(dev)
    t_end = time.perf_counter()
    tracer.stop()
    r.memory_peak_bytes = harness.memory_peak(dev)
    r.attempted = calls
    r.e2e["solves_per_s"] = calls * B / (t_end - t_first)
    r.info.update(
        route=core.cuda_kernel(data, config, batch=B),
        launches=harness.launches_since(before), calls=calls, batch=B,
        host_ms_per_call_p50=1e3 * harness.quantile(host_s, 0.5),
        host_ms_per_call_p99=1e3 * harness.quantile(host_s, 0.99),
        window_s=t_end - t_first)
    r.readings["trace"] = tr = tracer.result
    if tr is not None:
        r.info["traced_ms_per_call"] = 1e3 * tr["host_s"] / max(tr["units"], 1)
    del data, ring
    harness.release(dev)

    # the answers against the plain reference, once the window has closed
    c0 = time.perf_counter()
    plant_ref, _, qp = harness.reference_qp(cfg)
    ref = Gpad(qp, iterations, dev)
    gap = 0.0
    for index, z in sorted(keep, key=lambda kz: kz[0]):
        X0 = pool[index % P]
        for s in range(0, B, CHECK_ROWS):
            z_ref, _ = ref.solve(X0[s:s + CHECK_ROWS], restart=config.restart)
            gap = max(gap, harness.max_gap(z[s:s + CHECK_ROWS], z_ref))
    r.check("z_gap", gap)
    r.info["checked_calls"] = sorted(i for i, _ in keep)
    r.info["reference_s"] = time.perf_counter() - c0

    bound = work.bound_seconds(*work.call_work(plant_ref.shape(qp), B, iterations))
    r.readings.update(host_s_per_call=host_s, bound_s_per_unit=bound)
    r.info["bound_ms_per_call"] = 1e3 * bound
