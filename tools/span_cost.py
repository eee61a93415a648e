"""The host cost of ``tpu_gpad_torch.tracing.span``, off and on.

    python tools/span_cost.py [--device cuda|cpu]

Prints one JSON line: nanoseconds an empty span costs with no profiler
recording (``off_ns_per_span``, the best of 7 repeats less an empty
loop's), microseconds with a profiler that records the device alone
(``device_only_us_per_span``, a card only: the benchmark's metrics
window) and with one that records the host (``on_us_per_span``); the
spans of one fleet ``solve_batch`` of the battery n3 N10 plant (B16384 on
a card, B64 on the CPU) and of one serving ``Controller.step`` of battery
n30 N30 on 256 plants with restart (a card only), and their cost off per
call. On a card it also gives what the benchmark's span metrics read in
each kind of session, over 200 fleet calls (the card drained every 4)
and 50 steps: the mean ``solve_batch`` span (``fleet_entry_ms``) beside
the host clock's mean call with no profiler, and the mean step less its
wait for u* (``serve_step_host_ms``). Imports no jax.
"""

import argparse
import json
import sys
import time
import timeit
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

import tpu_gpad_torch as tg  # noqa: E402
from tpu_gpad_torch import tracing  # noqa: E402

P = tracing.PREFIX
QUEUE = 4
SESSIONS = {"device_only": [torch.profiler.ProfilerActivity.CUDA],
            "host_and_device": [torch.profiler.ProfilerActivity.CPU,
                                torch.profiler.ProfilerActivity.CUDA]}


def _ns_per_loop(stmt: str, number: int) -> float:
    g = {"span": tracing.span}
    return 1e9 * min(timeit.repeat(stmt, globals=g, number=number,
                                   repeat=7)) / number


def _spans_per_call(fn) -> int:
    fn()  # warm up (builds, allocations) unprofiled
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()
    counts = sum(v["count"] for k, v in tracing.summary().items()
                 if k != "syncs")
    tracing.reset()
    return counts


def _queued(fn, calls: int) -> None:
    """``calls`` calls of ``fn``, the card drained after every ``QUEUE``,
    as the benchmark's fleet loop keeps its queue."""
    for k in range(calls):
        fn()
        if (k + 1) % QUEUE == 0:
            torch.cuda.synchronize()
    torch.cuda.synchronize()


def _aggregate(fn, calls: int, acts) -> dict:
    """The spans' aggregate over ``calls`` calls under a profiler."""
    torch.cuda.synchronize()
    tracing.reset()
    with torch.profiler.profile(activities=acts):
        _queued(fn, calls)
    out = tracing.summary()
    tracing.reset()
    return out


def _readings(dev, data, X0, ctrl, x) -> dict:
    """What the span metrics read in each kind of session, on a card."""
    calls, steps = 200, 50
    out = {}
    for _ in range(2):  # the first profiler start in the process is slow
        _aggregate(lambda: tg.solve_batch(data, X0), 2,
                   SESSIONS["device_only"])
    host = []

    def timed():
        t0 = time.perf_counter()
        tg.solve_batch(data, X0)
        host.append(time.perf_counter() - t0)

    _queued(timed, calls)
    out["fleet_host_clock_ms"] = 1e3 * sum(host) / calls
    for kind, acts in SESSIONS.items():
        s = _aggregate(lambda: tg.solve_batch(data, X0), calls, acts)
        call = s[P + "solve_batch"]
        out[f"fleet_entry_ms.{kind}"] = 1e3 * call["total_s"] / call["count"]
        s = _aggregate(lambda: ctrl.step(x), steps, acts)
        step, wait = s[P + "step"], s[P + "step.wait"]
        out[f"serve_step_host_ms.{kind}"] = (
            1e3 * (step["total_s"] - wait["total_s"]) / step["count"])
        out[f"serve_syncs_per_step.{kind}"] = s["syncs"] / step["count"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available()
                    else "cpu")
    dev = torch.device(ap.parse_args().device)
    empty = _ns_per_loop("pass", 1_000_000)
    off = _ns_per_loop("with span('x'): pass", 1_000_000) - empty
    out = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "torch": torch.__version__, "off_ns_per_span": off}
    kinds = SESSIONS if dev.type == "cuda" else {
        "host_and_device": [torch.profiler.ProfilerActivity.CPU]}
    for kind, acts in kinds.items():
        with torch.profiler.profile(activities=acts):
            on = _ns_per_loop("with span('x'): pass", 2_000) - empty
        key = "on_us_per_span" if kind == "host_and_device" else (
            "device_only_us_per_span")
        out[key] = on * 1e-3
    tracing.reset()
    data = tg.dualize(tg.condense(tg.problems.battery(3, 10)), 100,
                      paired="auto", device=dev)
    B = 16384 if dev.type == "cuda" else 64
    X0 = torch.rand((B, data.n_x), device=dev) - 0.5
    n = _spans_per_call(lambda: tg.solve_batch(data, X0))
    out.update(fleet_spans_per_call=n, fleet_off_us_per_call=n * off * 1e-3)
    if dev.type == "cuda":
        ctrl = tg.Controller(tg.problems.battery(30, 30), iterations=100,
                             config=tg.SolverConfig(restart=True),
                             device=dev)
        x = np.random.default_rng(0).uniform(-0.5, 0.5, (256, 30))
        n = _spans_per_call(lambda: ctrl.step(x))
        out.update(serve_spans_per_step=n,
                   serve_off_us_per_step=n * off * 1e-3)
        out.update(_readings(dev, data, X0, ctrl, x))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
