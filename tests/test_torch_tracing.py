"""The port's spans and host-sync count (``tpu_gpad_torch.tracing``), CPU.

Off (no profiler recording) a span is the shared no-op and the aggregate
stays empty; on, under ``torch.profiler`` with CPU activity, the spans of
a solve's entry and of a controller step appear with their nesting, as
host events (``cpu_op``, which ``gpad_bench.trace`` labels idle gaps by)
of the exported Chrome trace, the result after the iteration on every
route, with no sync on a CPU device; a ``torch.export`` taken while a
profiler records holds no profiler op and matches the live call.
"""

import inspect
import io
import json

import numpy as np
import pytest
import torch

import tpu_gpad_torch as tg
from tpu_gpad_torch import aot, tracing
from tpu_gpad_torch.solver import SolverConfig

torch.set_num_threads(2)

P = tracing.PREFIX
ITERS = 20
LIVE_TOL = 2e-6  # an artifact against the live solve (test_torch_aot.py)


@pytest.fixture(scope="module")
def data():
    return tg.dualize(tg.condense(tg.problems.battery(3, 10)), ITERS,
                      paired="auto", device="cpu")


def _x0(n=4, seed=0):
    return np.random.default_rng(seed).uniform(-0.4, 0.4, (n, 3))


def _profiled(fn, path=None):
    """``fn()`` under a CPU profiler: the aggregate and the trace's events."""
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    summary = tracing.summary()
    tracing.reset()
    events = []
    if path is not None:
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return summary, events


def _solve(data, **kw):
    return lambda: tg.solve_batch(data, _x0(), SolverConfig(**kw))


def _step(**kw):
    ctrl = tg.Controller(tg.problems.battery(3, 10), iterations=ITERS,
                         device="cpu", **kw)
    return lambda: [ctrl.step(_x0(seed=k)) for k in range(2)]


# each case's spans, child -> parent
CASES = {
    "fixed": ({"solve_batch.affine": "solve_batch",
               "solve_batch.route": "solve_batch",
               "solve_batch.iterate": "solve_batch",
               "solve_batch.finish": "solve_batch"}, {}),
    "restart": ({"solve_batch.iterate": "solve_batch",
                 "solve_batch.finish": "solve_batch"},
                {"restart": True}),
    "dual": ({"solve_batch.iterate": "solve_batch",
              "solve_batch.finish": "solve_batch"},
             {"form": "dual", "restart": True}),
    "eps": ({"solve_batch.iterate": "solve_batch",
             "solve_batch.eps_test": "solve_batch.iterate",
             "solve_batch.finish": "solve_batch"},
            {"mode": "eps", "eps_g": 1e-5, "eps_V": 1e-5, "restart": True,
             "check_every": 5}),
    "step": ({"step.parameter": "step", "step.h2d": "step.parameter",
              "solve_batch": "step", "solve_batch.iterate": "solve_batch",
              "step.wait": "step"}, {}),
    "polish": ({"step.polish": "step", "step.wait": "step",
                "solve_batch": "step"}, {"polish": True}),
}


def _run(data, case):
    kw = CASES[case][1]
    return _step(**kw) if case in ("step", "polish") else _solve(data, **kw)


def test_off_is_the_shared_noop_and_records_nothing(data):
    tracing.reset()
    assert tracing.span("solve_batch") is tracing.span("step", sync=None)
    with tracing.span("x", sync=torch.device("cuda")) as s:
        assert s is None
    _solve(data)()
    _step()()
    assert tracing.summary() == {"syncs": 0}


@pytest.mark.parametrize("case", list(CASES))
def test_spans_nest_as_the_call_does(data, case, tmp_path):
    summary, events = _profiled(_run(data, case), tmp_path / "trace.json")
    spans = {e["name"]: [] for e in events}
    for e in events:
        if e.get("ph") == "X" and e["name"].startswith(P):
            assert e["cat"] == "cpu_op", e
            spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    for child, parent in CASES[case][0].items():
        assert summary[P + child]["count"] > 0, child
        assert spans[P + child] and spans[P + parent], (child, parent)
        for s, t in spans[P + child]:
            assert any(a <= s and t <= b for a, b in spans[P + parent]), (
                child, parent)
    # the result follows the iteration, never inside it
    for s, t in spans.get(P + "solve_batch.finish", []):
        assert all(t <= a or b <= s
                   for a, b in spans[P + "solve_batch.iterate"])
    for name, v in summary.items():
        if name != "syncs":
            assert v["total_s"] > 0 and v["syncs"] == 0, name
    assert summary["syncs"] == 0  # a CPU device: nothing waits


def test_a_step_covers_its_child_spans(data):
    summary, _ = _profiled(_step())
    step, parts = summary[P + "step"], ("step.parameter", "solve_batch",
                                         "step.wait")
    assert step["count"] == 2
    assert all(summary[P + n]["count"] == 2 for n in parts)
    children = sum(summary[P + n]["total_s"] for n in parts)
    assert children <= step["total_s"]


def test_setup_spans(data):
    summary, _ = _profiled(
        lambda: tg.dualize(tg.condense(tg.problems.battery(3, 10)), ITERS,
                           device="cpu"))
    assert summary[P + "condense"]["count"] == 1
    assert summary[P + "dualize"]["count"] == 1
    # the decorator keeps each function's name and arguments
    assert tg.condense.__name__ == "condense"
    assert "problem" in inspect.signature(tg.condense).parameters


def test_build_span_wraps_a_missing_library(tmp_path, monkeypatch):
    """A library not yet loaded builds inside the ``build`` span (here an
    nvcc that fails and prints its arguments, the defines among them);
    one already loaded opens no span."""
    from tpu_gpad_torch import cuda_build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\necho "$@" >&2\nexit 1\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setitem(cuda_build._LIBS, "loaded", None)
    errors = []

    def build():
        cuda_build.load_all(["loaded"])
        try:
            cuda_build.load("gpad_dual", ("GPAD_TEST_DEFINE",))
        except RuntimeError as e:
            errors.append(str(e))

    summary, _ = _profiled(build)
    assert summary[P + "build"]["count"] == 1
    assert "-DGPAD_TEST_DEFINE" in errors[0]


@pytest.mark.parametrize("sync,counted", [
    (torch.device("cuda"), 1), (torch.device("cuda", 1), 1),
    (torch.device("cpu"), 0), (torch.zeros(1), 0), (None, 0)])
def test_a_sync_counts_where_it_waits_on_a_card(sync, counted):
    def wait():
        with tracing.span("step.wait", sync=sync):
            pass

    summary, _ = _profiled(wait)
    assert summary["syncs"] == counted
    assert summary[P + "step.wait"]["syncs"] == counted


@pytest.mark.parametrize("kw", [{}, {"mode": "eps", "eps_g": 1e-5,
                                     "eps_V": 1e-5, "restart": True,
                                     "check_every": 5}],
                         ids=["fixed", "eps"])
def test_an_export_under_the_profiler_holds_no_profiler_op(data, kw):
    cfg = SolverConfig(iterations=ITERS, **kw)
    blobs = []
    summary, _ = _profiled(lambda: blobs.append(aot.export_solver(
        data, cfg, batch_size=4)))
    assert not any(n.startswith(P + "solve_batch") for n in summary)
    program = torch.export.load(io.BytesIO(blobs[0]))
    targets = [str(n.target) for n in program.graph.nodes]
    assert not [t for t in targets
                if "profiler" in t or "record_function" in t]
    x0 = _x0()
    out = aot.load_solver(blobs[0])(x0)
    live = tg.solve_batch(data, x0, cfg)
    for k in ("u", "z", "y"):
        torch.testing.assert_close(out[k], getattr(live, k), atol=LIVE_TOL,
                                   rtol=0, msg=k)


def test_reset_clears_the_aggregate(data):
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _solve(data)()
    assert tracing.summary()[P + "solve_batch"]["count"] == 1
    tracing.reset()
    assert tracing.summary() == {"syncs": 0}
