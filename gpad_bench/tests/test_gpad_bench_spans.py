"""The readers of the metrics that rest on the program's own spans
(``tpu_gpad_torch.tracing``), from an aggregate filled by a profiled CPU
run of ``solve_batch`` and ``Controller.step``."""

import sys

import numpy as np
import pytest
import torch

from gpad_bench import harness

NAMES = ("entry_host_ms.fleet", "step_host_ms.serve",
         "host_syncs_per_step.serve")
READERS = {n: harness.load_module(harness.BENCH / "metrics" / f"{n}.py")
           for n in NAMES}
CALLS, STEPS = 3, 4
TRACED = {"trace": {"busy_s": 0.9, "window_s": 1.0, "units": 7}}


@pytest.fixture
def filled():
    """The aggregate after CALLS fleet calls and STEPS controller steps,
    each step one more ``solve_batch`` call, under a CPU profiler."""
    import tpu_gpad_torch as tg
    from tpu_gpad_torch import tracing

    problem = tg.problems.battery(3, 10)
    data = tg.dualize(tg.condense(problem), 20, paired="auto", device="cpu")
    ctrl = tg.Controller(problem, iterations=20,
                         config=tg.SolverConfig(restart=True), device="cpu")
    X0 = torch.rand((8, data.n_x)) - 0.5
    x = np.random.default_rng(1).uniform(-0.5, 0.5, (4, data.n_x))
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(CALLS):
            tg.solve_batch(data, X0)
        for _ in range(STEPS):
            ctrl.step(x)
    yield tracing.summary()
    tracing.reset()


def test_each_reader_reads_the_aggregate(filled):
    P = "tpu_gpad_torch."
    call, step, wait = (filled[P + n] for n in ("solve_batch", "step",
                                                "step.wait"))
    assert call["count"] == CALLS + STEPS and step["count"] == STEPS
    entry = READERS["entry_host_ms.fleet"].read(TRACED)
    assert entry == pytest.approx(1e3 * call["total_s"] / (CALLS + STEPS))
    host = READERS["step_host_ms.serve"].read(TRACED)
    assert host == pytest.approx(1e3 * (step["total_s"] - wait["total_s"])
                                 / STEPS)
    assert 0 < host < 1e3 * step["total_s"] / STEPS
    # a CPU device: the host waits on nothing
    assert READERS["host_syncs_per_step.serve"].read(TRACED) == 0


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("readings", [{}, {"dualize_s": 0.2}, {"trace": None}],
                         ids=["empty", "untraced", "no_trace"])
def test_a_run_without_a_trace_reads_nothing(filled, name, readings):
    assert READERS[name].read(readings) is None


@pytest.mark.parametrize("name", NAMES)
def test_nothing_recorded_reads_nothing(name):
    from tpu_gpad_torch import tracing

    tracing.reset()
    assert READERS[name].read(TRACED) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_spans_reads_nothing(filled, name, monkeypatch):
    """A checkout whose program has no ``tracing`` module (an earlier
    commit): the reader finds nothing and raises nothing."""
    import tpu_gpad_torch

    monkeypatch.delattr(tpu_gpad_torch, "tracing")
    monkeypatch.setitem(sys.modules, "tpu_gpad_torch.tracing", None)
    assert READERS[name].read(TRACED) is None
