"""The host-sync count of ``tpu_gpad_torch.tracing``'s spans on the card.

A serving step of the battery 30x30 controller (256 plants, restart, warm
starts) counts exactly its two syncs, the parameter's copy to the card
and u*'s copy back; a fleet ``solve_batch`` of the battery n3 N10 plant at
B16384 counts none with its states on the card, and one, their copy, from
the host. Under ``torch.cuda.set_sync_debug_mode("warn")``
PyTorch warns at every synchronizing CUDA operation, and the warnings
equal the count: the counter misses no sync. Every test needs a CUDA
device and skips without one. This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing_cuda.py
"""

import warnings

import numpy as np
import pytest
import torch

import tpu_gpad_torch as tg
from tpu_gpad_torch import tracing

pytestmark = pytest.mark.cuda

STEPS = 3


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _profiled(fn, calls: int):
    """``calls`` calls of ``fn`` under a profiler and the sync debug mode:
    the spans' summary and the synchronizing operations PyTorch warned of."""
    fn()  # builds and warms up, unprofiled
    torch.cuda.synchronize()
    tracing.reset()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for _ in range(calls):
                    fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    summary = tracing.summary()
    tracing.reset()
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    return summary, len(syncs)


def test_serve_step_counts_its_two_syncs(dev):
    ctrl = tg.Controller(tg.problems.battery(30, 30), iterations=100,
                         config=tg.SolverConfig(restart=True),
                         warm_start=True, paired="auto", device=dev)
    x = np.random.default_rng(3).uniform(-0.5, 0.5, (256, 30))
    summary, warned = _profiled(lambda: ctrl.step(x), STEPS)
    assert summary["tpu_gpad_torch.step"]["count"] == STEPS
    assert summary["tpu_gpad_torch.step.h2d"]["syncs"] == STEPS
    assert summary["tpu_gpad_torch.step.wait"]["syncs"] == STEPS
    assert summary["syncs"] == 2 * STEPS
    assert warned == summary["syncs"]


@pytest.mark.parametrize("source,syncs", [("card", 0), ("numpy", 1),
                                          ("cpu_tensor", 1)])
def test_fleet_call_counts_its_syncs(dev, source, syncs):
    """States on the card: no sync; from the host, NumPy or a CPU tensor:
    one, the pageable copy in ``solve_batch.affine``."""
    data = tg.dualize(tg.condense(tg.problems.battery(3, 10)), 100,
                      paired="auto", device=dev)
    X0 = torch.rand((16384, data.n_x), device=dev) - 0.5
    X0 = {"card": X0, "numpy": X0.cpu().numpy(), "cpu_tensor": X0.cpu()}[
        source]
    summary, warned = _profiled(lambda: tg.solve_batch(data, X0), STEPS)
    assert summary["tpu_gpad_torch.solve_batch"]["count"] == STEPS
    assert summary["tpu_gpad_torch.solve_batch.iterate"]["count"] == STEPS
    assert summary["syncs"] == syncs * STEPS
    assert summary.get("tpu_gpad_torch.solve_batch.affine",
                       {}).get("syncs", 0) == syncs * STEPS
    assert warned == summary["syncs"]
