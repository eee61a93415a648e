"""``tpu_gpad_torch.utils.timing`` against ``tpu_gpad.utils.timing``: the
gate of the interleaved A/B harness on the same window pairs, the harness
end to end on CPU tensors (``device="cpu"``, the host clock), and the
refusals: the default device is the card, and a CPU clock never times a
non-CPU output.

A recorded benchmark run of the JAX package (VERDICT.md, r03 item 2):
under contention a solve-side slope window collapsed to a clamp and
fabricated a per-round ratio of 988219.68. The harness must reject such
rounds, not aggregate them."""

import math

import numpy as np
import pytest
import torch

from tpu_gpad.utils.timing import _gate_ab_rounds as jax_gate

import tpu_gpad_torch.utils as tu
from tpu_gpad_torch.utils import timing
from tpu_gpad_torch.utils.timing import _gate_ab_rounds, interleaved_ab

torch.set_num_threads(2)


def _good_pairs(n=6, ta=5.0e-4, tb=5.3e-4, jitter=0.05, seed=0):
    rng = np.random.default_rng(seed)
    return [
        (ta * (1 + jitter * rng.uniform(-1, 1)),
         tb * (1 + jitter * rng.uniform(-1, 1)))
        for _ in range(n)
    ]


def test_gate_rejects_r03_style_garbage():
    pairs = _good_pairs(6)
    # the r03 failure: solve slope collapsed to the old 1e-9 clamp
    pairs.insert(3, (1e-9, 5.3e-4))
    # a contended solve window 4x slow (ratio ~0.26)
    pairs.insert(5, (2.0e-3, 5.3e-4))
    out = _gate_ab_rounds(pairs, rounds=8)
    assert out["rejected_rounds"] >= 2
    assert out["rounds"] + out["rejected_rounds"] == len(pairs)
    assert not out["unstable"]
    # no fabricated ratio survives
    assert max(out["ratios"]) < 10.0
    assert 0.9 < out["ratio_b_over_a_median"] < 1.25
    # raw ratios are still visible for post-mortems
    assert any(r > 1e5 for r in out["ratios_all"])
    assert out == jax_gate(pairs, rounds=8)


def test_gate_floor_marks_side_invalid():
    # floor-failed sides arrive as None (interleaved_ab applies the floor
    # before aggregation); those rounds count as rejected
    pairs = _good_pairs(5) + [(None, 5.3e-4), (5.0e-4, None)]
    out = _gate_ab_rounds(pairs, rounds=7)
    assert out["rejected_rounds"] == 2
    assert out["rounds"] == 5
    assert out == jax_gate(pairs, rounds=7)


def test_gate_all_garbage_is_loud_not_numeric():
    out = _gate_ab_rounds([(None, 1.0), (None, 1.0)], rounds=2)
    assert out["unstable"]
    assert out["rounds"] == 0
    assert math.isnan(out["ratio_b_over_a_median"])


def test_gate_unstable_when_too_few_valid():
    pairs = _good_pairs(2) + [(None, 1e-3)] * 6
    out = _gate_ab_rounds(pairs, rounds=8)
    assert out["unstable"]
    assert out["unstable"] == jax_gate(pairs, rounds=8)["unstable"]


@pytest.fixture
def one_intra_op_thread():
    """Torch on one intra-op thread while a test reads a host-clock ratio
    from ``interleaved_ab``, restored afterwards. On a host oversubscribed
    by other test workers, a product split over threads waits for a
    descheduled peer, more per call in a short window than in a long one,
    and the two sides' windows differ in length (each sized by its own
    probe), so equal work read 0.05-0.1x in 3 of 60 runs under six
    workers, and a pass whose every round the gate rejected sent the
    autoscale to a second pass."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_interleaved_ab_smoke_cpu(one_intra_op_thread):
    # end-to-end: equal workloads -> ratio near 1, all contract keys present
    x = torch.ones((256, 256))
    f = lambda: torch.tanh(x @ x)
    out = interleaved_ab(f, f, rounds=3, k_large=4, min_window_s=0.01,
                         device="cpu")
    for key in (
        "ratio_b_over_a_median",
        "ratios_all",
        "rejected_rounds",
        "unstable",
        "rounds_attempted",
    ):
        assert key in out
    if not out["unstable"]:
        assert 0.2 < out["ratio_b_over_a_median"] < 5.0


def test_interleaved_ab_floor_rejects_impossible_side():
    # a floor ABOVE any credible time for side B forces every round's B
    # side invalid -> loud NaN result, never a number
    x = torch.ones((64, 64))
    f = lambda: x + 1.0
    out = interleaved_ab(
        f, f, rounds=2, k_large=4, min_window_s=0.005, t_b_floor_s=1e9,
        device="cpu",
    )
    assert out["rounds"] == 0
    assert out["unstable"]
    assert math.isnan(out["ratio_b_over_a_median"])


def test_interleaved_ab_iqr_autoscale(one_intra_op_thread):
    # an easy target is met in one pass; an impossible one exhausts the
    # wall budget, keeps the tightest pass, and reports the escalation
    x = torch.ones((256, 256))
    f = lambda: torch.tanh(x @ x)
    out = interleaved_ab(
        f, f, rounds=3, k_large=4, min_window_s=0.01,
        iqr_rel_target=10.0, autoscale_max_s=30.0, device="cpu",
    )
    assert out["autoscale_passes"] == 1
    out2 = interleaved_ab(
        f, f, rounds=3, k_large=4, min_window_s=0.01,
        iqr_rel_target=1e-12, autoscale_max_s=1.0, device="cpu",
    )
    assert out2["autoscale_passes"] >= 1
    assert "autoscale_window_s" in out2
    if not out2["unstable"]:
        assert 0.2 < out2["ratio_b_over_a_median"] < 5.0


@pytest.mark.parametrize("name", ["device_time_stats", "interleaved_ab",
                                  "device_time_percentiles",
                                  "matmul_peak_tflops"])
def test_default_device_is_the_card(name):
    """Without a card, the default device raises before anything runs: a
    measurement never falls back to the host clock."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    calls = []
    f = lambda: calls.append(1) or torch.ones(1)
    args = {"device_time_stats": (f,), "interleaved_ab": (f, f),
            "device_time_percentiles": (f,), "matmul_peak_tflops": ()}[name]
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        getattr(tu, name)(*args)
    assert calls == []


def test_cpu_clock_refuses_another_device_output():
    # a tensor that is not on the CPU (here on the meta device, as a CUDA
    # one would be) timed by the host clock would time its enqueue only
    f = lambda: torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="timed on cpu"):
        tu.device_time_stats(f, n=2, k_large=4, min_window_s=0.001,
                             device="cpu")


def test_stats_percentiles_and_wall_times_cpu():
    x = torch.ones((128, 128))
    f = lambda: torch.tanh(x @ x)
    st = tu.device_time_stats(f, n=3, k_large=4, min_window_s=0.005,
                              device="cpu")
    assert set(st) == {"median_s", "iqr_s", "n", "samples_s", "rejected",
                       "window_calls"}
    assert st["n"] + st["rejected"] <= 6 and st["median_s"] > 0
    assert st["window_calls"] >= 2
    pc = tu.device_time_percentiles(f, n=5, min_window_s=0.005, device="cpu")
    assert (pc["p50_windowmean_s"] <= pc["p90_windowmean_s"]
            <= pc["p99_windowmean_s"])
    assert pc["n"] >= 1
    w = tu.wall_times(f, warmup=1, iters=4)
    assert w.shape == (4,) and (w > 0).all()


def test_slope_rejects_non_positive_windows(monkeypatch):
    """A window pair whose long window comes out no longer than the short
    one is rejected and counted, never clamped into a rate."""
    seq = iter([0.0, 1.0] + [2.0, 1.0] * 3 + [1.0, 3.0] * 10)
    monkeypatch.setattr(timing, "_run_chain",
                        lambda fn, k, device="cuda": next(seq))
    st = tu.device_time_stats(lambda: None, n=3, k_large=22,
                              min_window_s=0.0, device="cpu")
    assert st["rejected"] == 3 and st["n"] == 3
    assert st["median_s"] == pytest.approx(2.0 / 20)


@pytest.mark.parametrize("tier", [("float32", "highest"), ("float32", "high"),
                                  ("float32", "default"),
                                  ("bfloat16", "highest")],
                         ids=["highest", "high", "default", "bfloat16"])
def test_matmul_peak_tflops_cpu(tier):
    dtype, precision = tier
    tf = tu.matmul_peak_tflops(dtype, precision, size=64, repeats=2,
                               device="cpu")
    assert math.isfinite(tf) and tf > 0
    assert torch.backends.cuda.matmul.allow_tf32 is False
