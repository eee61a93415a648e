"""Device time of a call: CUDA events on the card, the host clock for CPU work.

The counterpart of ``tpu_gpad.utils.timing``. PyTorch returns before the
card finishes, so a host clock without a synchronise measures only the
enqueue. Here a window of k calls is bracketed by two CUDA events recorded
on the current stream and read after one synchronise (``_run_chain``), and
the statistics of the JAX package are kept as they are, in NumPy: the
slope between a long and a short window (the fixed cost of a window
cancels), the rejection of non-positive windows, the interleaved A/B
rounds with their floors, ``gate_band`` medians and ``unstable`` flag, and
the IQR autoscale.

Every function but ``wall_times`` takes ``device``: "cuda" (the default)
times the card and raises where there is none; "cpu" times work on CPU
tensors with ``time.perf_counter``, which is the CPU's own device time (a
CPU op returns when it is done), and raises for a CUDA output. Nothing
falls back from one clock to the other.

``anchored_throughput`` and its ``ANCHOR_*`` constants are not ported: they
pin the TPU v5e's measured fp32 roofline.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch


def _clock(device) -> torch.device:
    """The device whose clock a measurement reads: a CUDA device (raises
    without one) or the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "timing on device 'cuda' needs a CUDA device; pass device='cpu' "
            "to time work on CPU tensors with the host clock")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unknown timing device: {device}")
    return device


def _tensors(out):
    """The tensors in ``out`` (a tensor, a dict, a sequence, a dataclass)."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)
    elif hasattr(out, "__dataclass_fields__"):
        for name in out.__dataclass_fields__:
            yield from _tensors(getattr(out, name))


def _check_output(out, device: torch.device) -> None:
    """Raise for an output on another kind of device than the clock's: a
    CUDA output timed by the host clock would time its enqueue only."""
    for t in _tensors(out):
        if t.device.type != device.type:
            raise ValueError(
                f"fn returned a tensor on {t.device}, timed on {device}: "
                "time CUDA work with device='cuda'")
        return


def _run_chain(fn, k: int, device="cuda") -> float:
    """Seconds that ``k`` calls of ``fn()`` take on ``device``: on the card
    from a CUDA event before the first dispatch to one after the last, read
    after one synchronise; on the CPU by the host clock."""
    device = torch.device(device)
    if device.type == "cpu":
        t0 = time.perf_counter()
        out = None
        for _ in range(k):
            out = fn()
        elapsed = time.perf_counter() - t0
        _check_output(out, device)
        return elapsed
    with torch.cuda.device(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = None
        for _ in range(k):
            out = fn()
        end.record()
        end.synchronize()
        _check_output(out, device)
        return start.elapsed_time(end) / 1e3


def device_time_per_call(fn, warmup: int = 3, repeats: int = 20) -> float:
    """Median device time of ``fn()`` in seconds over ``repeats`` calls.

    ``warmup`` calls run first, outside the timed window (the first call
    builds and loads the kernels). Raises when no CUDA device is present:
    a measurement never falls back to the host clock.

    Unlike ``tpu_gpad.utils.device_time_per_call`` (the minimum of slope
    samples over chains of calls, built to cancel a tunnel's fixed round
    trip), each call here is bracketed by its own pair of CUDA events, so
    the reading is one call's device time, host gaps inside it included;
    ``device_time_stats`` is the slope method."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_time_per_call needs a CUDA device")
    for _ in range(warmup):
        fn()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(repeats)
    ]
    torch.cuda.synchronize()
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events) / 1e3


def _sized_k_large(fn, k_small: int, k_large: int, min_window_s: float,
                   device="cuda") -> int:
    """``k_large`` grown until the slope window (k_large - k_small calls)
    lasts at least ``min_window_s`` (at most 20000 calls)."""
    t_probe = _run_chain(fn, k_large, device) / k_large
    if t_probe * (k_large - k_small) < min_window_s:
        k_large = k_small + max(int(min_window_s / max(t_probe, 1e-7)), 20)
        k_large = min(k_large, 20000)
    return k_large


def device_time_stats(
    fn,
    n: int = 5,
    k_small: int = 2,
    k_large: int = 22,
    min_window_s: float = 0.15,
    device="cuda",
) -> dict:
    """Median-of-n slope-method timing with spread: each sample is
    (t(k_large calls) - t(k_small calls)) / (k_large - k_small), so the
    fixed cost of a window cancels; ``k_large`` grows until a window lasts
    ``min_window_s``.

    A window whose difference comes out <= 0 is meaningless and is
    REJECTED and re-sampled (up to ``2n`` attempts), counted in
    ``rejected``; if every window is rejected, the one sample is the long
    window's mean, never a clamp. Returns ``{"median_s", "iqr_s", "n",
    "samples_s", "rejected", "window_calls"}``."""
    device = _clock(device)
    _run_chain(fn, 2, device)  # warm up builds and caches
    k_large = _sized_k_large(fn, k_small, k_large, min_window_s, device)
    samples = []
    rejected = 0
    for _ in range(2 * n):
        if len(samples) == n:
            break
        t_small = _run_chain(fn, k_small, device)
        t_large = _run_chain(fn, k_large, device)
        slope = (t_large - t_small) / (k_large - k_small)
        if slope <= 0:
            rejected += 1
            continue
        samples.append(slope)
    if not samples:  # every window rejected: report the long window, loudly
        samples = [max(t_large / k_large, 1e-9)]
    s = np.asarray(samples)
    q1, q3 = np.percentile(s, [25, 75])
    return {
        "median_s": float(np.median(s)),
        "iqr_s": float(q3 - q1),
        "n": int(len(samples)),
        "samples_s": [float(x) for x in s],
        "rejected": int(rejected),
        "window_calls": int(k_large - k_small),
    }


def device_time_percentiles(
    fn, n: int = 100, min_window_s: float = 0.05, device="cuda"
) -> dict:
    """Device-time percentiles over ``n`` independent slope-method samples.

    Each sample is a *window mean* over the (k_large - k_small) chained
    calls of one slope window, so these are percentiles of window-mean
    device time: averaging inside a window hides a single call's tail, and
    what they track is the variation from window to window. Keys carry
    ``_windowmean_s`` to keep that visible; ``window_calls`` is the
    averaging width."""
    stats = device_time_stats(fn, n=n, min_window_s=min_window_s,
                              device=device)
    s = np.asarray(stats["samples_s"])
    return {
        "p50_windowmean_s": float(np.percentile(s, 50)),
        "p90_windowmean_s": float(np.percentile(s, 90)),
        "p99_windowmean_s": float(np.percentile(s, 99)),
        "n": int(stats["n"]),
        # non-positive windows rejected and re-sampled; slow windows are
        # kept: they are the tail
        "rejected_windows": int(stats["rejected"]),
        "window_calls": int(stats["window_calls"]),
    }


def interleaved_ab(
    fn_a,
    fn_b,
    rounds: int = 8,
    k_small: int = 2,
    k_large: int = 22,
    min_window_s: float = 0.15,
    t_a_floor_s: float = 0.0,
    t_b_floor_s: float = 0.0,
    gate_band: float = 3.0,
    iqr_rel_target: "float | None" = None,
    autoscale_max_s: float = 120.0,
    device="cuda",
) -> dict:
    """Drift-cancelling A/B comparison: alternate slope-method windows of A
    and B and report per-round ratios, so that both sides see the same
    state of the device (clocks, power, contention) in each round.

    A round is REJECTED (never silently used) when any of:

    - either slope is <= 0;
    - either side is faster than its physical floor (``t_a_floor_s`` /
      ``t_b_floor_s``: a faster reading is impossible, not lucky);
    - either side deviates from its own cross-round median by more than
      ``gate_band``x in either direction, or the ratio deviates from the
      cross-round median ratio by more than ``gate_band``x.

    Rejected rounds are replaced (up to ``2*rounds`` window pairs) and
    counted in ``rejected_rounds``; ``unstable`` is set when fewer than
    ``max(3, rounds//2)`` valid rounds survive.

    With ``iqr_rel_target`` (e.g. 0.10) the measurement escalates, 3x
    longer windows and more rounds a pass, until the surviving ratios'
    IQR/median meets the target or ``autoscale_max_s`` of wall clock is
    spent; the result is the tightest pass, with ``autoscale_passes`` and
    ``autoscale_window_s``.

    Returns ``{"ratio_b_over_a_median", "ratio_b_over_a_iqr", "ratios",
    "ratios_all", "t_a_median_s", "t_b_median_s", "rounds",
    "rounds_attempted", "rejected_rounds", "unstable"}``. A ratio > 1
    means A is faster (B takes longer). Both fns must return their output
    tensor(s) (e.g. ``res.u``), on ``device``."""
    device = _clock(device)
    t_start = time.perf_counter()

    def one_pass(win_s, n_rounds):
        _run_chain(fn_a, 2, device)
        _run_chain(fn_b, 2, device)
        ka = _sized_k_large(fn_a, k_small, k_large, win_s, device)
        kb = _sized_k_large(fn_b, k_small, k_large, win_s, device)
        raw = []  # (ta, tb) with None for slope-invalid sides
        for _ in range(2 * n_rounds):
            # stop when `rounds` rounds survive the full gate (floor and
            # band): band-rejected rounds are replaced too
            if (
                len(raw) >= n_rounds
                and _gate_ab_rounds(raw, n_rounds, gate_band)["rounds"]
                >= n_rounds
            ):
                break
            ta = (
                _run_chain(fn_a, ka, device) - _run_chain(fn_a, k_small, device)
            ) / (ka - k_small)
            tb = (
                _run_chain(fn_b, kb, device) - _run_chain(fn_b, k_small, device)
            ) / (kb - k_small)
            raw.append(
                (
                    ta if ta > max(t_a_floor_s, 0.0) else None,
                    tb if tb > max(t_b_floor_s, 0.0) else None,
                )
            )
        return _gate_ab_rounds(raw, n_rounds, gate_band)

    win, n_rounds, passes = min_window_s, rounds, 0
    best = None
    while True:
        res = one_pass(win, n_rounds)
        passes += 1
        med = res["ratio_b_over_a_median"]
        rel = (
            res["ratio_b_over_a_iqr"] / abs(med)
            if res["rounds"] > 0 and med
            else float("inf")
        )
        if best is None or rel < best[0]:
            best = (rel, res, win)
        if (
            iqr_rel_target is None
            or best[0] <= iqr_rel_target
            or time.perf_counter() - t_start > autoscale_max_s
        ):
            break
        win, n_rounds = win * 3.0, max(n_rounds, rounds + 2)
    _, res, win_used = best
    if iqr_rel_target is not None:
        res["autoscale_passes"] = passes
        res["autoscale_window_s"] = win_used
    return res


def _gate_ab_rounds(raw, rounds: int, gate_band: float = 3.0) -> dict:
    """The gating and aggregation step of ``interleaved_ab``, pure: ``raw``
    holds the (ta, tb) window pairs, None for a side whose slope failed
    the floor or positivity check."""
    pairs = [p for p in raw if p[0] is not None and p[1] is not None]
    n_attempted = len(raw)
    if not pairs:  # nothing valid: a loud, unusable result
        return {
            "ratio_b_over_a_median": float("nan"),
            "ratio_b_over_a_iqr": float("nan"),
            "ratios": [],
            "ratios_all": [],
            "t_a_median_s": float("nan"),
            "t_b_median_s": float("nan"),
            "rounds": 0,
            "rounds_attempted": n_attempted,
            "rejected_rounds": n_attempted,
            "unstable": True,
        }
    t_as = np.asarray([p[0] for p in pairs])
    t_bs = np.asarray([p[1] for p in pairs])
    ratios_all = t_bs / t_as
    med_a, med_b = np.median(t_as), np.median(t_bs)
    med_r = np.median(ratios_all)
    keep = (
        (t_as > med_a / gate_band)
        & (t_as < med_a * gate_band)
        & (t_bs > med_b / gate_band)
        & (t_bs < med_b * gate_band)
        & (ratios_all > med_r / gate_band)
        & (ratios_all < med_r * gate_band)
    )
    r = ratios_all[keep]
    n_valid = int(keep.sum())
    if n_valid == 0:  # the medians themselves are corrupted
        return {
            "ratio_b_over_a_median": float("nan"),
            "ratio_b_over_a_iqr": float("nan"),
            "ratios": [],
            "ratios_all": [float(x) for x in ratios_all],
            "t_a_median_s": float("nan"),
            "t_b_median_s": float("nan"),
            "rounds": 0,
            "rounds_attempted": n_attempted,
            "rejected_rounds": n_attempted,
            "unstable": True,
        }
    q1, q3 = np.percentile(r, [25, 75])
    return {
        "ratio_b_over_a_median": float(np.median(r)),
        "ratio_b_over_a_iqr": float(q3 - q1),
        "ratios": [float(x) for x in r],
        "ratios_all": [float(x) for x in ratios_all],
        "t_a_median_s": float(np.median(t_as[keep])),
        "t_b_median_s": float(np.median(t_bs[keep])),
        "rounds": n_valid,
        "rounds_attempted": n_attempted,
        "rejected_rounds": n_attempted - n_valid,
        "unstable": bool(n_valid < max(3, rounds // 2)),
    }


def matmul_peak_tflops(
    dtype: str = "float32",
    precision: str = "highest",
    size: int = 4096,
    repeats: int = 5,
    device="cuda",
) -> float:
    """Measured dense-product ceiling of ``device`` at a precision tier: a
    (size, size) @ (size, size) product through the torch engine's own
    matmul closure (``solver.core._Matmul`` at ``matmul_dtype=dtype``
    and ``precision``, under its TF32 scope), so it reads the roof of the
    engine's products under each tier. The constant operand is prepared
    once, as the engine prepares its constants; the FLOPs counted are the
    2 size^3 useful ones, also for "high", which runs three products.
    The median of ``repeats`` slope-method samples (a minimum is biased
    fast by timing noise)."""
    from tpu_gpad_torch.solver.core import SolverConfig, _Matmul, tf32_matmuls

    device = _clock(device)
    mm = _Matmul(SolverConfig(matmul_dtype=dtype, precision=precision),
                 device=device)
    a = torch.ones((size, size), dtype=torch.float32, device=device)
    b = mm.prep(torch.ones((size, size), dtype=torch.float32, device=device))
    with tf32_matmuls(mm.tf32):
        stats = device_time_stats(lambda: mm(a, b), n=repeats, device=device)
    return float(2 * size**3 / stats["median_s"] / 1e12)


def wall_times(fn, warmup: int = 2, iters: int = 20) -> np.ndarray:
    """Host-observed seconds per call, the host's work around the device's
    included (what a client of a serving deployment observes): each call is
    timed to the synchronise of its output's device."""

    def call():
        out = fn()
        for t in _tensors(out):
            if t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
            break

    for _ in range(warmup):
        call()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        ts.append(time.perf_counter() - t0)
    return np.asarray(ts)
