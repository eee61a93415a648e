"""Device time of a call, taken with CUDA events.

PyTorch returns before the device finishes, so a host clock without a
synchronise measures only the enqueue. Here each call is bracketed by two
events recorded on the current stream and read after one synchronise.
"""

from __future__ import annotations

import statistics

import torch


def device_time_per_call(fn, warmup: int = 3, repeats: int = 20) -> float:
    """Median device time of ``fn()`` in seconds over ``repeats`` calls.

    ``warmup`` calls run first, outside the timed window (the first call
    builds and loads the kernels). Raises when no CUDA device is present:
    a measurement never falls back to the host clock."""
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
