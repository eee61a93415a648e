"""The profiled sub-windows of a traced run and their reduction to numbers.

``Tracer.tick`` is called once a unit (a call or a step) from a driver's
loop. With tracing on it runs ``torch.profiler`` twice inside the window,
the card drained before and after each:

- the metrics window, from 30% of the window for up to 1 s, traces the
  device alone (the host's operations unrecorded): a marker
  operation opens and closes it on the device's clock; the union of
  device operations between them is the busy time, and the units
  dispatched inside it divide it;
- the breakdown window, from 60% for up to 0.5 s, traces the host too,
  inside one host span (``gpad_bench.traced_window``), to label each idle
  gap by the innermost host operation running at its midpoint.

Each trace is exported when its window closes (inside the measured
window, which only a traced run's unit count feels); ``reduce`` reads an
exported Chrome trace.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

WINDOW_SPAN = "gpad_bench.traced_window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation"}
TOP = 10


class _Window:
    """One profiled sub-window: [start_s, start_s + length_s) of the
    measured window, with or without the host's operations."""

    def __init__(self, start_s: float, length_s: float, host: bool):
        self.start_s, self.length_s, self.host = start_s, length_s, host
        self.state = "before"
        self.units = 0
        self.host_s = 0.0
        self.result = None
        self._prof = self._span = self._marker = None
        self._t0 = 0.0

    def start(self, device) -> None:
        import torch

        torch.cuda.synchronize(device)
        self._prof = torch.profiler.profile(activities=_activities(self.host))
        self._prof.start()
        if self.host:
            self._span = torch.profiler.record_function(WINDOW_SPAN)
            self._span.__enter__()
        else:
            self._marker = torch.zeros(1, device=device)
            self._marker.add_(1.0)  # opens the window on the device's clock
        self._t0 = time.perf_counter()
        self.state = "on"

    def stop(self, device) -> None:
        import torch

        torch.cuda.synchronize(device)
        self.host_s = time.perf_counter() - self._t0
        if self.host:
            self._span.__exit__(None, None, None)
        else:
            self._marker.add_(1.0)  # closes it
            torch.cuda.synchronize(device)
        self._prof.stop()
        self.state = "after"
        # read now: a later profiler session clears this one's events
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        self._prof = None
        self.result = reduce(events, span=self.host)
        self.result["units"] = self.units


class Tracer:
    """The metrics and breakdown windows of a traced run, or nothing
    (``on=False``)."""

    def __init__(self, on: bool, seconds: float, device):
        self.on = on and device.type == "cuda"
        self.device = device
        self.windows = [_Window(0.3 * seconds, min(1.0, 0.2 * seconds), False),
                        _Window(0.6 * seconds, min(0.5, 0.1 * seconds), True)]

    def warm_up(self) -> None:
        """A tiny profile of each kind in set-up, so that the profiler's
        first start (CUPTI's initialisation) falls outside the window."""
        if not self.on:
            return
        import torch

        for host in (False, True):
            with torch.profiler.profile(activities=_activities(host)):
                torch.ones(1, device=self.device).add_(1)
                torch.cuda.synchronize(self.device)

    def inside(self) -> bool:
        return any(w.state == "on" for w in self.windows)

    def tick(self, elapsed: float) -> None:
        """Before each unit: start or stop a window by the measured
        window's elapsed seconds; count the units dispatched inside."""
        if not self.on:
            return
        for w in self.windows:
            if w.state == "before" and elapsed >= w.start_s and not self.inside():
                w.start(self.device)
            elif w.state == "on" and elapsed >= w.start_s + w.length_s:
                w.stop(self.device)
            if w.state == "on":
                w.units += 1

    def stop(self) -> None:
        """After the measured window: close a window it ended inside."""
        for w in self.windows:
            if w.state == "on":
                w.stop(self.device)

    @property
    def result(self) -> dict | None:
        """busy_s, window_s, units and device_ops of the metrics window,
        idle_gaps of the breakdown window; None unless both closed."""
        metrics, labels = (w.result for w in self.windows)
        if metrics is None or labels is None:
            return None
        return {**metrics, "idle_gaps": labels["idle_gaps"],
                "host_s": self.windows[0].host_s}


def _activities(host: bool):
    from torch.profiler import ProfilerActivity

    return ([ProfilerActivity.CPU] if host else []) + [ProfilerActivity.CUDA]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(events: list, span: bool = True) -> dict:
    """busy_s, window_s, device_ops and idle_gaps of one traced window from
    its Chrome trace events (microsecond timestamps). The window is the
    host span ``WINDOW_SPAN`` (``span``), or else the first device
    operation's start to the last one's end (the markers)."""
    dev_events, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "").lower()
        s = float(e["ts"])
        t = s + float(e["dur"])
        if cat in DEVICE_CATS:
            dev_events.append((s, t, e.get("name", "?")[:160]))
        elif cat in HOST_CATS:
            host.append((s, t, e.get("name", "?")[:160]))
    if span:
        marks = [h for h in host if h[2] == WINDOW_SPAN]
        if not marks:
            raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
        w0, w1 = marks[0][0], marks[0][1]
        host = [h for h in host if h[2] != WINDOW_SPAN]
    else:
        if not dev_events:
            raise RuntimeError("the trace has no device operation")
        w0 = min(s for s, _, _ in dev_events)
        w1 = max(t for _, t, _ in dev_events)
    dev = []
    by_name = defaultdict(float)
    for s, t, name in dev_events:
        s, t = max(s, w0), min(t, w1)
        if t > s:
            dev.append((s, t))
            by_name[name] += (t - s) * 1e-6
    busy = _union(dev)
    host.sort()
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    edge = w0
    for s, t in busy + [[w1, w1]]:
        if s > edge:
            gaps[_host_at(host, starts, 0.5 * (edge + s))] += (s - edge) * 1e-6
        edge = max(edge, t)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": sum(t - s for s, t in busy) * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": [[k, v] for k, v in top],
        "idle_gaps": [[k, v] for k, v in idle],
    }


def _host_at(host, starts, t: float, reach: int = 256) -> str:
    """The innermost host operation running at ``t``: the latest-starting
    one that contains it (children start after their parents)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "host outside any operation"
