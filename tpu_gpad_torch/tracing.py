"""Spans and a host-sync count inside the port, on the profiler's clock.

``span(name)`` marks a stretch of host work: the solve's entry
(``solve_batch`` and its route, affine maps, iteration, result and eps
tests), the controller's step (parameter, H2D copy, polish, the wait for
u*), and set-up (``condense``, ``dualize``, ``build``). Every name is
prefixed with ``tpu_gpad_torch.``.

Tracing is on exactly while a ``torch.profiler`` session records, outside
``torch.compile`` and ``torch.export`` tracing; there is no other switch.

- Off, ``span`` returns one shared no-op context manager: the cost is the
  profiler flag's check, with no clock read and no allocation.
- On, a span opens a record function of its name through torch's C++
  entry (``_RecordFunctionFast``: 0.4 us where the session records no
  host activity, against ``torch.profiler.record_function``'s 8), so it
  lands in a session that records the host as a ``cpu_op`` on the device
  trace's clock (the trace, exported with ``export_chrome_trace``, is the
  only export), and adds itself to an in-memory aggregate per name: count
  and host seconds in total.

``traced(name)`` wraps a whole function in a span.

``sync`` names the device (or a tensor on it) that the host waits on inside
the span: a pageable copy to or from a card, or a value read back from
one. Each span with a CUDA ``sync`` adds one to the aggregate's count of
host syncs. ``summary()`` reads the aggregate, ``reset()`` clears it.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

PREFIX = "tpu_gpad_torch."

_OFF = contextlib.nullcontext()  # torch.compile and torch.export trace it
_lock = threading.Lock()
_spans: dict[str, list] = {}  # name -> [count, total ns, syncs]


class _Span:
    """A recorded span: a profiler range and its share of the aggregate."""

    __slots__ = ("name", "sync", "_range", "_t0")

    def __init__(self, name: str, sync):
        self.name = PREFIX + name
        self.sync = sync

    def __enter__(self):
        self._range = _RecordFunctionFast(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        total = time.perf_counter_ns() - self._t0
        synced = _on_card(self.sync)
        with _lock:
            agg = _spans.setdefault(self.name, [0, 0, 0])
            agg[0] += 1
            agg[1] += total
            agg[2] += synced
        self._range.__exit__(*exc)
        return False


def _on_card(sync) -> bool:
    if isinstance(sync, torch.Tensor):
        sync = sync.device
    return isinstance(sync, torch.device) and sync.type == "cuda"


def span(name: str, sync=None):
    """A context manager around host work named ``tpu_gpad_torch.<name>``;
    ``sync``: the device, or a tensor on it, that the host waits on inside
    it (None where it waits on none)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return _OFF  # no profiler op in a traced graph
    return _Span(name, sync)


def traced(name: str):
    """A decorator: each call of the function runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def summary() -> dict:
    """``{name: {count, total_s, syncs}}`` of every span recorded since
    the last ``reset``, and ``syncs``, the host syncs of them all."""
    with _lock:
        out = {name: {"count": c, "total_s": t * 1e-9, "syncs": n}
               for name, (c, t, n) in _spans.items()}
    out["syncs"] = sum(v["syncs"] for v in out.values())
    return out


def reset() -> None:
    """Clear the aggregate."""
    with _lock:
        _spans.clear()
