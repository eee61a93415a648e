"""Median host milliseconds inside one unsynced ``solve_batch`` call: the
solver's entry, routing and launches on the host, timed by the harness
around every call of the window outside the profiled sub-window."""

import statistics


def read(r: dict):
    host = r.get("host_s_per_call")
    return 1e3 * statistics.median(host) if host else None
