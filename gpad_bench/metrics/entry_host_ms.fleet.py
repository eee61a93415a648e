"""Host milliseconds inside one ``solve_batch`` call by the program's own
span (``tpu_gpad_torch.solve_batch``: its checks, affine maps, routing,
launch and result), over the calls of the profiled sub-windows: the inside
counterpart of ``host_ms_per_call.fleet``, profiler cost included."""

from gpad_bench import spans


def read(r: dict):
    s = spans.read(r, "solve_batch")
    if s is None:
        return None
    call = s[spans.PREFIX + "solve_batch"]
    return 1e3 * call["total_s"] / call["count"]
