"""Host syncs a ``Controller.step``: the program's count of spans in which
the host waited on the card (``tpu_gpad_torch.tracing``'s ``syncs``), over
the steps of the profiled sub-windows."""

from gpad_bench import spans


def read(r: dict):
    s = spans.read(r, "step")
    if s is None:
        return None
    return s["syncs"] / s[spans.PREFIX + "step"]["count"]
