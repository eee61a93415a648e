"""Host milliseconds of one ``Controller.step`` outside its wait for u*:
the program's ``tpu_gpad_torch.step`` spans less its ``step.wait`` spans
(the copy of u* back, which waits on the card), over the steps of the
profiled sub-windows."""

from gpad_bench import spans


def read(r: dict):
    s = spans.read(r, "step", "step.wait")
    if s is None:
        return None
    step, wait = s[spans.PREFIX + "step"], s[spans.PREFIX + "step.wait"]
    return 1e3 * (step["total_s"] - wait["total_s"]) / step["count"]
