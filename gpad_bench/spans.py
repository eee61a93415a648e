"""The program's own spans, for the readers of the metrics that rest on them.

``tpu_gpad_torch.tracing`` aggregates every span recorded while a
profiler records: in a traced run, exactly the two profiled sub-windows
(set-up and the reference's check run no span of the program under a
profiler). A program without the facility, or a run without a trace,
reads as nothing.
"""

PREFIX = "tpu_gpad_torch."


def read(r: dict, *names):
    """The aggregate (``tracing.summary()``) of a traced run's readings
    ``r`` where each span of ``names`` counted above 0, else None."""
    if not r.get("trace"):
        return None
    try:
        from tpu_gpad_torch import tracing
    except ImportError:  # a program without spans
        return None
    summary = tracing.summary()
    if any(summary.get(PREFIX + n, {}).get("count", 0) <= 0 for n in names):
        return None
    return summary
