"""The share of the profiled sub-window, in percent, in which no operation
ran on the device (the steps' gaps on the card)."""


def read(r: dict):
    t = r.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
