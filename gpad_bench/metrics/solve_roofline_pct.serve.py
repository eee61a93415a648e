"""The solve's share of its roofline, in percent: the least time the card
could take for one step's work (``work.call_work``, the same whatever
route or kernel runs it) over the device-busy time per step in the
profiled sub-window."""


def read(r: dict):
    t = r.get("trace")
    if not t or not t["units"] or t["busy_s"] <= 0:
        return None
    return 100.0 * r["bound_s_per_unit"] / (t["busy_s"] / t["units"])
