"""idle_share.rebuild: percent of one traced rebuild's window in which no
operation ran on the device (100 minus the union of their intervals)."""


def read(rec):
    t = rec.get("rebuild_trace")
    if t is None or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
