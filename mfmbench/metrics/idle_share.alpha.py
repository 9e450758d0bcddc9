"""idle_share.alpha: percent of one traced scoring request's window in
which no operation ran on the device."""


def read(rec):
    t = rec.get("alpha_trace")
    if t is None or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
