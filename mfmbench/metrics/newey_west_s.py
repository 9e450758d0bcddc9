"""newey_west_s: seconds of the benchmark's span around the newey_west stage's
public method, ended by a synchronize (mean of repeats)."""


def read(rec):
    return rec.get("spans", {}).get("newey_west")
