"""regression_s: seconds of the benchmark's span around the regression stage's
public method, ended by a synchronize (mean of repeats)."""


def read(rec):
    return rec.get("spans", {}).get("regression")
