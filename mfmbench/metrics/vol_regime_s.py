"""vol_regime_s: seconds of the benchmark's span around the vol_regime stage's
public method, ended by a synchronize (mean of repeats)."""


def read(rec):
    return rec.get("spans", {}).get("vol_regime")
