"""alpha_score_ms: milliseconds per expression of the span around
``alpha_summary(alphas, fwd)``, ended by a synchronize."""


def read(rec):
    s = rec.get("spans", {}).get("alpha_score")
    return None if s is None else 1e3 * s
