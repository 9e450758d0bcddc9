"""exprs_per_s: expressions scored in the window over its seconds."""


def read(rec):
    n = rec.get("exprs")
    return n / rec["window_s"] if n else None
