"""rebuild_s: the window's seconds over the rebuilds completed in it."""


def read(rec):
    n = rec.get("rebuilds")
    return rec["window_s"] / n if n else None
