"""setup_s: process start to the first timed request (host clock)."""


def read(rec):
    return rec.get("setup_s")
