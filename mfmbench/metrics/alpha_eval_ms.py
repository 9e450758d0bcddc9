"""alpha_eval_ms: milliseconds per expression of the span around
``compile_alpha_batch(exprs, chunk)(panel)``, ended by a synchronize."""


def read(rec):
    s = rec.get("spans", {}).get("alpha_eval")
    return None if s is None else 1e3 * s
