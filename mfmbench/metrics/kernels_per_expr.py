"""kernels_per_expr: device kernels in the trace of one scoring request,
over its expressions."""


def read(rec):
    t = rec.get("alpha_trace")
    return None if t is None or not t["kernels"] else t["kernels"] / t["exprs"]
