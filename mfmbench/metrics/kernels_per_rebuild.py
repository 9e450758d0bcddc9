"""kernels_per_rebuild: device kernels in the trace of one rebuild."""


def read(rec):
    t = rec.get("rebuild_trace")
    return None if t is None or not t["kernels"] else t["kernels"]
