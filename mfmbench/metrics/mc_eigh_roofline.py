"""mc_eigh_roofline: the eigen Monte-Carlo's weighted-eigh kernel's least
time over its device time, in percent.

The least time is ``eigen_roofline``'s, :func:`mfmbench.roofline.
eigen_stage_bound` of the configuration's shapes and fixed weighted sweep
count: the model's own work at K (not at a padded n), so any padding or
design of the kernel is read against the same count.  The device time is
the traced rebuild's time in the operations whose names hold
``weighted_kernel``, in either design.  ``eigen_roofline`` divides by the
whole eigen call's device time instead; this share leaves out the rest of
the stage (G's build, the sorts, the rebuild of the covariances).

The trace keeps its ten largest operation names (``tracing.device_trace``),
each a name's summed time over all its launches.  The weighted kernel is
among them in every rebuild cell; were it ever to leave the ten, the share
is left out, not undercounted."""

from mfmbench import roofline


def read(rec):
    trace = rec.get("rebuild_trace")
    shape = rec.get("roofline_shape")
    if trace is None or shape is None:
        return None
    dev = sum(s for name, s in trace["device_ops"]
              if "weighted_kernel" in name)
    if not dev:
        return None
    bound = roofline.eigen_stage_bound(shape["T"], shape["M"], shape["K"],
                                       shape["sweeps"]["weighted"])
    return 100.0 * bound["least_s"] / dev
