"""eigen_roofline: the eigen stage's least time over its device time, in
percent.  The least time is :func:`mfmbench.roofline.eigen_stage_bound` of
the configuration's shapes and fixed sweep count; the device time is the
summed duration of the operations traced in one call of the stage."""

from mfmbench import roofline


def read(rec):
    dev = rec.get("eigen_device_s")
    shape = rec.get("roofline_shape")
    if not dev or shape is None:
        return None
    bound = roofline.eigen_stage_bound(shape["T"], shape["M"], shape["K"],
                                       shape["sweeps"]["weighted"])
    return 100.0 * bound["least_s"] / dev
