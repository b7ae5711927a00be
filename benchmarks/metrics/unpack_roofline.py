"""Share (%) of its bound that the unpacks reach: the least time of a
frame's unpack (the packed FINAL plane read once, the uint8 edge map
written once) over their device time a frame in the traced stretch."""

from benchmarks import roofline

KERNELS = ("unpack_kernel", "unpack_core_kernel")


def read(r):
    if r.lane is None:
        return None
    us = r.lane.us_of(*KERNELS)
    if us is None:
        return None
    bound, _ = roofline.bound_s(*roofline.unpack_work(r.canny["height"], r.canny["width"]))
    return 100.0 * bound * 1e6 / (us / r.lane.frames)
