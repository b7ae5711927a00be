"""Share (%) of its bound that the ingest, chain and pack kernel reaches:
the least time of a frame's work (the BGR frame read once, the two packed
planes written once; the stencil chain's operations), whatever tiling the
kernel takes, over its device time a frame in the traced stretch."""

from benchmarks import roofline

KERNEL = "ff_pack_kernel"


def read(r):
    if r.lane is None:
        return None
    us = r.lane.us_of(KERNEL)
    if us is None:
        return None
    c = r.canny
    bound, _ = roofline.bound_s(*roofline.ff_pack_work(c["height"], c["width"], c["channels"],
                                                       c["kernel_size"]))
    return 100.0 * bound * 1e6 / (us / r.lane.frames)
