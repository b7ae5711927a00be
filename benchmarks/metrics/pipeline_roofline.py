"""Share (%) of the chip's peak that a whole call reaches: the least time
of what a frame cannot do without (the frame read once, the edge map
written once, the stencil chain's operations) over the device's busy time
a frame in the traced stretch. It bounds every kernel's gain from above;
hysteresis rounds are not counted, since their number is not observed."""

from benchmarks import roofline


def read(r):
    if r.lane is None:
        return None
    c = r.canny
    bound, _ = roofline.bound_s(*roofline.pipeline_work(c["height"], c["width"], c["channels"],
                                                        c["kernel_size"]))
    return 100.0 * bound * 1e6 / (r.lane.busy_us() / r.lane.frames)
