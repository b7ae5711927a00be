"""Device µs a frame of the phase-1 round kernel (dilation rounds up to
``scan_after``), from the traced stretch."""

KERNEL = "hyst_kernel<false"


def read(r):
    if r.lane is None:
        return None
    us = r.lane.us_of(KERNEL)
    return None if us is None else us / r.lane.frames
