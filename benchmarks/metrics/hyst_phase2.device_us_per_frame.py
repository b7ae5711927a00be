"""Device µs a frame of the phase-2 round kernel (dilations and the
8-direction scans up to the round cap), from the traced stretch."""

KERNEL = "hyst_kernel<true"


def read(r):
    if r.lane is None:
        return None
    us = r.lane.us_of(KERNEL)
    return None if us is None else us / r.lane.frames
