"""Device µs a frame of the unpacks (``unpack``; the tile path's
``unpack_core``), from the traced stretch."""

KERNELS = ("unpack_kernel", "unpack_core_kernel")


def read(r):
    if r.lane is None:
        return None
    us = r.lane.us_of(*KERNELS)
    return None if us is None else us / r.lane.frames
