"""Device µs a frame of the one-card collective round loop (the local
saturate and the strip refresh of every tile, in one launch), from the
traced stretch."""

KERNEL = "sharded_loop_kernel"


def read(r):
    if r.lane is None:
        return None
    us = r.lane.us_of(KERNEL)
    return None if us is None else us / r.lane.frames
