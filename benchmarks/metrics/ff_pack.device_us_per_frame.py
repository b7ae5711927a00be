"""Device µs a frame of the ingest, chain and pack kernel (``ff_pack``, and
its tile export mode), from the traced stretch."""

KERNEL = "ff_pack_kernel"


def read(r):
    if r.lane is None:
        return None
    us = r.lane.us_of(KERNEL)
    return None if us is None else us / r.lane.frames
