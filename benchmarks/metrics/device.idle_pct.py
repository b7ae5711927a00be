"""Share (%) of the traced stretch in which no operation ran on the card."""


def read(r):
    if r.lane is None or r.lane.window_us <= 0:
        return None
    return 100.0 * (1.0 - r.lane.busy_us() / r.lane.window_us)
