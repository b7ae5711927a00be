"""Mean host time of a call's enqueue over the window: the host clock
around each ``process`` call, with no synchronisation inside it."""


def read(r):
    return sum(r.host_us) / len(r.host_us) if r.host_us else None
