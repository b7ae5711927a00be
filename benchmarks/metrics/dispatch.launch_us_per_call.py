"""Host µs a call spent in the CUDA runtime's launch calls
(``cudaLaunchKernel``, ``cudaLaunchCooperativeKernel``, ...), from the
profiler's runtime records inside the traced stretch's ``bench.call``
spans: their summed length over those spans. None without a device lane or
where no launch record lies inside a call."""

import bisect

from benchmarks import devtrace

PREFIX = "cudaLaunch"


def read(r):
    if r.lane is None:
        return None
    calls = sorted((h for h in r.lane.host if h.name == devtrace.CALL_SPAN),
                   key=lambda h: h.start_us)
    starts = [h.start_us for h in calls]
    us = 0.0
    found = False
    for h in r.lane.host:
        if not h.name.startswith(PREFIX):
            continue
        i = bisect.bisect_right(starts, h.start_us) - 1
        if i >= 0 and h.end_us <= calls[i].end_us:
            us += h.us
            found = True
    return us / len(calls) if found else None
