"""Host µs a call of the launch wrappers' preparation, from the program's
``cc.prep.<launch name>`` spans (each wrapper from its entry to just
before its C entry: the checks, the scratch and output allocations, the
pointers and the stream) in the traced stretch: the spans' summed length
over the stretch's calls (its ``bench.call`` spans). The profiler's own
cost is in it. None without a device lane or where the program has no such
spans."""

from benchmarks import devtrace

PREFIX = "cc.prep."


def read(r):
    if r.lane is None:
        return None
    calls = sum(h.name == devtrace.CALL_SPAN for h in r.lane.host)
    us = [h.us for h in r.lane.host if h.name.startswith(PREFIX)]
    return sum(us) / calls if us and calls else None
