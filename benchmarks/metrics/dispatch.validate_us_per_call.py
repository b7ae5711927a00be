"""Host µs a call of the engine's checks, from the program's ``cc.validate``
span (the spec lock, the dtype checks, the cached thresholds; on the tile
path also the host part of the shard) in the traced stretch: the spans'
summed length over the stretch's calls (its ``bench.call`` spans). The
profiler's own cost is in it. None without a device lane or where the
program has no such span."""

from benchmarks import devtrace

SPAN = "cc.validate"


def read(r):
    if r.lane is None:
        return None
    calls = sum(h.name == devtrace.CALL_SPAN for h in r.lane.host)
    us = [h.us for h in r.lane.host if h.name == SPAN]
    return sum(us) / calls if us and calls else None
