"""Device time per call: the port of ``cudacam_tpu/utils/devtime.py``.

PyTorch returns from a launch before the device has finished, so a host
clock around an asynchronous call times the enqueue. Two honest clocks:

* :func:`event_time_ms_per_call`: CUDA events on the current stream around
  ``calls`` invocations (the reference's own ``cudaEventRecord`` timers,
  cannyEdgeH.cu:409-430): the stream's time from the first launch to the
  last kernel's end, idle gaps between kernels included;
* :func:`device_time_ms_per_call`: the kernels' own busy time under
  ``torch.profiler``, summed over every kernel the call launches, idle gaps
  excluded: the 'device' profiling mode's source. A session opens with
  throwaway launches whose records the profiler may drop, and counts only
  when its trace is whole (every device entry a multiple of the calls, none
  from before the session); another session is tried when it is not.

On the CPU there is no device lane: both return ``None``, and the caller
uses the wall clock, which is honest there.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Optional, Union

import torch

from cudacam_tpu_torch.utils.logging import get_logger

log = get_logger("devtime")


def _cuda(device: Union[str, torch.device, None]) -> Optional[torch.device]:
    """``device`` as a CUDA device, or None when it is the CPU (or when no
    device is given and there is no card)."""
    if device is None:
        return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else None
    dev = torch.device(device)
    return dev if dev.type == "cuda" else None


def event_time_ms_per_call(
    fn: Callable[[], object],
    calls: int = 4,
    device: Union[str, torch.device, None] = None,
) -> Optional[float]:
    """CUDA-event ms per invocation of ``fn`` on ``device``'s current
    stream, after one untimed call. None on the CPU."""
    dev = _cuda(device)
    if dev is None:
        return None
    fn()
    stream = torch.cuda.current_stream(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record(stream)
    for _ in range(calls):
        fn()
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) / calls


#: Profiler sessions :func:`device_time_ms_per_call` refused in this
#: process: traces that were not whole, or showed no device time.
refused_sessions = 0

#: Throwaway launches (``torch.cuda._sleep``, kernel ``spin_kernel``) that
#: open a session, one count a try. On the card's torch 2.11 the profiler
#: drops the first kernel records of a session, more of them the longer
#: the process has run after its first session (ROADMAP Queue 3, F8): the
#: throwaway records are dropped in their place.
SENTINELS = (64, 1024, 16384)
SENTINEL_KERNEL = "spin_kernel"


def open_session(device: Union[str, torch.device, None] = None,
                 sentinels: int = SENTINELS[0]) -> None:
    """Open a profiler session on ``device`` with ``sentinels`` throwaway
    launches (:data:`SENTINEL_KERNEL`) and a synchronize: the records the
    profiler drops at a session's start are theirs. Every ``torch.profiler``
    session of the port that traces the card opens so."""
    dev = _cuda(device)
    with torch.cuda.device(dev):
        for _ in range(sentinels):
            torch.cuda._sleep(1)
    torch.cuda.synchronize(dev)


def session_lane(events, calls: int):
    """The device lane of one profiler session's ``events``
    (``prof.events()``) that ran ``calls`` identical calls: (the device
    events, whether the lane is whole). Host entries are left out (on the
    card's torch a host op's entry repeats its kernels' device time), so are
    the sentinels (:data:`SENTINELS`) and device events that start before
    the session's first host event (earlier work). The lane is whole when
    it holds a device event and every device entry's count is a multiple of
    ``calls``: a session that lost records, or carried some over, is not."""
    cpu = torch.autograd.DeviceType.CPU
    host0 = min((e.time_range.start for e in events if e.device_type == cpu), default=None)
    lane = [e for e in events
            if e.device_type != cpu and SENTINEL_KERNEL not in e.name
            and (host0 is None or e.time_range.start >= host0)]
    counts = Counter(e.name for e in lane)
    return lane, bool(lane) and all(n % calls == 0 for n in counts.values())


def whole_session_us(events, calls: int) -> Optional[float]:
    """Device µs of one profiler session's ``events`` that ran ``calls``
    identical calls (:func:`session_lane`), None when its lane is not
    whole."""
    lane, whole = session_lane(events, calls)
    return sum(e.time_range.elapsed_us() for e in lane) if whole else None


def device_time_ms_per_call(
    fn: Callable[[], object],
    calls: int = 4,
    device: Union[str, torch.device, None] = None,
) -> Optional[float]:
    """Device busy ms per invocation of ``fn`` (already warm), from
    ``torch.profiler``: the device time of every kernel and copy the calls
    ran, over ``calls``, from the first of up to three sessions whose trace
    is whole (:func:`whole_session_us`), each opened by more sentinels
    (:data:`SENTINELS`). None when no trace is whole or shows device time
    (the CPU, or a host whose profiler cannot see the card): time with
    :func:`event_time_ms_per_call` then."""
    global refused_sessions
    dev = _cuda(device)
    if dev is None:
        return None
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    for sentinels in SENTINELS:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            open_session(dev, sentinels)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize(dev)
        events = prof.events()
        total_us = whole_session_us(events, calls)
        if total_us is not None:
            return total_us / calls / 1e3
        refused_sessions += 1
        lane = Counter(e.name[:40] for e in events if e.device_type != torch.autograd.DeviceType.CPU)
        log.warning("profiler trace not whole over %d calls, session refused: device entries %s",
                    calls, dict(lane))
    return None
