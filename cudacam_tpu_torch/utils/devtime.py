"""Device time per call: the port of ``cudacam_tpu/utils/devtime.py``.

PyTorch returns from a launch before the device has finished, so a host
clock around an asynchronous call times the enqueue. Two honest clocks:

* :func:`event_time_ms_per_call`: CUDA events on the current stream around
  ``calls`` invocations (the reference's own ``cudaEventRecord`` timers,
  cannyEdgeH.cu:409-430): the stream's time from the first launch to the
  last kernel's end, idle gaps between kernels included;
* :func:`device_time_ms_per_call`: the kernels' own busy time under
  ``torch.profiler``, summed over every kernel the call launches, idle gaps
  excluded: the 'device' profiling mode's source.

On the CPU there is no device lane: both return ``None``, and the caller
uses the wall clock, which is honest there.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch


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


def device_time_ms_per_call(
    fn: Callable[[], object],
    calls: int = 4,
    device: Union[str, torch.device, None] = None,
) -> Optional[float]:
    """Device busy ms per invocation of ``fn`` (already warm), from
    ``torch.profiler``: the self device time of every kernel and copy the
    calls ran, over ``calls``. None when the trace shows no device time (the
    CPU, or a host whose profiler cannot see the card): time with
    :func:`event_time_ms_per_call` then."""
    dev = _cuda(device)
    if dev is None:
        return None
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(dev)
    total_us = 0.0
    for ev in prof.key_averages():
        total_us += float(getattr(ev, "self_device_time_total", 0.0)
                          or getattr(ev, "self_cuda_time_total", 0.0) or 0.0)
    if total_us <= 0.0:
        return None
    return total_us / calls / 1e3
