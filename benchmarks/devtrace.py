"""Reading a torch.profiler session of the card: which records count, and
what the device lane says.

The session arithmetic is a frozen copy of the system's own (the sentinel
launches that open a session, and the rule that a session counts only when
it is whole), kept here so that the yardstick does not move with the
program. On the card's torch the profiler drops the first kernel records of
a session, more of them the longer the process has run: every session opens
with throwaway ``torch.cuda._sleep`` launches (kernel ``spin_kernel``),
whose records are dropped in place of the run's, and a session is used only
when every device entry's count is a multiple of the calls it ran.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

import torch

#: Sentinel launches of successive tries of a session.
SENTINELS = (64, 1024, 16384)
SENTINEL_KERNEL = "spin_kernel"
#: The host span the harness puts around the traced stretch, and the spans
#: around each call and each wait for a call in flight.
STRETCH_SPAN = "bench.traced_stretch"
CALL_SPAN = "bench.call"
WAIT_SPAN = "bench.wait_in_flight"
#: The spans' own entries on the device lane (user annotations), which are
#: no device work.
SPANS = (STRETCH_SPAN, CALL_SPAN, WAIT_SPAN)


def open_session(device: torch.device, sentinels: int) -> None:
    """Launch ``sentinels`` throwaway kernels and synchronize."""
    with torch.cuda.device(device):
        for _ in range(sentinels):
            torch.cuda._sleep(1)
    torch.cuda.synchronize(device)


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    start_us: float
    end_us: float

    @property
    def us(self) -> float:
        return self.end_us - self.start_us


@dataclasses.dataclass
class Lane:
    """The device lane of a whole session, and the host spans beside it."""

    ops: List[Op]  # device operations in the stretch, by start
    host: List[Op]  # host events, by start
    window_us: float  # the traced stretch's length
    frames: int  # frames the traced calls carried

    def busy_us(self) -> float:
        """Device time in which an operation ran (the union of the ops)."""
        busy, end = 0.0, float("-inf")
        for op in self.ops:
            s, e = max(op.start_us, end), op.end_us
            if e > s:
                busy += e - s
            end = max(end, e)
        return busy

    def us_of(self, *patterns: str) -> Optional[float]:
        """Device µs of the ops whose name holds one of ``patterns``; None
        when no op does."""
        hit = [op.us for op in self.ops if any(p in op.name for p in patterns)]
        return sum(hit) if hit else None

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        total: Dict[str, float] = defaultdict(float)
        for op in self.ops:
            total[op.name] += op.us
        return [[k, v / 1e6] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle stretches of the device inside the window: (start, end) µs."""
        out, end = [], self.ops[0].start_us if self.ops else 0.0
        for op in self.ops:
            if op.start_us > end:
                out.append((end, op.start_us))
            end = max(end, op.end_us)
        return out

    def top_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """The ``n`` longest idle gaps, each named by the innermost host span
        running at its middle."""
        starts = [h.start_us for h in self.host]
        named = []
        for s, e in sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]:
            mid = (s + e) / 2
            i = bisect.bisect_right(starts, mid)
            inner = [h for h in self.host[:i] if h.end_us >= mid]
            name = min(inner, key=lambda h: h.us).name if inner else "(no host span)"
            named.append([name, (e - s) / 1e6])
        return named


def read_lane(events, calls: int, frames: int) -> Tuple[Optional[Lane], str]:
    """The lane of one session's ``events`` (``prof.events()``) that ran
    ``calls`` calls of ``frames`` frames in the stretch span: (lane, "")
    when whole, (None, why) when not. Device entries before the stretch,
    and the sentinels, are left out."""
    cpu = torch.autograd.DeviceType.CPU
    stretch = [e for e in events if e.device_type == cpu and e.name == STRETCH_SPAN]
    if len(stretch) != 1:
        return None, f"{len(stretch)} stretch spans"
    t0, t1 = stretch[0].time_range.start, stretch[0].time_range.end
    ops = sorted((Op(e.name, e.time_range.start, e.time_range.end) for e in events
                  if e.device_type != cpu and SENTINEL_KERNEL not in e.name
                  and e.name not in SPANS and e.time_range.start >= t0),
                 key=lambda o: o.start_us)
    counts = Counter(op.name for op in ops)
    if not ops or any(n % calls for n in counts.values()):
        return None, f"device entries {dict(counts)} over {calls} calls"
    host = sorted((Op(e.name, e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == cpu and e.time_range.start >= t0
                   and e.name != STRETCH_SPAN), key=lambda o: o.start_us)
    end = max(t1, ops[-1].end_us)
    return Lane(ops, host, end - t0, frames), ""
