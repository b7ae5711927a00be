"""Frame-rate metering: the port's copy of ``cudacam_tpu/io/metrics.py``.

Mirrors the reference UI's FPS meter: a rolling average of frame times that
resets its accumulation window every 10 seconds so the reading tracks the
current rate rather than the whole run (reference imguiApp.cpp:267-283).
"""
from __future__ import annotations

import time
from typing import Optional


class FpsMeter:
    def __init__(self, window_s: float = 10.0) -> None:
        self._window = window_s
        self._t0: Optional[float] = None
        self._last: Optional[float] = None
        self._frames = 0
        self._total_frames = 0
        self._start: Optional[float] = None

    def tick(self, now: Optional[float] = None) -> None:
        """Record one frame boundary."""
        now = time.perf_counter() if now is None else now
        if self._start is None:
            self._start = now
        if self._t0 is None or (now - self._t0) > self._window:
            # Rolling reset (imguiApp.cpp:276-280).
            self._t0 = now
            self._frames = 0
        self._frames += 1
        self._total_frames += 1
        self._last = now

    @property
    def fps(self) -> float:
        """Current-window frames per second."""
        if self._t0 is None or self._last is None or self._last <= self._t0:
            return 0.0
        return (self._frames - 1) / (self._last - self._t0) if self._frames > 1 else 0.0

    @property
    def ms_per_frame(self) -> float:
        f = self.fps
        return 1000.0 / f if f > 0 else 0.0

    @property
    def total_frames(self) -> int:
        return self._total_frames

    @property
    def elapsed_s(self) -> float:
        if self._start is None or self._last is None:
            return 0.0
        return self._last - self._start
