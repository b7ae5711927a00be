"""Named-timer aggregation: the port's copy of ``cudacam_tpu/utils/timer.py``.

Analog of the reference's ``timerManager`` singleton (src/utils/timer.hpp:6-67):
a map name -> {total_time, count} with create/add/average, consumed by the
profiling table UI (imguiApp.cpp:345-386). Improvements over the reference:
instances instead of a hard singleton (a default shared instance is provided),
a ``reset`` (the reference accumulates forever), min/max tracking, and a
renderable text table.
"""
from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, Tuple


@dataclass
class _TimerSlot:
    total_ms: float = 0.0
    count: int = 0
    min_ms: float = math.inf
    max_ms: float = 0.0

    def add(self, elapsed_ms: float) -> None:
        self.total_ms += elapsed_ms
        self.count += 1
        self.min_ms = min(self.min_ms, elapsed_ms)
        self.max_ms = max(self.max_ms, elapsed_ms)

    @property
    def average_ms(self) -> float:
        return self.total_ms / self.count if self.count else 0.0


class TimerManager:
    """Thread-safe named timer aggregation (reference: timer.hpp:13-67)."""

    _default: Optional["TimerManager"] = None
    _default_lock = threading.Lock()

    def __init__(self) -> None:
        self._slots: Dict[str, _TimerSlot] = {}
        self._lock = threading.Lock()

    @classmethod
    def get(cls) -> "TimerManager":
        """Shared default instance (reference: timerManager::Get, timer.hpp:13)."""
        with cls._default_lock:
            if cls._default is None:
                cls._default = cls()
            return cls._default

    def create_timer(self, name: str) -> None:
        with self._lock:
            self._slots.setdefault(name, _TimerSlot())

    def add_time(self, name: str, elapsed_ms: float) -> None:
        with self._lock:
            self._slots.setdefault(name, _TimerSlot()).add(elapsed_ms)

    def get_average_time(self, name: str) -> float:
        with self._lock:
            slot = self._slots.get(name)
            return slot.average_ms if slot else 0.0

    def get_count(self, name: str) -> int:
        with self._lock:
            slot = self._slots.get(name)
            return slot.count if slot else 0

    def reset(self, name: Optional[str] = None) -> None:
        with self._lock:
            if name is None:
                self._slots.clear()
            else:
                self._slots.pop(name, None)

    def items(self) -> Iterator[Tuple[str, float, int]]:
        with self._lock:
            snap = [(k, v.average_ms, v.count) for k, v in self._slots.items()]
        return iter(snap)

    def table(self) -> str:
        """Render the profiling table (analog of imguiApp.cpp:353-386),
        including the total row the UI computes."""
        rows = sorted(self.items())
        if not rows:
            return "(no timers)"
        width = max(len(n) for n, _, _ in rows)
        lines = [f"{'stage':<{width}}  {'avg ms':>10}  {'count':>7}"]
        total = 0.0
        for name, avg, count in rows:
            lines.append(f"{name:<{width}}  {avg:>10.4f}  {count:>7}")
            total += avg
        lines.append(f"{'TOTAL':<{width}}  {total:>10.4f}")
        return "\n".join(lines)

    def time(self, name: str) -> "_TimerContext":
        """Context manager measuring wall time into this manager."""
        return _TimerContext(self, name)


class _TimerContext:
    def __init__(self, manager: TimerManager, name: str) -> None:
        self._manager = manager
        self._name = name
        self._start = 0.0

    def __enter__(self) -> "_TimerContext":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        elapsed_ms = (time.perf_counter() - self._start) * 1e3
        self._manager.add_time(self._name, elapsed_ms)
