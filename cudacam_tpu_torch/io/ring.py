"""Device-resident output ring buffer — the PBO analog: the port of
``cudacam_tpu/io/ring.py``.

The reference keeps display frames on the GPU via a CUDA-GL interop pixel
buffer object, so display never crosses back to the host (reference
cannyEdgeH.cu:166-209; imguiApp.cpp:427-431). The headless equivalent is a
ring of tensors on the engine's device: ``push`` retains the engine's output
there (no transfer, no sync), and host readback happens only on explicit
``latest_np`` for preview, recording or inspection, through :func:`to_host`,
the one place a frame crosses to the host.

A tensor has no "ready" to wait for, so ``push`` records a CUDA event on
the frame's stream beside each CUDA tensor, and :meth:`wait` synchronizes
on the event of a retained frame: the backpressure of the run loop, with no
device-wide synchronize.

A plain slot list is used rather than one stacked tensor: pushing a frame
is then a reference retain of the engine's asynchronous output.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


def to_host(frame) -> np.ndarray:
    """A frame as a host numpy array: a tensor (on any device) is copied
    to the host, which waits for the work that produces it; anything else
    goes through ``np.asarray``."""
    if isinstance(frame, torch.Tensor):
        return frame.detach().cpu().numpy()
    return np.asarray(frame)


class DeviceRingBuffer:
    """Fixed-capacity ring of device tensors, newest-first access."""

    def __init__(self, capacity: int = 8) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._cap = capacity
        self._slots: List = [None] * capacity
        self._events: List[Optional[torch.cuda.Event]] = [None] * capacity
        self._head = -1  # index of newest
        self._count = 0
        self._pushed = 0

    def __len__(self) -> int:
        return self._count

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def total_pushed(self) -> int:
        return self._pushed

    def push(self, frame) -> None:
        """Retain a device tensor (its work may still be in flight; no sync
        forced). A CUDA tensor gets an event on its device's current stream."""
        self._head = (self._head + 1) % self._cap
        self._slots[self._head] = frame
        event = None
        if isinstance(frame, torch.Tensor) and frame.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(frame.device))
        self._events[self._head] = event
        self._count = min(self._count + 1, self._cap)
        self._pushed += 1

    def latest(self):
        """Newest device tensor, or None."""
        return None if self._count == 0 else self._slots[self._head]

    def get(self, age: int = 0):
        """Device tensor ``age`` frames back (0 = newest)."""
        if age < 0 or age >= self._count:
            raise IndexError(f"age {age} out of range (have {self._count})")
        return self._slots[(self._head - age) % self._cap]

    def wait(self, age: int = 0) -> None:
        """Block the host until the frame ``age`` back has been computed
        (its event, recorded at ``push``); nothing to wait for on the CPU."""
        if age < 0 or age >= self._count:
            raise IndexError(f"age {age} out of range (have {self._count})")
        event = self._events[(self._head - age) % self._cap]
        if event is not None:
            event.synchronize()

    def history(self, k: Optional[int] = None) -> List:
        """Newest-first list of up to k retained device tensors."""
        k = self._count if k is None else min(k, self._count)
        return [self.get(i) for i in range(k)]

    def latest_np(self) -> Optional[np.ndarray]:
        """Explicit host readback of the newest frame (the ONLY place the
        ring crosses the device->host boundary)."""
        f = self.latest()
        return None if f is None else to_host(f)

    def clear(self) -> None:
        self._slots = [None] * self._cap
        self._events = [None] * self._cap
        self._head = -1
        self._count = 0
