"""The port's native runtime: the prefetching frame pump (``framepump.cpp``,
its own copy of the JAX package's ``cudacam_tpu/native``), bound with ctypes.

A C++ producer thread reads a ``.rawv`` stream into a ring of page-aligned
slots while the consumer overlaps device work. The consumer borrows slots
zero-copy: ``acquire`` (one slot at a time, the previous one given back) or
``lend`` / ``give_back`` (several at once, given back oldest first). On a
card, :meth:`FramePump.pin` registers every slot as pinned memory, so that a
non-blocking upload reads straight from the slot; the app gives a slot back
only after its upload's event has completed.

The shared library is compiled with g++ at first use into the git-ignored
``cudacam_tpu_torch/_build`` (plain C ABI, no pybind11), named by a digest of
the source and flags, so an edited source rebuilds. A failed build raises;
nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from cudacam_tpu_torch.utils.logging import get_logger

log = get_logger("native")

SOURCE = Path(__file__).resolve().parent / "framepump.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_U8P = ctypes.POINTER(ctypes.c_uint8)
_H = ctypes.c_void_p
_U32P = ctypes.POINTER(ctypes.c_uint32)
#: C entry points: name -> (restype, argtypes).
SIGNATURES = {
    "fp_open": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int]),
    "fp_spec": (None, [_H, _U32P, _U32P, _U32P, ctypes.POINTER(ctypes.c_uint64)]),
    "fp_start": (ctypes.c_int, [_H, ctypes.c_int]),
    "fp_acquire": (_U8P, [_H]),
    "fp_release": (None, [_H]),
    "fp_read": (ctypes.c_int, [_H, _U8P]),
    "fp_frames_buffered": (ctypes.c_uint64, [_H]),
    "fp_error": (ctypes.c_int, [_H]),
    "fp_stop": (None, [_H]),
    "fp_close": (None, [_H]),
    "fp_slot_count": (ctypes.c_int, [_H]),
    "fp_slot": (ctypes.c_void_p, [_H, ctypes.c_int]),
    "fp_frame_bytes": (ctypes.c_uint64, [_H]),
    "fp_write_file": (ctypes.c_int, [ctypes.c_char_p, _U8P, ctypes.c_uint32, ctypes.c_uint32,
                                     ctypes.c_uint32, ctypes.c_uint64]),
}


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libframepump_{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (when the library for this source is not on disk yet) and load
    the native library. Raises when g++ is missing or the build fails."""
    path = library_path()
    if not path.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the native frame pump cannot be built")
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = BUILD_DIR / f"{path.stem}.{os.getpid()}.tmp"
        cmd = [gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        log.info("building the native frame pump: %s", " ".join(cmd))
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name} ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent build of the same source is the same file
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def write_rawv(path: str, frames: np.ndarray) -> str:
    """Write an (N, H, W[, C]) uint8 array as a .rawv stream file (the bytes
    of ``io/rawv.py::write_rawv``)."""
    if frames.dtype != np.uint8 or frames.ndim not in (3, 4):
        raise ValueError(f"frames must be uint8 (N,H,W[,C]), got {frames.dtype} {frames.shape}")
    frames = np.ascontiguousarray(frames)
    n, h, w = frames.shape[:3]
    c = frames.shape[3] if frames.ndim == 4 else 1
    rc = load_library().fp_write_file(path.encode(), frames.ctypes.data_as(_U8P), h, w, c, n)
    if rc != 0:
        raise IOError(f"fp_write_file failed ({rc}) for {path}")
    return path


class FramePump:
    """Zero-copy reader over a .rawv stream with native prefetch.

    ``acquire()`` returns a read-only numpy view of the next ring slot,
    valid until the next ``acquire()``; ``read()`` returns an owned copy;
    ``lend()`` returns a view that stays valid until ``give_back()`` has
    given back that slot (slots go back oldest first)."""

    def __init__(self, path: str, loop: bool = False, ring_slots: int = 4) -> None:
        self._lib = load_library()
        self._h = self._lib.fp_open(path.encode(), 1 if loop else 0)
        if not self._h:
            raise IOError(f"cannot open rawv stream {path}")
        hh, ww, cc = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_uint32()
        nn = ctypes.c_uint64()
        self._lib.fp_spec(self._h, ctypes.byref(hh), ctypes.byref(ww), ctypes.byref(cc),
                          ctypes.byref(nn))
        self.height, self.width, self.channels = hh.value, ww.value, cc.value
        self.n_frames = nn.value
        self._shape: Tuple[int, ...] = (
            (self.height, self.width, self.channels) if self.channels > 1
            else (self.height, self.width)
        )
        self._lent = 0
        self._pinned: List[int] = []  # slot addresses registered with CUDA
        rc = self._lib.fp_start(self._h, ring_slots)
        if rc != 0:
            self._lib.fp_close(self._h)
            self._h = None
            raise IOError(f"fp_start failed ({rc})")

    @property
    def buffered(self) -> int:
        """Filled slots in the ring, those lent included."""
        return int(self._lib.fp_frames_buffered(self._h))

    @property
    def lent(self) -> int:
        """Slots lent and not given back."""
        return self._lent

    @property
    def pinned(self) -> bool:
        return bool(self._pinned)

    def lend(self) -> Optional[np.ndarray]:
        """Borrow the next frame as a read-only zero-copy view of its slot,
        keeping the slots already lent; None at end of stream. The view is
        valid until its slot is given back."""
        ptr = self._lib.fp_acquire(self._h)
        if not ptr:
            if self._lib.fp_error(self._h):
                raise IOError("torn frame in rawv stream")
            return None
        self._lent += 1
        view = np.ctypeslib.as_array(ptr, shape=(int(np.prod(self._shape)),)).reshape(self._shape)
        view.flags.writeable = False
        return view

    def give_back(self) -> None:
        """Give the oldest lent slot back to the producer."""
        if not self._lent:
            raise RuntimeError("no slot is lent")
        self._lib.fp_release(self._h)
        self._lent -= 1

    def acquire(self) -> Optional[np.ndarray]:
        """Borrow the next frame as a zero-copy view; None at end of stream.
        Every slot lent before is given back first, so the view is
        invalidated by the next acquire()."""
        while self._lent:
            self.give_back()
        return self.lend()

    def read(self) -> Optional[np.ndarray]:
        """Owned copy of the next frame; None at end of stream."""
        v = self.acquire()
        if v is None:
            return None
        out = v.copy()
        self.give_back()
        return out

    def slots(self) -> List[Tuple[int, int]]:
        """(address, bytes) of every slot of the ring."""
        n, nbytes = self._lib.fp_slot_count(self._h), int(self._lib.fp_frame_bytes(self._h))
        return [(self._lib.fp_slot(self._h, i), nbytes) for i in range(n)]

    def pin(self) -> None:
        """Register every slot as pinned (page-locked) memory with CUDA, so
        that a non-blocking upload reads straight from a slot. Raises
        without a card or when a registration fails; registered slots are
        unregistered by :meth:`close`."""
        import torch

        if self._pinned:
            return
        if not torch.cuda.is_available():
            raise RuntimeError("pinning the frame pump's slots needs a CUDA device")
        cudart = torch.cuda.cudart()
        try:
            for addr, nbytes in self.slots():
                torch.cuda.check_error(cudart.cudaHostRegister(addr, nbytes, 0))
                self._pinned.append(addr)
        except Exception:
            self._unpin()
            raise

    def _unpin(self) -> None:
        if self._pinned:
            import torch

            cudart = torch.cuda.cudart()
            for addr in self._pinned:
                torch.cuda.check_error(cudart.cudaHostUnregister(addr))
            self._pinned = []

    def stop(self) -> None:
        """Phase-1 shutdown, safe from ANY thread: stops the producer and
        wakes a consumer blocked in acquire() (it returns None). Call this
        from a controlling thread, then let the owner call close()."""
        if self._h:
            self._lib.fp_stop(self._h)

    def close(self) -> None:
        """Destroy the pump, unregistering pinned slots first. Per the C ABI
        contract (framepump.cpp), no other FramePump call on this handle may
        START once close begins; consumers already blocked inside acquire()
        are drained safely (close stops the producer, wakes them, and waits
        until they leave before freeing). A caller that pinned the slots
        waits for its uploads from them first."""
        if self._h:
            try:
                self._unpin()
            finally:
                self._lib.fp_close(self._h)
                self._h = None

    def __enter__(self) -> "FramePump":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass
