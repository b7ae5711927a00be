"""Frame sources of the port: its own copy of what it uses from
``cudacam_tpu/io/sources.py``.

The scene generators (``make_scene``, ``make_spiral_frame``,
``make_spiral_thresh``) give the same bytes as the JAX package's for the
same arguments, and ``open_source`` opens the spec forms the CLI takes:
``synthetic[:HxW[x1]]``, ``spiral[:HxW]``, ``webcam[:IDX]``, ``video:PATH``,
``seq:PATH``, ``rawv:PATH``, bare ``.rawv`` / ``.npy`` / directory /
video paths, and ``multi:<spec>,<spec>,...`` or ``multi:N*<spec>`` (a batch
of cameras, ``io/multi.py``). Every source locks its frame spec at ``start()``; frames are
uint8 (H, W, 3) BGR or (H, W) mono.
"""
from __future__ import annotations

import abc
import logging
import os
from typing import Iterator, Optional, Tuple

import numpy as np

log = logging.getLogger("cudacam_tpu_torch.io")


def make_scene(h: int, w: int, seed: int = 0, t: float = 0.0) -> np.ndarray:
    """Deterministic BGR scene with realistic edge structure: smooth
    background, shapes and mild texture. ``t`` animates it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (
        96
        + 64 * np.sin(2 * np.pi * (xx + 40.0 * t) / 397.0)
        + 48 * np.cos(2 * np.pi * (yy + 25.0 * t) / 251.0)
    )
    img = np.stack([base, base * 0.9, base * 1.1], axis=-1)
    for _ in range(24):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        r = int(rng.integers(16, max(17, min(h, w) // 9)))
        val = rng.integers(0, 256, size=3)
        dy = int(20.0 * t * (1 if (cy + cx) % 2 else -1))
        mask = (yy - (cy + dy) % h) ** 2 + (xx - cx) ** 2 < r * r
        img[mask] = val
    for _ in range(16):
        if h > 64 and w > 64:
            y0, x0 = rng.integers(0, h - 64), rng.integers(0, w - 64)
            hh, ww = rng.integers(24, min(160, h - y0)), rng.integers(24, min(160, w - x0))
            img[y0 : y0 + hh, x0 : x0 + ww] = rng.integers(0, 256, size=3)
    img += rng.normal(0, 2.0, size=img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_spiral_thresh(h: int, w: int) -> np.ndarray:
    """Adversarial hysteresis input: a square spiral of CANDIDATE (128)
    pixels seeded with one FINAL (255) at its outer end, a single chain of
    geodesic length ~h*w/2."""
    t = np.zeros((h, w), np.uint8)
    sides = []
    sw_, sh_ = w - 1, h - 1
    while sw_ > 0 and sh_ > 0:
        sides += [(0, 1, sw_), (1, 0, sh_), (0, -1, sw_ - 2), (-1, 0, sh_ - 2)]
        sw_ -= 4
        sh_ -= 4
    r = c = 0
    t[0, 0] = 128
    for dr, dc, n in sides:
        for _ in range(max(0, n)):
            r += dr
            c += dc
            t[r, c] = 128
    t[0, 0] = 255
    return t


def make_spiral_frame(h: int, w: int, v: int = 65, gap: int = 12) -> np.ndarray:
    """Adversarial hysteresis input as a BGR image: a square spiral ridge
    whose flank gradients land in the candidate band at the default (10, 40)
    thresholds, seeded by one bright blob at the outer tip. Arms sit ``gap``
    px apart so the 5x5 blur keeps each ridge distinct. Cap-class: the
    100-round cap cuts its hysteresis off."""
    if h < 2 * gap + 4 or w < 2 * gap + 4:
        raise ValueError(
            f"spiral frame needs h, w >= {2 * gap + 4} (gap={gap}); "
            f"got {h}x{w}"
        )
    img = np.zeros((h, w), np.uint8)
    top, left, bot, right = 1, 1, h - 2, w - 2
    pts = []
    while right - left > gap and bot - top > gap:
        for cc in range(left, right + 1):
            pts.append((top, cc))
        for rr in range(top, bot + 1):
            pts.append((rr, right))
        for cc in range(right, left + gap - 1, -1):
            pts.append((bot, cc))
        for rr in range(bot, top + gap - 1, -1):
            pts.append((rr, left + gap))
        top += gap
        left += gap
        bot -= gap
        right -= gap
    for (r, c) in pts:
        img[r, c] = v
    r0, c0 = pts[0]
    img[max(0, r0 - 1) : r0 + 2, c0 : c0 + 3] = 255  # seed blob on the tip
    return np.stack([img] * 3, axis=-1)


class FrameSource(abc.ABC):
    """Spec-locked frame producer: ``start()`` locks (height, width,
    channels); ``read()`` blocks for the next frame; sources iterate and
    work as context managers."""

    def __init__(self) -> None:
        self._running = False
        self._frame: Optional[np.ndarray] = None  # last frame read
        self._pending: Optional[np.ndarray] = None  # start() frame, unserved
        self._spec: Optional[Tuple[int, int, int]] = None

    def start(self) -> None:
        if self._running:
            return
        self._open()
        first = self._next()
        if first is None:
            raise RuntimeError(f"{type(self).__name__}: no first frame")
        self._frame = first
        self._pending = first
        self._spec = self._derive_spec(first)
        self._running = True
        log.info("%s started: spec=%s", type(self).__name__, self._spec)

    def _derive_spec(self, first: np.ndarray) -> Tuple[int, int, int]:
        """Per-frame (height, width, channels) from the first frame;
        batched sources override (their frames carry a leading batch dim)."""
        c = 1 if first.ndim == 2 else first.shape[2]
        return (first.shape[0], first.shape[1], c)

    def stop(self) -> None:
        if self._running:
            self._close()
            self._running = False

    def is_running(self) -> bool:
        return self._running

    @property
    def spec(self) -> Tuple[int, int, int]:
        """(height, width, channels), locked at start."""
        if self._spec is None:
            raise RuntimeError("source not started")
        return self._spec

    @property
    def frame(self) -> Optional[np.ndarray]:
        """Last frame read."""
        return self._frame

    def read(self) -> np.ndarray:
        """Blocking read of the next frame; raises at end of stream or on a
        blank frame."""
        nxt = self._take()
        self._frame = nxt
        return nxt

    def _take(self) -> np.ndarray:
        """The next frame, start()'s first while it is unserved; raises at
        end of stream or on a blank frame."""
        if not self._running:
            raise RuntimeError("source not started")
        if self._pending is not None:
            nxt, self._pending = self._pending, None
        else:
            nxt = self._next()
            if nxt is None or nxt.size == 0:
                raise EOFError(f"{type(self).__name__}: stream ended/blank frame")
        return nxt

    def __iter__(self) -> Iterator[np.ndarray]:
        if not self._running:
            self.start()
        while True:
            try:
                yield self.read()
            except EOFError:
                return

    def __enter__(self) -> "FrameSource":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    @abc.abstractmethod
    def _open(self) -> None: ...

    @abc.abstractmethod
    def _next(self) -> Optional[np.ndarray]: ...

    def _close(self) -> None:
        pass


class SyntheticSource(FrameSource):
    """Animated procedural scene; endless unless ``n_frames`` is set.
    ``channels=1`` emits (H, W) grayscale frames."""

    def __init__(self, height: int = 1080, width: int = 1920, seed: int = 0,
                 n_frames: Optional[int] = None, fps: float = 30.0,
                 channels: int = 3) -> None:
        super().__init__()
        if channels not in (1, 3):
            raise ValueError(f"channels must be 1 or 3, got {channels}")
        self._h, self._w, self._seed = height, width, seed
        self._n = n_frames
        self._fps = fps
        self._c = channels
        self._i = 0

    def _open(self) -> None:
        self._i = 0

    def _next(self) -> Optional[np.ndarray]:
        if self._n is not None and self._i >= self._n:
            return None
        f = make_scene(self._h, self._w, self._seed, t=self._i / self._fps)
        self._i += 1
        return f[..., 0].copy() if self._c == 1 else f


class _CaptureSource(FrameSource):
    """Frames decoded by OpenCV from a video file or a camera."""

    def __init__(self) -> None:
        super().__init__()
        self._cap = None

    def _next(self) -> Optional[np.ndarray]:
        ok, frame = self._cap.read()
        return frame if ok else None

    def _close(self) -> None:
        if self._cap is not None:
            self._cap.release()
            self._cap = None


class VideoFileSource(_CaptureSource):
    """Frames decoded from a video file (host-side decode)."""

    def __init__(self, path: str, loop: bool = False) -> None:
        super().__init__()
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self._path = path
        self._loop = loop

    def _open(self) -> None:
        import cv2

        self._cap = cv2.VideoCapture(self._path)
        if not self._cap.isOpened():
            raise RuntimeError(f"cannot open video {self._path}")

    def _next(self) -> Optional[np.ndarray]:
        frame = super()._next()
        if frame is None and self._loop:
            import cv2

            self._cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
            frame = super()._next()
        return frame


class WebcamSource(_CaptureSource):
    """Live camera, requesting 1920x1080 (falls back to the device default)."""

    def __init__(self, device: int = 0, width: int = 1920, height: int = 1080) -> None:
        super().__init__()
        self._device = device
        self._req = (width, height)

    def _open(self) -> None:
        import cv2

        self._cap = cv2.VideoCapture(self._device, cv2.CAP_ANY)
        if not self._cap.isOpened():
            raise RuntimeError(f"cannot open webcam {self._device}")
        self._cap.set(cv2.CAP_PROP_FRAME_WIDTH, self._req[0])
        self._cap.set(cv2.CAP_PROP_FRAME_HEIGHT, self._req[1])


class SequenceSource(FrameSource):
    """Recorded frames: a ``.npy`` file of shape (N, H, W[, C]) uint8, a
    directory of ``.npy`` / image files (sorted), or an in-memory array
    (:meth:`from_array`)."""

    def __init__(self, path: str, loop: bool = False) -> None:
        super().__init__()
        self._path = path
        self._loop = loop
        self._frames: Optional[np.ndarray] = None
        self._files: Optional[list] = None
        self._i = 0
        self._served = 0
        self._max_frames = 0

    @classmethod
    def from_array(cls, frames: np.ndarray, loop: bool = False,
                   max_frames: int = 0) -> "SequenceSource":
        """In-memory sequence; ``max_frames`` bounds a looping source (0 =
        unbounded)."""
        src = cls(path="<memory>", loop=loop)
        src._frames = np.asarray(frames, np.uint8)
        src._max_frames = int(max_frames)
        return src

    def _open(self) -> None:
        self._i = 0
        self._served = 0
        if self._path == "<memory>":
            return
        if os.path.isdir(self._path):
            names = sorted(
                f for f in os.listdir(self._path)
                if f.endswith((".npy", ".png", ".jpg", ".jpeg", ".bmp"))
            )
            if not names:
                raise RuntimeError(f"no frames in {self._path}")
            self._files = [os.path.join(self._path, f) for f in names]
        else:
            arr = np.load(self._path)
            if arr.dtype != np.uint8 or arr.ndim not in (3, 4):
                raise ValueError(
                    f"sequence must be uint8 (N,H,W[,C]), got {arr.dtype} {arr.shape}"
                )
            self._frames = arr

    def _next(self) -> Optional[np.ndarray]:
        if self._max_frames and self._served >= self._max_frames:
            return None
        self._served += 1
        n = len(self._files) if self._files is not None else len(self._frames)
        if self._i >= n:
            if not self._loop:
                return None
            self._i = 0
        i = self._i
        self._i += 1
        if self._frames is not None:
            return self._frames[i]
        p = self._files[i]
        if p.endswith(".npy"):
            return np.load(p)
        import cv2

        img = cv2.imread(p)
        if img is None:
            raise IOError(f"unreadable frame {p}")
        return img


class RawvSource(FrameSource):
    """Frames from a ``.rawv`` stream via the native prefetching frame pump
    (``cudacam_tpu_torch/native``): a C++ producer thread fills a ring of
    ``ring_slots`` page-aligned slots while the consumer overlaps device
    work.

    ``read()`` returns an owned copy of each frame. ``lend()`` returns the
    next frame as a read-only view of its slot, which stays the frame's
    until ``give_back()`` returns that slot (oldest lent first); ``pin()``
    registers the slots as pinned memory, so that the app uploads straight
    from them (``CannyApp`` on a card does both). ``frame`` holds only the
    copies ``read()`` made, never a lent view."""

    def __init__(self, path: str, loop: bool = False, ring_slots: int = 4) -> None:
        super().__init__()
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self._path = path
        self._loop = loop
        self._ring_slots = ring_slots
        self._pump = None

    def _open(self) -> None:
        from cudacam_tpu_torch.native import FramePump

        self._pump = FramePump(self._path, loop=self._loop, ring_slots=self._ring_slots)

    def start(self) -> None:
        if not self._running:
            super().start()
            self._frame = None  # the first frame is a lent view until it is served

    def _next(self) -> Optional[np.ndarray]:
        return self._pump.lend()  # start()'s first frame stays lent until it is served

    def read(self) -> np.ndarray:
        """Blocking read of the next frame, an owned copy; raises at end of
        stream. Refused while slots are lent: its slot would not be the
        oldest to give back."""
        if self._running and self._pump.lent > (self._pending is not None):
            raise RuntimeError("RawvSource.read while slots are lent: give them back first")
        frame = self._take().copy()
        self._pump.give_back()
        self._frame = frame
        return frame

    def lend(self) -> np.ndarray:
        """The next frame as a read-only view of its ring slot, valid until
        :meth:`give_back` returns that slot; raises at end of stream."""
        return self._take()

    def give_back(self) -> None:
        """Return the oldest lent slot to the producer."""
        self._pump.give_back()

    @property
    def lent(self) -> int:
        """Slots lent and not given back (a frame not yet read included)."""
        return self._pump.lent if self._pump is not None else 0

    @property
    def ring_slots(self) -> int:
        return self._ring_slots

    def pin(self) -> None:
        """Register the ring's slots as pinned memory (raises without a card
        or when a registration fails)."""
        if not self._running:
            raise RuntimeError("source not started")
        self._pump.pin()

    @property
    def pinned(self) -> bool:
        return self._pump is not None and self._pump.pinned

    def _close(self) -> None:
        if self._pump is not None:
            self._pump.close()
            self._pump = None


def open_source(spec: str, **kw) -> FrameSource:
    """Parse a source spec string into a FrameSource (the CLI's way in):
    ``synthetic`` | ``synthetic:HxW`` | ``synthetic:HxWx1`` (grayscale) |
    ``spiral[:HxW]`` | ``webcam[:IDX]`` | ``video:PATH`` | ``seq:PATH`` |
    ``rawv:PATH`` | a bare path (``.rawv`` / ``.npy`` / directory / video,
    by extension) | ``multi:<spec>,<spec>,...`` or ``multi:N*<spec>`` (batched
    multi-camera; children must share a frame spec)."""
    if spec.startswith("multi:"):
        from cudacam_tpu_torch.io.multi import BatchSource

        body = spec.split(":", 1)[1]
        if "*" in body.split(",")[0] and "," not in body:
            n_str, child = body.split("*", 1)
            children_specs = [child] * int(n_str)
        else:
            children_specs = [s for s in body.split(",") if s]
        # Distinct seeds for synthetic children so the cameras differ.
        children = []
        for i, cs in enumerate(children_specs):
            src = open_source(cs, **dict(kw))
            if isinstance(src, SyntheticSource):
                src._seed = src._seed + i
            children.append(src)
        return BatchSource(children)
    if spec.startswith("synthetic"):
        if ":" in spec:
            dims = [int(v) for v in spec.split(":", 1)[1].lower().split("x")]
            if len(dims) == 2:
                h, w = dims
                return SyntheticSource(height=h, width=w, **kw)
            if len(dims) == 3:
                h, w, c = dims
                return SyntheticSource(height=h, width=w, channels=c, **kw)
            raise ValueError(f"bad synthetic spec {spec!r}: want HxW or HxWxC")
        return SyntheticSource(**kw)
    if spec.startswith("spiral"):
        if ":" in spec:
            h, w = (int(v) for v in spec.split(":", 1)[1].lower().split("x"))
        else:
            h, w = 1080, 1920
        # One frame, looped, bounded (default 1000) so sinks that read until
        # the source ends terminate.
        n = kw.pop("n_frames", 0) or 1000
        kw.setdefault("loop", True)
        return SequenceSource.from_array(make_spiral_frame(h, w)[None], max_frames=n, **kw)
    if spec.startswith("webcam"):
        dev = int(spec.split(":", 1)[1]) if ":" in spec else 0
        return WebcamSource(device=dev, **kw)
    if spec.startswith("video:"):
        return VideoFileSource(spec.split(":", 1)[1], **kw)
    if spec.startswith("seq:"):
        return SequenceSource(spec.split(":", 1)[1], **kw)
    if spec.startswith("rawv:"):
        return RawvSource(spec.split(":", 1)[1], **kw)
    if spec.endswith(".rawv"):
        return RawvSource(spec, **kw)
    if spec.endswith(".npy") or os.path.isdir(spec):
        return SequenceSource(spec, **kw)
    return VideoFileSource(spec, **kw)
