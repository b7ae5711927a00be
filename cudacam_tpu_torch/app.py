"""CannyApp — the headless streaming application: the port of
``cudacam_tpu/app.py``.

Analog of ``App::ImguiApp`` (reference src/imgui/imguiApp.{hpp,cpp}):
owns the frame source, the pipeline engine, the device-resident output ring
(the PBO analog) and the FPS meter, and drives the per-frame loop
(ImguiApp::run, imguiApp.cpp:496-525). The reference's UI controls map to API
methods usable from the CLI or any embedding:

* stage combo box (imguiApp.cpp:312-324)        -> ``set_stage`` / ``cycle_stage``
  (any-key stage cycling, imguiApp.cpp:180-194)
* threshold sliders (imguiApp.cpp:326-339)      -> ``set_thresholds``
* pause/start button (imguiApp.cpp:291-295)     -> ``pause`` / ``resume``
* DELETE toggles the CUDA pipeline (:183-186)   -> ``toggle_pipeline``
* profiling checkbox + table (:345-386)         -> ``set_profiling`` /
  ``profiling_table``
* FPS meter (:267-283)                          -> ``fps``

The display path is headless-first: outputs stay on the engine's device in
the ring; ``preview`` / ``save_frame`` / recording / publishing do the only
host readbacks, all through ``io.ring.to_host``.

On the card the app owns ``ring_capacity`` pinned staging buffers: a host
frame is copied into the next one and uploaded with a non-blocking copy on
the engine's stream, so the run loop never waits for an upload; a buffer is
reused only after the event recorded behind its last upload. A source that
lends its ring slots (``RawvSource``, the native frame pump) skips the
staging copy: its slots are registered as pinned memory when the app is
made, each frame is uploaded straight from its slot, and a slot goes back to
the pump only after the event behind its upload has completed. Backpressure is
one event wait per ring turnover (``DeviceRingBuffer.wait``), never a
device-wide synchronize. The app runs on ``device='cuda'`` unless asked for
the CPU, and raises without a card.
"""
from __future__ import annotations

import collections
import os
import time
import warnings
from typing import Callable, Deque, List, Optional, Union

import numpy as np
import torch

from cudacam_tpu_torch.config import CannyConfig
from cudacam_tpu_torch.engine import CannyEngine
from cudacam_tpu_torch.io import DeviceRingBuffer, FpsMeter, FrameSource, to_host
from cudacam_tpu_torch.io.preview import ascii_preview, save_png
from cudacam_tpu_torch.stages import CANNY_STAGE_NAMES, CannyStage
from cudacam_tpu_torch.utils.logging import get_logger

log = get_logger("app")


class CannyApp:
    def __init__(
        self,
        source: FrameSource,
        config: Optional[CannyConfig] = None,
        final_stage: CannyStage = CannyStage.HYSTER,
        ring_capacity: int = 8,
        profiling: bool = False,
        profiling_mode: str = "auto",
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        self._source = source
        source.start()
        h, w, c = source.spec
        if config is None:
            config = CannyConfig(height=h, width=w, channels=c)
        elif (config.height, config.width, config.channels) != (h, w, c):
            raise ValueError(
                f"config spec {config.height}x{config.width}x{config.channels} "
                f"!= source spec {h}x{w}x{c}"
            )
        self._cfg = config
        self._engine = CannyEngine(config, device=device, profiling=profiling)
        self._engine.profiling_mode = profiling_mode
        self._engine._profiling_mode_resolved()  # a mode this device lacks raises here
        self._ring = DeviceRingBuffer(ring_capacity)
        # Pinned staging buffers of the upload path, made at the first frame
        # (its shape: a batch source's frames carry a leading batch dim), each
        # with the event recorded behind its last upload.
        self._staging: Optional[List[torch.Tensor]] = None
        self._staging_events: List[Optional[object]] = [None] * ring_capacity
        self._staging_idx = 0
        # A source that lends pinned ring slots, on the card: the event behind
        # each lent slot's last upload, oldest first (None: not uploaded yet).
        self._lends = self._engine.device.type == "cuda" and hasattr(source, "lend")
        self._slot_uploads: Deque[Optional[torch.cuda.Event]] = collections.deque()
        if self._lends:
            source.pin()
        self._fps = FpsMeter()
        self._stage = CannyStage(final_stage)
        self._paused = False
        self._pipeline_enabled = True  # DELETE-key analog (imguiApp.cpp:183)
        self._last_input: Optional[np.ndarray] = None
        #: Frame pacing cap (the reference's vsync lock, ~60 Hz,
        #: imguiApp.cpp:42,208). None = unpaced (max throughput).
        self.max_fps: Optional[float] = None
        self._next_deadline = 0.0
        # Host-side publishing: when enabled, the RUN LOOP thread snapshots
        # every k-th output to host memory, so other threads (the preview
        # server, the key controller) never touch the device.
        self._publish_every = 0
        # (raw_frame, output) published as ONE tuple reference so readers on
        # other threads can never observe a torn pair from two different
        # frames (tuple assignment is atomic under the GIL).
        self._published_pair: Optional[tuple] = None
        #: Display composition mode for preview/save/serve (io.compose.MODES).
        self.display_mode = "edges"
        # Device-resident input loop (preload_device_loop): when set, step()
        # cycles these preloaded device frames and never touches the source
        # or the host->device path again.
        self._device_frames: Optional[List] = None
        self._device_raw: Optional[List[np.ndarray]] = None
        self._device_idx = 0

    # -- controls ----------------------------------------------------------

    @property
    def engine(self) -> CannyEngine:
        return self._engine

    @property
    def ring(self) -> DeviceRingBuffer:
        return self._ring

    @property
    def stage(self) -> CannyStage:
        return self._stage

    def set_stage(self, stage: CannyStage) -> None:
        self._stage = CannyStage(stage)
        log.info("stage -> %s", CANNY_STAGE_NAMES[self._stage])

    def cycle_stage(self) -> CannyStage:
        """Advance to the next stage, wrapping (imguiApp.cpp:188-193)."""
        self._stage = CannyStage((self._stage + 1) % len(CannyStage))
        return self._stage

    def set_thresholds(self, low: Optional[int] = None, high: Optional[int] = None) -> None:
        if low is not None:
            self._engine.set_low_threshold(low)
        if high is not None:
            self._engine.set_high_threshold(high)

    def pause(self) -> None:
        self._paused = True

    def resume(self) -> None:
        self._paused = False

    @property
    def paused(self) -> bool:
        return self._paused

    def toggle_pipeline(self) -> bool:
        """Enable/disable processing; when off, raw frames pass through
        (the reference's DELETE key, imguiApp.cpp:183-186)."""
        self._pipeline_enabled = not self._pipeline_enabled
        return self._pipeline_enabled

    def set_profiling(self, enabled: bool) -> None:
        self._engine.set_profiling(enabled)

    def profiling_table(self) -> str:
        return self._engine.profiling_table()

    @property
    def fps(self) -> float:
        return self._fps.fps

    def apply_controls(
        self,
        low: Optional[int] = None,
        high: Optional[int] = None,
        stage: Optional[object] = None,
        paused: Optional[bool] = None,
        pipeline: Optional[bool] = None,
        mode: Optional[str] = None,
        profiling: Optional[bool] = None,
        max_fps: Optional[float] = None,
    ) -> dict:
        """Apply any subset of the runtime controls and return the updated
        status — the live analog of the reference's UI loop, where
        sliders/combo/pause act on a RUNNING stream (imguiApp.cpp:303-349).

        Safe to call from any thread while the run loop streams: every
        setter only swaps Python references/ints (atomic under the GIL), and
        all device work — including re-uploading the threshold pair —
        happens lazily on the run-loop thread. Threshold moves and stage
        changes build nothing: the kernel library is loaded once, and the
        kernels read the thresholds from a device tensor. Raises ValueError
        on invalid values.
        """
        if stage is not None:
            if isinstance(stage, str) and not stage.isdigit():
                try:
                    stage = CannyStage[stage.upper()]
                except KeyError:
                    raise ValueError(f"unknown stage {stage!r}")
            self.set_stage(CannyStage(int(stage)))
        if low is not None:
            self._engine.set_low_threshold(int(low))
        if high is not None:
            self._engine.set_high_threshold(int(high))
        if paused is not None:
            (self.pause if paused else self.resume)()
        if pipeline is not None and pipeline != self._pipeline_enabled:
            self.toggle_pipeline()
        if mode is not None:
            from cudacam_tpu_torch.io.compose import MODES

            if mode not in MODES:
                raise ValueError(f"unknown display mode {mode!r}")
            self.display_mode = mode
        if profiling is not None:
            self.set_profiling(bool(profiling))
        if max_fps is not None:
            self.max_fps = float(max_fps) if max_fps > 0 else None
        return self.status()

    def status(self) -> dict:
        """Live status snapshot (the ImGui info panel analog)."""
        return {
            "stage": self._stage.name,
            "stage_label": CANNY_STAGE_NAMES[self._stage],
            "low": self._engine.get_low_threshold(),
            "high": self._engine.get_high_threshold(),
            "backend": self._engine.backend,
            "paused": self._paused,
            "pipeline_enabled": self._pipeline_enabled,
            "fps": round(self._fps.fps, 2),
            "frames": self._fps.total_frames,
            "spec": self._source.spec,
            "display_mode": self.display_mode,
            "max_fps": self.max_fps,
            "profiling": (
                self._engine.profiling_table()
                if self._engine.is_profiling_enabled()
                else None
            ),
        }

    def warmup(self) -> None:
        """Run the current stage's pipeline once ahead of the first frame
        (it sets up the kernels' launches). When host publishing is enabled,
        also performs one throwaway device readback, so that the first
        device-to-host transfer of the process does not land in the middle
        of the streaming loop."""
        if self._pipeline_enabled:
            self._engine.warmup(self._stage)
            if self._publish_every:
                h, w, c = self._source.spec
                shape = (h, w, c) if c == 3 else (h, w)
                to_host(self._engine.process(np.zeros(shape, np.uint8),
                                             self._stage))

    def preload_device_loop(self, n_frames: int = 8) -> int:
        """Read ``n_frames`` from the source ONCE, upload them to the
        device, and have every subsequent step() cycle these device-resident
        inputs without touching the source or the host->device path again:
        the stream's cost without capture and upload. Intended for
        soaks/demos/benchmarks of replayable sources; live sources cannot
        use it (their frames would be ignored). Returns the number of frames
        actually preloaded."""
        self._give_back_slots()
        frames = []
        for _ in range(max(1, int(n_frames))):
            try:
                frames.append(self._source.read())
            except EOFError:
                break
        if not frames:
            raise RuntimeError("source yielded no frames to preload")
        self._device_raw = frames
        dev = self._engine.device
        self._device_frames = [torch.from_numpy(np.ascontiguousarray(f)).to(dev) for f in frames]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self._device_idx = len(frames) - 1  # first step wraps to frame 0
        self._last_input = frames[-1]
        log.info("device loop: %d frames preloaded (%d MB host-resident)",
                 len(frames), sum(f.nbytes for f in frames) >> 20)
        return len(frames)

    # -- per-frame loop ----------------------------------------------------

    def _upload(self, frame: np.ndarray) -> torch.Tensor:
        """A host frame as a tensor on the engine's device. On the card: a
        non-blocking upload on the current stream, with an event behind it,
        straight from a lent ring slot (which must be pinned), or else from a
        copy into the next pinned staging buffer, whose previous upload is
        waited for first (long done, in a stream that keeps up)."""
        dev = self._engine.device
        if self._lends:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)  # a read-only view: the copy reads it
                host = torch.from_numpy(frame)
            if not host.is_pinned():
                raise RuntimeError("the source's ring slot is not pinned: a non-blocking upload "
                                   "from it would be synchronous")
            out = host.to(dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            if self._slot_uploads:  # empty only once a one-slot ring's stream ended
                self._slot_uploads[-1] = event
            return out
        host = torch.from_numpy(np.ascontiguousarray(frame))
        if dev.type != "cuda":
            return host
        if self._staging is None or self._staging[0].shape != host.shape:
            self._staging = [torch.empty(host.shape, dtype=host.dtype).pin_memory()
                             for _ in range(self._ring.capacity)]
            self._staging_events = [None] * self._ring.capacity
        i = self._staging_idx
        self._staging_idx = (i + 1) % len(self._staging)
        if self._staging_events[i] is not None:
            self._staging_events[i].synchronize()
        self._staging[i].copy_(host)
        out = self._staging[i].to(dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        self._staging_events[i] = event
        return out

    def _read_frame(self) -> np.ndarray:
        """The source's next frame: on the slot route a view of its lent
        slot. Slots whose uploads have completed go back first, oldest
        first, except the newest (it holds the current raw frame); a ring
        whose every slot is lent waits for its oldest upload (with one slot,
        that is the newest, and the current raw frame is copied first)."""
        if not self._lends:
            return self._source.read()
        q = self._slot_uploads
        while len(q) > 1 and (q[0] is None or q[0].query()):
            q.popleft()
            self._source.give_back()
        if q and self._source.lent >= self._source.ring_slots:
            if q[0] is not None:
                q[0].synchronize()
            if len(q) == 1:
                self._own_last_input()
            q.popleft()
            self._source.give_back()
        frame = self._source.lend()
        q.append(None)
        return frame

    def _own_last_input(self) -> None:
        """Replace the current raw frame, a view of the newest lent slot, by
        an owned copy before that slot goes back: a caller that holds the
        frame (``preview``, ``save_frame`` after ``close``) never reads a
        slot the producer refills or the pump has freed."""
        if self._last_input is not None:
            self._last_input = np.array(self._last_input)

    def _give_back_slots(self) -> None:
        """Wait for every upload from the source's slots and give every
        lent slot back, the current raw frame kept as an owned copy."""
        if self._lends:
            torch.cuda.current_stream(self._engine.device).synchronize()
        if self._slot_uploads:
            self._own_last_input()
        while self._slot_uploads:
            event = self._slot_uploads.popleft()
            if event is not None:
                event.synchronize()
            self._source.give_back()

    def step(self) -> object:
        """One iteration of the run loop (ImguiApp::run body,
        imguiApp.cpp:502-521): read the next frame (while paused, the last
        frame is reused — reading once if none exists yet), process it
        (unless the pipeline is toggled off, in which case the raw frame
        passes through), retain the output on device, tick the meter, and
        return the device output."""
        if self.max_fps:
            now = time.perf_counter()
            if now < self._next_deadline:
                time.sleep(self._next_deadline - now)
            self._next_deadline = (
                max(self._next_deadline, now - 1.0 / self.max_fps)
                + 1.0 / self.max_fps
            )
        if self._device_frames is not None:
            # Cycle preloaded device-resident inputs: zero host->device
            # transfers per frame.
            if not self._paused:
                self._device_idx = (self._device_idx + 1) % len(
                    self._device_frames
                )
            frame = self._device_frames[self._device_idx]
            self._last_input = self._device_raw[self._device_idx]
        else:
            if not self._paused or self._last_input is None:
                self._last_input = self._read_frame()
            frame = self._upload(self._last_input)
        if self._pipeline_enabled:
            out = self._engine.process(frame, self._stage)
        else:
            out = frame  # pass-through: the raw frame, on the engine's device
        self._ring.push(out)
        # Backpressure: launches are asynchronous, and an unbounded queue of
        # in-flight frames balloons host and device memory. Once per ring
        # turnover, wait for the OLDEST retained output (its event) — at most
        # ~ring_capacity frames stay in flight while the pipeline remains
        # deep.
        if self._ring.total_pushed % self._ring.capacity == 0:
            self._ring.wait(len(self._ring) - 1)
        if (
            self._publish_every
            and self._ring.total_pushed % self._publish_every == 0
        ):
            # self._last_input is always the HOST copy of the current raw
            # frame (in device-loop mode ``frame`` is device-resident); a
            # lent slot's view is copied, since its slot goes back later.
            raw = self._last_input.copy() if self._lends else self._last_input
            self._published_pair = (raw, to_host(out))
        self._fps.tick()
        return out

    def run(
        self,
        n_frames: Optional[int] = None,
        on_frame: Optional[Callable[[int, object], None]] = None,
    ) -> int:
        """Drive the loop for ``n_frames`` (or until the source ends).
        Returns the number of frames processed."""
        done = 0
        try:
            while n_frames is None or done < n_frames:
                out = self.step()
                if on_frame is not None:
                    on_frame(done, out)
                done += 1
        except EOFError:
            log.info("source ended after %d frames", done)
        except KeyboardInterrupt:
            # Preserve the count for the caller's summary/recordings.
            log.info("interrupted after %d frames", done)
        return done

    # -- readback / export (the only host transfers) -----------------------

    def enable_publishing(self, every: int = 2) -> None:
        """Snapshot every ``every``-th output to host memory from the run
        loop (for consumers on other threads, e.g. the preview server)."""
        self._publish_every = max(1, int(every))

    def published_np(self, mode: Optional[str] = None) -> Optional[np.ndarray]:
        """Latest host-published frame, composed per ``mode`` (defaults to
        ``self.display_mode``). When publishing is enabled this NEVER
        touches the device (safe from any thread); it returns None until the
        run loop publishes the first frame. With publishing disabled it
        falls back to a direct readback (caller's thread owns the device)."""
        from cudacam_tpu_torch.io.compose import compose

        mode = mode or self.display_mode
        if self._publish_every:
            pair = self._published_pair  # one read: raw+out from SAME frame
            if pair is None:
                return None
            return compose(pair[0], pair[1], mode)
        return compose(self._last_input, self._ring.latest_np(), mode)

    def preview(
        self,
        width: int = 96,
        color: bool = True,
        zoom: float = 1.0,
        center: Optional[tuple] = None,
        mode: Optional[str] = None,
    ) -> str:
        """Terminal rendering of the newest output, composed per ``mode``
        (edges/raw/split/overlay; defaults to ``self.display_mode``).
        ``zoom`` > 1 crops to a 1/zoom-sized window around ``center``
        (fractions of the frame, default middle) — the reference's
        mouse-wheel zoom tooltip, 2-6x (imguiApp.cpp:168-179, 452-474)."""
        from cudacam_tpu_torch.io.compose import compose

        f = compose(self._last_input, self._ring.latest_np(),
                    mode or self.display_mode)
        if f is None:
            return ""
        if zoom > 1.0:
            h, w = f.shape[:2]
            cy, cx = center or (0.5, 0.5)
            zh, zw = max(2, int(h / zoom)), max(2, int(w / zoom))
            y0 = min(max(0, int(cy * h) - zh // 2), h - zh)
            x0 = min(max(0, int(cx * w) - zw // 2), w - zw)
            f = f[y0 : y0 + zh, x0 : x0 + zw]
        return ascii_preview(f, width=width, color=color)

    def save_frame(self, path: str, mode: Optional[str] = None) -> Optional[str]:
        from cudacam_tpu_torch.io.compose import compose

        f = compose(self._last_input, self._ring.latest_np(),
                    mode or self.display_mode)
        return None if f is None else save_png(path, f)

    def record(
        self,
        n_frames: Optional[int],
        path: str,
        on_frame: Optional[Callable[[int, object], None]] = None,
        fps: float = 30.0,
    ) -> str:
        """Process ``n_frames`` (None = until the source ends) and save the
        outputs: raw edge maps as one (N, H, W) .npy, or — when ``path``
        ends in .mp4/.avi — an encoded video of the composed display frames
        (``self.display_mode``). ``on_frame`` is chained after the
        recording callback."""
        video = path.endswith((".mp4", ".avi"))
        if video:
            return self._record_video(n_frames, path, on_frame, fps)
        outs: List[np.ndarray] = []

        def cb(i: int, o) -> None:
            outs.append(to_host(o))
            if on_frame is not None:
                on_frame(i, o)

        try:
            self.run(n_frames, on_frame=cb)
        except KeyboardInterrupt:
            # Save what was captured rather than losing it.
            log.info("recording interrupted after %d frames", len(outs))
        if not outs:
            raise RuntimeError("no frames recorded (source empty?)")
        arr = np.stack(outs)
        if not path.endswith(".npy"):
            path += ".npy"  # np.save appends it; return the real file path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        np.save(path, arr)
        return path

    def _record_video(self, n_frames, path, on_frame, fps) -> str:
        import cv2

        from cudacam_tpu_torch.io.compose import compose

        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        fourcc = cv2.VideoWriter_fourcc(
            *("mp4v" if path.endswith(".mp4") else "MJPG")
        )
        writer = [None]
        count = [0]

        def cb(i: int, o) -> None:
            frame = compose(self._last_input, to_host(o), self.display_mode)
            if writer[0] is None:
                h, w = frame.shape[:2]
                writer[0] = cv2.VideoWriter(path, fourcc, fps, (w, h))
                if not writer[0].isOpened():
                    raise IOError(f"cannot open video writer for {path}")
            writer[0].write(np.ascontiguousarray(frame))
            count[0] += 1
            if on_frame is not None:
                on_frame(i, o)

        try:
            self.run(n_frames, on_frame=cb)
        except KeyboardInterrupt:
            log.info("video recording interrupted after %d frames", count[0])
        finally:
            if writer[0] is not None:
                writer[0].release()
        if count[0] == 0:
            raise RuntimeError("no frames recorded (source empty?)")
        return path

    def close(self) -> None:
        self._give_back_slots()
        self._source.stop()

    def __enter__(self) -> "CannyApp":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
