"""CannyEngine — the port's pipeline orchestrator.

Port of ``cudacam_tpu/engine/engine.py``: spec-locked frames, run-to-stage
execution, and runtime thresholds with the reference's clamping. The
engine runs on ``device='cuda'`` unless asked for the CPU: on CUDA it builds
the kernels at construction and raises when there is no card or they cannot
be built; on ``'cpu'`` every stage runs the plain PyTorch ops. There is no
fallback between the two.

Thresholds are held as one device int32 [low, high] tensor that the
kernels read, so a threshold change rebuilds nothing and the hot path reads
nothing back to the host. A batched (B, H, W[, 3]) input runs HYSTER as one
launch of each kernel for the whole batch, and a display stage as one
``ff_stages`` launch for the whole batch; ``process_all`` loops over its
frames, as the JAX package maps over them.
``threshold_sweep`` runs K threshold pairs over one frame.

Per-stage profiling is off by default and then adds nothing to ``process``:
no launch, no event, no sync. Switched on (``set_profiling``), each frame is
timed per stage into a named-timer table (``profiling_table``), on the card
with CUDA events (the reference's own ``cudaEventRecord`` timers,
cannyEdgeH.cu:409-430), never a host clock around an asynchronous launch;
on the CPU with the wall clock. ``profiling_mode``: ``stages`` times the
plain stage ops one by one, which are the CPU engine's own path, so it is a
mode of ``device='cpu'`` only and raises on the card (a profiled frame on the
card is always the kernels' output); ``cumulative`` times the run-to-stage-k
programs users actually run and gives stage k the increment t(k) - t(k-1),
clamped at 0; ``device`` samples increments once per (batch, stage) from the
kernels' busy time under ``torch.profiler`` and then streams untimed: t(k)
of a display stage is the one-pass feed-forward kernel writing every buffer
MONO..k, so each stage's row is what producing its own buffer adds (the
run-to-stage-k programs differ by less than their noise: THRESH's skips the
magnitude that NMS's computes); ``auto`` is ``device`` on the card and
``stages`` on the CPU.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from cudacam_tpu_torch.config import CannyConfig
from cudacam_tpu_torch.stages import CANNY_STAGE_NAMES, CannyStage
from cudacam_tpu_torch.ops import bitpack, torch_ops
from cudacam_tpu_torch.ops.cuda import canny
from cudacam_tpu_torch.ops.cuda._build import load
from cudacam_tpu_torch.ops.cuda.feedforward import ff_stages_batched
from cudacam_tpu_torch.utils.devtime import device_time_ms_per_call, event_time_ms_per_call
from cudacam_tpu_torch.utils.logging import get_logger
from cudacam_tpu_torch.utils.timer import TimerManager

log = get_logger("engine")

PROFILING_MODES = ("auto", "stages", "cumulative", "device")

FrameLike = Union[np.ndarray, torch.Tensor]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """'cuda' (one card, built kernels) or 'cpu' (the plain ops). A CUDA
    device without a card or without a working kernel build raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev}: no CUDA device is available (pass device='cpu')")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        load()  # raises when the kernels cannot be built
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cpu' or 'cuda', got {dev}")
    return dev


class ThresholdControls:
    """Runtime threshold accessors: clamping identical to the reference
    setters (low <= high, parity-aware cap), plus a cached device tensor
    of the pair, rebuilt only when a value changed. Requires ``self._cfg``
    and ``self._device``."""

    def _init_thresholds(self, config: CannyConfig) -> None:
        self._low = config.low_threshold
        self._high = config.high_threshold
        self._thresh_dev: Optional[tuple] = None

    def get_low_threshold(self) -> int:
        return self._low

    def get_high_threshold(self) -> int:
        return self._high

    def set_low_threshold(self, low: int) -> None:
        self._low = max(0, min(int(low), self._high))

    def set_high_threshold(self, high: int) -> None:
        self._high = min(self._cfg.threshold_cap, max(int(high), self._low))

    def _thresholds(self) -> torch.Tensor:
        """The device [low, high] tensor, cached BY VALUE: the entry carries
        the pair it was built from, so a setter on another thread can never
        leave a stale pair in use."""
        cached = self._thresh_dev
        lo, hi = self._low, self._high
        if cached is None or cached[0] != lo or cached[1] != hi:
            t = torch.tensor([lo, hi], dtype=torch.int32).to(self._device)
            cached = (lo, hi, t)
            self._thresh_dev = cached
        return cached[2]


class CannyEngine(ThresholdControls):
    """Spec-locked Canny engine on one torch device."""

    #: Interleaved sampling rounds of the ``device`` profiling mode.
    PROFILE_ROUNDS = 5

    def __init__(
        self,
        config: CannyConfig,
        device: Union[str, torch.device] = "cuda",
        profiling: bool = False,
        timers: Optional[TimerManager] = None,
    ) -> None:
        self._cfg = config
        self._device = resolve_device(device)
        self._init_thresholds(config)
        self._profiling = bool(profiling)
        #: 'auto' | 'stages' | 'cumulative' | 'device' (module docstring).
        self.profiling_mode = "auto"
        self._timers = timers or TimerManager.get()
        self._profile_warmed: set = set()
        for name in CANNY_STAGE_NAMES.values():
            self._timers.create_timer(name)
        log.debug("engine created: %s device=%s", config, self._device)

    @property
    def config(self) -> CannyConfig:
        return self._cfg

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def backend(self) -> str:
        """'cuda' (the kernels) or 'cpu' (the plain ops)."""
        return self._device.type

    def is_profiling_enabled(self) -> bool:
        return self._profiling

    def set_profiling(self, enabled: bool) -> None:
        """Toggle per-stage timing (reference cannyEdgeH.hpp:31)."""
        self._profiling = bool(enabled)

    @property
    def timers(self) -> TimerManager:
        return self._timers

    def profiling_table(self) -> str:
        return self._timers.table()

    def _profiling_mode_resolved(self) -> str:
        if self.profiling_mode not in PROFILING_MODES:
            raise ValueError(f"profiling_mode must be one of {PROFILING_MODES}")
        on_card = self._device.type == "cuda"
        if self.profiling_mode == "stages" and on_card:
            raise ValueError(
                "profiling_mode 'stages' times the plain stage ops and runs on "
                "device='cpu' only; on the card use 'cumulative' or 'device'")
        if self.profiling_mode != "auto":
            return self.profiling_mode
        return "device" if on_card else "stages"

    def _validate(self, frame: FrameLike) -> Tuple[torch.Tensor, bool]:
        """Spec lock + type checks; returns (tensor on the engine's device,
        batched?)."""
        if frame is None:
            raise ValueError("Cannot process empty frame")
        if isinstance(frame, np.ndarray):
            if frame.size == 0:
                raise ValueError("Cannot process empty frame")
            if frame.dtype != np.uint8:
                raise ValueError(f"Only uint8 frames supported, got {frame.dtype}")
            arr = torch.from_numpy(np.ascontiguousarray(frame))
        elif isinstance(frame, torch.Tensor):
            if frame.numel() == 0:
                raise ValueError("Cannot process empty frame")
            if frame.dtype != torch.uint8:
                raise ValueError(f"Only uint8 frames supported, got {frame.dtype}")
            arr = frame
        else:
            raise ValueError(f"frame must be a numpy array or torch tensor, got {type(frame)}")
        c = self._cfg.channels
        expected = (self._cfg.height, self._cfg.width) + ((c,) if c == 3 else ())
        shape = tuple(arr.shape)
        if shape == expected:
            batched = False
        elif len(shape) == len(expected) + 1 and shape[1:] == expected:
            batched = True
        else:
            raise ValueError(
                f"Frame specs differ from initialization: got {shape}, "
                f"expected {expected} or (B,)+{expected}"
            )
        return arr.to(self._device).contiguous(), batched

    def process(
        self, frame: FrameLike, final_stage: CannyStage = CannyStage.HYSTER
    ) -> torch.Tensor:
        """Run stages 0..final_stage; returns that stage's uint8 buffer on
        the engine's device."""
        arr, batched = self._validate(frame)
        final_stage = CannyStage(final_stage)
        thr = self._thresholds()
        if self._profiling:
            return self._process_profiled(arr, batched, final_stage, thr)
        return self._to_stage(arr, batched, final_stage, thr)

    def _to_stage(self, arr, batched: bool, stage: CannyStage, thr) -> torch.Tensor:
        """The program users run: the cumulative run to ``stage``."""
        if batched:
            return canny.canny_to_stage_batched(arr, thr, self._cfg, stage)
        return canny.canny_to_stage(arr, thr, self._cfg, stage)

    # -- profiling ----------------------------------------------------------

    def _timed_ms(self, fn: Callable[[], object]) -> Tuple[object, float]:
        """``fn()`` and its milliseconds: CUDA events on the engine's stream
        around it on the card (one event synchronize), the wall clock on the
        CPU."""
        if self._device.type != "cuda":
            t0 = time.perf_counter()
            out = fn()
            return out, (time.perf_counter() - t0) * 1e3
        stream = torch.cuda.current_stream(self._device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = fn()
        end.record(stream)
        end.synchronize()
        return out, start.elapsed_time(end)

    def _process_profiled(self, arr, batched: bool, final_stage: CannyStage, thr) -> torch.Tensor:
        mode = self._profiling_mode_resolved()
        if mode == "device":
            return self._process_profiled_device(arr, batched, final_stage, thr)
        if mode == "cumulative":
            return self._process_profiled_cumulative(arr, batched, final_stage, thr)
        return self._process_profiled_stages(arr, batched, final_stage, thr)

    def _process_profiled_stages(self, arr, batched: bool, final_stage: CannyStage,
                                 thr) -> torch.Tensor:
        """The CPU engine's stage ops one by one, each timed into its stage's
        timer (Sobel and the magnitude together as "3/6", as the reference
        times them); the outputs are the unprofiled path's, byte for byte.
        A batch runs each op frame by frame inside its stage's window. Never
        reached on the card (``_profiling_mode_resolved`` raises there)."""
        cfg, names = self._cfg, CANNY_STAGE_NAMES
        disp = torch_ops.display_coeff(cfg)

        def over(fn):
            """``fn`` over the frames of a batch (or the one frame)."""
            if not batched:
                return fn
            def run(*xs):
                outs = [fn(*(x[b] for x in xs)) for b in range(len(xs[0]))]
                if isinstance(outs[0], tuple):
                    return tuple(torch.stack(o) for o in zip(*outs))
                return torch.stack(outs)
            return run

        def timed(stage: CannyStage, fn, *xs):
            out, ms = self._timed_ms(lambda: over(fn)(*xs))
            self._timers.add_time(names[stage], ms)
            return out

        mono = timed(CannyStage.MONO, torch_ops.rgb2mono, arr)
        if final_stage == CannyStage.MONO:
            return mono
        blur = timed(CannyStage.GAUSSIAN, lambda m: torch_ops.gaussian_blur(m, cfg.kernel_size),
                     mono)
        if final_stage == CannyStage.GAUSSIAN:
            return blur
        sum_x, sum_y = timed(CannyStage.GRADIENT, torch_ops.sobel_sums, blur)
        if final_stage == CannyStage.GRADIENT:
            return over(lambda sx, sy: torch_ops.nms_magnitude_u8(sx, sy, disp, cfg.norm))(
                sum_x, sum_y)
        nms = timed(CannyStage.NMS,
                    lambda sx, sy: torch_ops.non_max_suppression(sx, sy, disp, cfg.norm),
                    sum_x, sum_y)
        if final_stage == CannyStage.NMS:
            return nms
        thresh = timed(CannyStage.THRESH,
                       lambda sx, sy: torch_ops.compute_threshold_map(sx, sy, thr[0], thr[1], cfg),
                       sum_x, sum_y)
        if final_stage == CannyStage.THRESH:
            return thresh
        return timed(CannyStage.HYSTER, lambda t: bitpack.hysteresis_packed(
            t, max_iters=cfg.max_hysteresis_iters, dilate_steps=cfg.hysteresis_inner_steps,
            scan_after=cfg.hysteresis_scan_after), thresh)

    def _stages_to(self, final_stage: CannyStage):
        return [s for s in CannyStage if s <= final_stage]

    def _process_profiled_cumulative(self, arr, batched: bool, final_stage: CannyStage,
                                     thr) -> torch.Tensor:
        """Profiling on the programs users run: the cumulative run-to-stage-k
        calls, stage k given the increment t(k) - t(k-1), clamped at 0. Costs
        about two frames. The first profiled frame of a (batch, stage) runs
        every program once outside the timed loop, so that enabling profiling
        on a live stream records no set-up time as stage time."""
        key = ("cumwarm", batched, final_stage)
        if key not in self._profile_warmed:
            for stage in self._stages_to(final_stage):
                self._to_stage(arr, batched, stage, thr)
            self._profile_warmed.add(key)
        prev, out = 0.0, None
        for stage in self._stages_to(final_stage):
            out, ms = self._timed_ms(lambda: self._to_stage(arr, batched, stage, thr))
            self._timers.add_time(CANNY_STAGE_NAMES[stage], max(0.0, ms - prev))
            prev = ms
        return out

    def _sample_program(self, arr, batched: bool, stage: CannyStage, thr) -> Callable[[], object]:
        """The program whose time ends stage ``stage`` in the ``device``
        mode: HYSTER's own; for a display stage the one-pass feed-forward
        kernel (``ff_stages``, K7) writing every buffer MONO..``stage``, one
        launch for the frame or the batch, as the display stages run it."""
        if stage == CannyStage.HYSTER:
            return lambda: self._to_stage(arr, batched, stage, thr)
        stages = tuple(s for s in CannyStage if s <= stage)
        frames = arr if batched else arr.unsqueeze(0)
        kw = canny.ff_kwargs(self._cfg)
        return lambda: ff_stages_batched(frames, thr, stages, **kw)

    def _sample_ms(self, run: Callable[[], object]) -> float:
        """One device-mode sample of ``run``: kernel busy ms per call over 20
        calls; CUDA events where the profiler shows no device time; on the
        CPU, the wall clock of one call, which is honest there."""
        ms = None
        if self._device.type == "cuda":
            ms = device_time_ms_per_call(run, calls=20, device=self._device)
            if ms is None:
                ms = event_time_ms_per_call(run, calls=5, device=self._device)
        return self._timed_ms(run)[1] if ms is None else ms

    def _process_profiled_device(self, arr, batched: bool, final_stage: CannyStage,
                                 thr) -> torch.Tensor:
        """Per-stage times from the kernels' busy time (``torch.profiler``),
        not from a clock around the calls: the first profiled frame of a
        (batch, stage) samples each stage's program (:meth:`_sample_program`)
        in ``PROFILE_ROUNDS`` interleaved rounds, so that a drift of the
        card's clock falls on every stage alike, and records the increments
        of the medians; later frames run the program untimed, so the stream
        keeps its speed and the table shows the sample."""
        key = ("devsample", batched, final_stage)
        if key not in self._profile_warmed:
            stages = self._stages_to(final_stage)
            runs = [self._sample_program(arr, batched, s, thr) for s in stages]
            for run in runs:
                run()  # warm
            samples = [[] for _ in stages]
            for _ in range(self.PROFILE_ROUNDS):
                for got, run in zip(samples, runs):
                    got.append(self._sample_ms(run))
            prev = 0.0
            for stage, got in zip(stages, samples):
                ms = float(np.median(got))
                self._timers.add_time(CANNY_STAGE_NAMES[stage], max(0.0, ms - prev))
                prev = ms
            self._profile_warmed.add(key)
        return self._to_stage(arr, batched, final_stage, thr)

    def process_all(self, frame: FrameLike) -> Dict[str, torch.Tensor]:
        """Run everything, returning every stage buffer on the engine's
        device under the keys of ``xla_ops.canny_all_stages`` (stacked per
        key for a batch)."""
        arr, batched = self._validate(frame)
        thr = self._thresholds()
        if not batched:
            return canny.canny_all_stages(arr, thr, self._cfg)
        per_frame = [canny.canny_all_stages(f, thr, self._cfg) for f in arr]
        return {k: torch.stack([d[k] for d in per_frame]) for k in per_frame[0]}

    def threshold_sweep(
        self, frame: FrameLike, lows, highs
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Edge maps and FINAL-edge counts of one frame for K (low, high)
        pairs, as given (unclamped): ((K, H, W) uint8, (K,) int32) on the
        engine's device. The pairs go to the device once per call; nothing
        is built per threshold and nothing is read back."""
        arr, batched = self._validate(frame)
        if batched:
            raise ValueError("threshold_sweep takes a single frame")
        lows = np.asarray(lows, np.int32)
        highs = np.asarray(highs, np.int32)
        if lows.shape != highs.shape or lows.ndim != 1:
            raise ValueError("lows/highs must be equal-length 1D")
        pairs = torch.from_numpy(np.stack([lows, highs]))
        if self._device.type == "cuda":  # pinned: an asynchronous copy
            pairs = pairs.pin_memory().to(self._device, non_blocking=True)
        return canny.threshold_sweep(arr, pairs[0], pairs[1], self._cfg)

    def warmup(self, final_stage: CannyStage = CannyStage.HYSTER, batch: int = 0) -> None:
        """Run one frame (or a batch of ``batch`` frames) of zeros ahead of
        the first real frame: builds the kernels and sets up their launches."""
        c = self._cfg.channels
        shape = (self._cfg.height, self._cfg.width) + ((c,) if c == 3 else ())
        if batch:
            shape = (batch,) + shape
        self.process(torch.zeros(shape, dtype=torch.uint8, device=self._device), final_stage)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        if self._profiling:
            # Drop the warm-up samples: they time set-up, not kernels. The
            # device-mode sample keys go too, so the first real frame
            # samples again (its table entries were just reset).
            self._timers.reset()
            self._profile_warmed = {k for k in self._profile_warmed if k[0] != "devsample"}

    @contextlib.contextmanager
    def trace(self, logdir: str):
        """Capture a ``torch.profiler`` profile of everything run inside the
        context and write it as a chrome trace, ``<logdir>/trace.json``: the
        deep-dive layer under the per-stage timer table."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self._device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with profile(activities=activities) as prof:
            yield
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
