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
launch of each kernel for the whole batch; the display stages and
``process_all`` loop over its frames, as the JAX package maps over them.
``threshold_sweep`` runs K threshold pairs over one frame.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from cudacam_tpu_torch.config import CannyConfig
from cudacam_tpu_torch.stages import CannyStage
from cudacam_tpu_torch.ops.cuda import canny
from cudacam_tpu_torch.ops.cuda._build import load

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

    def __init__(self, config: CannyConfig, device: Union[str, torch.device] = "cuda") -> None:
        self._cfg = config
        self._device = resolve_device(device)
        self._init_thresholds(config)

    @property
    def config(self) -> CannyConfig:
        return self._cfg

    @property
    def device(self) -> torch.device:
        return self._device

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
        if batched:
            return canny.canny_to_stage_batched(arr, thr, self._cfg, final_stage)
        return canny.canny_to_stage(arr, thr, self._cfg, final_stage)

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
