"""ShardedCannyEngine: the CannyEngine surface over a tile mesh
(``cudacam_tpu/engine/sharded_engine.py`` analog).

Frames are cut into tiles over a (batch, rows, cols) mesh
(``parallel/mesh.py``) and run through the sharded pipeline
(``parallel/sharded.py``): spec-locked ``process``, clamped runtime
thresholds held on the device, run to any stage. On a one-card mesh the
engine runs on ``device='cuda'`` unless asked for the CPU, and every tile of
the batch lives on that device; on a distributed mesh the device is the
transport's, and ``process`` takes and returns this process's shard::

    eng = ShardedCannyEngine(CannyConfig(height=4320, width=7680),
                             make_mesh(batch=1, rows=4, cols=2))
    edges = eng.process(frames)            # (B, H, W) uint8 on the card
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch
from torch.autograd import profiler as autograd_profiler

from cudacam_tpu_torch.config import CannyConfig
from cudacam_tpu_torch.engine.engine import ThresholdControls, resolve_device
from cudacam_tpu_torch.ops.cuda._build import close_span, open_span
from cudacam_tpu_torch.parallel.mesh import TileMesh, single_device_mesh
from cudacam_tpu_torch.parallel.sharded import (
    ShardedPipeline, build_sharded_pipeline, shard_frame,
)
from cudacam_tpu_torch.stages import CannyStage

FrameLike = Union[np.ndarray, torch.Tensor]


class ShardedCannyEngine(ThresholdControls):
    def __init__(
        self,
        config: CannyConfig,
        mesh: Optional[TileMesh] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        self._cfg = config
        self._mesh = mesh if mesh is not None else single_device_mesh()
        if self._mesh.distributed:
            self._device = self._mesh.transport.device
        else:
            self._device = resolve_device(device)
        self._init_thresholds(config)
        self._fns: Dict[CannyStage, ShardedPipeline] = {}

    @property
    def config(self) -> CannyConfig:
        return self._cfg

    @property
    def mesh(self) -> TileMesh:
        return self._mesh

    @property
    def device(self) -> torch.device:
        return self._device

    def pipeline(self, stage: CannyStage = CannyStage.HYSTER) -> ShardedPipeline:
        """The sharded pipeline to ``stage``, built once per stage."""
        stage = CannyStage(stage)
        fn = self._fns.get(stage)
        if fn is None:
            fn = self._fns[stage] = build_sharded_pipeline(self._cfg, self._mesh, stage)
        return fn

    def shard(self, frames: FrameLike) -> torch.Tensor:
        """A (B, H, W[, C]) batch as the pipeline takes it: on the engine's
        device (a distributed mesh: this process's tile of its batch)."""
        if isinstance(frames, np.ndarray):
            frames = torch.from_numpy(np.ascontiguousarray(frames))
        return shard_frame(frames, self._mesh, self._device)

    def process(
        self, frames: FrameLike, final_stage: CannyStage = CannyStage.HYSTER
    ) -> torch.Tensor:
        """Run stages 0..final_stage on a (B, H, W[, C]) uint8 batch; B must
        be a multiple of the mesh batch axis. Returns the (B, H, W) uint8
        buffer on the engine's device (a distributed mesh: this process's
        shard of it). Under a ``torch.profiler`` session the checks are the
        host span ``cc.validate``; :meth:`shard` (a copy to the device)
        comes after it."""
        span = open_span("cc.validate") if autograd_profiler._is_profiler_enabled else None
        c = self._cfg.channels
        expected = (self._cfg.height, self._cfg.width) + ((c,) if c == 3 else ())
        dtype_ok = (frames.dtype == np.uint8 if isinstance(frames, np.ndarray)
                    else frames.dtype == torch.uint8)
        shape = tuple(frames.shape)
        if not dtype_ok or len(shape) != len(expected) + 1 or shape[1:] != expected:
            raise ValueError(f"expected uint8 (B,)+{expected}, got {frames.dtype} {shape}")
        nb = self._mesh.batch
        if shape[0] % nb:
            raise ValueError(f"batch {shape[0]} not divisible by mesh batch {nb}")
        fn = self.pipeline(final_stage)
        thr = self._cached_thresholds()
        if span is not None:
            close_span(span)
        frames = self.shard(frames)
        return fn(frames, thr if thr is not None else self._thresholds())

    def warmup(self, final_stage: CannyStage = CannyStage.HYSTER,
               batch: Optional[int] = None) -> None:
        """Run a batch of zeros ahead of the first real frames: builds the
        kernels and sets up their launches."""
        c = self._cfg.channels
        shape = ((batch or self._mesh.batch, self._cfg.height, self._cfg.width)
                 + ((c,) if c == 3 else ()))
        self.process(torch.zeros(shape, dtype=torch.uint8), final_stage)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
