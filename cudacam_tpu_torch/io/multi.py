"""Multi-camera batching — several sources driven as one batched stream.

BASELINE config 4 ("batched multi-camera frames") as a product surface: a
``BatchSource`` reads one frame from each child source per step and stacks
them into a (B, H, W[, C]) batch, which the engine processes as a single
launch of each kernel (``ops/cuda/megakernel.py``, the batched path). The
port's copy of ``cudacam_tpu/io/multi.py``. All children must share one
frame spec; the stream ends when any child ends.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from cudacam_tpu_torch.io.sources import FrameSource


class BatchSource(FrameSource):
    def __init__(self, sources: Sequence[FrameSource]) -> None:
        super().__init__()
        if not sources:
            raise ValueError("BatchSource needs at least one child source")
        self._children: List[FrameSource] = list(sources)

    @property
    def batch(self) -> int:
        return len(self._children)

    def _open(self) -> None:
        specs = []
        for s in self._children:
            s.start()
            specs.append(s.spec)
        if len(set(specs)) != 1:
            raise ValueError(f"child sources disagree on frame spec: {specs}")

    def _next(self) -> Optional[np.ndarray]:
        frames = []
        for s in self._children:
            try:
                frames.append(s.read())
            except EOFError:
                return None  # any child ending ends the batch stream
        return np.stack(frames)

    def _close(self) -> None:
        for s in self._children:
            s.stop()

    def _derive_spec(self, first: np.ndarray):
        """The spec contract stays per-frame: frames are (B, H, W[, C]), so
        the per-frame spec comes from a child (validated to agree)."""
        return self._children[0].spec
