"""Implement a custom FrameSource and run the port's app headlessly.

Run:  python examples/torch_custom_source.py [--device cpu]
"""
import argparse
import os
import sys

# Make the example runnable from a source checkout (no-op when the
# package is installed).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from typing import Optional

import numpy as np

from cudacam_tpu_torch.app import CannyApp
from cudacam_tpu_torch.io import FrameSource


class GradientPulse(FrameSource):
    """A synthetic source: a moving bright bar over a gradient background."""

    def __init__(self, height=240, width=320, n_frames=30):
        super().__init__()
        self._h, self._w, self._n = height, width, n_frames
        self._i = 0

    def _open(self) -> None:
        self._i = 0

    def _next(self) -> Optional[np.ndarray]:
        if self._i >= self._n:
            return None
        h, w = self._h, self._w
        frame = np.tile(np.linspace(0, 180, w, dtype=np.uint8), (h, 1))
        x = (self._i * 7) % (w - 20)
        frame[:, x : x + 20] = 255
        self._i += 1
        return np.repeat(frame[..., None], 3, axis=2)  # BGR


parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the hand-written kernels (raises without a card); "
                         "cpu: the plain PyTorch ops")
args = parser.parse_args()

with CannyApp(GradientPulse(), device=args.device) as app:
    app.warmup()
    n = app.run(None)  # until the source ends
    print(f"processed {n} frames at {app.fps:.1f} fps (device {app.engine.device})")
    print(app.preview(width=72, color=False))  # ASCII render of the edges
