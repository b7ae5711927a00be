"""Library quickstart on the PyTorch/CUDA port: process frames, inspect
stages, sweep thresholds.

Run:  python examples/torch_basic.py [--device cpu]
"""
import argparse
import os
import sys

# Make the example runnable from a source checkout (no-op when the
# package is installed).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from cudacam_tpu_torch import CannyConfig, CannyStage
from cudacam_tpu_torch.engine import CannyEngine
from cudacam_tpu_torch.io import make_scene, to_host

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the hand-written kernels (raises without a card); "
                         "cpu: the plain PyTorch ops")
args = parser.parse_args()

h, w = 480, 640
engine = CannyEngine(CannyConfig(height=h, width=w), device=args.device)
frame = make_scene(h, w, seed=1)  # any (H, W, 3) BGR uint8 array

# Full pipeline -> uint8 edge map (255 = edge) on the engine's device.
edges = to_host(engine.process(frame))
print(f"edges: {edges.shape} {edges.dtype}, {int((edges == 255).sum())} edge px "
      f"(device {engine.device})")

# Run-to-stage-k returns that stage's display buffer.
nms = to_host(engine.process(frame, CannyStage.NMS))
print(f"NMS magnitudes: max={int(nms.max())}")

# Runtime threshold changes build nothing: the kernels read them on the device.
engine.set_low_threshold(20)
engine.set_high_threshold(80)
edges_tight = to_host(engine.process(frame))
print(f"tighter thresholds: {int((edges_tight == 255).sum())} edge px")

# K (low, high) pairs over one frame, one feed-forward pass.
maps, counts = engine.threshold_sweep(frame, [5, 10, 20], [40, 80, 160])
print("sweep edge counts:", [int(c) for c in to_host(counts)])

# Batched multi-camera frames are first-class: one launch of each kernel.
batch = np.stack([make_scene(h, w, seed=s) for s in range(4)])
out = engine.process(batch)
print("batched:", tuple(out.shape))
