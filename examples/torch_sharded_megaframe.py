"""Shard a mega-frame into row tiles with halo exchange, on one device.

The JAX example spreads the tiles over devices (or virtual CPU devices);
here a (1, n, 1) tile mesh lives on one card (or the CPU), and the tiles
exchange their halos and run the collective round loop there:

    python examples/torch_sharded_megaframe.py [--device cpu] [--tiles 8]
"""
import argparse
import os
import sys

# Make the example runnable from a source checkout (no-op when the
# package is installed).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from cudacam_tpu_torch import CannyConfig
from cudacam_tpu_torch.engine import ShardedCannyEngine
from cudacam_tpu_torch.io import make_scene
from cudacam_tpu_torch.parallel import make_mesh

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the hand-written kernels (raises without a card); "
                         "cpu: the plain PyTorch ops")
parser.add_argument("--tiles", type=int, default=8, help="row tiles of the mesh")
args = parser.parse_args()

n = args.tiles
# Every tile on the row axis: each exchanges halos with two neighbours.
mesh = make_mesh(batch=1, rows=n, cols=1)
h, w = 64 * n, 1920
cfg = CannyConfig(height=h, width=w)
engine = ShardedCannyEngine(cfg, mesh, device=args.device)
print(f"{n} row tiles of {h // n}x{w} on {engine.device}")

frames = np.stack([make_scene(h, w, seed=s) for s in range(2)])
out = engine.process(frames)
print("sharded edge maps:", tuple(out.shape), "mesh:", (mesh.batch, mesh.rows, mesh.cols),
      "collective rounds:", int(engine.pipeline().rounds))
