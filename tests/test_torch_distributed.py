"""The port's sharded pipeline across processes, on ``torch.distributed``
with gloo on the CPU (``tests/test_distributed.py`` analog).

Two processes form a process group on localhost and run a (1, 2, 1) mesh,
one row tile each: the halo strips cross the process boundary with
``batch_isend_irecv`` and the round loop's pending flag with
``all_reduce``. Each process writes its tile of the output; the test
assembles them and holds the frame to the NumPy oracle (tolerance 0). Run as
a script, this file is that worker:

    python tests/test_torch_distributed.py PORT RANK WORLD OUT_DIR
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[1]
H, W = 64, 96


def snake_frame() -> np.ndarray:
    """Dim lines whose flanks are candidate chains; only their short bright
    leads clear high=90, so the far ends need promotion across the tile
    boundary at row 32 (the vertical line) or along it (the horizontal)."""
    frame = np.zeros((H, W), np.uint8)
    frame[:, 90] = 85
    frame[:10, 90] = 255
    frame[40, :86] = 85
    frame[40, :10] = 255
    return frame


def _worker(port: str, rank: int, world: int, out_dir: str) -> None:
    import torch

    from cudacam_tpu_torch import CannyConfig, CannyStage
    from cudacam_tpu_torch.engine import ShardedCannyEngine
    from cudacam_tpu_torch.parallel import distributed

    distributed.initialize(f"localhost:{port}", num_processes=world, process_id=rank,
                           backend="gloo")
    assert distributed.is_coordinator() == (rank == 0)
    mesh = distributed.pod_mesh(batch=1)
    assert (mesh.batch, mesh.rows, mesh.cols) == (1, world, 1) and mesh.distributed
    eng = ShardedCannyEngine(CannyConfig(height=H, width=W, channels=1), mesh)
    eng.set_high_threshold(90)
    eng.set_low_threshold(5)
    frames = torch.from_numpy(snake_frame())[None]
    out = eng.process(frames)
    thresh = eng.process(frames, CannyStage.THRESH)
    assert out.shape == (1, H // world, W) and out.device.type == "cpu"
    rounds = int(eng.pipeline().rounds)
    np.save(os.path.join(out_dir, f"hyster_{rank}.npy"), out.numpy())
    np.save(os.path.join(out_dir, f"thresh_{rank}.npy"), thresh.numpy())
    torch.distributed.destroy_process_group()
    print(f"OK rank={rank} rounds={rounds}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_row_mesh(tmp_path):
    from cudacam_tpu.ops import numpy_oracle as oracle

    world = 2
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(_REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, __file__, str(port), str(r), str(world),
                               str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"OK rank={r}" in out, f"worker {r}:\n{out}"
    want = oracle.canny_pipeline(snake_frame(), low=5, high=90)
    for key, name in (("hyster", "hyster"), ("thresh", "thresh")):
        got = np.concatenate([np.load(tmp_path / f"{name}_{r}.npy") for r in range(world)], axis=1)
        np.testing.assert_array_equal(got[0], want[key])
    # the promotion crossed the process boundary: the vertical line's flanks
    # are edges far below row 32, where only rows < 10 seed
    assert want["hyster"][60, 88] == 255 or want["hyster"][60, 92] == 255
    assert "rounds=0" not in "".join(outs)


if __name__ == "__main__":
    sys.path.insert(0, str(_REPO))
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
