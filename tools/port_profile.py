#!/usr/bin/env python3
"""Where the device time goes in the PyTorch/CUDA port, on one GPU.

Run from the root of a checkout, on a host with a CUDA device and nvcc:

    python3 tools/port_profile.py [--out FILE]

Six parts (``--parts``, default all), each printing one JSON line per
workload (and writing them all to ``--out`` when given):

* ``trace``: ``CannyEngine(device='cuda')`` under torch.profiler: ``process``
  on the 1080p 8-scene stream (``make_scene`` seeds 0-7, five passes), on the
  1080p spiral frame (two passes) and on the x8 batch of seven scenes and the
  spiral (one call per pass, five passes), and ``process_all`` on the 8-scene
  stream (three passes): device µs per frame for each kernel (other device
  work under its own name), the device's busy time, the idle share of the
  traced span, and the wall time per frame with the profiler on;
* ``sizes``: 4K and 8K streams (four scenes each) byte-equal to the plain
  PyTorch path on the card, with each frame's round flags, CUDA-event
  ms/frame (median of 5 passes), and the spiral frame's flags and ms;
* ``sweeps``: ``threshold_sweep`` of scene 0 with ``benchmark.py``'s K=16
  pairs at 1080p, 4K and 8K under torch.profiler (five passes; "per frame"
  there is per sweep);
* ``sharded``: ``ShardedCannyEngine`` on a one-card mesh under torch.profiler:
  HYSTER on one 8K scene over (1, 4, 2) (five passes) and on the 1080p spiral
  over (1, 2, 2) (two passes), with the device events per frame of each
  kernel and the median µs of one event, which separates the gated round
  kernels (returning at once) from the working ones;
* ``split``: ``CannyEngine.process`` at 8K under torch.profiler with
  ``continuation='split'`` (K11) and with the whole-frame continuation (K2):
  the cap-class spiral (two passes) and calm scene 0 (five passes);
* ``app``: ``CannyApp`` at 1080p BGR under torch.profiler, 64 frames of a
  looped sequence of the eight scenes: host frames through the pinned
  staging buffers (the uploads show as ``Memcpy HtoD``) and
  ``preload_device_loop(8)``.

Imports no jax and nothing of the JAX package: the frame generators are the
port's own (``cudacam_tpu_torch.io.sources``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from cudacam_tpu_torch.app import CannyApp  # noqa: E402
from cudacam_tpu_torch.io.sources import (  # noqa: E402
    SequenceSource, make_scene, make_spiral_frame,
)
from cudacam_tpu_torch import CannyConfig, CannyStage  # noqa: E402
from cudacam_tpu_torch.engine import CannyEngine, ShardedCannyEngine  # noqa: E402
from cudacam_tpu_torch.ops import torch_ops  # noqa: E402
from cudacam_tpu_torch.ops.cuda.canny import pipeline_kwargs  # noqa: E402
from cudacam_tpu_torch.ops.cuda.megakernel import canny_mega_pipeline  # noqa: E402
from cudacam_tpu_torch.parallel import make_mesh  # noqa: E402

KERNELS = ("ff_pack_kernel", "hyst_kernel<false>", "hyst_kernel<true>", "unpack_kernel",
           "ff_stages_kernel", "pack_thresh_kernel", "sweep_pack_kernel", "unpack_core_kernel",
           "exchange_kernel", "split_kernel", "sweeps_kernel")


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def trace(name: str, call, inputs, frames_per_input: int, passes: int) -> dict:
    """``call(x)`` for every x of ``inputs``, ``passes`` times, traced."""
    for x in inputs:  # warm-up: build, launch configs, thresholds on the device
        call(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(passes):
            for x in inputs:
                call(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = passes * len(inputs) * frames_per_input
    dev = [e for e in prof.events() if e.device_type.name == "CUDA"]
    per_kernel = {}
    for e in dev:
        key = next((k for k in KERNELS if k in e.name), e.name)
        per_kernel.setdefault(key, []).append(e.time_range.elapsed_us())
    span = max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in dev)
    return {
        "workload": name, "frames": n, "device_events": len(dev),
        "device_us_per_frame": {k: sum(v) / n for k, v in per_kernel.items()},
        "events_per_frame": {k: len(v) / n for k, v in per_kernel.items()},
        "median_us_per_event": {k: statistics.median(v) for k, v in per_kernel.items()},
        "busy_us": busy, "span_us": span,
        "idle_share": 1 - busy / span, "traced_wall_ms_per_frame": wall * 1e3 / n,
    }


def ms_per_call(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def sizes(h: int, w: int) -> dict:
    cfg = CannyConfig(height=h, width=w)
    eng = CannyEngine(cfg, device="cuda")
    thr = eng._thresholds()
    frames = [torch.from_numpy(make_scene(h, w, seed=s)).cuda() for s in range(4)]
    equal, flags = [], []
    for f in frames:
        plain = torch_ops.canny_to_stage(f, thr[0], thr[1], cfg, CannyStage.HYSTER)
        equal.append(bool(torch.equal(eng.process(f), plain)))
        flags.append(canny_mega_pipeline(f, thr, **pipeline_kwargs(cfg))[1].tolist())
    spiral = torch.from_numpy(make_spiral_frame(h, w)).cuda()
    return {
        "workload": f"stream {h}x{w}", "inner_steps": cfg.hysteresis_inner_steps,
        "scan_after": cfg.hysteresis_scan_after, "equal_plain": equal, "flags": flags,
        "ms_per_frame": ms_per_call(lambda: [eng.process(f) for f in frames]) / len(frames),
        "spiral_flags": canny_mega_pipeline(spiral, thr, **pipeline_kwargs(cfg))[1].tolist(),
        "spiral_ms": ms_per_call(lambda: eng.process(spiral), reps=3),
    }


def sweep(h: int, w: int) -> dict:
    eng = CannyEngine(CannyConfig(height=h, width=w), device="cuda")
    frame = torch.from_numpy(make_scene(h, w, seed=0)).cuda()
    lows, highs = np.linspace(5, 60, 16).astype(np.int32), np.linspace(20, 180, 16).astype(np.int32)
    return trace(f"threshold_sweep K=16 {h}x{w}", lambda x: eng.threshold_sweep(x, lows, highs),
                 [frame], 1, 5)


def sharded() -> list:
    rows = []
    for label, (h, w), mesh, frame, passes in (
            ("8K scene", (4320, 7680), (1, 4, 2), make_scene, 5),
            ("1080p spiral", (1080, 1920), (1, 2, 2), make_spiral_frame, 2)):
        eng = ShardedCannyEngine(CannyConfig(height=h, width=w), make_mesh(*mesh))
        x = torch.from_numpy(frame(h, w)).cuda()[None]
        row = trace(f"sharded HYSTER {label} {mesh}", eng.process, [x], 1, passes)
        row["collective_rounds"] = int(eng.pipeline().rounds)
        rows.append(row)
    return rows


def split() -> list:
    h, w = 4320, 7680
    spiral = torch.from_numpy(make_spiral_frame(h, w)).cuda()
    scene = torch.from_numpy(make_scene(h, w, seed=0)).cuda()
    rows = []
    for cont in ("split", "kernel"):
        eng = CannyEngine(CannyConfig(height=h, width=w, continuation=cont), device="cuda")
        rows += [trace(f"8K spiral, continuation={cont}", eng.process, [spiral], 1, 2),
                 trace(f"8K scene 0, continuation={cont}", eng.process, [scene], 1, 5)]
    return rows


def app() -> list:
    scenes = np.stack([make_scene(1080, 1920, seed=s) for s in range(8)])
    rows = []
    for label, loop in (("host frames (pinned staging)", 0), ("preload_device_loop(8)", 8)):
        with CannyApp(SequenceSource.from_array(scenes, loop=True)) as a:
            a.warmup()
            if loop:
                a.preload_device_loop(loop)
            rows.append(trace(f"app 1080p BGR, {label}", lambda n: a.run(n), [64], 64, 1))
    return rows


PARTS = ("trace", "sizes", "sweeps", "sharded", "split", "app")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, help="also write the JSON lines here")
    ap.add_argument("--parts", default=",".join(PARTS), help=f"comma-separated of {PARTS}")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_profile: needs a CUDA device", file=sys.stderr)
        return 1
    parts = args.parts.split(",")
    rows = []
    if "trace" in parts:
        eng = CannyEngine(CannyConfig(height=1080, width=1920), device="cuda")
        scenes = [torch.from_numpy(make_scene(1080, 1920, seed=s)).cuda() for s in range(8)]
        spiral = torch.from_numpy(make_spiral_frame(1080, 1920)).cuda()
        batch = torch.stack(scenes[:7] + [spiral])
        rows += [
            trace("1080p 8-scene stream", eng.process, scenes, 1, 5),
            trace("1080p spiral", eng.process, [spiral], 1, 2),
            trace("1080p x8 batch (7 scenes + spiral)", eng.process, [batch], 8, 5),
            trace("1080p process_all, 8-scene stream", eng.process_all, scenes, 1, 3),
        ]
    if "sizes" in parts:
        rows += [sizes(2160, 3840), sizes(4320, 7680)]
    if "sweeps" in parts:
        rows += [sweep(1080, 1920), sweep(2160, 3840), sweep(4320, 7680)]
    if "sharded" in parts:
        rows += sharded()
    if "split" in parts:
        rows += split()
    if "app" in parts:
        rows += app()
    lines = [json.dumps(r) for r in rows]
    print("\n".join(lines))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    if not all(all(r.get("equal_plain", [True])) for r in rows):
        print("port_profile: a frame differs from the plain path", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
